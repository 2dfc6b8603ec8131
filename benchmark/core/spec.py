"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout and
the files it names, found by name.

- ``benchmark/configs/<config>.json``: a model's settings at the top level
  (the program's ``GlobalConfig`` fields), with ``source``, ``reduced``
  and ``assumed``.
- ``benchmark/traffic/<traffic>.json``: a traffic mix, ``driver`` (a
  module ``benchmark/drivers/<driver>.py``) and its parameters.
- ``benchmark/limits/<cell>.json``: each number the check of ``correct``
  compares, with its limit.
- ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict            # the model's settings
    traffic_name: str
    traffic: dict           # the mix's parameters, ``driver`` among them
    limits: dict            # check name -> limit
    end_to_end: list        # the cell's end-to-end metric entries
    per_layer: list         # the cell's per-layer metric entries


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, benchmark: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with everything it names.
    Refuses a cell that reports a per-layer metric without the end-to-end
    metric that metric moves."""
    bench = benchmark or _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _json(os.path.join(root, cfg_entry["file"]))
    traffic = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    have = {m["name"] for m in e2e}
    for m in layer:
        if m["moves"] not in have:
            raise SystemExit(f"cell {name}: per-layer metric {m['name']} "
                             f"moves {m['moves']}, which the cell does not "
                             f"report")
    return Cell(name, w["chips"], w["config"], config, w["traffic"], traffic,
                limits, e2e, layer)


def program_config(settings: dict):
    """The program's ``GlobalConfig`` of a configuration file's settings."""
    import dataclasses

    from deepsense6g_tii_tpu_torch.config import GlobalConfig
    fields = {f.name for f in dataclasses.fields(GlobalConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in settings.items() if k in fields}
    return GlobalConfig(**kw)


def driver(cell: Cell):
    """``benchmark/drivers/<driver>.py``, the traffic mix's generator."""
    return importlib.import_module("benchmark.drivers."
                                   + cell.traffic["driver"])


def metric_reader(name: str):
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "bench_metric_" + name.replace(".", "_"))


def name_list(metric: str) -> set:
    """Kernel names from every file of ``metrics/<metric>.d/``, one a line
    (``#`` starts a comment)."""
    d = os.path.join(HERE, "metrics", metric + ".d")
    names = set()
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn)) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if line:
                    names.add(line)
    return names
