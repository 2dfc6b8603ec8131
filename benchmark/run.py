"""The benchmark of ``deepsense6g_tii_tpu_torch`` on NVIDIA GPUs.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the machine it is started on and
prints one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number that decided ``correct``
beside its limit (also the last lines of standard error).

Everything a cell needs is found by name (``benchmark/core/spec.py``): its
configuration, its traffic mix and that mix's driver, the limits of its
check, and one reader for each per-layer metric.  A new cell, configuration
or metric is new files and new entries in ``BENCHMARK.json``.

The run exits with a code other than 0 and prints no result when CUDA is
missing or the card count is below the cell's, and when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``deepsense6g_tii_tpu`` is loaded
at the end.  Caches (the kernels the program builds under ``build/``, the
pool of training samples under ``build/benchmark/``) stay inside the
checkout, at fixed paths.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "deepsense6g_tii_tpu"})


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is
    ``jax``, ``jaxlib``, ``flax`` or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", default=None,
                   help="also write the check's readings (each leaf's "
                   "norms, or each checked row's answers and reference "
                   "logits) to this JSON file, for setting its limits")
    return p.parse_args(argv)


class RunData:
    """What a per-layer metric's reader reads: the cell, the driver's
    counters and end-to-end values, and the trace."""

    def __init__(self, cell, result):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.counters = result["counters"]
        self.end_to_end = result["end_to_end"]
        self.trace = result["trace"]


def _smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None, device: str = "cuda", hooks=None, overrides=None) -> int:
    """``device``, ``hooks`` and ``overrides`` (``config`` and ``traffic``
    settings merged into the cell's) serve the benchmark's own tests."""
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", "benchmark", sub)
    from benchmark.core import spec
    from benchmark.core import trace as tr
    cell = spec.load_cell(args.workload)
    for key, extra in (overrides or {}).items():
        getattr(cell, key).update(extra)

    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"the cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    args.device = device
    args.seed = args.seed % 2 ** 63
    torch.set_num_threads(4)
    result = spec.driver(cell).drive(cell, args, T_START, hooks)

    e2e = dict(result["end_to_end"], setup_s=result["setup_s"])
    metrics = {}
    if not args.trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        run = RunData(cell, result)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    numbers = result["checks"]
    if not set(cell.limits) <= set(numbers):
        raise SystemExit(f"checks {sorted(numbers)} lack limits' "
                         f"{sorted(cell.limits)}")
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]}
              for k in sorted(cell.limits)}
    result["counters"]["not_compared"] = {
        k: v for k, v in numbers.items() if k not in cell.limits}
    correct = result["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    if args.readings:
        with open(args.readings, "w") as f:
            json.dump(result["readings"], f)

    bad = forbidden_modules()
    if bad:
        print(f"loaded at the end of the run: {', '.join(bad)}",
              file=sys.stderr)
        return 3

    on_card = device == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(result["memory_peak_bytes"])}
    out = {"correct": correct, "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        trace = result["trace"]
        dev["busy_s"] = tr.busy_us(trace.kernels) / 1e6
        dev["window_s"] = trace.window_us / 1e6
        out["breakdown"] = tr.breakdown(trace)
    out["checks"] = checks

    if on_card:
        print(f"card: {_smi('name,power.limit,clocks.max.sm')}",
              file=sys.stderr)
    print("end to end: " + json.dumps(e2e), file=sys.stderr)
    print("counters: " + json.dumps(result["counters"]), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
