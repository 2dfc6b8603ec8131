"""The harness's data and arithmetic, on the CPU: every cell and metric
loads by name, a cell whose metric lacks the metric it moves is refused,
the trace reductions, the FLOP and roofline counts, the reference against
itself, and no module of the benchmark imports JAX or the JAX package."""

import ast
import copy
import json
import math
import os

import pytest
import torch

from benchmark.core import spec, trace
from benchmark.reference import counts
from benchmark.reference import model as ref
from benchmark.tests.conftest import ROOT, SMALL

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["FFM"] in (0, 1)
    assert spec.driver(cell).drive
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_by_name(name):
    assert callable(spec.metric_reader(name).read)
    if name.endswith("_roofline.train") or name.endswith("_roofline.serve"):
        assert spec.name_list(name)


def test_refuses_a_metric_without_the_metric_it_moves():
    bench = copy.deepcopy(BENCH)
    bench["per_layer"].append({
        "name": "train_mfu2", "unit": "%", "better": "higher",
        "source": "host_clock", "layer": "x", "moves": "serve_p90_ms",
        "workloads": ["gpt-train-b32"]})
    with pytest.raises(SystemExit, match="does not report"):
        spec.load_cell("gpt-train-b32", benchmark=bench)


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def _trace(kernels, window, units, **extra):
    t = trace.Trace(kernels, [("host", window[0], window[1])], window, units)
    t.extra.update(extra)
    return t


def test_busy_is_the_union_of_kernel_intervals():
    k = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30)]
    assert trace.busy_us(k) == 25
    assert trace.idle_gaps(k, (0, 40)) == [(15, 20), (30, 40)]


class _Run:
    def __init__(self, cell, t, **counters):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.trace, self.counters, self.end_to_end = t, counters, {}


def test_kernels_per_step_idle_share_and_roofline():
    cell = spec.load_cell("gpt-train-b32")
    bound = counts.attention_bound_s(cell.config, 32, True)
    # two steps; attention kernels take 10x their bound
    us = 10 * bound * 1e6
    k = [("void flash_fwd_mma_kernel<true>(int)", 0, us),
         ("elementwise_kernel", us, us + 100),
         ("flash_bwd_mma_kernel", 2 * us, 3 * us)]
    t = _trace(k, (0, 4 * us), 2, batch=32)
    run = _Run(cell, t)
    read = lambda n: spec.metric_reader(n).read(run)  # noqa: E731
    assert read("kernels_per_step.train") == 1.5
    assert read("attn_roofline.train") == pytest.approx(10.0)
    busy = 2 * us + 100
    assert read("idle_share.train") == pytest.approx(
        100 * (1 - busy / (4 * us)))
    # a roofline whose kernels the trace lacks reads nothing
    t.extra["buckets"] = [8, 8]
    assert spec.metric_reader("scan_roofline.serve").read(run) is None


def test_mfu_and_counters():
    cell = spec.load_cell("gpt-train-b32")
    run = _Run(cell, None, train_flops=counts.PEAK_BF16, window_s=2.0,
               data_wait_share=0.25)
    assert spec.metric_reader("train_mfu").read(run) == pytest.approx(50.0)
    assert spec.metric_reader("data_wait_share.train").read(
        run) == pytest.approx(25.0)


def test_flop_count_matches_the_hand_count():
    gpt = spec.load_cell("gpt-train-b32").config
    fwd = counts.forward_flops_per_sample(gpt)
    # the hand count: backbones ~95, fusion linears ~64, attention ~28
    assert fwd == pytest.approx(187e9, rel=0.05)
    assert counts.train_flops_per_sample(gpt) == 3 * fwd
    mamba = _config("mambafuser")
    assert 150e9 < counts.forward_flops_per_sample(mamba) < 200e9


def test_scan_shapes_and_bounds():
    mamba = _config("mambafuser")
    shapes = counts.scan_shapes(mamba, 24)
    assert len(shapes) == 67
    assert counts.scan_bound_s(mamba, 24, True) > counts.scan_bound_s(
        mamba, 24, False) > 0


def _small_cfg(**kw):
    cfg = dict(spec.load_cell("gpt-train-b32").config, **SMALL)
    return {**cfg, **kw}


def test_linear_recurrence_gradients():
    torch.manual_seed(0)
    a = torch.rand(7, 2, 3, dtype=torch.float64, requires_grad=True)
    b = torch.randn(7, 2, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(ref.LinearRecurrence.apply, (a, b))


@pytest.mark.parametrize("ffm", [0, 1])
def test_reference_checkpointed_equals_plain(ffm):
    from benchmark.core import data, weights
    from benchmark.reference.train import run_steps
    cfg = _small_cfg(FFM=ffm, TFM=ffm)
    rows = [data.rows(cfg, 0, [2 * s, 2 * s + 1]) for s in range(2)]
    w = weights.make_weights(cfg, 5, "cpu")
    a = run_steps(cfg, w, rows, 9, 1e-4, "cpu")
    b = run_steps(cfg, w, rows, 9, 1e-4, "cpu", quant="fp8")
    assert a["losses"] != b["losses"]
    model = ref.BeamFuserReference(cfg, checkpointed=False)
    model.load_state_dict(w)
    model.train()
    x = {k: torch.as_tensor(v) for k, v in rows[0].items()}
    logits = model(x["image"], x["lidar"], x["radar"], x["gps"],
                   ref.DropoutDraws(9, 0, "cpu"))
    from benchmark.reference.train import focal_loss
    assert focal_loss(logits, x["beam"]).item() == pytest.approx(
        a["losses"][0], rel=1e-6)


def test_weights_load_into_the_program():
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser

    from benchmark.core import weights
    for ffm in (0, 1):
        cfg = _small_cfg(FFM=ffm, TFM=ffm)
        model = BeamFuser(spec.program_config(cfg), device="cpu")
        model.load_state_dict(weights.make_weights(cfg, 1, "cpu"),
                              strict=True)


FORBIDDEN = {"jax", "jaxlib", "flax", "deepsense6g_tii_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    here = os.path.join(ROOT, "benchmark")
    for dirpath, _, files in os.walk(here):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"
        if os.sep + "reference" + os.sep in path:
            assert "deepsense6g_tii_tpu_torch" not in set(_imports(path)), \
                f"{path}: the reference imports the program"


def test_the_run_names_forbidden_modules_by_top_level_name(monkeypatch):
    import sys

    from benchmark import run
    monkeypatch.setitem(sys.modules, "deepsense6g_tii_tpu_torch_x",
                        math)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "deepsense6g_tii_tpu.config", math)
    assert run.forbidden_modules() == ["deepsense6g_tii_tpu"]
