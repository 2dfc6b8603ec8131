"""The check of ``correct`` fails what it has to fail.

On the CPU, at a small size, each driver runs the whole of a run (the
look for a card skipped) with the timed path sound and then broken
underneath, and ``correct`` has to come out true and then false, for each
fault the cell can have: a training step that leaves its state unchanged,
a training step that takes half of the batch and the mean over it, a
served answer altered where it is produced.  (No cell spans several
chips, so none can drop an exchange between them.)

The controls, the reference on float8 operands in the program's place and
the same planted faults, have to fail the cell's limits too: at the small
size on the CPU here, and at the cell's own size on a card (``-m card``).
"""

import json
import os

import pytest
import torch

from benchmark import controls, run
from benchmark.core import spec
from benchmark.tests.conftest import ROOT, SMALL, SMALL_TRAFFIC

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = {w["name"]: spec.load_cell(w["name"]).traffic["driver"]
             for w in json.load(f)["workloads"]}
TRAIN = [c for c, d in CELLS.items() if d == "train"]
SERVE = [c for c, d in CELLS.items() if d == "serve"]


def _run(capsys, cell, hooks=None, seed=3000000007, traffic=None):
    driver = spec.load_cell(cell).traffic["driver"]
    t = dict(SMALL_TRAFFIC[driver], **(traffic or {}))
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "1", "--trace", "0"], device="cpu", hooks=hooks,
                  overrides={"config": SMALL, "traffic": t})
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _state_unchanged(engine):
    """The optimizer's step does nothing: the weights never move."""
    engine.state.optimizer.step = lambda *a, **k: None


def _half_batch(engine):
    """Each step trains on the first half of its rows alone."""
    step = engine.train_step

    def half(batch, lr):
        n = batch["image"].shape[0] // 2
        m = step({k: v[:n] for k, v in batch.items()}, lr)
        # the engine reads a rank row for every row of the batch
        return dict(m, ranks=torch.cat([m["ranks"], m["ranks"]]))

    engine.train_step = half


def _altered(pred):
    """Every served top beam moves to the next beam index."""
    predict = pred.predict

    def altered(*x):
        idx, conf = predict(*x)
        return idx % pred.config.num_beams + 1, conf

    pred.predict = altered


@pytest.mark.parametrize("cell", TRAIN)
def test_train_check(cell, capsys, small_root):
    assert _run(capsys, cell)["correct"] is True
    for fault in (_state_unchanged, _half_batch):
        out = _run(capsys, cell, hooks={"wrap_engine": fault})
        assert out["correct"] is False, fault.__name__


@pytest.mark.parametrize("cell", SERVE)
def test_serve_check(cell, capsys):
    assert _run(capsys, cell)["correct"] is True
    out = _run(capsys, cell, hooks={"wrap_predictor": _altered})
    assert out["correct"] is False


def _failed(limits, numbers):
    return any(numbers[k] > v for k, v in limits.items())


def _small_cell(name):
    cell = spec.load_cell(name)
    cell.config.update(SMALL)
    cell.traffic.update(SMALL_TRAFFIC[cell.traffic["driver"]])
    return cell


@pytest.mark.parametrize("name", TRAIN + SERVE[:1])
def test_controls_fail_the_limits(name):
    cell = _small_cell(name)
    if cell.traffic["driver"] == "train":
        out = controls.train_readings(cell, 11, torch.device("cpu"))
        assert _failed(cell.limits, out["half_batch"])
    else:
        out = controls.serve_readings(cell, 11, torch.device("cpu"))
        assert _failed(cell.limits, out["altered"])
    assert _failed(cell.limits, out["control"])


@pytest.mark.card
@pytest.mark.parametrize("name", TRAIN + SERVE[:1])
def test_controls_fail_the_limits_at_full_size(name, card):
    cell = spec.load_cell(name)
    read = (controls.train_readings if cell.traffic["driver"] == "train"
            else controls.serve_readings)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (1, 2, 3):
        out = read(cell, seed, card)
        assert _failed(cell.limits, out["control"])
