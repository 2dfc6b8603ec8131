"""The port's zero-data quickstart (deepsense6g_tii_tpu_torch/examples/
quickstart.py) on the CPU: one epoch and the test split at the debug
geometry write every artifact, and the working directory is left as it was
found; without CUDA its default device raises.  tests/test_examples.py
runs the JAX package's quickstart.
"""

import csv
import os

import pytest
import torch

from deepsense6g_tii_tpu_torch.examples import quickstart
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)


def test_quickstart_on_cpu(tmp_path):
    cwd = os.getcwd()
    work = tmp_path / "qs"
    assert quickstart.main(["--device", "cpu", "--epochs", "1",
                            "--workdir", str(work)]) == 0
    assert os.getcwd() == cwd
    logdir = work / "log" / "quickstart"
    for name in quickstart.ARTIFACTS:
        assert (logdir / name).is_file(), name
    with open(work / "beam_pred.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["index", "top-1 beam", "top-2 beam", "top-3 beam"]
    assert len(rows) == 1 + 2 * 2          # 2 test samples, 2 scenarios
    assert all(1 <= int(b) <= 64 for r in rows[1:] for b in r[1:])
    assert (work / "beam_pred_confidence_seq.csv").is_file()
    assert not (logdir / "final_model.msgpack").exists()


def test_quickstart_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["--workdir", str(tmp_path / "qs")])
    assert not (tmp_path / "qs").exists()
