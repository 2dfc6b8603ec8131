"""Shared set-up of the benchmark's own tests: the checkout's root on the
path, the ``card`` marker, and the small geometry the CPU runs take.

    python -m pytest benchmark/tests -q            # on the CPU
    python -m pytest benchmark/tests -q -m card    # on a machine with CUDA
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the models at a size a CPU test run holds, in float32
SMALL = dict(seq_len=2, input_resolution=64, crop=64, vert_anchors=2,
             horz_anchors=2, n_layer=1, backbone_blocks=[1, 1, 1, 1],
             compute_dtype="float32")
SMALL_TRAFFIC = {
    "train": dict(batch=4, pool=12, trace_steps=1, warmup_steps=0),
    "serve": dict(buckets=[2, 4], sizes_to=4, pool_rows=6, check_rows=8,
                  trace_requests=2, warmup_per_bucket=1, calib_rows=3),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips elsewhere (the card "
        "fixture decides)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present, decided at run time."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    """The training pool's cache under a temporary root."""
    import benchmark.drivers.train as train_driver
    monkeypatch.setattr(train_driver, "ROOT", str(tmp_path))
    return tmp_path
