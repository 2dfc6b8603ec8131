"""The port's data-path tools (deepsense6g_tii_tpu_torch/tools/): the
convergence smoke and the DBA regression for a few steps at the small
geometry on the CPU, ``make_learnable_samples`` against the JAX tool's
arrays, bench_io and bench_engine at toy sizes, and every tool's entry
point defaulting to the card.  The timings they print on the CPU are the
host's; their device numbers are null there.
"""

import os

import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.tools import (bench_engine, bench_io,
                                             convergence_smoke,
                                             dba_regression)
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)
from tools import dba_regression as jdba

SMALL = dict(seq_len=2, input_resolution=32, vert_anchors=1, horz_anchors=1,
             n_layer=1, backbone_blocks=(1, 1, 1, 1), compute_dtype="float32",
             use_pallas_scan=False, use_flash_attention=False)


@pytest.mark.parametrize("arch", ["mamba", "gpt"])
def test_convergence_smoke_run(arch):
    fused = int(arch == "mamba")
    cfg = GlobalConfig(**SMALL, FFM=fused, TFM=fused)
    out = convergence_smoke.run(cfg, steps=4, batch=2, lr=1e-3,
                                device="cpu", verbose=False)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert out["first"] == out["losses"][0] and out["last"] < out["first"]
    assert out["halved"] == (out["last"] < 0.5 * out["first"])
    assert 0.0 <= out["top1"] <= 1.0


def test_convergence_smoke_config():
    assert convergence_smoke.config("mamba", "cpu").FFM == 1
    cfg = convergence_smoke.config("gpt", "cpu")
    assert (cfg.FFM, cfg.TFM, cfg.compute_dtype) == (0, 0, "float32")
    assert cfg.n_tokens == 962 and not cfg.use_flash_attention


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("res", [16, 32])
def test_make_learnable_samples_equal_jax(compact, res):
    kw = dict(seq_len=2, input_resolution=res)
    got = dba_regression.make_learnable_samples(GlobalConfig(**kw), 6,
                                                seed=4, compact=compact)
    want = jdba.make_learnable_samples(JaxConfig(**kw), 6, seed=4,
                                       compact=compact)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["image"].dtype == (np.uint8 if compact else np.float32)


@pytest.mark.parametrize("arch,radar_uint8", [("gpt", False),
                                              ("mamba", True)])
def test_dba_regression_run(arch, radar_uint8, tmp_path):
    out_file = str(tmp_path / "dba.json")
    out = dba_regression.run(n_train=8, n_val=8, batch_size=4, epochs=2,
                             res=32, arch=arch, verbose=False,
                             radar_uint8=radar_uint8, out=out_file,
                             device="cpu")
    assert len(out["val_curve"]) == 2
    for k in ("dba_ema", "dba_raw", "dba_floor"):
        assert 0.0 <= out[k] <= 1.0
    assert out["dba_ema"] == out["val_curve"][-1]
    assert (out["arch"], out["radar_uint8"], out["device"]) == (
        arch, radar_uint8, "cpu")
    assert os.path.isfile(out_file)


def test_dba_regression_config():
    small = dba_regression.config("mamba", False, 64, on_card=True)
    assert (small.n_layer, small.vert_anchors, small.input_resolution) == (
        2, 2, 64)
    assert small.use_pallas_scan and small.compute_dtype == "bfloat16"
    full = dba_regression.config("gpt", True, 64, on_card=True)
    assert full.n_tokens == 962 and full.use_flash_attention
    assert not dba_regression.config("gpt", False, 64,
                                     on_card=False).use_flash_attention


def test_bench_io_run(tmp_path):
    out = bench_io.run(str(tmp_path) + "/", samples=2, workers=2,
                       batch_size=2, device="cpu", points=500, verbose=False)
    for k in ("python_ply", "native_ply", "cached_dataset",
              "cached_batch_loader"):
        assert out[k]["samples"] == 2 and out[k]["samples_per_s"] > 0
    assert out["native_clouds"] == (10 if out["native"] else 0)
    assert out["h2d"] is None
    assert "DEEPSENSE_DISABLE_NATIVE" not in os.environ


@pytest.mark.parametrize("loader,radar", [("fast", "float16"),
                                          ("classic", "uint8")])
def test_bench_engine_run(tmp_path, loader, radar):
    cfg = GlobalConfig(**SMALL, FFM=1, TFM=1)
    out = bench_engine.run(cfg, B=2, N=4, epochs=1, loader_kind=loader,
                           radar_dtype=radar, cache_dir=str(tmp_path / "c"),
                           device="cpu")
    assert out["value"] > 0 and out["loader_only_sps"] > 0
    assert out["step_only_sps"] is None and out["h2d_ms"] is None
    compact = loader == "fast"
    assert out["h2d_dtypes"]["image"] == ("uint8" if compact else "float32")
    assert out["h2d_dtypes"]["radar"] == (radar if compact else "float32")
    assert len(out["data_wait_share"]) == 1


@pytest.mark.parametrize("tool,argv", [
    (convergence_smoke, []), (dba_regression, []), (bench_io, []),
    (bench_engine, None)])
def test_tools_default_to_cuda(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DEEPSENSE_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main() if argv is None else tool.main(argv)
