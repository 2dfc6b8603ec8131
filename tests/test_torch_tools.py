"""The port's data-path and measuring tools (deepsense6g_tii_tpu_torch/
tools/): the convergence smoke and the DBA regression for a few steps at
the small geometry on the CPU, ``make_learnable_samples`` against the JAX
tool's arrays, bench_io, bench_engine, bench_serve and profile_step at toy
sizes, bench_matrix on tiny child commands, and every tool's entry point
defaulting to the card.  The timings they print on the CPU are the host's;
their device numbers are null there.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.tools import (bench_engine, bench_io,
                                             bench_matrix, bench_serve,
                                             convergence_smoke,
                                             dba_regression, profile_step,
                                             trace)
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
    (bench_engine, None), (bench_serve, []), (profile_step, [])])
def test_tools_default_to_cuda(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DEEPSENSE_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main() if argv is None else tool.main(argv)


# -- bench_serve --------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gpt", "mamba"])
def test_bench_serve_run(arch):
    fused = int(arch == "mamba")
    cfg = GlobalConfig(**SMALL, crop=SMALL["input_resolution"], FFM=fused,
                       TFM=fused)
    out = bench_serve.run(cfg, [2, 1], iters=2, device="cpu")
    assert (out["arch"], out["device"]) == (arch, "cpu")
    for b in (1, 2):
        r = out[f"b{b}"]
        assert 0 < r["p50_ms"] <= r["p90_ms"] and r["batch"] == b
        assert r["samples_per_sec"] == pytest.approx(b / r["p50_ms"] * 1e3)
    assert out["pipelined"]["batch"] == 2 and out["pipelined"]["calls"] == 40
    assert out["pipelined"]["samples_per_sec"] > 0
    json.dumps(out)


def test_bench_serve_exported_raises():
    with pytest.raises(NotImplementedError, match="item 8"):
        bench_serve.main(["--exported", "--device", "cpu"])


# -- profile_step -------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gpt", "mamba"])
def test_profile_step_run(arch):
    cfg, B, K, GA = profile_step.step_config(
        {"DEEPSENSE_BENCH_ARCH": arch}, on_card=False)
    assert (B, K, GA) == (1, 1, 1) and cfg.compute_dtype == "float32"
    out = profile_step.run(cfg.replace(**SMALL), B=2, dispatches=2,
                           device="cpu")
    assert out["time"] == "host" and out["steps"] == 2
    cats = {c["category"] for c in out["categories"]}
    assert {"convolution", "optimizer", "GEMM"} <= cats
    assert out["top"] and out["total_ms_per_step"] > 0
    sites = out["conv_sites"]
    assert "image_encoder/stem fwd" in sites
    assert "image_encoder/stage1 bwd" in sites and "unattributed ?" not in \
        sites
    assert any(s.startswith("fusion") for s in sites) == (arch == "mamba")
    assert out["launches_per_step"] == {}           # plain paths on the CPU


def test_profile_step_main_prints_json_last(monkeypatch, capsys):
    real = profile_step.step_config

    def small(env, on_card):
        cfg, _, K, GA = real(env, on_card)
        return cfg.replace(**SMALL), 1, K, GA

    monkeypatch.setattr(profile_step, "step_config", small)
    monkeypatch.setenv("DEEPSENSE_BENCH_ARCH", "gpt")
    assert profile_step.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "host (CPU self time)" in lines[0]
    out = json.loads(lines[-1])
    assert (out["arch"], out["B"], out["card"]) == ("gpt", 1, None)
    assert out["categories"] and out["conv_sites"]


@pytest.mark.parametrize("knob,value", [
    ("MERGE_LR", "1"), ("MERGE_LR_S1", "1"), ("PADDED", "1"),
    ("MU_DTYPE", "bfloat16"), ("FLASH_DROPOUT", "hw")])
def test_profile_step_refuses_tpu_knobs(knob, value):
    with pytest.raises(NotImplementedError, match="PyTorch port"):
        profile_step.step_config({f"DEEPSENSE_BENCH_{knob}": value}, True)


def test_profile_step_config_from_knobs():
    env = {"DEEPSENSE_BENCH_ARCH": "mamba", "DEEPSENSE_BENCH_B": "4",
           "DEEPSENSE_BENCH_K": "2", "DEEPSENSE_BENCH_GRAD_ACCUM": "2",
           "DEEPSENSE_BENCH_REVERSE_SCAN": "1",
           "DEEPSENSE_BENCH_REMAT": "fusion", "DEEPSENSE_BENCH_MERGE_LR": "0"}
    cfg, B, K, GA = profile_step.step_config(env, on_card=True)
    assert (B, K, GA) == (4, 2, 2)
    assert (cfg.FFM, cfg.TFM, cfg.reverse_scan_kernel, cfg.use_pallas_scan,
            cfg.compute_dtype) == (1, 1, True, True, "bfloat16")
    gpt, B, _, _ = profile_step.step_config(
        {"DEEPSENSE_BENCH_FLASH_DROPOUT": "hash"}, on_card=True)
    assert (gpt.FFM, gpt.use_flash_attention, B) == (0, True, 8)
    assert gpt.flash_dropout_impl == "hash" and gpt.n_tokens == 962
    assert not profile_step.step_config({"DEEPSENSE_BENCH_FLASH": "0"},
                                        True)[0].use_flash_attention


@pytest.mark.parametrize("name,want", [
    ("void flash_fwd_mma_kernel<64>(__nv_bfloat16 const*)",
     "port: flash_attention_fwd"),
    ("void flash_bwd_mma_kernel<32>(BwdArgs)",
     "port: flash_attention_bwd_merged"),
    ("void flash_bwd_dkv_kernel<16, true>(BwdArgs)",
     "port: flash_attention_bwd_merged"),
    ("void flash_bwd_dkv_kernel<16, false>(BwdArgs)",
     "port: flash_attention_bwd_dkv"),
    ("void scan_fwd_kernel<__nv_bfloat16, false, 2>(__nv_bfloat16 const*)",
     "port: selective_scan_fwd"),
    ("void scan_fwd_kernel<float, true, 0>(float const*)",
     "port: selective_scan_fwd_rev"),
    ("void scan_bwd_local_kernel<__nv_bfloat16, true>(float const*)",
     "port: selective_scan_bwd_rev"),
    ("void scan_bwd_kernel<float, false>(float const*)",
     "port: selective_scan_bwd"),
    ("void scan_seq_kernel<__nv_bfloat16, 16, 1, 128>(float const*)",
     "port: selective_scan_seq"),
    ("void flash_bwd_dq_mma_kernel<64>(BwdArgs)",
     "port: flash_attention_bwd_dq"),
    ("void flash_bwd_dkv_mma_kernel<128>(BwdArgs)",
     "port: flash_attention_bwd_dkv"),
    ("void chain_kernel<16, true>(float4 const*)",
     "port: scan_roofline_chain"),
    ("scan_carry_kernel(float const*, float const*)",
     "port: selective_scan_fwd + selective_scan_bwd"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "convolution"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>(float*)",
     "elementwise and reduction"),
    ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopB_NNT", "GEMM"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>", "GEMM"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BinaryFunctor<float>>(int)", "elementwise and reduction"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
     "TensorListMetadata<4>>(int)", "optimizer"),
    ("Memcpy HtoD (Pinned -> Device)", "memcpy/memset"),
    ("aten::mkldnn_convolution", "convolution"),
    ("aten::addmm", "GEMM"),
    ("cudaLaunchKernel", "other")])
def test_profile_step_categories(name, want):
    launched = {"selective_scan_fwd": 67, "selective_scan_bwd": 67}
    assert profile_step.category(name, launched) == want


CSRC = os.path.join(os.path.dirname(profile_step.__file__), os.pardir,
                    "csrc")
GLOBAL = re.compile(r"(?:template\s*<([^<>]*)>\s*)?__global__\s+void\s+"
                    r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                    r"(\w+)\s*\(")


def _device_kernels():
    """Every __global__ function of the port's CUDA sources -> its template
    parameters."""
    found = {}
    for f in sorted(os.listdir(CSRC)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, f)) as fh:
                for params, name in GLOBAL.findall(fh.read()):
                    found[name] = [p.strip() for p in params.split(",")
                                   if p.strip()]
    return found


def test_profile_step_maps_every_device_kernel():
    """The wrappers' DEVICE_KERNELS tables name exactly the sources' kernels,
    so that a renamed kernel cannot fall silently into 'other'."""
    assert set(_device_kernels()) == set(profile_step.PORT_KERNELS)
    wrappers = {v for k, v in vars(profile_step.fa).items()
                if k.startswith("KERNEL")} | {
        v for k, v in vars(profile_step.ss).items()
        if k.startswith("KERNEL")} | {profile_step.scan_roofline.KERNEL_CHAIN}
    for name, names in profile_step.PORT_KERNELS.items():
        assert names and set(names) <= wrappers, name


@pytest.mark.parametrize("name", sorted(profile_step.KERNEL_FLAGS))
def test_kernel_flag_is_the_sources_template_parameter(name):
    """A flag's position names that bool parameter in the kernel's template,
    so that reordered template arguments cannot swap two wrappers."""
    pos, flag = profile_step.KERNEL_FLAGS[name]
    assert _device_kernels()[name][pos] == f"bool {flag}"
    assert len(profile_step.PORT_KERNELS[name]) == 2


class _Event:
    def __init__(self, name, start, end, device="CUDA", annotation=False):
        self.name = name
        self.time_range = type("T", (), {"start": start, "end": end})()
        self.device_type = getattr(torch.autograd.DeviceType, device)
        self.is_user_annotation = annotation


def test_trace_kernels_leave_out_annotations():
    """The optimizer's record_function range shows on the device's timeline
    as a user annotation spanning its kernels: it is no kernel."""
    events = [_Event("Optimizer.step#AdamW.step", 0, 30, annotation=True),
              _Event("multi_tensor_apply_kernel", 2, 5),
              _Event("aten::add", 0, 1, device="CPU")]
    assert [e.name for e in trace.kernel_events(events)] == [
        "multi_tensor_apply_kernel"]


def test_trace_counts_dropped_events_and_busy_time():
    ks = [_Event("a", 0, 10), _Event("a", 5, 20), _Event("b", 30, 40),
          _Event("a", 50, 55), _Event("b", 60, 61)]
    assert trace.dropped_events(ks, 2) == 1       # a: 3 of 4
    assert trace.dropped_events(ks, 1) == 0
    assert trace.busy_us(ks) == 20 + 10 + 5 + 1
    assert trace.short_name("void ns::k<1>(int)") == "k"


# -- bench_matrix -------------------------------------------------------------

def child(code, timeout=60):
    return ({}, ["-c", code], timeout)


@pytest.fixture
def items(monkeypatch):
    table = {
        "ok": child("print('{progress'); print('{\"v\": 1}')"),
        "not_json": child("print('{oops')"),
        "fails": child("import sys; print('{\"v\": 2}'); "
                       "sys.exit('boom')"),
        "slow": child("import time; time.sleep(30)", timeout=1),
    }
    monkeypatch.setattr(bench_matrix, "ITEMS", table)
    return table


def test_bench_matrix_records_each_outcome(items, tmp_path):
    out = tmp_path / "m.json"
    assert bench_matrix.main(["--out", str(out)]) == 0
    got = json.loads(out.read_text())["items"]
    assert got["ok"]["v"] == 1 and got["ok"]["wall_s"] >= 0
    assert got["not_json"]["error"].startswith("last brace-prefixed")
    assert got["not_json"]["line"] == "{oops"
    assert got["fails"]["error"] == "rc=1"
    assert got["fails"]["stderr_tail"] == ["boom"]
    assert got["slow"] == {"error": "timeout after 1s"}


def test_bench_matrix_partial_rerun_keeps_old_entries(items, tmp_path):
    out = tmp_path / "m.json"
    out.write_text(json.dumps({"items": {"old": {"v": 0}, "ok": {"v": -1}}}))
    assert bench_matrix.main(["--only", "ok", "--out", str(out)]) == 0
    got = json.loads(out.read_text())["items"]
    assert got["old"] == {"v": 0} and got["ok"]["v"] == 1
    assert sorted(got) == ["ok", "old"]
    with pytest.raises(SystemExit, match="unknown"):
        bench_matrix.main(["--only", "nope", "--out", str(out)])


def test_bench_matrix_items_run_the_port_tools():
    assert sorted(bench_matrix.ITEMS) == sorted([
        "gpt_serve", "mamba_serve", "engine_e2e_gpt", "engine_e2e_mamba",
        "convergence_gpt", "profile_gpt", "profile_mamba"])
    for env, args, timeout in bench_matrix.ITEMS.values():
        assert args[0] == "-m" and args[1].startswith(
            "deepsense6g_tii_tpu_torch.tools.") and timeout > 0
        __import__(args[1])
    assert sys.modules[bench_matrix.__name__] is bench_matrix
