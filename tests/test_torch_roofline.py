"""The port's kernel tools (deepsense6g_tii_tpu_torch/tools/): the roofline
calibration chain's plain version against the JAX tool's Pallas chain
kernel in interpret mode, the rate arithmetic of ``calibrate``, the chain
wrapper's checks, and the device rules of the tools' entry points, on the
CPU.  The chain's CUDA kernel (csrc/scan_roofline_chain.cu) is held against
the plain version on the card by chip_smoke.py.
"""

import functools
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deepsense6g_tii_tpu_torch.ops import _build
from deepsense6g_tii_tpu_torch.tools import (bench_flash, bench_scan,
                                             scan_roofline, timing)
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

SHAPE, BLK = (64, 8, 128), 32


@pytest.fixture(scope="module")
def jax_chain_kernel():
    """tools/scan_roofline.py::_chain_kernel of the JAX package; importing
    that tool sets a compilation-cache variable, which is taken back."""
    had = "JAX_COMPILATION_CACHE_DIR" in os.environ
    from tools import scan_roofline as jax_roofline
    if not had:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    return jax_roofline._chain_kernel


def _pallas_chain(kernel, x, k, use_exp):
    """The JAX tool's chain as its calibrate() launches it, gridded over
    the leading axis in (BLK, 8, 128) blocks, in interpret mode."""
    call = pl.pallas_call(
        functools.partial(kernel, k, use_exp), grid=(x.shape[0] // BLK,),
        in_specs=[pl.BlockSpec((BLK,) + x.shape[1:], lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((BLK,) + x.shape[1:], lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)
    return np.asarray(call(jnp.asarray(x)))


def _x(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.25, 2.0, SHAPE).astype(np.float32)


class TestChainAgainstPallas:
    @pytest.mark.parametrize("k", [8, 72])
    def test_mul_chain_matches(self, jax_chain_kernel, k):
        """k multiplies by 1.0000001.  The plain chain rounds after every
        multiply, as the CUDA kernel's __fmul_rn does, and equals a numpy
        f32 loop element for element.  In interpret mode XLA folds the
        kernel's k constant multiplies into one, rounded once; the two
        differ by at most k/2 + 1/2 ulps: held to k ulps."""
        x = _x(k)
        want = _pallas_chain(jax_chain_kernel, x, k, False)
        got = scan_roofline.chain_reference(torch.from_numpy(x), k, False)
        assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
        np.testing.assert_allclose(got.numpy(), want, rtol=k * 2.0 ** -23,
                                   atol=0)
        ieee = x
        for _ in range(k):
            ieee = ieee * np.float32(1.0000001)
        np.testing.assert_array_equal(got.numpy(), ieee)

    @pytest.mark.parametrize("k", [4, 20])
    def test_exp_chain_matches(self, jax_chain_kernel, k):
        """k steps of x = exp(x * -0.41421): each exp rounds within an ulp
        or two on either side, and the map contracts (|slope| < 0.42)."""
        x = _x(100 + k)
        want = _pallas_chain(jax_chain_kernel, x, k, True)
        got = scan_roofline.chain_reference(torch.from_numpy(x), k, True)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)

    def test_cpu_chain_is_the_plain_version(self, monkeypatch):
        monkeypatch.setattr(_build, "load", None)      # never built
        x = torch.from_numpy(_x(5))
        for use_exp in (False, True):
            torch.testing.assert_close(
                scan_roofline.chain(x, 3, use_exp),
                scan_roofline.chain_reference(x, 3, use_exp), rtol=0, atol=0)


class TestChainWrapper:
    def test_lengths_come_from_the_kernel_source(self):
        """The wrapper's chain lengths are the literals of the .cu file, and
        each is an instantiation of its entry point."""
        src = (_build.CSRC_DIR / "scan_roofline_chain.cu").read_text()
        for name, k in zip(("MUL_K_LO", "MUL_K_HI", "EXP_K_LO", "EXP_K_HI"),
                           scan_roofline.MUL_K + scan_roofline.EXP_K):
            assert re.search(rf"constexpr int {name} = {k};", src), name
            assert re.search(rf"launch<{name}, (true|false)>", src), name
        # both ends of each chain at least ~3x its bytes on an H100: k FMULs
        # at 33.5e12 a second, k exps at 4.2e12, against 8 bytes at 3.35e12
        assert min(scan_roofline.MUL_K) * 3.35e12 / 8 / 33.5e12 > 2
        assert min(scan_roofline.EXP_K) * 3.35e12 / 8 / 4.2e12 > 2

    @pytest.mark.parametrize("case", ["device", "k", "dtype", "size"])
    def test_kernel_input_checks(self, case):
        """Off the CPU the chain launches its kernel or raises: a meta
        tensor stands in for a CUDA one and is refused before any launch."""
        x, k, use_exp = torch.empty(SHAPE, device="meta"), 256, False
        match = "cuda or cpu"
        if case == "k":
            k, match = 72, "holds k"
        elif case == "dtype":
            x, match = x.double(), "float32"
        elif case == "size":
            x, match = torch.empty(6, device="meta"), "4n elements"
        with pytest.raises(ValueError, match=match):
            scan_roofline.chain(x, k, use_exp)


class TestChainBound:
    """The chain's bound, counted by hand over the tool's (4096, 8, 1024)
    array: an FMUL issues once a lane and clock (33.5e12 a second on an
    H100, half the data sheet's FMA-counting 67 TFLOP/s), an exponential on
    the special-function units (4.22e12 a second), the two pipes side by
    side, and 8 bytes an element at 3.35e12 bytes a second as the floor."""
    N_EL, FMUL, SFU = 4096 * 8 * 1024, 33.5e12, 4.22e12

    @pytest.mark.parametrize("k, use_exp, want, by", [
        (1024, False, 1.0257, "operations"),   # 1024 FMULs: ~1.03 ms
        (128, True, 1.0178, "operations"),     # 128 exps: ~1.02 ms
        (8, False, 0.080130, "bytes"),         # 8 FMULs: the bytes' time
        (1, True, 0.080130, "bytes")])
    def test_hand_count(self, k, use_exp, want, by):
        got = scan_roofline.chain_bound_ms(k, use_exp, self.N_EL, self.FMUL,
                                           self.SFU)
        assert got["bound_ms"] == pytest.approx(want, rel=1e-4)
        assert got["bound_by"] == by
        assert got["bytes_ms"] == pytest.approx(0.080130, rel=1e-4)
        assert (got["exp_ms"] is None) == (not use_exp)

    def test_exp_chain_overlaps_its_pipes(self):
        """The exp chain's k FMULs run beside its k exponentials: the bound
        is the larger of the two, not their sum."""
        got = scan_roofline.chain_bound_ms(128, True, self.N_EL, self.FMUL,
                                           self.SFU)
        assert got["fmul_ms"] == pytest.approx(0.12822, rel=1e-4)
        assert got["ops_ms"] == got["exp_ms"] == got["bound_ms"]

    def test_four_chains_of_the_tool(self):
        """The four chains the tool launches (1,280 FMULs and 160
        exponentials an element in all) take at least ~2.55 ms, three
        times the 0.849 ms that pricing every step at the data sheet's f32
        rate gave."""
        total = sum(scan_roofline.chain_bound_ms(
            k, use_exp, self.N_EL, self.FMUL, self.SFU)["bound_ms"]
            for use_exp, ks in ((False, scan_roofline.MUL_K),
                                (True, scan_roofline.EXP_K)) for k in ks)
        assert sum(scan_roofline.MUL_K) == 1280
        assert sum(scan_roofline.EXP_K) == 160
        assert total == pytest.approx(1.2822 + 1.2722, rel=1e-3)


class TestCalibrate:
    def test_rate_arithmetic_on_stubbed_timings(self, monkeypatch):
        """rate = (k_hi - k_lo) * elements / (t_hi - t_lo), the times and
        the bytes' time passed on."""
        times = [0.5, 2.1]

        def stub(fn, device, iters):
            assert device == "cpu" and fn().shape == (4, 8, 16)
            return times.pop(0)

        monkeypatch.setattr(timing, "time_ms", stub)
        got = scan_roofline.calibrate((4, 8, 16), 8, 72, use_exp=False,
                                      device="cpu")
        assert got["ms_lo"] == 0.5 and got["ms_hi"] == 2.1
        assert got["rate"] == pytest.approx(64 * 512 / 1.6e-3)
        assert got["bytes_ms"] == pytest.approx(1e3 * 8 * 512 / 3.35e12)

    def test_runs_on_the_cpu_when_asked(self):
        got = scan_roofline.calibrate((4, 8, 16), 2, 6, use_exp=True,
                                      device="cpu", iters=2)
        assert got["rate"] > 0 and got["ms_hi"] > 0

    def test_roofline_line_on_the_cpu(self, monkeypatch):
        """The tool's line at a tiny geometry on the CPU (plain versions),
        with stubbed times: JAX's keys, the sequential forward beside them,
        and the backward as (forward + backward) - forward."""
        monkeypatch.setattr(scan_roofline, "CHAIN_SHAPE", (4, 8, 16))
        for name, v in (("B_", 2), ("L_", 70), ("D_", 8)):
            monkeypatch.setattr(scan_roofline, name, v)
        times = iter([1.0, 4.0, 2.0, 6.0, 0.5, 0.75, 2.5])

        def stub(fn, device, iters=20):
            assert device == "cpu"
            fn()
            return next(times)

        monkeypatch.setattr(timing, "time_ms", stub)
        out = scan_roofline.roofline(0, device="cpu")
        assert set(out) == {"geometry", "calibration", "fwd", "bwd",
                            "fwd_sequential"}
        cal = out["calibration"]
        assert cal["mul_Tops"] == pytest.approx(768 * 512 / 3e-3 / 1e12)
        assert cal["exp_Texp"] == pytest.approx(96 * 512 / 4e-3 / 1e12)
        assert cal["exp_cost_muls"] == pytest.approx(
            cal["mul_Tops"] / cal["exp_Texp"])
        assert [out[k]["ms"] for k in ("fwd", "fwd_sequential", "bwd")] == [
            0.5, 0.75, 2.0]
        assert out["geometry"]["elements"] == 2 * 70 * 16 * 8

    def test_implied_operations(self):
        row = scan_roofline._row(2.0, 3e13, 5.0, 3.0, 1e9)
        assert row["implied_ops_per_element"] == pytest.approx(60.0)
        assert row["analytic_ops_per_element"] == 8.0
        assert row["overhead_x"] == pytest.approx(7.5)
        assert row["overlap_floor_x"] == pytest.approx(5 / 8)


@pytest.mark.parametrize("tool", [scan_roofline, bench_scan, bench_flash])
def test_tool_mains_need_cuda(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tool.main([])


def test_tools_default_to_cuda():
    for fn in (scan_roofline.calibrate, scan_roofline.scan_inputs,
               bench_scan.bench, bench_scan.inputs, bench_flash.bench,
               bench_flash.inputs, timing.time_ms):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_bench_flash_loads_another_checkout(tmp_path):
    """--root PATH: another checkout's flash module, imported under a name
    of its own beside this one, building under its own root."""
    import shutil
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(os.path.join(repo, "deepsense6g_tii_tpu_torch"),
                    tmp_path / "deepsense6g_tii_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(repo, "pyproject.toml"), tmp_path)
    assert bench_flash.load_flash() is fa
    assert bench_flash.load_flash(repo) is fa
    other = bench_flash.load_flash(str(tmp_path))
    assert other is not fa and other is bench_flash.load_flash(str(tmp_path))
    assert other._build.CSRC_DIR == (tmp_path / "deepsense6g_tii_tpu_torch"
                                     / "csrc")
    assert other._build.BUILD_DIR == tmp_path / "build" / "kernels"
    assert other._build.KERNEL_LAUNCHES is not _build.KERNEL_LAUNCHES
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, 40, 16)).astype(np.float32))
    for a, b in zip(other.flash_mha_fwd(x, x, x), fa.flash_mha_fwd(x, x, x)):
        assert torch.equal(a, b)


def test_bench_flash_weights_a_gpt_step(monkeypatch):
    """per_step sums each kernel's launch time over 8 launches at each head
    dim, as a GPT TransFuser training step launches them."""
    monkeypatch.setattr(
        bench_flash, "launch_ms", lambda d, p, device, flash: dict(
            fwd_ms=d * (1 + p), bwd_ms=2.0 * d, split_bwd_ms=3.0 * d,
            dq_ms=1.0 * d, dkv_ms=1.5 * d))
    out = bench_flash.per_step(device="cpu")
    assert set(out) == {"p=0.0", "p=0.1"}
    assert set(out["p=0.1"]) == {*bench_flash.MEASURES, "launch_ms"}
    assert out["p=0.0"]["fwd_ms"] == 8 * (16 + 32 + 64 + 128)
    assert out["p=0.1"]["fwd_ms"] == pytest.approx(8 * 240 * 1.1)
    assert out["p=0.1"]["bwd_ms"] == 8 * 2 * 240
    assert out["p=0.1"]["split_bwd_ms"] == 8 * 3 * 240
    assert out["p=0.0"]["dq_ms"] + out["p=0.0"]["dkv_ms"] == 8 * 2.5 * 240
