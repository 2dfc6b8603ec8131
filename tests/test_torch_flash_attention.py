"""The port's flash attention (deepsense6g_tii_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On a CPU tensor the port's wrapper runs its plain version, which is what
these tests hold against the Pallas kernel; the CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from deepsense6g_tii_tpu_torch.ops import _build
from deepsense6g_tii_tpu_torch.ops import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(seed, b=1, h=2, t=70, d=64):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=(b, h, t, d)) * 0.3).astype(np.float32)
                 for _ in range(3))


def _logsumexp(s):
    m = s.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]


class TestAgainstPallas:
    @pytest.mark.parametrize("d", [16, 64])
    @pytest.mark.parametrize("t", [70, 200, 386])
    def test_output_matches_jax_kernel(self, t, d):
        q, k, v = _qkv(t * 1000 + d, t=t, d=d)
        sm = d ** -0.5
        want = np.asarray(jax_flash_mha(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), sm_scale=sm,
                                        block=128, interpret=True))
        got = fa.flash_mha(*map(torch.from_numpy, (q, k, v)), sm_scale=sm)
        # the bound of tests/test_flash_attention.py:42-43 (f32, streaming
        # vs materialised softmax)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)

    @pytest.mark.parametrize("t", [70, 386])
    def test_lse_matches_numpy(self, t):
        q, k, v = _qkv(t, t=t, d=32)
        sm = 32 ** -0.5
        _, lse = fa.flash_mha_fwd(*map(torch.from_numpy, (q, k, v)),
                                  sm_scale=sm)
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                      k.astype(np.float64)) * sm
        assert lse.dtype == torch.float32 and lse.shape == (1, 2, t)
        np.testing.assert_allclose(lse.numpy(), _logsumexp(s),
                                   rtol=1e-6, atol=1e-5)

    def test_default_scale_is_rsqrt_d(self):
        q, k, v = (torch.from_numpy(x) for x in _qkv(3, t=40, d=16))
        np.testing.assert_array_equal(
            fa.flash_mha(q, k, v).numpy(),
            fa.flash_mha(q, k, v, sm_scale=0.25).numpy())

    def test_bf16_keeps_dtype(self):
        q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(4, t=33))
        o, lse = fa.flash_mha_fwd(q, k, v)
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32


class TestWrapper:
    def test_dropout_raises(self):
        # dropout needs the stream's seed, as the JAX package's needs an rng
        q, k, v = (torch.from_numpy(x) for x in _qkv(5, t=20))
        with pytest.raises(ValueError, match="dropout"):
            fa.flash_mha(q, k, v, dropout_p=0.1)

    def test_cpu_tensors_never_reach_the_kernel(self, monkeypatch):
        def no_build(name):
            raise AssertionError(f"kernel {name} loaded for a CPU tensor")

        monkeypatch.setattr(_build, "load", no_build)
        monkeypatch.setattr(fa, "_FNS", {})
        before = dict(_build.KERNEL_LAUNCHES)
        q, k, v = (torch.from_numpy(x) for x in _qkv(6, t=50))
        fa.flash_mha(q, k, v)
        assert _build.KERNEL_LAUNCHES == before

    @pytest.mark.parametrize("case", ["head_dim", "dtype", "shape",
                                      "strided"])
    def test_kernel_input_checks(self, case):
        q, k, v = (torch.from_numpy(x) for x in _qkv(7, t=24, d=32))
        if case == "head_dim":
            q, k, v = (x[..., :24].contiguous() for x in (q, k, v))
            err = ValueError
        elif case == "dtype":
            q, k, v = (x.half() for x in (q, k, v))
            err = TypeError
        elif case == "shape":
            k = k[:, :, :20].contiguous()
            err = ValueError
        else:
            q = q.transpose(2, 3).contiguous().transpose(2, 3)
            err = ValueError
        with pytest.raises(err):
            fa._check_kernel_inputs(q, k, v)

    def test_import_and_cpu_call_need_no_nvcc(self, tmp_path):
        code = (
            "import torch\n"
            "from deepsense6g_tii_tpu_torch.ops import _build, flash_attention as fa\n"
            "x = torch.zeros(1, 1, 8, 16)\n"
            "fa.flash_mha(x, x, x)\n"
            "assert not _build._LIBS and not _build.KERNEL_LAUNCHES\n")
        pythonpath = os.pathsep.join(
            x for x in (REPO, os.environ.get("PYTHONPATH")) if x)
        env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=pythonpath)
        subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       check=True, timeout=120)

    def test_library_key_covers_included_headers(self, monkeypatch,
                                                 tmp_path):
        (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
        (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
        (tmp_path / "b.cuh").write_text("// v1\n")
        (tmp_path / "c.cuh").write_text("// not included\n")
        monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
        assert [p.name for p in _build._sources("k")] == ["k.cu", "a.cuh",
                                                          "b.cuh"]
        before = _build.library_path("k")
        (tmp_path / "c.cuh").write_text("// edited\n")
        assert _build.library_path("k") == before
        (tmp_path / "b.cuh").write_text("// v2\n")
        assert _build.library_path("k") != before

    def test_build_passes_the_csrc_include_dir(self, monkeypatch, tmp_path):
        cmds = []

        class FakeNvcc:
            returncode = 0

            def __init__(self, cmd, **kw):
                cmds.append(cmd)
                open(cmd[cmd.index("-o") + 1], "w").close()

            def communicate(self):
                return ("",)

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
        monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
        _build.build([fa.KERNEL, fa.BWD_LIBRARY])
        assert len(cmds) == 2 and all(
            cmd[cmd.index("-I") + 1] == str(_build.CSRC_DIR) for cmd in cmds)
        assert _build.library_path(fa.BWD_LIBRARY).exists()

    def test_missing_nvcc_is_a_clear_error(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr(_build, "CUDA_NVCC", str(tmp_path / "nvcc"))
        with pytest.raises(RuntimeError, match="nvcc"):
            _build._nvcc()
