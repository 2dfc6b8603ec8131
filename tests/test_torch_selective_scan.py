"""The port's selective scan (deepsense6g_tii_tpu_torch/ops/selective_scan.py)
against the JAX package's associative-scan reference and its Pallas kernel
in interpret mode, on the CPU.

On a CPU tensor the port's wrapper runs its plain version (a doubling scan),
which is what these tests hold against JAX; the CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py.  Tolerance:
rtol/atol 1e-4, the bound of tests/test_ops.py:45-46 (the two sides sum the
recurrence in other orders).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.ops import selective_scan as jax_ss
from deepsense6g_tii_tpu_torch.ops import _build
from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b=2, L=300, d=128, n=16, groups=None):
    """Scan inputs as numpy f32, shaped like tests/test_ops.py:18-24."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, L, d)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, L, d))) * 0.1).astype(np.float32)
    a_shape = (d, n) if groups is None else (groups, d, n)
    A = -np.abs(rng.normal(size=a_shape)).astype(np.float32)
    B = rng.normal(size=(b, L, n)).astype(np.float32)
    C = rng.normal(size=(b, L, n)).astype(np.float32)
    return u, dt, A, B, C


def _bf16(x):
    """x rounded to bfloat16, as f32 numpy (exact in both frameworks)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _port(u, dt, A, B, C, reverse=False, dtype=torch.float32):
    t = lambda x, dt_=torch.float32: torch.from_numpy(x).to(dt_)  # noqa: E731
    return ss.selective_scan_fwd(t(u, dtype), t(dt), t(A), t(B, dtype),
                                 t(C, dtype), reverse=reverse)


def _naive(u, dt, A, B, C, reverse=False):
    """Step-by-step numpy loop in f64: y (b, L, d), h_out (b, n, d)."""
    b, L, d = u.shape
    y = np.zeros((b, L, d))
    h_out = np.zeros((b, A.shape[-1], d))
    for i in range(b):
        h = np.zeros(A.shape)
        for t in (range(L - 1, -1, -1) if reverse else range(L)):
            h = (np.exp(dt[i, t][:, None] * A) * h
                 + (dt[i, t] * u[i, t])[:, None] * B[i, t][None])
            y[i, t] = h @ C[i, t]
        h_out[i] = h.T
    return y, h_out


class TestAgainstJaxReference:
    @pytest.mark.parametrize("reverse", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_selective_scan_ref(self, reverse, dtype):
        u, dt, A, B, C = _inputs(1 + reverse)
        if dtype == "bfloat16":
            u, B, C = _bf16(u), _bf16(B), _bf16(C)
        jdt = getattr(jnp, dtype)
        want = jax_ss.selective_scan_ref(
            jnp.asarray(u, jdt), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, jdt), jnp.asarray(C, jdt), reverse=reverse)
        y, _ = _port(u, dt, A, B, C, reverse, getattr(torch, dtype))
        assert y.dtype == torch.float32 and y.shape == (2, 300, 128)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("reverse", [False, True])
    def test_matches_naive_loop_with_final_state(self, reverse):
        u, dt, A, B, C = _inputs(3, b=2, L=20, d=4, n=3)
        want_y, want_h = _naive(u, dt, A, B, C, reverse)
        y, h_out = ss.selective_scan_reference(
            *map(torch.from_numpy, (u, dt, A, B, C)), reverse=reverse)
        assert h_out.shape == (2, 3, 4)
        np.testing.assert_allclose(y.numpy(), want_y, rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(h_out.numpy(), want_h, rtol=2e-5,
                                   atol=1e-5)


class TestAgainstPallasInterpret:
    @pytest.mark.parametrize("reverse", [False, True])
    def test_matches_kernel(self, reverse):
        u, dt, A, B, C = _inputs(4)                       # ragged L = 300
        args = tuple(map(jnp.asarray, (u, dt, A, B, C)))
        want = (jax_ss.selective_scan(*args, reverse=reverse, interpret=True)
                if reverse else jax_ss.selective_scan(*args, True))
        y, _ = _port(u, dt, A, B, C, reverse)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("reverse", [False, True])
    def test_grouped_A_matches_kernel(self, reverse):
        u, dt, A, B, C = _inputs(5, b=4, groups=2)
        want = jax_ss.selective_scan(*map(jnp.asarray, (u, dt, A, B, C)),
                                     interpret=True, reverse=reverse)
        y, h_out = _port(u, dt, A, B, C, reverse)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
        # each group is the plain scan under its own A
        for g in range(2):
            rows = slice(2 * g, 2 * g + 2)
            yg, hg = _port(u[rows], dt[rows], A[g], B[rows], C[rows],
                           reverse)
            torch.testing.assert_close(y[rows], yg, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(h_out[rows], hg, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("reverse", [False, True])
    def test_final_state_matches_kernel(self, reverse):
        u, dt, A, B, C = _inputs(6, L=256)
        A_t = jnp.asarray(A).T[None]                      # (1, n, d)
        _, _, want = jax_ss._scan_fwd_pallas(
            *map(jnp.asarray, (u, dt, B, C)), A_t, "chunked",
            interpret=True, reverse=reverse)
        _, h_out = _port(u, dt, A, B, C, reverse)
        assert h_out.shape == (2, 16, 128) and h_out.dtype == torch.float32
        np.testing.assert_allclose(h_out.numpy(), np.asarray(want), **TOL)

    def test_bf16_inputs_match_kernel(self):
        u, dt, A, B, C = _inputs(7)
        u, B, C = _bf16(u), _bf16(B), _bf16(C)
        bf = jnp.bfloat16
        want = jax_ss.selective_scan(
            jnp.asarray(u, bf), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, bf), jnp.asarray(C, bf), True)
        y, _ = _port(u, dt, A, B, C, dtype=torch.bfloat16)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


class TestWrapper:
    def test_column_slices_of_B_and_C(self):
        """B and C may be column views of one (b, L, k) tensor, as the Mamba
        layer's x_proj output gives them."""
        u, dt, A, B, C = map(torch.from_numpy, _inputs(8, L=40, d=8))
        x_dbl = torch.cat([torch.zeros(2, 40, 3), B, C], dim=-1)
        Bv, Cv = x_dbl[..., 3:19], x_dbl[..., 19:]
        assert not Bv.is_contiguous()
        ss._check_kernel_inputs(u, dt, A, Bv, Cv)
        got = ss.selective_scan_fwd(u, dt, A, Bv, Cv)
        torch.testing.assert_close(got, ss.selective_scan_fwd(u, dt, A, B, C),
                                   rtol=1e-6, atol=1e-6)

    def test_cpu_tensors_never_reach_the_kernel(self, monkeypatch):
        def no_build(name):
            raise AssertionError(f"kernel {name} loaded for a CPU tensor")

        monkeypatch.setattr(_build, "load", no_build)
        monkeypatch.setattr(ss, "_FN", None)
        before = dict(_build.KERNEL_LAUNCHES)
        ss.selective_scan_fwd(*map(torch.from_numpy, _inputs(9, L=30, d=8)),
                              reverse=True)
        assert _build.KERNEL_LAUNCHES == before

    def test_kernel_path_refuses_autograd(self):
        """The kernel has no backward yet: off the CPU, an input that
        requires grad raises instead of leaving the graph cut.  (A meta
        tensor stands in for a CUDA one; the guard runs before any launch.)
        The CPU plain path stays differentiable."""
        u, dt, A, B, C = (torch.from_numpy(x).to("meta")
                          for x in _inputs(11, L=16, d=8))
        with pytest.raises(NotImplementedError, match="slice 4"):
            ss.selective_scan_fwd(u.requires_grad_(), dt, A, B, C)
        with torch.no_grad():
            assert not ss.needs_grad(u, dt)
        assert ss.needs_grad(u, dt) and not ss.needs_grad(dt, A)
        cpu = [torch.from_numpy(x) for x in _inputs(11, L=16, d=8)]
        y, _ = ss.selective_scan_fwd(cpu[0].requires_grad_(), *cpu[1:])
        y.sum().backward()
        assert cpu[0].grad is not None and torch.isfinite(cpu[0].grad).all()

    @pytest.mark.parametrize("case", ["n", "shape", "dtype", "dt_dtype",
                                      "strided_u", "bc_strides", "groups"])
    def test_kernel_input_checks(self, case):
        u, dt, A, B, C = map(torch.from_numpy, _inputs(10, L=24, d=8))
        err = ValueError
        if case == "n":
            A, B, C = A[:, :8], B[..., :8], C[..., :8]
        elif case == "shape":
            dt = dt[:, :20]
        elif case == "dtype":
            u, err = u.bfloat16(), TypeError
        elif case == "dt_dtype":
            dt, err = dt.double(), TypeError
        elif case == "strided_u":
            u = u.transpose(1, 2).contiguous().transpose(1, 2)
        elif case == "bc_strides":
            C = C.transpose(1, 2).contiguous().transpose(1, 2)
        else:
            A = torch.stack([A, A, A])                    # 3 groups, batch 2
        with pytest.raises(err):
            ss._check_kernel_inputs(u, dt, A, B, C)

    def test_import_and_cpu_call_need_no_nvcc(self, tmp_path):
        code = (
            "import torch\n"
            "from deepsense6g_tii_tpu_torch.ops import _build\n"
            "from deepsense6g_tii_tpu_torch.ops import selective_scan as ss\n"
            "u, bc = torch.zeros(1, 8, 4), torch.zeros(1, 8, 16)\n"
            "ss.selective_scan_fwd(u, u, -torch.ones(4, 16), bc, bc)\n"
            "assert not _build._LIBS and not _build.KERNEL_LAUNCHES\n")
        pythonpath = os.pathsep.join(
            x for x in (REPO, os.environ.get("PYTHONPATH")) if x)
        env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=pythonpath)
        subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       check=True, timeout=120)
