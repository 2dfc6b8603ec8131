"""The port's selective scan (deepsense6g_tii_tpu_torch/ops/selective_scan.py),
forward and backward, against the JAX package's associative-scan reference
and its Pallas kernels in interpret mode, on the CPU.

On a CPU tensor the port's wrappers run their plain versions (doubling
scans), which is what these tests hold against JAX; the CUDA kernels
themselves are held against the same plain versions on the card by
chip_smoke.py.  Tolerances: forward rtol/atol 1e-4, the bound of
tests/test_ops.py:45-46 (the two sides sum the recurrence in other
orders); gradients 1e-4 of each gradient's largest element, and 2^-7 for
bf16 du, dB and dC (both sides round f32 sums to bf16 once: two ulps).
"""

import ctypes
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.ops import selective_scan as jax_ss
from deepsense6g_tii_tpu_torch.ops import _build
from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
from deepsense6g_tii_tpu_torch.tools import scan_roofline
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
GRADS = ("du", "ddt", "dA", "dB", "dC")
GRAD_RTOL, BF16_GRAD_RTOL = 1e-4, 2.0 ** -7


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


def _dy(seed, b=2, L=300, d=128):
    return np.random.default_rng(seed).normal(size=(b, L, d)).astype(
        np.float32)


def _port_bwd(u, dt, A, B, C, dy, reverse=False, dtype=torch.float32):
    t = lambda x, dt_=torch.float32: torch.from_numpy(x).to(dt_)  # noqa: E731
    return ss.selective_scan_bwd(t(u, dtype), t(dt), t(A), t(B, dtype),
                                 t(C, dtype), t(dy), None, reverse=reverse)


def _assert_grads_close(got, want, bf16=False):
    """(du, ddt, dA, dB, dC) within GRAD_RTOL of each gradient's largest
    element (BF16_GRAD_RTOL for bf16 du, dB, dC), dtypes as JAX's."""
    for name, g, w in zip(GRADS, got, want):
        low = bf16 and name in ("du", "dB", "dC")
        assert g.dtype == (torch.bfloat16 if low else torch.float32), name
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(
            g.float().numpy(), w, rtol=0, err_msg=name,
            atol=(BF16_GRAD_RTOL if low else GRAD_RTOL) * np.abs(w).max())


def _jax_vjp(fn, u, dt, A, B, C, dy, bf16):
    """JAX's gradients of fn(u, dt, A, B, C) for the output gradient dy."""
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    args = (jnp.asarray(u, jdt), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, jdt), jnp.asarray(C, jdt))
    return jax.jit(lambda *a: jax.vjp(fn, *a)[1](jnp.asarray(dy)))(*args)


class TestBackward:
    @pytest.mark.parametrize("grouped", [False, True])
    @pytest.mark.parametrize("reverse", [False, True])
    def test_plain_backward_is_autograd_of_plain_forward(self, reverse,
                                                         grouped):
        """In f64, over three chunks' length (any L in the plain version)."""
        x = [torch.from_numpy(a).double() for a in _inputs(
            12, b=4, L=150, d=8, groups=2 if grouped else None)]
        dy = torch.from_numpy(_dy(13, b=4, L=150, d=8)).double()
        x = [a.requires_grad_() for a in x]
        y, _ = ss.selective_scan_reference(*x, reverse=reverse)
        want = torch.autograd.grad(y, x, dy)
        got = ss.selective_scan_bwd_reference(*(a.detach() for a in x), dy,
                                              reverse)
        for name, g, w in zip(GRADS, got, want):
            assert g.dtype == torch.float64 and g.shape == w.shape, name
            torch.testing.assert_close(g, w, rtol=0, msg=name,
                                       atol=1e-12 * float(w.abs().max()))

    @pytest.mark.parametrize("reverse", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax_grad_of_selective_scan_ref(self, reverse, dtype):
        bf16 = dtype == "bfloat16"
        u, dt, A, B, C = _inputs(14 + reverse)          # ragged L = 300
        if bf16:
            u, B, C = _bf16(u), _bf16(B), _bf16(C)
        dy = _dy(16)
        want = _jax_vjp(lambda *a: jax_ss.selective_scan_ref(
            *a, reverse=reverse), u, dt, A, B, C, dy, bf16)
        got = _port_bwd(u, dt, A, B, C, dy, reverse, getattr(torch, dtype))
        _assert_grads_close(got, want, bf16)

    @pytest.mark.parametrize("reverse", [False, True])
    @pytest.mark.parametrize("case", ["float32", "grouped_bfloat16"])
    def test_matches_pallas_backward_kernels(self, reverse, case):
        """Through jax.vjp of the Pallas scan in interpret mode, which runs
        _bwd_kernel_chunked (forward direction) or _bwd_kernel_chunked_rev
        (reverse); L = 300 is not a multiple of its 128-step chunk."""
        bf16 = case != "float32"
        u, dt, A, B, C = _inputs(17 + reverse, b=4 if bf16 else 2,
                                 groups=2 if bf16 else None)
        if bf16:
            u, B, C = _bf16(u), _bf16(B), _bf16(C)
        dy = _dy(19, b=u.shape[0])
        want = _jax_vjp(lambda *a: jax_ss.selective_scan(
            *a, interpret=True, reverse=reverse), u, dt, A, B, C, dy, bf16)
        got = _port_bwd(u, dt, A, B, C, dy, reverse,
                        torch.bfloat16 if bf16 else torch.float32)
        assert got[2].shape == A.shape
        _assert_grads_close(got, want, bf16)


def _states_loop(u, dt, A, B, C, reverse):
    """numpy f64: the state before each step of the scan, (b, L, n, d)."""
    b, L, d = u.shape
    out = np.zeros((b, L, A.shape[-1], d))
    for i in range(b):
        h = np.zeros(A.shape)
        for t in (range(L - 1, -1, -1) if reverse else range(L)):
            out[i, t] = h.T
            h = (np.exp(dt[i, t][:, None] * A) * h
                 + (dt[i, t] * u[i, t])[:, None] * B[i, t][None])
    return out


class TestChunkStates:
    @pytest.mark.parametrize("reverse", [False, True])
    def test_match_naive_loop(self, reverse):
        """The state entering each chunk in the scan's direction; reverse
        chunks are aligned to the end (L = 150: chunk 0 starts at -42)."""
        x = _inputs(20, L=150, d=4)
        got = ss.chunk_states_reference(*map(torch.from_numpy, x),
                                        reverse=reverse)
        n_chunks = ss.num_chunks(150)
        assert got.shape == (2, n_chunks, 16, 4) and n_chunks == 3
        before = _states_loop(*x, reverse)
        firsts = ([min(149, 150 - (n_chunks - c) * ss.CHUNK + ss.CHUNK - 1)
                   for c in range(n_chunks)] if reverse
                  else [c * ss.CHUNK for c in range(n_chunks)])
        np.testing.assert_allclose(got.numpy(), before[:, firsts],
                                   rtol=1e-5, atol=1e-6)

    def test_match_pallas_h_in(self):
        """Every other 64-step chunk boundary is a boundary of the TPU
        forward's 128-step chunks, where both hold the same state."""
        u, dt, A, B, C = _inputs(21)                      # L = 300
        A_t = jnp.asarray(A).T[None]
        _, want, _ = jax_ss._scan_fwd_pallas(
            *(jnp.pad(jnp.asarray(x), ((0, 0), (0, 84), (0, 0)))
              for x in (u, dt, B, C)), A_t, "chunked", interpret=True)
        got = ss.chunk_states_reference(*map(torch.from_numpy,
                                             (u, dt, A, B, C)))
        assert got.shape == (2, 5, 16, 128) and want.shape == (2, 3, 16, 128)
        np.testing.assert_allclose(got[:, ::2].numpy(), np.asarray(want),
                                   **TOL)


class TestSelectiveScanFunction:
    def test_gradcheck_with_plain_launchers(self, monkeypatch):
        """SelectiveScan's wiring, with its launchers replaced by the plain
        forward and backward: torch.autograd.gradcheck in f64, and the
        gradients equal autograd of the plain forward, with B and C column
        slices of one x_dbl, grouped A, both directions and h_out unused."""
        calls = []

        def launch_fwd(u, dt, A, B, C, reverse, save_states):
            calls.append("fwd")
            y, h_out = ss.selective_scan_reference(u, dt, A, B, C, reverse)
            return y, h_out, ss.chunk_states_reference(u, dt, A, B, C,
                                                       reverse)

        def launch_bwd(u, dt, A, B, C, dy, h_in, *, reverse=False):
            calls.append("bwd")
            assert h_in.shape == (4, 1, 16, 3) and not B.is_contiguous()
            return ss.selective_scan_bwd_reference(u, dt, A, B, C, dy,
                                                   reverse)

        monkeypatch.setattr(ss, "_launch_fwd", launch_fwd)
        monkeypatch.setattr(ss, "selective_scan_bwd", launch_bwd)
        rng = np.random.default_rng(22)
        u = torch.from_numpy(rng.normal(size=(4, 6, 3))).requires_grad_()
        dt = torch.from_numpy(rng.uniform(0.1, 0.9, (4, 6, 3)))
        dt.requires_grad_()
        A = torch.from_numpy(-rng.uniform(0.5, 2, (2, 3, 16)))
        A.requires_grad_()
        x_dbl = torch.from_numpy(rng.normal(size=(4, 6, 34)))
        x_dbl.requires_grad_()
        for reverse in (False, True):
            def scan(u, dt, A, x_dbl, kernel=True):
                B, C = x_dbl[..., 2:18], x_dbl[..., 18:]
                fn = (ss.SelectiveScan.apply if kernel else
                      ss.selective_scan_reference)
                return fn(u, dt, A, B, C, reverse)[0]

            args = (u, dt, A, x_dbl)
            assert torch.autograd.gradcheck(scan, args)
            dy = torch.from_numpy(rng.normal(size=(4, 6, 3)))
            got = torch.autograd.grad(scan(*args), args, dy)
            want = torch.autograd.grad(scan(*args, kernel=False), args, dy)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
        assert "fwd" in calls and "bwd" in calls


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
        monkeypatch.setattr(_build, "_FNS", {})
        before = dict(_build.KERNEL_LAUNCHES)
        x = [torch.from_numpy(a) for a in _inputs(9, L=30, d=8)]
        ss.selective_scan_fwd(*x, reverse=True)
        ss.selective_scan_fwd(x[0].requires_grad_(), *x[1:])
        ss.selective_scan_bwd(*x, torch.ones(2, 30, 8), None)
        assert _build.KERNEL_LAUNCHES == before

    def test_kernel_path_refuses_autograd(self, monkeypatch):
        """Off the CPU, an input that requires grad goes through
        SelectiveScan, the kernels' autograd Function, whose forward asks
        the forward kernel for the chunk-entry states; without grad the
        kernel is asked for none.  (A meta tensor stands in for a CUDA one:
        the Function's forward runs the kernel's input checks, then refuses
        the device, before any launch.)  The CPU plain path stays
        differentiable."""
        u, dt, A, B, C = (torch.from_numpy(x).to("meta")
                          for x in _inputs(11, L=16, d=8))
        u.requires_grad_()
        with pytest.raises(ValueError, match="one \\(b, L, d\\) shape"):
            ss.selective_scan_fwd(u, dt[:, :8], A, B, C)
        with pytest.raises(ValueError, match="cuda or cpu"):
            ss.selective_scan_fwd(u, dt, A, B, C)
        asked = []

        def launch(u, dt, A, B, C, reverse, save_states):
            asked.append((save_states, torch.is_grad_enabled()))
            raise RuntimeError("no launch")

        monkeypatch.setattr(ss, "_launch_fwd", launch)
        for grad in (True, False):
            with torch.set_grad_enabled(grad), pytest.raises(RuntimeError):
                ss.selective_scan_fwd(u, dt, A, B, C, reverse=True)
        # the Function's forward runs with grad off, asking for h_in
        assert asked == [(True, False), (False, False)]
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


# the C parameter types of the kernels' entry points, as ctypes types
_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "float": ctypes.c_float,
            "uint32_t": ctypes.c_uint32}
_ENTRY_POINTS = [(m, f) for m in (ss, fa, scan_roofline)
                 for f in m._SIGNATURES]


@pytest.mark.parametrize("module,fname", _ENTRY_POINTS,
                         ids=[f for _, f in _ENTRY_POINTS])
def test_ctypes_argtypes_match_the_c_entry_point(module, fname):
    """Each wrapper's ctypes argument list is its C entry point's, type for
    type, as csrc/ declares it: a mismatch would only show on the card."""
    library, argtypes = module._SIGNATURES[fname]
    src = (_build.CSRC_DIR / f"{library}.cu").read_text()
    found = re.search(r'extern "C" int ' + fname + r"\(([^)]*)\)", src)
    assert found, f"no entry point {fname} in {library}.cu"
    params = [" ".join(w for w in p.split()[:-1] if w != "const")
              for p in found.group(1).split(",")]
    assert [_C_TYPES[p] for p in params] == list(argtypes)


def test_layout_constants_come_from_the_header():
    """The wrapper sizes h_in and the dB/dC partials by the constants that
    csrc/selective_scan.cuh states, and the CPU plain version of h_in
    spaces its states the same way."""
    text = (_build.CSRC_DIR / "selective_scan.cuh").read_text()
    for name, value in (("N", ss.D_STATE), ("TL", ss.CHUNK),
                        ("DT", ss.CHANNELS_PER_BLOCK)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    x = [torch.from_numpy(a) for a in _inputs(12, L=2 * ss.CHUNK + 1, d=8)]
    assert ss.chunk_states_reference(*x).shape == (2, 3, ss.D_STATE, 8)
