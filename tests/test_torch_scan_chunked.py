"""The selective scan's chunk-parallel passes (deepsense6g_tii_tpu_torch/ops/
selective_scan.py and csrc/selective_scan_{fwd,bwd}.cu), in their plain
PyTorch versions, on the CPU.

The forward kernel cuts L into groups of 64-step chunks that run in
parallel (a state pass from zero, a carry pass, an output pass), and the
backward kernel runs every chunk on its own (a local gradient pass from
zero, a carry pass, the main pass).  Each pass has a plain version; these
tests hold the plain passes, composed as the kernels compose them, to the
plain scan, to its chunk-entry states and to the JAX package: its Pallas
forward's h_in and jax.vjp of its Pallas scan, both in interpret mode (the
JAX kernels need d % 128 == 0, so those cases use d = 128).  They also run
the CUDA wrappers' allocation, scratch and partial-sum code with the kernel
calls replaced by the plain passes.  Tolerances: the passes against the
plain scan in f64, 1e-9 of the largest value (the same sums in another
order); against JAX, forward rtol/atol 1e-4 and gradients 1e-4 of each
gradient's largest element, 2^-7 for bf16 du, dB and dC, the bounds of
tests/test_torch_selective_scan.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.ops import selective_scan as jax_ss
from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

GRADS = ("du", "ddt", "dA", "dB", "dC")
GRAD_RTOL, BF16_GRAD_RTOL = 1e-4, 2.0 ** -7
F64_RTOL = 1e-9


def _inputs(seed, b=2, L=150, d=24, groups=None, dtype=np.float64):
    """u, dt, A, B, C, dy as numpy, shaped like tests/test_ops.py:18-24."""
    rng = np.random.default_rng(seed)
    a_shape = (d, 16) if groups is None else (groups, d, 16)
    return (rng.normal(size=(b, L, d)).astype(dtype),
            (np.abs(rng.normal(size=(b, L, d))) * 0.3).astype(dtype),
            -np.abs(rng.normal(size=a_shape)).astype(dtype),
            rng.normal(size=(b, L, 16)).astype(dtype),
            rng.normal(size=(b, L, 16)).astype(dtype),
            rng.normal(size=(b, L, d)).astype(dtype))


def _close(got, want, rtol=F64_RTOL, name=""):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= rtol * scale, f"{name}: {err:.3g} of {scale:.3g}"


@pytest.mark.parametrize("groups", [None, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [1, 64, 65, 150])
def test_plain_passes_compose_to_the_scan(L, reverse, groups):
    """In f64: the forward's passes at every group size give the scan's y,
    h_out and chunk-entry states; the backward's passes give its
    gradients; the state pass from zero plus the carry gives the states
    entering each group."""
    x = [torch.from_numpy(a) for a in _inputs(
        L, b=4 if groups else 2, L=L, groups=groups)]
    u, dt, A, B, C, dy = x
    y, h_out = ss.selective_scan_reference(u, dt, A, B, C, reverse)
    h_in = ss.chunk_states_reference(u, dt, A, B, C, reverse)
    nc = ss.num_chunks(L)
    for G in range(1, nc + 1):
        got = ss.chunked_fwd_reference(u, dt, A, B, C, reverse, G)
        for name, g, w in zip(("y", "h_out", "h_in"), got, (y, h_out, h_in)):
            _close(g, w, name=f"{name} G={G}")
        loc, sdt = ss.chunk_local_states_reference(u, dt, A, B, C, reverse,
                                                   G)
        start = ss.carry_reference(loc, sdt, A, ascending=not reverse)
        # a group is entered at its first chunk, or its last in reverse
        firsts = [min(nc, s + G) - 1 if reverse else s
                  for s in range(0, nc, G)]
        _close(start, h_in[:, firsts], name=f"group entry G={G}")
    want = ss.selective_scan_bwd_reference(u, dt, A, B, C, dy, reverse)
    got = ss.chunked_bwd_reference(u, dt, A, B, C, dy, reverse)
    for name, g, w in zip(GRADS, got, want):
        _close(g, w, name=name)


def test_carry_is_the_recurrence_over_segments():
    """carry_reference against a scalar loop, both visiting orders, grouped
    A (rows 0-1 under A[0], rows 2-3 under A[1])."""
    rng = np.random.default_rng(3)
    loc = rng.normal(size=(4, 5, 16, 3))
    sdt = rng.uniform(0, 2, size=(4, 5, 3))
    A = -rng.uniform(0.1, 2, size=(2, 3, 16))
    for ascending in (True, False):
        got = ss.carry_reference(*map(torch.from_numpy, (loc, sdt, A)),
                                 ascending=ascending).numpy()
        order = range(5) if ascending else range(4, -1, -1)
        for b in range(4):
            h = np.zeros((16, 3))
            for s in order:
                np.testing.assert_allclose(got[b, s], h, rtol=1e-12,
                                           atol=1e-12)
                h = np.exp(A[b // 2].T * sdt[b, s]) * h + loc[b, s]


def test_grad_local_is_the_chunk_recurrence_from_zero():
    """The backward's first pass: within each chunk, against the scan,
    g = C dy + p and p = a g from p = 0, as a loop; its dt sums."""
    u, dt, A, B, C, dy = _inputs(4, b=1, L=100, d=3)
    for reverse in (False, True):
        p_loc, sdt = (x.numpy() for x in ss.grad_local_reference(
            *map(torch.from_numpy, (dt, A, C, dy)), reverse=reverse))
        nc = ss.num_chunks(100)
        for c in range(nc):
            start = 100 - (nc - c) * ss.CHUNK if reverse else c * ss.CHUNK
            steps = [t for t in range(start, start + ss.CHUNK)
                     if 0 <= t < 100]
            p = np.zeros((3, 16))
            for t in (steps if reverse else steps[::-1]):
                p = np.exp(dt[0, t][:, None] * A) * (
                    C[0, t][None] * dy[0, t][:, None] + p)
            np.testing.assert_allclose(p_loc[0, c], p.T, rtol=1e-10,
                                       atol=1e-12)
            np.testing.assert_allclose(sdt[0, c], dt[0, steps].sum(0),
                                       rtol=1e-12)


@pytest.mark.parametrize("G", [1, 2])
def test_h_in_matches_pallas_at_its_boundaries(G):
    """Every other 64-step chunk boundary is a boundary of the TPU
    forward's 128-step chunks, where the plain passes' h_in and the Pallas
    kernel's hold the same state."""
    u, dt, A, B, C, _ = _inputs(21, L=300, d=128, dtype=np.float32)
    _, want, _ = jax_ss._scan_fwd_pallas(
        *(jnp.pad(jnp.asarray(x), ((0, 0), (0, 84), (0, 0)))
          for x in (u, dt, B, C)), jnp.asarray(A).T[None], "chunked",
        interpret=True)
    _, _, got = ss.chunked_fwd_reference(
        *map(torch.from_numpy, (u, dt, A, B, C)), chunks_per_group=G)
    assert got.shape == (2, 5, 16, 128) and want.shape == (2, 3, 16, 128)
    np.testing.assert_allclose(got[:, ::2].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _jax_vjp(u, dt, A, B, C, dy, reverse, bf16):
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    args = (jnp.asarray(u, jdt), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, jdt), jnp.asarray(C, jdt))
    fn = lambda *a: jax_ss.selective_scan(*a, interpret=True,  # noqa: E731
                                          reverse=reverse)
    return jax.jit(lambda *a: jax.vjp(fn, *a)[1](jnp.asarray(dy)))(*args)


@pytest.mark.parametrize("L,reverse,case", [
    (1, False, "float32"), (5, True, "float32"), (63, False, "bfloat16"),
    (64, True, "bfloat16"), (65, False, "grouped"), (150, True, "grouped")])
def test_chunked_backward_matches_jax_vjp(L, reverse, case):
    """The backward's passes composed (local gradients, carry, per-chunk
    gradients, the wrapper's partial sums) against jax.vjp of the Pallas
    scan in interpret mode: both directions, grouped A, bf16 inputs, L
    around one and two chunks."""
    bf16 = case == "bfloat16"
    groups = 2 if case == "grouped" else None
    u, dt, A, B, C, dy = _inputs(30 + L, b=2, L=L, d=128, groups=groups,
                                 dtype=np.float32)
    if bf16:
        u, B, C = (torch.from_numpy(x).bfloat16().float().numpy()
                   for x in (u, B, C))
    want = _jax_vjp(u, dt, A, B, C, dy, reverse, bf16)
    low = torch.bfloat16 if bf16 else torch.float32
    t = lambda x, dtype=torch.float32: torch.from_numpy(x).to(dtype)  # noqa: E731
    got = ss.chunked_bwd_reference(t(u, low), t(dt), t(A), t(B, low),
                                   t(C, low), t(dy), reverse)
    for name, g, w in zip(GRADS, got, want):
        lowp = bf16 and name in ("du", "dB", "dC")
        assert g.dtype == (torch.bfloat16 if lowp else torch.float32), name
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(
            g.float().numpy(), w, rtol=0, err_msg=name,
            atol=(BF16_GRAD_RTOL if lowp else GRAD_RTOL) * np.abs(w).max())


@pytest.mark.parametrize("b,L,d", [(8, 962, 128), (8, 962, 256),
                                   (8, 962, 512), (8, 962, 1024),
                                   (1, 962, 1024), (8, 5, 1024),
                                   (1, 150, 40)])
def test_split_covers_every_chunk_once(b, L, d):
    """fwd_chunks_per_group: groups of consecutive chunks that cover every
    chunk once; the reverse direction's chunks, aligned to the end, cover
    [0, L) once; one group where the launch alone fills the card."""
    G = ss.fwd_chunks_per_group(b, L, d)
    nc, S = ss.num_chunks(L), ss.fwd_groups(L, G)
    assert 1 <= G <= nc and S == -(-nc // G)
    chunks = [c for s in range(S) for c in range(s * G, min(nc, s * G + G))]
    assert chunks == list(range(nc))
    for reverse in (False, True):
        steps = []
        for c in chunks:
            start = L - (nc - c) * ss.CHUNK if reverse else c * ss.CHUNK
            steps += [t for t in range(start, start + ss.CHUNK)
                      if 0 <= t < L]
        assert steps == list(range(L))
    blocks = b * -(-d // ss.FWD_CHANNELS_PER_BLOCK)
    want = -(-ss.FWD_TARGET_BLOCKS // blocks)
    if want < ss.FWD_MIN_GROUPS:
        assert G == nc
    else:       # groups as many as wanted, up to one a chunk, within 2x
        assert min(want, nc) / 2 < S <= min(want, nc)


def _plain_fwd_kernel(u, dt, A, B, C, y, h_out, h_in, scratch,
                      chunks_per_group, reverse):
    """The forward kernel's passes in their plain versions, writing where
    the C entry writes: loc, h_start and sdt in the scratch's layout."""
    b, L, d = u.shape
    S = ss.fwd_groups(L, chunks_per_group)
    h_start = None
    if S > 1:
        n = ss.D_STATE
        assert scratch.numel() == (2 * n + 1) * b * S * d
        loc_v, start_v = (scratch[i * b * S * n * d:(i + 1) * b * S * n * d]
                          .view(b, S, n, d) for i in range(2))
        sdt_v = scratch[2 * b * S * n * d:].view(b, S, d)
        loc, sdt = ss.chunk_local_states_reference(u, dt, A, B, C, reverse,
                                                   chunks_per_group)
        loc_v.copy_(loc)
        sdt_v.copy_(sdt)
        start_v.copy_(ss.carry_reference(loc_v, sdt_v, A,
                                         ascending=not reverse))
        h_start = start_v
    else:
        assert scratch is None
    got = ss.chunk_outputs_reference(u, dt, A, B, C, h_start, reverse,
                                     chunks_per_group)
    y.copy_(got[0])
    h_out.copy_(got[1])
    if h_in is not None:
        h_in.copy_(got[2])


def _plain_bwd_kernel(u, dt, A, B, C, dy, h_in, du, ddt, db_part, dc_part,
                      da_part, dA, dB, dC, scratch, reverse):
    """The backward kernel's passes in their plain versions, writing where
    the C entry writes."""
    b, L, d = u.shape
    nc, n = ss.num_chunks(L), ss.D_STATE
    p_in = None
    if nc > 1:
        assert scratch.numel() == (2 * n + 1) * b * nc * d
        p_loc, sdt = ss.grad_local_reference(dt, A, C, dy, reverse)
        p_in = scratch[b * nc * n * d:2 * b * nc * n * d].view(b, nc, n, d)
        p_in.copy_(ss.carry_reference(p_loc, sdt, A, ascending=reverse))
    else:
        assert scratch is None
    for out, got in zip((du, ddt, db_part, dc_part, da_part),
                        ss.bwd_chunk_reference(u, dt, A, B, C, dy, h_in,
                                               p_in, reverse)):
        out.copy_(got)
    for out, got in zip((dA, dB, dC), ss.bwd_sums_reference(
            A, B, C, db_part, dc_part, da_part)):
        out.copy_(got.view(out.shape))


@pytest.mark.parametrize("reverse", [False, True])
def test_wrappers_with_plain_passes(monkeypatch, reverse):
    """The CUDA path's wrappers (outputs, scratch, the forward's split, the
    backward's partial sums) with each kernel call replaced by its plain
    passes, on CPU tensors: the forward at every group size and the
    backward equal the plain scan and its backward; SelectiveScan through
    them equals autograd of the plain scan.  B and C are column slices and
    A is grouped, as in the model."""
    monkeypatch.setattr(ss, "_cuda", lambda u: None)
    monkeypatch.setattr(ss, "_fwd_kernel", _plain_fwd_kernel)
    monkeypatch.setattr(ss, "_bwd_kernel", _plain_bwd_kernel)
    u, dt, A, B, C, dy = (torch.from_numpy(x) for x in _inputs(
        9, b=2, L=150, d=40, groups=2, dtype=np.float32))
    x_dbl = torch.cat([torch.zeros(2, 150, 3), B, C], dim=-1)
    B, C = x_dbl[..., 3:19], x_dbl[..., 19:]
    y, h_out = ss.selective_scan_reference(u, dt, A, B, C, reverse)
    h_in = ss.chunk_states_reference(u, dt, A, B, C, reverse)
    for G in (None, 1, 2, 3):
        got = ss._launch_fwd(u, dt, A, B, C, reverse, True, G)
        for name, g, w in zip(("y", "h_out", "h_in"), got, (y, h_out, h_in)):
            _close(g, w, rtol=1e-5, name=f"{name} G={G}")
    got = ss._kernel_bwd(u, dt, A, B, C, dy, h_in, reverse)
    want = ss.selective_scan_bwd_reference(u, dt, A, B, C, dy, reverse)
    for name, g, w in zip(GRADS, got, want):
        _close(g, w, rtol=1e-5, name=name)
    leaves = [t.clone().requires_grad_() for t in (u, dt, A, x_dbl)]
    outs = []
    for fn in (ss.SelectiveScan.apply, ss.selective_scan_reference):
        yy = fn(*leaves[:3], leaves[3][..., 3:19], leaves[3][..., 19:],
                reverse)[0]
        outs.append(torch.autograd.grad(yy, leaves, dy))
    for g, w in zip(*outs):
        _close(g, w, rtol=1e-5)


def test_bench_scan_loads_another_checkout(tmp_path):
    """bench_scan --root PATH: another checkout's scan module under a name
    of its own, its layout read from its own headers."""
    import os
    import shutil
    from deepsense6g_tii_tpu_torch.tools import bench_scan
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(os.path.join(repo, "deepsense6g_tii_tpu_torch"),
                    tmp_path / "deepsense6g_tii_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(repo, "pyproject.toml"), tmp_path)
    assert bench_scan.load_scan() is ss and bench_scan.load_scan(repo) is ss
    other = bench_scan.load_scan(str(tmp_path))
    assert other is not ss and other is bench_scan.load_scan(str(tmp_path))
    assert other._build.BUILD_DIR == tmp_path / "build" / "kernels"
    x = [torch.from_numpy(a) for a in _inputs(41, L=70, d=8)[:5]]
    for a, b in zip(other.selective_scan_fwd(*x), ss.selective_scan_fwd(*x)):
        assert torch.equal(a, b)


def test_bench_scan_weighs_a_mamba_step():
    """per-step totals: 16 launches at each L = 962 shape, 3 at L = 5."""
    from deepsense6g_tii_tpu_torch.tools import bench_scan
    ms = {shape: {"bwd": L_ + d, "fwd_h_in": 1.0, "fwd": 2.0, "fwd_b1": 3.0,
                  "seq": 4.0, "seq_b1": 5.0}
          for shape in bench_scan.SHAPES for L_, d in [shape]}
    out = bench_scan.weigh(ms)
    assert out["bwd_per_mamba_step_ms"] == (
        16 * (4 * 962 + 128 + 256 + 512 + 1024) + 3 * (5 + 1024))
    assert out["fwd_h_in_per_mamba_step_ms"] == 67
    assert out["fwd_per_serving_forward_b8_ms"] == 134
    assert out["fwd_per_serving_forward_b1_ms"] == 201
    assert out["seq_per_serving_forward_b8_ms"] == 268
    assert out["seq_per_serving_forward_b1_ms"] == 335
