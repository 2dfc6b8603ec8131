"""The port's sequential selective-scan forward (``variant="sequential"``,
deepsense6g_tii_tpu_torch/ops/selective_scan.py) against the JAX package's
sequential Pallas kernel in interpret mode, a float64 numpy loop and the
port's own doubling scan, on the CPU.

On a CPU tensor the port runs the plain loop over time,
``selective_scan_sequential_reference``; the CUDA kernel
(csrc/selective_scan_seq.cu) is held against the same loop and against the
chunked kernel on the card by chip_smoke.py.  Its launch split
(``seq_launch``: lanes per channel, threads per block) is plain Python and
is checked here against the kernel's source.  Tolerances: against JAX rtol
and atol 1e-4, the bound of tests/test_ops.py:45-46 (the two sides sum over
the states in other orders); against the float64 loop 2e-5 (f32 rounding
over 300 steps); f64 against f64, 1e-10.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.ops import selective_scan as jax_ss
from deepsense6g_tii_tpu_torch.ops import _build
from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

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


def _torch(u, dt, A, B, C, dtype=torch.float32):
    t = lambda x, dt_=torch.float32: torch.from_numpy(x).to(dt_)  # noqa: E731
    return t(u, dtype), t(dt), t(A), t(B, dtype), t(C, dtype)


def _naive(u, dt, A, B, C):
    """Step-by-step numpy loop in f64, A (d, n) or (G, d, n): y (b, L, d),
    h_out (b, n, d) and the state before each step, (b, L, n, d)."""
    b, L, d = u.shape
    y, before = np.zeros((b, L, d)), np.zeros((b, L, A.shape[-1], d))
    h_out = np.zeros((b, A.shape[-1], d))
    for i in range(b):
        Ai = A if A.ndim == 2 else A[i // (b // A.shape[0])]
        h = np.zeros(Ai.shape)
        for t in range(L):
            before[i, t] = h.T
            h = (np.exp(dt[i, t][:, None] * Ai) * h
                 + (dt[i, t] * u[i, t])[:, None] * B[i, t][None])
            y[i, t] = h @ C[i, t]
        h_out[i] = h.T
    return y, h_out, before


class TestAgainstPallasSequential:
    @pytest.mark.parametrize("case", ["float32", "bfloat16", "grouped"])
    def test_matches_kernel(self, case):
        """y of the JAX sequential kernel (interpret mode) at b=2, L=300,
        d=128, and at b=4 with two groups of A."""
        grouped = case == "grouped"
        u, dt, A, B, C = _inputs(30, b=4 if grouped else 2,
                                 groups=2 if grouped else None)
        jdt = jnp.bfloat16 if case == "bfloat16" else jnp.float32
        if case == "bfloat16":
            u, B, C = _bf16(u), _bf16(B), _bf16(C)
        want = jax_ss.selective_scan(
            jnp.asarray(u, jdt), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, jdt), jnp.asarray(C, jdt), interpret=True,
            variant="sequential")
        tdt = torch.bfloat16 if case == "bfloat16" else torch.float32
        y, h_out = ss.selective_scan_fwd(*_torch(u, dt, A, B, C, tdt),
                                         variant="sequential")
        assert y.dtype == torch.float32 and y.shape == u.shape
        assert h_out.shape == (u.shape[0], 16, 128)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)

    def test_states_match_kernel(self):
        """h_out, and h_in at every other 64-step boundary (the TPU kernel's
        128-step chunks), equal the JAX sequential kernel's."""
        u, dt, A, B, C = _inputs(31, L=256)
        _, want_in, want_out = jax_ss._scan_fwd_pallas(
            *map(jnp.asarray, (u, dt, B, C)), jnp.asarray(A).T[None],
            "sequential", interpret=True)
        _, h_out, h_in = ss.selective_scan_sequential_reference(
            *_torch(u, dt, A, B, C))
        assert h_in.shape == (2, 4, 16, 128) and want_in.shape[1] == 2
        np.testing.assert_allclose(h_out.numpy(), np.asarray(want_out),
                                   **TOL)
        np.testing.assert_allclose(h_in[:, ::2].numpy(), np.asarray(want_in),
                                   **TOL)

    def test_reverse_raises_as_jax_does(self):
        x = _inputs(32, L=20, d=128)
        with pytest.raises(ValueError, match="only variant='chunked'"):
            jax_ss.selective_scan(*map(jnp.asarray, x), interpret=True,
                                  variant="sequential", reverse=True)
        with pytest.raises(ValueError, match="only variant='chunked'"):
            ss.selective_scan_fwd(*_torch(*x), variant="sequential",
                                  reverse=True)

    def test_unknown_variant_raises(self):
        with pytest.raises(ValueError, match="variant"):
            ss.selective_scan_fwd(*_torch(*_inputs(33, L=8, d=4)),
                                  variant="segmented")


class TestPlainLoop:
    @pytest.mark.parametrize("groups", [None, 2])
    def test_matches_float64_loop(self, groups):
        u, dt, A, B, C = _inputs(34, b=4, L=300, d=16, groups=groups)
        want_y, want_h, _ = _naive(u, dt, A, B, C)
        y, h_out, _ = ss.selective_scan_sequential_reference(
            *_torch(u, dt, A, B, C))
        np.testing.assert_allclose(y.numpy(), want_y, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(h_out.numpy(), want_h, rtol=2e-5,
                                   atol=2e-5)

    def test_float64_inputs_run_in_float64(self):
        u, dt, A, B, C = (x.astype(np.float64)
                          for x in _inputs(35, L=100, d=8))
        want_y, want_h, _ = _naive(u, dt, A, B, C)
        y, h_out, _ = ss.selective_scan_sequential_reference(
            *map(torch.from_numpy, (u, dt, A, B, C)))
        assert y.dtype == torch.float64
        np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(h_out.numpy(), want_h, rtol=1e-10,
                                   atol=1e-10)

    @pytest.mark.parametrize("groups", [None, 2])
    def test_matches_doubling_scan(self, groups):
        """The chunked variant's plain version (a doubling scan) and the
        loop: two independent computations of the same scan."""
        x = _torch(*_inputs(36, b=4, L=300, d=32, groups=groups))
        y, h_out, _ = ss.selective_scan_sequential_reference(*x)
        want_y, want_h = ss.selective_scan_reference(*x)
        torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(h_out, want_h, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("L", [5, 64, 65, 300])
    def test_h_in_equals_chunk_states_reference(self, L):
        """In f64 the loop's chunk-entry states are the doubling scan's
        (chunk_states_reference) and the numpy loop's, to rounding."""
        u, dt, A, B, C = (x.astype(np.float64)
                          for x in _inputs(37, L=L, d=8))
        _, _, h_in = ss.selective_scan_sequential_reference(
            *map(torch.from_numpy, (u, dt, A, B, C)))
        want = ss.chunk_states_reference(
            *map(torch.from_numpy, (u, dt, A, B, C)))
        assert h_in.shape == want.shape == (2, ss.num_chunks(L), 16, 8)
        torch.testing.assert_close(h_in, want, rtol=1e-12, atol=1e-12)
        before = _naive(u, dt, A, B, C)[2]
        np.testing.assert_allclose(h_in.numpy(),
                                   before[:, ::ss.CHUNK], rtol=1e-12,
                                   atol=1e-12)


class TestSequentialFunction:
    @pytest.mark.parametrize("groups", [None, 2])
    def test_gradients_equal_the_chunked_ones(self, monkeypatch, groups):
        """SelectiveScan with variant="sequential", its launchers replaced
        by the plain versions: the forward asks the sequential launcher for
        h_in, the backward (the chunked backward for either variant) gets
        h_in in the chunked layout, and the gradients equal the chunked
        variant's; gradcheck in f64, with B and C column slices."""
        calls = []

        def launch_seq(u, dt, A, B, C, save_states):
            calls.append(("seq", save_states))
            return ss.selective_scan_sequential_reference(u, dt, A, B, C)

        def launch_fwd(u, dt, A, B, C, reverse, save_states):
            calls.append(("chunked", save_states))
            y, h_out = ss.selective_scan_reference(u, dt, A, B, C, reverse)
            return y, h_out, ss.chunk_states_reference(u, dt, A, B, C,
                                                       reverse)

        def launch_bwd(u, dt, A, B, C, dy, h_in, *, reverse=False):
            calls.append(("bwd", reverse))
            torch.testing.assert_close(
                h_in, ss.chunk_states_reference(u, dt, A, B, C),
                rtol=1e-12, atol=1e-12)
            return ss.selective_scan_bwd_reference(u, dt, A, B, C, dy,
                                                   reverse)

        monkeypatch.setattr(ss, "_launch_seq", launch_seq)
        monkeypatch.setattr(ss, "_launch_fwd", launch_fwd)
        monkeypatch.setattr(ss, "selective_scan_bwd", launch_bwd)
        rng = np.random.default_rng(38)
        u = torch.from_numpy(rng.normal(size=(4, 70, 3))).requires_grad_()
        dt = torch.from_numpy(rng.uniform(0.1, 0.9, (4, 70, 3)))
        a_shape = (3, 16) if groups is None else (groups, 3, 16)
        A = torch.from_numpy(-rng.uniform(0.5, 2, a_shape))
        x_dbl = torch.from_numpy(rng.normal(size=(4, 70, 34)))
        args = (u, dt.requires_grad_(), A.requires_grad_(),
                x_dbl.requires_grad_())

        def scan(u, dt, A, x_dbl, variant="sequential"):
            B, C = x_dbl[..., 2:18], x_dbl[..., 18:]
            return ss.SelectiveScan.apply(u, dt, A, B, C, False, variant)[0]

        dy = torch.from_numpy(rng.normal(size=(4, 70, 3)))
        got = torch.autograd.grad(scan(*args), args, dy)
        want = torch.autograd.grad(scan(*args, variant="chunked"), args, dy)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
        assert calls[:3] == [("seq", True), ("bwd", False),
                             ("chunked", True)]
        small = [a[:, :6].detach().clone().requires_grad_()
                 if a.dim() == 3 and a.shape[1] == 70 else a for a in args]
        assert torch.autograd.gradcheck(scan, tuple(small))


class TestKernelRoute:
    def test_cuda_route_launches_the_sequential_kernel(self, monkeypatch):
        """Off the CPU, variant="sequential" goes to the sequential kernel
        (through SelectiveScan, asking for h_in, when an input needs grad)
        or raises: a meta tensor stands in for a CUDA one, and without the
        launcher stub it is refused before any launch.  Nothing falls back
        to the loop."""
        x = [torch.from_numpy(a).to("meta") for a in _inputs(39, L=16, d=8)]
        with pytest.raises(ValueError, match="cuda or cpu"):
            ss.selective_scan_fwd(*x, variant="sequential")
        with pytest.raises(ValueError, match="one \\(b, L, d\\) shape"):
            ss.selective_scan_fwd(x[0], x[1][:, :8], *x[2:],
                                  variant="sequential")
        asked = []

        def launch(u, dt, A, B, C, save_states):
            asked.append(save_states)
            raise RuntimeError("no launch")

        monkeypatch.setattr(ss, "_launch_seq", launch)
        monkeypatch.setattr(ss, "_launch_fwd", None)      # never called
        for grad in (False, True):
            x[0].requires_grad_(grad)
            with pytest.raises(RuntimeError, match="no launch"):
                ss.selective_scan_fwd(*x, variant="sequential")
        assert asked == [False, True]

    def test_cpu_tensors_never_reach_the_kernel(self, monkeypatch):
        def no_build(name):
            raise AssertionError(f"kernel {name} loaded for a CPU tensor")

        monkeypatch.setattr(_build, "load", no_build)
        monkeypatch.setattr(_build, "_FNS", {})
        before = dict(_build.KERNEL_LAUNCHES)
        x = _torch(*_inputs(40, L=30, d=8))
        ss.selective_scan_fwd(*x, variant="sequential")
        y, _ = ss.selective_scan_fwd(x[0].requires_grad_(), *x[1:],
                                     variant="sequential")
        y.sum().backward()
        assert torch.isfinite(x[0].grad).all()
        assert _build.KERNEL_LAUNCHES == before
        assert ss.SEQ_LIBRARY in ss.LIBRARIES


_SEQ = _build.header_constants("selective_scan_seq.cu")


class TestLaunchRule:
    @pytest.mark.parametrize("b", [1, 8, 16])
    @pytest.mark.parametrize("d", [128, 256, 512, 1024])
    def test_split_fits_the_kernel_and_covers_every_state(self, b, d):
        """At each MambaFuser d_inner and B = 1, 8, 16: the lanes a channel
        divide its 16 states, the block is one the kernel instantiates (a
        whole number of warps and of lane groups, within its launch
        bounds), and the grid (ceil(d / channels per block), b) gives each
        (row, channel, state) to exactly one lane.  The lane tile is the
        first of SEQ_TILES whose threads reach SEQ_WARP_THREADS for each
        channel a lane."""
        lanes, chans, threads = ss.seq_launch(b, d)
        assert (lanes, chans, threads) in ss.SEQ_SPLITS
        assert ss.D_STATE % lanes == 0 and threads % 32 == 0
        assert threads % lanes == 0 and threads <= _SEQ["SEQ_SM_THREADS"]
        cpb, npt = threads * chans // lanes, ss.D_STATE // lanes
        tid = np.arange(threads)
        covered = np.zeros((b, d, ss.D_STATE), int)
        for row in range(b):                              # blockIdx.y
            for blk in range(-(-d // cpb)):               # blockIdx.x
                for k in range(chans):
                    ch = blk * cpb + (tid // lanes) * chans + k
                    keep = ch < d
                    for j in range(npt):
                        np.add.at(covered, (row, ch[keep],
                                            (tid % lanes)[keep] * npt + j), 1)
        assert (covered == 1).all()
        reach = [t for t in ss.SEQ_TILES
                 if b * d * t[0] // t[1] >= ss.SEQ_WARP_THREADS * t[1]]
        assert (lanes, chans) == (reach[0] if reach else ss.SEQ_TILES[-1])

    def test_constants_come_from_the_kernel_source(self):
        """The splits the rule may pass are the table the C entry dispatches
        to an instantiation (lanes -> NPT = 16 / lanes, channels a lane ->
        NCH, threads -> NT), read from the .cu file, and the launch bounds
        are the ones the rule assumes."""
        src = (_build.CSRC_DIR / "selective_scan_seq.cu").read_text()
        table = re.search(r"constexpr int SEQ_SPLITS\[\]\[3\] = \{(.*?)\};",
                          src, re.S).group(1)
        assert ss.SEQ_SPLITS == tuple(
            tuple(map(int, row)) for row in
            re.findall(r"\{(\d+), (\d+), (\d+)\}", table))
        assert ("launch<T, N / SEQ_SPLITS[I][0], SEQ_SPLITS[I][1],\n"
                "                      SEQ_SPLITS[I][2]>") in src
        assert "__launch_bounds__(NT, SEQ_SM_THREADS / NT)" in src
        assert ss.SEQ_THREADS == tuple(sorted({t for *_, t in ss.SEQ_SPLITS}))
        assert set(ss.SEQ_TILES) == {(n, k) for n, k, _ in ss.SEQ_SPLITS}
        assert ss.D_STATE == 16 and ss.CHUNK % max(ss.SEQ_TILES)[0] == 0

    @pytest.mark.parametrize("split", ss.SEQ_SPLITS,
                             ids=lambda s_: "x".join(map(str, s_)))
    def test_every_instantiated_split_is_picked(self, split):
        """Each split the kernel instantiates is the rule's at some
        MambaFuser d_inner and B = 1, 8, 16: none is built for nothing."""
        assert split in {ss.seq_launch(b, d) for b in (1, 8, 16)
                         for d in (128, 256, 512, 1024)}

    @pytest.mark.parametrize("b,d", [(1, 128), (8, 256), (16, 1024)])
    def test_launcher_passes_the_rules_split(self, monkeypatch, b, d):
        """_launch_seq hands the C entry seq_launch(b, d) after the
        forward's shared arguments (outputs and the launch stubbed)."""
        calls = []
        monkeypatch.setattr(ss, "_fwd_outputs", lambda *a: (None,) * 3)
        monkeypatch.setattr(ss, "_fwd_args", lambda *a: ("args",))
        monkeypatch.setattr(ss, "_launch", lambda *a: calls.append(a))
        u = torch.empty((b, 5, d), device="meta")
        ss._launch_seq(u, u, None, None, None, False)
        assert calls == [("selective_scan_seq", ss.KERNEL_SEQ, u.device,
                          "args", *ss.seq_launch(b, d))]


def test_header_table_reads_a_kernels_table(monkeypatch, tmp_path):
    """_build.header_table: each row of a constexpr int table, whatever
    its spacing; a missing table raises."""
    (tmp_path / "k.cu").write_text(
        "constexpr int X = 3;\nconstexpr int T[][2] = {\n    {1, 2},"
        "{30,4}, { 5 , 60 }};\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert _build.header_table("k.cu", "T") == ((1, 2), (30, 4), (5, 60))
    with pytest.raises(KeyError, match="Y"):
        _build.header_table("k.cu", "Y")


def test_bench_scan_weighs_the_sequential_forward():
    """seq_per_serving_forward_b8_ms and _b1_ms: each shape's sequential
    time times its launches a serving forward (16 at each L = 962 shape,
    3 at L = 5), beside the chunked forward's totals."""
    from deepsense6g_tii_tpu_torch.tools import bench_scan
    ms = {(L_, d): {"bwd": 0.0, "fwd_h_in": 0.0, "fwd": 1.0, "fwd_b1": 0.5,
                    "seq": float(d), "seq_b1": L_ / 1000}
          for L_, d in bench_scan.SHAPES}
    out = bench_scan.weigh(ms)
    assert out["seq_per_serving_forward_b8_ms"] == (
        16 * (128 + 256 + 512 + 1024) + 3 * 1024)
    assert out["seq_per_serving_forward_b1_ms"] == pytest.approx(
        16 * 4 * 0.962 + 3 * 0.005)
    assert out["fwd_per_serving_forward_b8_ms"] == 67
    assert out["fwd_per_serving_forward_b1_ms"] == 33.5
