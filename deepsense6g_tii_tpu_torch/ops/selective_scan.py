"""Selective scan (the Mamba recurrence), forward and backward: hand-written
CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``deepsense6g_tii_tpu/ops/selective_scan.py:58-87,206-294,
297-606,623-702`` (``selective_scan_ref``, ``_fwd_kernel_chunked``,
``_fwd_kernel_chunked_rev``, ``_fwd_kernel_sequential``,
``_scan_fwd_pallas``, ``_bwd_kernel_chunked``, ``_bwd_kernel_chunked_rev``,
``_scan_bwd_pallas``, ``selective_scan`` and its ``custom_vjp``).  Per batch row b, channel d and state n::

    h_t = exp(dt_t * A[d,n]) * h_{t-1} + (dt_t * u_t) * B_t[n]    (h_{-1} = 0)
    y_t = sum_n h_t[d,n] * C_t[n]                                  (+ D*u: caller)

``reverse=True`` runs the recurrence right to left over natural-order
inputs and outputs (``flip(scan(flip(inputs)))``).  u, B and C may be
bfloat16 and are widened to f32; dt and A are f32; y and the final state
are f32.  A is (d, n) or (G, d, n): G parameter groups over equal slices of
the batch.

- ``csrc/selective_scan_fwd.cu`` computes y and the final state, and under
  autograd also the state entering each ``CHUNK``-step chunk (``h_in``).
  It cuts L into groups of chunks that run in parallel
  (:func:`fwd_chunks_per_group` picks the groups for each launch): a state
  pass runs each group from zero, a carry pass gives each group's entry
  state, and the output pass runs each group from it.
- ``csrc/selective_scan_seq.cu`` computes the same, left to right only,
  step by step in one pass over L (``variant="sequential"``, the JAX
  package's cross-check of the chunked forward), a channel's states spread
  over lanes as :func:`seq_launch` splits them for each launch; its
  ``h_in`` feeds the same backward kernel.
- ``csrc/selective_scan_bwd.cu`` runs every chunk on its own: a first pass
  gives each chunk's gradient carry from zero, a carry pass the carry
  entering each chunk, and the main pass recomputes the chunk's states from
  ``h_in`` and runs the gradient back through it, giving du, ddt and
  partial sums of dA, dB and dC, which a last pass adds up in f32 in a
  fixed order.

Each pass has a plain version here (:func:`chunk_local_states_reference`,
:func:`carry_reference`, :func:`chunk_outputs_reference`,
:func:`grad_local_reference`, :func:`bwd_chunk_reference`,
:func:`bwd_sums_reference`), and the plain
passes compose to the plain scan and its backward.  The launch counts tick
once per wrapper call, whatever passes the call runs.

Both take any L and any d (the TPU version needed d % 128 == 0 and padded L
to 128); they need n == 16, the d_state of every configuration of the
repository.  Dispatch rests on the tensors' device alone: a CPU tensor goes
to the plain version, a CUDA tensor to the kernel, or the wrapper raises.
Nothing falls back.  On a CUDA tensor that autograd records,
:func:`selective_scan_fwd` runs :class:`SelectiveScan`, whose backward is
the backward kernel.  Without autograd, the chunked forward is the custom
op ``torch.ops.deepsense6g.selective_scan_fwd`` (:data:`scan_fwd_op`; its
CUDA kernel is :func:`_launch_fwd` without ``h_in``, its CPU kernel
:func:`selective_scan_reference`, its fake implementation allocates what
:func:`_fwd_outputs` allocates), which ``torch.export`` traces.  Importing
this module registers the op and neither builds nor loads a kernel; the
first CUDA call does (ops/_build.py).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import needs_grad

FWD_LIBRARY = "selective_scan_fwd"
BWD_LIBRARY = "selective_scan_bwd"
SEQ_LIBRARY = "selective_scan_seq"
LIBRARIES = (FWD_LIBRARY, BWD_LIBRARY, SEQ_LIBRARY)
# launch counts, one name per kernel and direction
KERNEL = "selective_scan_fwd"
KERNEL_REV = "selective_scan_fwd_rev"
KERNEL_SEQ = "selective_scan_seq"
KERNEL_BWD = "selective_scan_bwd"
KERNEL_BWD_REV = "selective_scan_bwd_rev"
# the device kernels of csrc/selective_scan_*.cu -> their wrappers' KERNEL
# names, as flash_attention.DEVICE_KERNELS states them
DEVICE_KERNELS = {
    "scan_fwd_kernel": (KERNEL, KERNEL_REV),
    "scan_carry_kernel": (KERNEL, KERNEL_REV, KERNEL_BWD, KERNEL_BWD_REV),
    "scan_seq_kernel": (KERNEL_SEQ,),
    "scan_bwd_local_kernel": (KERNEL_BWD, KERNEL_BWD_REV),
    "scan_bwd_kernel": (KERNEL_BWD, KERNEL_BWD_REV),
    "scan_bwd_sums_kernel": (KERNEL_BWD, KERNEL_BWD_REV),
}
DEVICE_KERNEL_FLAGS = {"scan_fwd_kernel": (1, "REV"),
                       "scan_bwd_local_kernel": (1, "REV"),
                       "scan_bwd_kernel": (1, "REV")}
# the kernels' layout, as csrc/selective_scan.cuh states it: the states per
# channel, the steps per chunk-entry state h_in, and the channels per block
# of the backward's dB/dC partials; and the forward's channels per block
_LAYOUT = _build.header_constants("selective_scan.cuh")
D_STATE = _LAYOUT["N"]
CHUNK = _LAYOUT["TL"]
CHANNELS_PER_BLOCK = _LAYOUT["DT"]
FWD_CHANNELS_PER_BLOCK = _build.header_constants("selective_scan_fwd.cu")[
    "FCH"]
_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("chunked", "sequential")
# The forward's split of L (csrc/selective_scan_fwd.cu): about two blocks
# of the output pass for each of an H100's 132 SMs, and no split at all
# when fewer than FWD_MIN_GROUPS groups would be needed for that, since the
# state pass computes every exponential a second time.  Chosen from timings
# of every split at each of the MambaFuser's shapes (PERF.md).
FWD_TARGET_BLOCKS = 2 * 132
FWD_MIN_GROUPS = 4
# The sequential forward's launch splits (lanes per channel, channels a
# lane, threads per block): the table of the ones csrc/selective_scan_seq.cu
# instantiates, which are those seq_launch can pick.  seq_launch takes the
# lane tile of SEQ_TILES with the fewest shared-memory bytes a state and
# step whose threads still reach SEQ_WARP_THREADS for each channel a lane.
# 2^14 is the threshold that timings of every lane split at the
# MambaFuser's shapes and B = 1, 8, 16 chose on an NVIDIA H100 80GB HBM3
# (PERF.md); SEQ_SMS is that card's SM count, which the rule was fitted to.
SEQ_SPLITS = _build.header_table("selective_scan_seq.cu", "SEQ_SPLITS")
SEQ_THREADS = tuple(sorted({t for _, _, t in SEQ_SPLITS}))
SEQ_SMS = 132
SEQ_WARP_THREADS = 1 << 14
# lane tiles (lanes per channel, channels a lane), from the fewest bytes a
# state and step (8 / channels for B and C, 16 / states a lane for dt,
# dt*u and the y partials) to the most threads
SEQ_TILES = ((4, 2), (4, 1), (8, 1), (16, 1))


def num_chunks(L: int) -> int:
    return -(-L // CHUNK)


def fwd_chunks_per_group(b: int, L: int, d: int) -> int:
    """Chunks per group G of the forward kernel for a (b, L, d) launch.
    The groups run in parallel, S = ceil(n_chunks / G) of them giving
    b·S·ceil(d / FWD_CHANNELS_PER_BLOCK) blocks: as many groups as
    FWD_TARGET_BLOCKS asks for, up to one a chunk, or n_chunks (one group,
    no split) where fewer than FWD_MIN_GROUPS would be needed."""
    nc = num_chunks(L)
    want = -(-FWD_TARGET_BLOCKS // (b * -(-d // FWD_CHANNELS_PER_BLOCK)))
    if want < FWD_MIN_GROUPS:
        return nc
    return -(-nc // min(want, nc))


def seq_launch(b: int, d: int) -> tuple:
    """(lanes per channel, channels a lane, threads per block) of a
    sequential forward launch over b·d channels: the first lane tile of
    SEQ_TILES whose b·d·lanes / channels threads reach SEQ_WARP_THREADS
    times its channels a lane (the last tile where none does), in blocks of
    the fewest threads of SEQ_THREADS where those blocks still fit one an
    SM, else of the most.  The grid is (ceil(d / (threads · channels /
    lanes)), b)."""
    lanes, channels = next(
        (tile for tile in SEQ_TILES
         if b * d * tile[0] // tile[1] >= SEQ_WARP_THREADS * tile[1]),
        SEQ_TILES[-1])
    threads = SEQ_THREADS[0]
    if b * -(-d // (threads * channels // lanes)) > SEQ_SMS:
        threads = SEQ_THREADS[-1]
    return lanes, channels, threads


def fwd_groups(L: int, chunks_per_group: int) -> int:
    """The number of chunk groups S of a forward launch."""
    return -(-num_chunks(L) // chunks_per_group)


# -- plain versions -----------------------------------------------------------

def _widen(u, dt, A, B, C):
    """The inputs in f32 (f64 for f64 u), A as (d, n) or, grouped, one
    (1, d, n) row per batch row: (b, 1, d, n)."""
    ct = torch.float64 if u.dtype == torch.float64 else torch.float32
    u, dt, A, B, C = (x.to(ct) for x in (u, dt, A, B, C))
    if A.dim() == 3:
        A = A.repeat_interleave(u.shape[0] // A.shape[0], dim=0)[:, None]
    return u, dt, A, B, C


def _doubling_scan(a, x):
    """All states of h_t = a_t * h_{t-1} + x_t over dim 1 (h_{-1} = 0) by
    a doubling (Hillis-Steele) scan; a_0 is never used."""
    L, s = x.shape[1], 1
    while s < L:
        x = torch.cat([x[:, :s], torch.addcmul(x[:, s:], a[:, s:],
                                               x[:, :-s])], dim=1)
        if 2 * s < L:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return x


def _states(u, dt, A, B, C):
    """The widened inputs, the decays a_t and all states h_t (b, L, d, n)
    of the left-to-right scan."""
    u, dt, A, B, C = _widen(u, dt, A, B, C)
    a = torch.exp(dt[..., None] * A)                   # (b, L, d, n)
    h = _doubling_scan(a, (dt * u)[..., None] * B[:, :, None, :])
    return (u, dt, A, B, C), a, h


def selective_scan_reference(u, dt, A, B, C, reverse: bool = False):
    """Plain version: a doubling scan over L on (b, L, d, n) tensors in f32
    (f64 for f64 input), like the JAX package's associative-scan
    ``selective_scan_ref``.

    u, dt: (b, L, d); A: (d, n) or (G, d, n); B, C: (b, L, n).  Returns
    (y (b, L, d), h_out (b, n, d)), h_out being the state after the last
    step of the scan (position L-1, or 0 when ``reverse``)."""
    if reverse:
        y, h_out = selective_scan_reference(u.flip(1), dt.flip(1), A,
                                            B.flip(1), C.flip(1))
        return y.flip(1), h_out
    (_, _, _, _, C), _, h = _states(u, dt, A, B, C)
    y = torch.einsum("bldn,bln->bld", h, C)
    return y, h[:, -1].transpose(1, 2).contiguous()


def chunk_states_reference(u, dt, A, B, C, reverse: bool = False):
    """Plain version of the forward kernel's ``h_in``: the state entering
    each ``CHUNK``-step chunk in the scan's direction, (b, n_chunks, n, d)
    f32.  Chunk c covers steps [c·CHUNK, (c+1)·CHUNK) forwards; reverse
    chunks are aligned to the end of the sequence instead (chunk c ends at
    L − (n_chunks − 1 − c)·CHUNK), and their state enters from the right."""
    if reverse:
        return chunk_states_reference(u.flip(1), dt.flip(1), A, B.flip(1),
                                      C.flip(1)).flip(1)
    _, _, h = _states(u, dt, A, B, C)
    ends = list(range(CHUNK - 1, h.shape[1] - 1, CHUNK))
    h_in = torch.cat([torch.zeros_like(h[:, :1]), h[:, ends]], dim=1)
    return h_in.transpose(2, 3).contiguous()


def _wide(*xs):
    """The tensors in f32, or f64 when the first is f64."""
    ct = torch.float64 if xs[0].dtype == torch.float64 else torch.float32
    return [x.to(ct) for x in xs]


def _rows_A(A, b):
    """A as one (d, n) matrix per batch row: (b, d, n)."""
    if A.dim() == 2:
        return A.expand(b, *A.shape)
    return A.repeat_interleave(b // A.shape[0], dim=0)


def _to_scan(x, reverse: bool, front: int, total: int):
    """(b, L, ...) in the scan's order (flipped for ``reverse``), with
    ``front`` zero steps before it and zeros after it up to ``total``
    steps.  Zero steps (dt = 0, u = 0, dy = 0, B = C = 0) leave a state or
    a gradient carry as it is."""
    x = x.flip(1) if reverse else x
    pad = [0, 0] * (x.dim() - 2) + [front, total - front - x.shape[1]]
    return torch.nn.functional.pad(x, pad)


def _from_scan(x, reverse: bool, front: int, L: int):
    """The inverse of :func:`_to_scan` for a (b, total, ...) tensor."""
    x = x[:, front:front + L]
    return x.flip(1) if reverse else x


def _run(dt, dtu, A, B, h0):
    """All states (r, T, d, n) of h_t = a_t h_{t-1} + dtu_t B_t from the
    state h0 (r, d, n) by a doubling scan, and the decays a_t; dt, dtu
    (r, T, d), A (r, d, n), B (r, T, n)."""
    a = torch.exp(dt[..., None] * A[:, None])
    x = dtu[..., None] * B[:, :, None, :]
    h = _doubling_scan(torch.cat([torch.ones_like(a[:, :1]), a], 1),
                       torch.cat([h0[:, None], x], 1))[:, 1:]
    return a, h


def _grouped(u, dt, A, B, C, reverse, chunks_per_group):
    """The widened inputs in the scan's order, cut into the forward
    kernel's groups of chunks: (b·S, G·CHUNK, ...) each, group-major in the
    scan's order, A per row (b·S, d, n); with S, the steps of padding in
    front, and the natural index of each scanned group."""
    b, L, d = u.shape
    nc = num_chunks(L)
    G = min(chunks_per_group, nc)
    S = -(-nc // G)
    # the reverse direction's short group is its first (natural group S-1)
    front = (S * G - nc) * CHUNK if reverse else 0
    u, dt, B, C = _wide(u, dt, B, C)
    Ar = _rows_A(A.to(u.dtype), b).repeat_interleave(S, 0)
    cut = [_to_scan(x, reverse, front, S * G * CHUNK).reshape(
        b * S, G * CHUNK, *x.shape[2:]) for x in (u, dt, B, C)]
    order = list(range(S - 1, -1, -1)) if reverse else list(range(S))
    return (*cut, Ar), S, front, order


def chunk_local_states_reference(u, dt, A, B, C, reverse: bool = False,
                                 chunks_per_group: int = 1):
    """Plain version of the forward kernel's state pass: each group of
    ``chunks_per_group`` chunks scanned from a zero state.  Returns its end
    state (b, S, n, d) and its dt sum (b, S, d), groups in natural order
    (group s holds chunks [s·G, (s+1)·G))."""
    b = u.shape[0]
    (uc, dtc, Bc, _, Ar), S, _, order = _grouped(u, dt, A, B, C, reverse,
                                                 chunks_per_group)
    _, h = _run(dtc, dtc * uc, Ar, Bc, torch.zeros_like(Ar))
    loc = h[:, -1].transpose(1, 2).reshape(b, S, D_STATE, -1)
    sdt = dtc.sum(1).reshape(b, S, -1)
    return loc[:, order], sdt[:, order]


def carry_reference(loc, sdt, A, ascending: bool = True):
    """Plain version of the carry pass: with segments visited in order
    (from the first up, or from the last down), the carry entering each,
    out[s] = H, then H = exp(A·sdt[s])·H + loc[s], from H = 0.  loc and
    out (b, S, n, d), sdt (b, S, d), A (d, n) or (G, d, n)."""
    At = _rows_A(A.to(loc.dtype), loc.shape[0]).transpose(1, 2)
    out = torch.empty_like(loc)
    h = torch.zeros_like(loc[:, 0])
    S = loc.shape[1]
    for s in (range(S) if ascending else range(S - 1, -1, -1)):
        out[:, s] = h
        h = torch.exp(At * sdt[:, s, None]) * h + loc[:, s]
    return out


def chunk_outputs_reference(u, dt, A, B, C, h_start=None,
                            reverse: bool = False,
                            chunks_per_group: int | None = None):
    """Plain version of the forward kernel's output pass: each group of
    chunks scanned from its entry state ``h_start`` (b, S, n, d), or from
    zero for one group (``chunks_per_group`` None: all chunks).  Returns
    (y (b, L, d), h_out (b, n, d), h_in (b, n_chunks, n, d)) as the kernel
    writes them."""
    b, L, d = u.shape
    G = num_chunks(L) if chunks_per_group is None else chunks_per_group
    (uc, dtc, Bc, Cc, Ar), S, front, order = _grouped(u, dt, A, B, C,
                                                      reverse, G)
    h0 = (torch.zeros_like(Ar) if h_start is None else
          h_start[:, order].to(uc.dtype).transpose(2, 3).reshape(b * S, d,
                                                                 D_STATE))
    _, h = _run(dtc, dtc * uc, Ar, Bc, h0)
    y = torch.einsum("rtdn,rtn->rtd", h, Cc).reshape(b, -1, d)
    # the state before each chunk's first step, in the scan's order
    before = torch.cat([h0[:, None], h[:, :-1]], 1)[:, ::CHUNK]
    h_in = before.reshape(b, -1, d, D_STATE)[
        :, front // CHUNK:front // CHUNK + num_chunks(L)]
    h_in = (h_in.flip(1) if reverse else h_in).transpose(2, 3)
    return (_from_scan(y, reverse, front, L),
            h[:, -1].reshape(b, S, d, D_STATE)[:, -1].transpose(1, 2)
            .contiguous(), h_in.contiguous())


def chunked_fwd_reference(u, dt, A, B, C, reverse: bool = False,
                          chunks_per_group: int = 1, save_states=True):
    """The forward kernel's passes in their plain versions, composed as
    the kernel runs them: (y, h_out, h_in), h_in None unless
    ``save_states``."""
    h_start = None
    if fwd_groups(u.shape[1], chunks_per_group) > 1:
        loc, sdt = chunk_local_states_reference(u, dt, A, B, C, reverse,
                                                chunks_per_group)
        h_start = carry_reference(loc, sdt, A, ascending=not reverse)
    y, h_out, h_in = chunk_outputs_reference(u, dt, A, B, C, h_start,
                                             reverse, chunks_per_group)
    return y, h_out, h_in if save_states else None


def grad_local_reference(dt, A, C, dy, reverse: bool = False):
    """Plain version of the backward's first pass: each chunk's gradient
    recurrence g_t = C_t dy_t + p_{t+1}, p_t = a_t g_t run against the scan
    from p = 0 at the chunk's exit.  Returns the p leaving the chunk
    (b, n_chunks, n, d), sum over its steps t of exp(A·Σ_{s≤t} dt_s)·C_t
    dy_t in the scan's order, and the chunk's dt sum (b, n_chunks, d)."""
    b, L, d = dt.shape
    nc = num_chunks(L)
    dt, C, dy = _wide(dt, C, dy)
    ct = dt.dtype
    dt, C, dy = (_to_scan(x, reverse, 0, nc * CHUNK).reshape(
        b, nc, CHUNK, *x.shape[2:]) for x in (dt, C, dy))
    At = _rows_A(A.to(ct), b)[:, None, None]          # (b, 1, 1, d, n)
    decay = torch.exp(At * dt.cumsum(2)[..., None])   # (b, nc, T, d, n)
    p = (decay * dy[..., None] * C[..., None, :]).sum(2)
    sdt = dt.sum(2)
    if reverse:
        p, sdt = p.flip(1), sdt.flip(1)
    return p.transpose(2, 3).contiguous(), sdt


def bwd_chunk_reference(u, dt, A, B, C, dy, h_in, p_in=None,
                        reverse: bool = False):
    """Plain version of the backward's main pass: every chunk on its own
    from its entry state ``h_in`` and gradient carry ``p_in`` (b, n_chunks,
    n, d), or zero.  Returns du (f32), ddt and the partial sums the kernel
    writes: dB and dC per CHANNELS_PER_BLOCK channels (b, ceil(d / DT), L,
    n) and dA per chunk (b, n_chunks, d, n), f32 (f64 for f64 input)."""
    b, L, d = u.shape
    nc = num_chunks(L)
    total = nc * CHUNK
    uw, dtw, Bw, Cw = _wide(u, dt, B, C)
    ct = uw.dtype
    u_, dt_, B_, C_, dy_ = (_to_scan(x, reverse, 0, total).reshape(
        b * nc, CHUNK, *x.shape[2:]) for x in (uw, dtw, Bw, Cw, dy.to(ct)))
    Ar = _rows_A(A.to(ct), b).repeat_interleave(nc, 0)

    def chunks(x):      # (b, nc, n, d) in natural order -> (b·nc, d, n)
        x = x.flip(1) if reverse else x
        return x.to(ct).transpose(2, 3).reshape(b * nc, d, D_STATE)

    h0 = chunks(h_in)
    a, h = _run(dt_, dt_ * u_, Ar, B_, h0)
    ah = a * torch.cat([h0[:, None], h[:, :-1]], 1)
    # g against the scan, entering from p_in: a scan of the flipped chunk
    # after a first step that holds p_in (decays shifted by one)
    q = dy_[..., None] * C_[:, :, None, :]
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], 1)
    p0 = torch.zeros_like(h0) if p_in is None else chunks(p_in)
    g = _doubling_scan(
        torch.cat([torch.ones_like(a[:, :1]), a_next.flip(1)], 1),
        torch.cat([p0[:, None], q.flip(1)], 1))[:, 1:].flip(1)
    gb = (g * B_[:, :, None, :]).sum(-1)
    gah = g * ah
    du = dt_ * gb
    ddt = u_ * gb + (gah * Ar[:, None]).sum(-1)
    nd = -(-d // CHANNELS_PER_BLOCK)
    pad = [0, 0, 0, nd * CHANNELS_PER_BLOCK - d]

    def per_block(x):   # (b·nc, T, d, n) -> (b, nd, L, n), natural order
        x = torch.nn.functional.pad(x, pad).reshape(
            b, total, nd, CHANNELS_PER_BLOCK, D_STATE).sum(3)
        return _from_scan(x, reverse, 0, L).transpose(1, 2).contiguous()

    db_part = per_block(g * (dt_ * u_)[..., None])
    dc_part = per_block(h * dy_[..., None])
    da_part = (gah * dt_[..., None]).sum(1).reshape(b, nc, d, D_STATE)
    if reverse:
        da_part = da_part.flip(1)
    out = [_from_scan(x.reshape(b, total, d), reverse, 0, L)
           for x in (du, ddt)]
    return (*out, db_part, dc_part, da_part.contiguous())


def bwd_sums_reference(A, B, C, db_part, dc_part, da_part):
    """Plain version of the backward's sums: dA (A's shape), dB and dC
    (b, L, n) in B's dtype from the main pass's partials, in f32 (f64 for
    f64 partials): over the channel blocks, and over the chunks and the
    rows of each parameter group; dB and dC rounded once."""
    groups = A.shape[0] if A.dim() == 3 else 1
    b, _, d, n = da_part.shape
    dA = da_part.sum(1).view(groups, b // groups, d, n).sum(1)
    return (dA if A.dim() == 3 else dA[0], db_part.sum(1).to(B.dtype),
            dc_part.sum(1).to(C.dtype))


def chunked_bwd_reference(u, dt, A, B, C, dy, reverse: bool = False):
    """The backward kernel's passes in their plain versions, composed as
    the kernel runs them, from the forward's plain h_in: (du, ddt, dA, dB,
    dC) as :func:`selective_scan_bwd` returns them."""
    h_in = chunk_states_reference(u, dt, A, B, C, reverse)
    p_in = None
    if num_chunks(u.shape[1]) > 1:
        p_loc, sdt = grad_local_reference(dt, A, C, dy, reverse)
        p_in = carry_reference(p_loc, sdt, A, ascending=reverse)
    du, ddt, db_part, dc_part, da_part = bwd_chunk_reference(
        u, dt, A, B, C, dy, h_in, p_in, reverse)
    return (du.to(u.dtype), ddt, *bwd_sums_reference(A, B, C, db_part,
                                                     dc_part, da_part))


def selective_scan_sequential_reference(u, dt, A, B, C):
    """Plain version of the sequential kernel: a loop over the time steps
    on (b, d, n) states in f32 (f64 for f64 input), as the JAX package's
    ``_fwd_kernel_sequential`` walks them; independent of the doubling scan
    of :func:`selective_scan_reference`.  Left to right only.

    Returns (y (b, L, d), h_out (b, n, d), h_in (b, n_chunks, n, d)),
    h_in being the state entering each ``CHUNK``-step chunk, as
    :func:`chunk_states_reference` gives it."""
    u, dt, A, B, C = _widen(u, dt, A, B, C)
    if A.dim() == 4:
        A = A[:, 0]                                    # (b, d, n)
    h = u.new_zeros(u.shape[0], u.shape[2], A.shape[-1])
    ys, h_in = [], []
    for t in range(u.shape[1]):
        if t % CHUNK == 0:
            h_in.append(h)
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :])
        ys.append((h * C[:, t, None, :]).sum(-1))
    return (torch.stack(ys, 1), h.transpose(1, 2).contiguous(),
            torch.stack(h_in, 1).transpose(2, 3).contiguous())


def selective_scan_bwd_reference(u, dt, A, B, C, dy, reverse: bool = False):
    """Plain backward: the gradients (du, ddt, dA, dB, dC) of the scan's y
    for an output gradient ``dy``, by the formulas of the backward kernel
    (``csrc/selective_scan_bwd.cu``) on (b, L, d, n) tensors in f32 (f64
    for f64 input): states h_t by the doubling scan, ah_t = a_t·h_{t−1},
    and the gradient recurrence g_t = C_t·dy_t + a_{t+1}·g_{t+1} by a
    doubling scan over the flipped sequence; then

        du = dt Σ_n g B,  ddt = u Σ_n g B + Σ_n g·ah·A,
        dB = Σ_d g·dt·u,  dC = Σ_d h·dy,  dA = Σ_{b in group, t} g·ah·dt.

    du comes in u's dtype, ddt and dA in f32, dB and dC in B's dtype,
    rounded once from f32 sums (``_bwd_rule``)."""
    if reverse:
        du, ddt, dA, dB, dC = selective_scan_bwd_reference(
            u.flip(1), dt.flip(1), A, B.flip(1), C.flip(1), dy.flip(1))
        return du.flip(1), ddt.flip(1), dA, dB.flip(1), dC.flip(1)
    (uw, dtw, Aw, Bw, Cw), a, h = _states(u, dt, A, B, C)
    dy = dy.to(uw.dtype)
    ah = a * torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    q = dy[..., None] * Cw[:, :, None, :]
    # g_{L-1-s} = a_{L-s} g_{L-s} + q_{L-1-s}: a left-to-right scan of the
    # flipped sequence with the decays shifted by one
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    g = _doubling_scan(a_next.flip(1), q.flip(1)).flip(1)
    gb = (g * Bw[:, :, None, :]).sum(-1)
    gah = g * ah
    du = dtw * gb
    ddt = uw * gb + (gah * Aw).sum(-1)
    dB = (g * (dtw * uw)[..., None]).sum(2)
    dC = (h * dy[..., None]).sum(2)
    dA = (gah * dtw[..., None]).sum(1)                 # (b, d, n)
    dA = (dA.view(A.shape[0], -1, *dA.shape[1:]).sum(1) if A.dim() == 3
          else dA.sum(0))
    return du.to(u.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype)


# -- kernels -----------------------------------------------------------------

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "selective_scan_fwd": (FWD_LIBRARY, [_PTR] * 8 + [_INT] * 5 + [_LL] * 2
                           + [_INT] * 2 + [_PTR, _INT, _PTR]),
    "selective_scan_bwd": (BWD_LIBRARY, [_PTR] * 16 + [_INT] * 5 + [_LL] * 2
                           + [_INT] * 2 + [_PTR]),
    "selective_scan_seq": (SEQ_LIBRARY, [_PTR] * 8 + [_INT] * 5 + [_LL] * 2
                           + [_INT] * 4 + [_PTR]),
}


def _launch(fname: str, count_as: str, device, *args) -> None:
    library, argtypes = _SIGNATURES[fname]
    _build.launch(library, fname, argtypes, count_as, device, *args)


def _check_kernel_inputs(u, dt, A, B, C):
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"selective scan takes u and dt of one (b, L, d) "
                         f"shape, got {tuple(u.shape)}, {tuple(dt.shape)}")
    b, L, d = u.shape
    if B.shape != (b, L, D_STATE) or C.shape != B.shape:
        raise ValueError(f"selective scan kernel takes B and C of shape "
                         f"(b, L, {D_STATE}) = {(b, L, D_STATE)}, got "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if A.shape[-2:] != (d, D_STATE) or A.dim() not in (2, 3) or (
            A.dim() == 3 and (A.shape[0] == 0 or b % A.shape[0])):
        raise ValueError(f"selective scan kernel takes A of shape (d, n) or "
                         f"(G, d, n) with G dividing the batch {b}, got "
                         f"{tuple(A.shape)}")
    if u.dtype not in _DTYPES or B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError(f"selective scan kernel takes u, B, C of one dtype, "
                        f"float32 or bfloat16, got {u.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"selective scan kernel takes float32 dt and A, got "
                        f"{dt.dtype}, {A.dtype}")
    if b == 0 or L == 0 or d == 0 or b > 65535:
        raise ValueError(f"selective scan kernel takes 0 < b <= 65535, "
                         f"0 < L, 0 < d, got {tuple(u.shape)}")
    for name, x in (("u", u), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if x.device != u.device:
            raise ValueError("u, dt, A, B and C must lie on one device")
        if name in ("u", "dt", "A") and not x.is_contiguous():
            raise ValueError(f"selective scan kernel takes a contiguous "
                             f"{name}")
    if B.stride() != C.stride() or B.stride(2) != 1:
        raise ValueError(f"selective scan kernel takes B and C with equal "
                         f"strides and unit stride over n, got {B.stride()}, "
                         f"{C.stride()}")


def _check_bwd_inputs(u, dt, A, B, C, dy, h_in):
    _check_kernel_inputs(u, dt, A, B, C)
    b, L, d = u.shape
    for name, x, shape in (("dy", dy, (b, L, d)),
                           ("h_in", h_in, (b, num_chunks(L), D_STATE, d))):
        if (x.shape != shape or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != u.device):
            raise ValueError(f"selective scan backward takes a contiguous "
                             f"float32 {name} of shape {shape} on "
                             f"{u.device}, got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")


def _cuda(u):
    if u.device.type != "cuda":
        raise ValueError(f"selective scan runs on cuda or cpu tensors, got "
                         f"{u.device}")


def _fwd_outputs(u, dt, A, B, C, save_states: bool):
    """The forward kernels' checks and outputs: y, h_out and, when
    ``save_states``, h_in (else None), f32 on u's device."""
    _check_kernel_inputs(u, dt, A, B, C)
    _cuda(u)
    b, L, d = u.shape
    y = torch.empty((b, L, d), dtype=torch.float32, device=u.device)
    h_out = torch.empty((b, D_STATE, d), dtype=torch.float32, device=u.device)
    h_in = (torch.empty((b, num_chunks(L), D_STATE, d), dtype=torch.float32,
                        device=u.device) if save_states else None)
    return y, h_out, h_in


def _fwd_args(u, dt, A, B, C, y, h_out, h_in):
    """The arguments the forward kernels share, in their C order up to
    is_bf16."""
    b, L, d = u.shape
    return (u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            None if h_in is None else h_in.data_ptr(), b, L, d, D_STATE,
            A.shape[0] if A.dim() == 3 else 1, B.stride(0), B.stride(1),
            int(u.dtype == torch.bfloat16))


def _scratch(n_segments: int, b: int, d: int, device):
    """The f32 scratch of a forward or backward launch over ``n_segments``
    chunks or groups of chunks: two (b, n_segments, n, d) carries and a
    (b, n_segments, d) dt sum in one buffer (None for one segment)."""
    if n_segments < 2:
        return None
    return torch.empty((2 * D_STATE + 1) * b * n_segments * d,
                       dtype=torch.float32, device=device)


def _fwd_kernel(u, dt, A, B, C, y, h_out, h_in, scratch, chunks_per_group,
                reverse):
    """One call of the forward kernel's C entry (its passes), counted as
    one launch."""
    _launch("selective_scan_fwd", KERNEL_REV if reverse else KERNEL,
            u.device, *_fwd_args(u, dt, A, B, C, y, h_out, h_in),
            int(reverse), None if scratch is None else scratch.data_ptr(),
            chunks_per_group)


def _launch_fwd(u, dt, A, B, C, reverse: bool, save_states: bool,
                chunks_per_group: int | None = None):
    """The forward kernel: (y, h_out, h_in), h_in (b, n_chunks, n, d) f32
    when ``save_states``, else None (and not written).  The chunks run in
    groups of ``chunks_per_group``, by default :func:`fwd_chunks_per_group`
    of the launch's shape."""
    y, h_out, h_in = _fwd_outputs(u, dt, A, B, C, save_states)
    b, L, d = u.shape
    G = (fwd_chunks_per_group(b, L, d) if chunks_per_group is None
         else min(chunks_per_group, num_chunks(L)))
    _fwd_kernel(u, dt, A, B, C, y, h_out, h_in,
                _scratch(fwd_groups(L, G), b, d, u.device), G, reverse)
    return y, h_out, h_in


def _launch_seq(u, dt, A, B, C, save_states: bool):
    """The sequential forward kernel: (y, h_out, h_in) as
    :func:`_launch_fwd` gives them, left to right, in the launch split of
    :func:`seq_launch`."""
    b, _, d = u.shape
    y, h_out, h_in = _fwd_outputs(u, dt, A, B, C, save_states)
    _launch("selective_scan_seq", KERNEL_SEQ, u.device,
            *_fwd_args(u, dt, A, B, C, y, h_out, h_in),
            *seq_launch(b, d))
    return y, h_out, h_in


def selective_scan_bwd(u, dt, A, B, C, dy, h_in, *, reverse: bool = False):
    """Gradients (du, ddt, dA, dB, dC) of the scan's y for an output
    gradient ``dy`` (b, L, d) f32: du in u's dtype, ddt and dA (A's shape)
    in f32, dB and dC (b, L, n) in B's dtype.  ``h_in`` is the forward
    kernel's chunk-entry states.  A CPU tensor takes
    :func:`selective_scan_bwd_reference` (which needs no ``h_in``)."""
    if u.device.type == "cpu":
        return selective_scan_bwd_reference(u, dt, A, B, C, dy, reverse)
    _check_bwd_inputs(u, dt, A, B, C, dy, h_in)
    _cuda(u)
    return _kernel_bwd(u, dt, A, B, C, dy, h_in, reverse)


def _kernel_bwd(u, dt, A, B, C, dy, h_in, reverse):
    """The backward kernel's outputs, partial sums and scratch, and its
    launch: (du, ddt, dA, dB, dC)."""
    b, L, d = u.shape
    dev = u.device
    nd = -(-d // CHANNELS_PER_BLOCK)
    groups = A.shape[0] if A.dim() == 3 else 1
    du = torch.empty_like(u)
    ddt = torch.empty((b, L, d), dtype=torch.float32, device=dev)
    dA = torch.empty((groups, d, D_STATE), dtype=torch.float32, device=dev)
    dB, dC = (torch.empty((b, L, D_STATE), dtype=B.dtype, device=dev)
              for _ in range(2))
    db_part, dc_part = (torch.empty((b, nd, L, D_STATE), dtype=torch.float32,
                                    device=dev) for _ in range(2))
    da_part = torch.empty((b, num_chunks(L), d, D_STATE), dtype=torch.float32,
                          device=dev)
    _bwd_kernel(u, dt, A, B, C, dy, h_in, du, ddt, db_part, dc_part, da_part,
                dA, dB, dC, _scratch(num_chunks(L), b, d, dev), reverse)
    return du, ddt, dA if A.dim() == 3 else dA[0], dB, dC


def _bwd_kernel(u, dt, A, B, C, dy, h_in, du, ddt, db_part, dc_part, da_part,
                dA, dB, dC, scratch, reverse):
    """One call of the backward kernel's C entry (its passes), counted as
    one launch."""
    _launch("selective_scan_bwd", KERNEL_BWD_REV if reverse else KERNEL_BWD,
            u.device, u.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), dy.data_ptr(), h_in.data_ptr(),
            du.data_ptr(), ddt.data_ptr(), db_part.data_ptr(),
            dc_part.data_ptr(), da_part.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(),
            None if scratch is None else scratch.data_ptr(), u.shape[0],
            u.shape[1], u.shape[2], D_STATE,
            A.shape[0] if A.dim() == 3 else 1, B.stride(0), B.stride(1),
            int(u.dtype == torch.bfloat16), int(reverse))


class SelectiveScan(torch.autograd.Function):
    """The scan with its backward: the forward kernel (the chunked one, or
    the sequential one for ``variant="sequential"``) also writes the
    chunk-entry states, which the backward kernel reads with u, dt, A, B
    and C; the backward is the chunked kernel for either variant, as in the
    JAX package.  Returns (y, h_out); h_out takes no gradient."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, reverse, variant="chunked"):
        if variant == "sequential":
            y, h_out, h_in = _launch_seq(u, dt, A, B, C, True)
        else:
            y, h_out, h_in = _launch_fwd(u, dt, A, B, C, reverse, True)
        ctx.save_for_backward(u, dt, A, B, C, h_in)
        ctx.reverse = reverse
        ctx.mark_non_differentiable(h_out)
        return y, h_out

    @staticmethod
    def backward(ctx, dy, _dh_out):
        u, dt, A, B, C, h_in = ctx.saved_tensors
        grads = selective_scan_bwd(u, dt, A, B, C, dy.contiguous(), h_in,
                                   reverse=ctx.reverse)
        # None for reverse and variant (torch drops a trailing None that has
        # no input)
        return (*grads, None, None)


def _scan_fwd_cuda(u, dt, A, B, C, reverse):
    """The CUDA kernel of :data:`scan_fwd_op`: the forward kernel without
    the chunk-entry states."""
    return _launch_fwd(u, dt, A, B, C, reverse, False)[:2]


OP_NAME = "selective_scan_fwd"
scan_fwd_op = torch.library.custom_op(
    f"{_build.OP_NAMESPACE}::{OP_NAME}", _scan_fwd_cuda,
    mutates_args=(), device_types="cuda",
    schema="(Tensor u, Tensor dt, Tensor A, Tensor B, Tensor C, "
           "bool reverse) -> (Tensor, Tensor)")


@scan_fwd_op.register_kernel("cpu")
def _scan_fwd_cpu(u, dt, A, B, C, reverse):
    y, h_out = selective_scan_reference(u, dt, A, B, C, reverse)
    return y.contiguous(), h_out


@scan_fwd_op.register_fake
def _scan_fwd_fake(u, dt, A, B, C, reverse):
    b, L, d = u.shape
    ct = torch.float64 if u.dtype == torch.float64 else torch.float32
    return (u.new_empty((b, L, d), dtype=ct),
            u.new_empty((b, D_STATE, d), dtype=ct))


def selective_scan_fwd(u, dt, A, B, C, *, reverse: bool = False,
                       variant: str = "chunked"):
    """y (b, L, d) f32 and the final state h_out (b, n, d) f32 of the
    selective scan; see the module docstring for the contract.
    ``variant="sequential"`` runs the step-by-step kernel (the plain loop
    :func:`selective_scan_sequential_reference` on the CPU), left to right
    only: with ``reverse=True`` it raises ``ValueError``, as the JAX
    package does.  Differentiable in u, dt, A, B and C on either device;
    without an input that requires grad (or under ``torch.no_grad()``) the
    chunked variant is :data:`scan_fwd_op`."""
    if variant not in VARIANTS:
        raise ValueError(f"selective scan variant must be one of {VARIANTS}, "
                         f"got {variant!r}")
    if reverse and variant != "chunked":
        raise ValueError("reverse scan supports only variant='chunked'")
    grad = needs_grad(u, dt, A, B, C)
    if u.device.type == "cpu" and (grad or variant == "sequential"):
        if variant == "sequential":
            return selective_scan_sequential_reference(u, dt, A, B, C)[:2]
        return selective_scan_reference(u, dt, A, B, C, reverse)
    if grad:
        return SelectiveScan.apply(u, dt, A, B, C, bool(reverse), variant)
    if variant == "sequential":
        return _launch_seq(u, dt, A, B, C, False)[:2]
    if u.device.type in ("cpu", "cuda"):
        return scan_fwd_op(u, dt, A, B, C, bool(reverse))
    # no kernel serves another device: the launcher's checks refuse it
    return _launch_fwd(u, dt, A, B, C, reverse, False)[:2]
