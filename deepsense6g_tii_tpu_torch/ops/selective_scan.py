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
- ``csrc/selective_scan_seq.cu`` computes the same, left to right only,
  step by step (``variant="sequential"``, the JAX package's cross-check of
  the chunked forward); its ``h_in`` feeds the same backward kernel.
- ``csrc/selective_scan_bwd.cu`` recomputes each chunk's states from
  ``h_in`` and runs the gradient recurrence against the scan, giving du,
  ddt and per-block partial sums of dA, dB and dC, which
  :func:`selective_scan_bwd` adds up in f32.

Both take any L and any d (the TPU version needed d % 128 == 0 and padded L
to 128); they need n == 16, the d_state of every configuration of the
repository.  Dispatch rests on the tensors' device alone: a CPU tensor goes
to the plain version, a CUDA tensor to the kernel, or the wrapper raises.
Nothing falls back.  On a CUDA tensor that autograd records,
:func:`selective_scan_fwd` runs :class:`SelectiveScan`, whose backward is
the backward kernel.  Importing this module neither builds nor loads a
kernel; the first CUDA call does (ops/_build.py).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

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
# the kernels' layout, as csrc/selective_scan.cuh states it: the states per
# channel, the steps per chunk-entry state h_in, and the channels per block
# of the backward's dB/dC partials
_LAYOUT = _build.header_constants("selective_scan.cuh")
D_STATE = _LAYOUT["N"]
CHUNK = _LAYOUT["TL"]
CHANNELS_PER_BLOCK = _LAYOUT["DT"]
_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("chunked", "sequential")


def num_chunks(L: int) -> int:
    return -(-L // CHUNK)


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
                           + [_INT] * 2 + [_PTR]),
    "selective_scan_bwd": (BWD_LIBRARY, [_PTR] * 12 + [_INT] * 5 + [_LL] * 2
                           + [_INT] * 2 + [_PTR]),
    "selective_scan_seq": (SEQ_LIBRARY, [_PTR] * 8 + [_INT] * 5 + [_LL] * 2
                           + [_INT] + [_PTR]),
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


def _launch_fwd(u, dt, A, B, C, reverse: bool, save_states: bool):
    """The forward kernel: (y, h_out, h_in), h_in (b, n_chunks, n, d) f32
    when ``save_states``, else None (and not written)."""
    y, h_out, h_in = _fwd_outputs(u, dt, A, B, C, save_states)
    _launch("selective_scan_fwd", KERNEL_REV if reverse else KERNEL,
            u.device, *_fwd_args(u, dt, A, B, C, y, h_out, h_in),
            int(reverse))
    return y, h_out, h_in


def _launch_seq(u, dt, A, B, C, save_states: bool):
    """The sequential forward kernel: (y, h_out, h_in) as
    :func:`_launch_fwd` gives them, left to right."""
    y, h_out, h_in = _fwd_outputs(u, dt, A, B, C, save_states)
    _launch("selective_scan_seq", KERNEL_SEQ, u.device,
            *_fwd_args(u, dt, A, B, C, y, h_out, h_in))
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
    b, L, d = u.shape
    dev = u.device
    nd = -(-d // CHANNELS_PER_BLOCK)
    du = torch.empty_like(u)
    ddt = torch.empty((b, L, d), dtype=torch.float32, device=dev)
    db_part, dc_part = (torch.empty((b, nd, L, D_STATE), dtype=torch.float32,
                                    device=dev) for _ in range(2))
    da_part = torch.empty((b, d, D_STATE), dtype=torch.float32, device=dev)
    groups = A.shape[0] if A.dim() == 3 else 1
    _launch("selective_scan_bwd", KERNEL_BWD_REV if reverse else KERNEL_BWD,
            dev, u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), h_in.data_ptr(), du.data_ptr(),
            ddt.data_ptr(), db_part.data_ptr(), dc_part.data_ptr(),
            da_part.data_ptr(), b, L, d, D_STATE, groups, B.stride(0),
            B.stride(1), int(u.dtype == torch.bfloat16), int(reverse))
    # the sums across blocks, in f32, then dB and dC rounded once
    dA = da_part.view(groups, b // groups, d, D_STATE).sum(1)
    return (du, ddt, dA if A.dim() == 3 else dA[0],
            db_part.sum(1).to(B.dtype), dc_part.sum(1).to(C.dtype))


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


def needs_grad(*tensors) -> bool:
    """True when autograd records and any of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def selective_scan_fwd(u, dt, A, B, C, *, reverse: bool = False,
                       variant: str = "chunked"):
    """y (b, L, d) f32 and the final state h_out (b, n, d) f32 of the
    selective scan; see the module docstring for the contract.
    ``variant="sequential"`` runs the step-by-step kernel (the plain loop
    :func:`selective_scan_sequential_reference` on the CPU), left to right
    only: with ``reverse=True`` it raises ``ValueError``, as the JAX
    package does.  Differentiable in u, dt, A, B and C on either device."""
    if variant not in VARIANTS:
        raise ValueError(f"selective scan variant must be one of {VARIANTS}, "
                         f"got {variant!r}")
    if reverse and variant != "chunked":
        raise ValueError("reverse scan supports only variant='chunked'")
    if u.device.type == "cpu":
        if variant == "sequential":
            return selective_scan_sequential_reference(u, dt, A, B, C)[:2]
        return selective_scan_reference(u, dt, A, B, C, reverse)
    if needs_grad(u, dt, A, B, C):
        return SelectiveScan.apply(u, dt, A, B, C, bool(reverse), variant)
    if variant == "sequential":
        return _launch_seq(u, dt, A, B, C, False)[:2]
    y, h_out, _ = _launch_fwd(u, dt, A, B, C, reverse, False)
    return y, h_out
