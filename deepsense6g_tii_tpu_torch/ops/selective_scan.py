"""Selective-scan forward (the Mamba recurrence): a hand-written CUDA kernel
for Hopper and its plain PyTorch version.

Counterpart of ``deepsense6g_tii_tpu/ops/selective_scan.py:58-87,206-347,
623-680`` (``selective_scan_ref``, ``_fwd_kernel_chunked``,
``_fwd_kernel_chunked_rev``, ``_scan_fwd_pallas`` and ``selective_scan``).
Per batch row b, channel d and state n::

    h_t = exp(dt_t * A[d,n]) * h_{t-1} + (dt_t * u_t) * B_t[n]    (h_{-1} = 0)
    y_t = sum_n h_t[d,n] * C_t[n]                                  (+ D*u: caller)

``reverse=True`` runs the recurrence right to left over natural-order
inputs and outputs (``flip(scan(flip(inputs)))``).  u, B and C may be
bfloat16 and are widened to f32; dt and A are f32; y and the final state
are f32.  A is (d, n) or (G, d, n): G parameter groups over equal slices of
the batch.

The kernel, ``csrc/selective_scan_fwd.cu``, takes any L and any d (the TPU
version needed d % 128 == 0 and padded L to 128); it needs n == 16, the
d_state of every configuration of the repository.  Dispatch rests on the
tensors' device alone: a CPU tensor goes to :func:`selective_scan_reference`,
a CUDA tensor to the kernel, or the wrapper raises.  Nothing falls back.
Importing this module neither builds nor loads the kernel; the first CUDA
call does (ops/_build.py).

The kernel has no backward yet (ROADMAP.md slice 4): on a CUDA tensor the
wrapper raises when autograd would need its gradient, instead of handing
back an output cut from the graph.  The plain version stays differentiable.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "selective_scan_fwd"
D_STATE = 16
_DTYPES = (torch.float32, torch.bfloat16)
_FN = None


def selective_scan_reference(u, dt, A, B, C, reverse: bool = False):
    """Plain version: a doubling (Hillis-Steele) scan over L on
    (b, L, d, n) f32 tensors, like the JAX package's associative-scan
    ``selective_scan_ref``.

    u, dt: (b, L, d); A: (d, n) or (G, d, n); B, C: (b, L, n).  Returns
    (y (b, L, d) f32, h_out (b, n, d) f32), h_out being the state after the
    last step of the scan (position L-1, or 0 when ``reverse``)."""
    if reverse:
        y, h_out = selective_scan_reference(u.flip(1), dt.flip(1), A,
                                            B.flip(1), C.flip(1))
        return y.flip(1), h_out
    b, L, _ = u.shape
    u, dt, B, C, A = (x.float() for x in (u, dt, B, C, A))
    if A.dim() == 3:                                   # (b, 1, d, n)
        A = A.repeat_interleave(b // A.shape[0], dim=0)[:, None]
    a = torch.exp(dt[..., None] * A)                   # (b, L, d, n)
    h = (dt * u)[..., None] * B[:, :, None, :]
    s = 1
    while s < L:
        h = torch.cat([h[:, :s], torch.addcmul(h[:, s:], a[:, s:],
                                               h[:, :-s])], dim=1)
        if 2 * s < L:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    y = torch.einsum("bldn,bln->bld", h, C)
    return y, h[:, -1].transpose(1, 2).contiguous()


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load(KERNEL).selective_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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


def needs_grad(*tensors) -> bool:
    """True when autograd records and any of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def selective_scan_fwd(u, dt, A, B, C, *, reverse: bool = False):
    """y (b, L, d) f32 and the final state h_out (b, n, d) f32 of the
    selective scan; see the module docstring for the contract."""
    if u.device.type == "cpu":
        return selective_scan_reference(u, dt, A, B, C, reverse)
    if needs_grad(u, dt, A, B, C):
        raise NotImplementedError(
            "the selective-scan kernel has no backward yet (ROADMAP.md "
            "slice 4, MambaFuser training): run it under torch.no_grad() "
            "or train with use_pallas_scan=False")
    if u.device.type != "cuda":
        raise ValueError(f"selective scan runs on cuda or cpu tensors, got "
                         f"{u.device}")
    _check_kernel_inputs(u, dt, A, B, C)
    b, L, d = u.shape
    y = torch.empty((b, L, d), dtype=torch.float32, device=u.device)
    h_out = torch.empty((b, D_STATE, d), dtype=torch.float32, device=u.device)
    groups = A.shape[0] if A.dim() == 3 else 1
    fn = _kernel_fn()
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), h_out.data_ptr(), b, L, d,
                 D_STATE, groups, B.stride(0), B.stride(1),
                 int(u.dtype == torch.bfloat16), int(reverse),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    _build.count_launch(KERNEL)
    return y, h_out
