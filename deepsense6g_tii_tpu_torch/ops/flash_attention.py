"""Flash multi-head attention forward: a hand-written CUDA kernel for Hopper
and its plain PyTorch version.

Counterpart of ``deepsense6g_tii_tpu/ops/flash_attention.py:160-245,572-608``
(``_fwd_kernel``, ``_mha_fwd_pallas`` and ``flash_mha``).  The kernel,
``csrc/flash_attention_fwd.cu``, computes O = softmax(q kᵀ·scale) v and the
row log-sum-exp by a streaming running max and sum, never forming the T×T
score matrix in device memory; it masks the key columns past T itself, so
the host pads nothing (the TPU version padded T to a multiple of its 512
tile).

Dispatch rests on the tensors' device alone: a CPU tensor goes to
:func:`flash_mha_reference`, a CUDA tensor to the kernel, or the wrapper
raises.  Nothing falls back.  Importing this module neither builds nor
loads the kernel; the first CUDA call does (ops/_build.py).

Attention-probability dropout is not implemented here: the serving path
runs with ``dropout_p == 0`` and the wrapper raises otherwise.  The
counter-hash dropout stream of the JAX package comes with the backward
kernels of the training path.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "flash_attention_fwd"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_FN = None


def flash_mha_reference(q, k, v, sm_scale):
    """Plain version: materialises softmax(q kᵀ·scale) in f32.

    q, k, v: (B, heads, T, head_dim).  Returns O in q's dtype and the row
    lse (B, heads, T) in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load(KERNEL).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check_kernel_inputs(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention takes q, k, v of one (B, heads, T, "
                         f"head_dim) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    b, h, t, _ = q.shape
    if t == 0 or b * h == 0 or b * h > 65535:
        raise ValueError(f"flash attention kernel takes 0 < T and "
                         f"0 < B*heads <= 65535, got {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError("q, k and v must lie on one device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash attention kernel takes contiguous, "
                             f"16-byte aligned tensors; {name} is not")


def flash_mha_fwd(q, k, v, *, sm_scale=None, dropout_p: float = 0.0):
    """softmax(q kᵀ·sm_scale) v and its row lse.

    q, k, v: (B, heads, T, head_dim), any T.  Returns (O in the input dtype,
    lse (B, heads, T) f32).  ``sm_scale`` defaults to head_dim**-0.5."""
    if dropout_p != 0.0:
        raise NotImplementedError(
            "flash attention forward takes dropout_p == 0 only; in-kernel "
            "dropout comes with the training path's backward kernels")
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    _check_kernel_inputs(q, k, v)
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b * h, t, d, int(q.dtype == torch.bfloat16),
                 float(sm_scale), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    _build.count_launch(KERNEL)
    return o, lse


def flash_mha(q, k, v, *, sm_scale=None, dropout_p: float = 0.0):
    """Flash attention: softmax(q kᵀ·sm_scale) v, q/k/v (B, heads, T, D)."""
    return flash_mha_fwd(q, k, v, sm_scale=sm_scale, dropout_p=dropout_p)[0]
