"""Flash multi-head attention with hash dropout, forward and backward:
hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``deepsense6g_tii_tpu/ops/flash_attention.py:71-651``
(``_uniform_hash``, ``dropout_scale_reference``, ``_fwd_kernel``,
``_merged_bwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``, ``_bwd_mode``,
``_mha_core``'s VJP, ``flash_mha``, ``_mask_kernel`` and ``dropout_mask``).

- ``csrc/flash_attention_fwd.cu`` computes O = softmax(q kᵀ·scale) v and the
  row log-sum-exp by a streaming running max and sum, never forming the T×T
  score matrix in device memory.
- ``csrc/flash_attention_bwd.cu`` recomputes P = exp(s·scale − lse) tile by
  tile and forms dq, dk and dv: in one pass (``merged``, the TPU's
  ``_merged_bwd_kernel``) or as the ``dq`` + ``dkv`` pair (``split``, the
  deterministic one: no atomics).

In bf16, the dtype the card serves and trains in, the forward and both
backwards run their products on the tensor cores (mma.sync.m16n8k16, bf16
operands, f32 sums; ``csrc/flash_mma.cuh``); in f32 the products run on
the CUDA cores in f32.
- ``csrc/flash_dropout_mask.cu`` exports the dropout scale that the other
  kernels draw, the oracle for their stream.

All kernels mask rows and columns past T themselves, so the host pads
nothing (the TPU version padded T to a multiple of its 512 tile).
Attention-probability dropout is the JAX package's counter-hash stream
(``flash_dropout_impl="hash"``): element (bh, row, col) is kept when the
24-bit uniform of murmur3-fmix32(((bh·t_pad + row)·t_pad + col) ^ seed) is
≥ p, with t_pad = T rounded up to ``block`` (512, the JAX default) whatever
the Hopper tile.  The seed is an int32, as ``derive_seed`` makes it, and is
read as uint32.  The same bits come out of :func:`dropout_scale_reference`
here and in the JAX package.

Dispatch rests on the tensors' device alone: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, or the wrapper raises.  Nothing falls
back.  The forward is the custom op ``torch.ops.deepsense6g.flash_mha_fwd``
(:data:`flash_fwd_op`; its CUDA kernel is the launch, its CPU kernel
:func:`flash_mha_reference`, its fake implementation allocates what the
launch allocates), the one place that launches the forward kernel, so that
``torch.export`` traces the serving forward through it.  Importing this
module registers the op and neither builds nor loads a kernel; the first
CUDA call does (ops/_build.py).
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from . import _build

KERNEL = "flash_attention_fwd"
BWD_LIBRARY = "flash_attention_bwd"
KERNEL_MERGED = "flash_attention_bwd_merged"
KERNEL_DQ = "flash_attention_bwd_dq"
KERNEL_DKV = "flash_attention_bwd_dkv"
KERNEL_MASK = "flash_dropout_mask"
LIBRARIES = (KERNEL, BWD_LIBRARY, KERNEL_MASK)
# The device kernels of these wrappers' CUDA sources (csrc/), by name ->
# the KERNEL names of the wrappers that launch them, for
# tools/profile_step.py.  A kernel that one bool template parameter sends to
# one of two wrappers stands in DEVICE_KERNEL_FLAGS with (the parameter's
# position, its name in the source); its wrappers are (false, true).  A
# kernel of several wrappers and no flag is a pass they share.
DEVICE_KERNELS = {
    "flash_fwd_kernel": (KERNEL,),
    "flash_fwd_mma_kernel": (KERNEL,),
    "flash_bwd_prep_kernel": (KERNEL_MERGED, KERNEL_DQ),
    "flash_bwd_mma_kernel": (KERNEL_MERGED,),
    "cast_bf16_kernel": (KERNEL_MERGED,),
    "flash_bwd_dkv_kernel": (KERNEL_DKV, KERNEL_MERGED),
    "flash_bwd_dkv_mma_kernel": (KERNEL_DKV,),
    "flash_bwd_dq_kernel": (KERNEL_DQ,),
    "flash_bwd_dq_mma_kernel": (KERNEL_DQ,),
    "dropout_mask_kernel": (KERNEL_MASK,),
}
DEVICE_KERNEL_FLAGS = {"flash_bwd_dkv_kernel": (1, "MERGED")}
HEAD_DIMS = (16, 32, 64, 128)
DEFAULT_BLOCK = 512
_DTYPES = (torch.float32, torch.bfloat16)
_U32 = 0xFFFFFFFF

# the merged backward's dq accumulator budget on the TPU; kept so that
# DEEPSENSE_FLASH_BWD=auto picks what the JAX package picks
_MERGED_DQ_BYTES = 4 * 1024 * 1024


# -- the dropout stream ------------------------------------------------------

def uniform_hash(ids: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3-fmix32 of (ids ^ seed) -> uniform f32 in [0, 1), from the top
    24 bits.  ``ids`` is an int64 tensor of values in [0, 2^32); ``seed`` an
    int (a negative int32 reads as its uint32 bits).

    Torch has no general uint32 arithmetic, so this computes in int64 masked
    with ``& 0xFFFFFFFF`` after each step.  The product of two 32-bit values
    can pass 2^63 and wrap in int64, but a wrapped product keeps its low 32
    bits, which are all the mask keeps: the result is the uint32 product."""
    x = ids.bitwise_xor(int(seed) & _U32).bitwise_and_(_U32)
    x.bitwise_xor_(x >> 16)
    x.mul_(0x85EBCA6B).bitwise_and_(_U32)
    x.bitwise_xor_(x >> 13)
    x.mul_(0xC2B2AE35).bitwise_and_(_U32)
    x.bitwise_xor_(x >> 16)
    return (x >> 8).to(torch.float32) * 2.0 ** -24


def keep_threshold(dropout_p: float) -> int:
    """ceil(p·2^24) for p as an f32: the kernels keep an element when its
    24-bit draw n is ≥ this, the exact integer form of
    ``n·2^-24 ≥ float32(p)`` (the compare of :func:`uniform_hash`'s
    uniforms), and 0 (keep all) for p = 0.  Below 2^24 for every p that
    :func:`flash_mha` takes (float32(p) < 1)."""
    return math.ceil(float(np.float32(dropout_p)) * 2.0 ** 24)


def padded_length(t: int, block: int = DEFAULT_BLOCK) -> int:
    """T rounded up to ``block``: the t_pad of the dropout ids."""
    return -(-t // block) * block


def drop_scale(dropout_p: float) -> float:
    """1/(1-p) as the f32 value that scales a kept element."""
    return float(np.float32(1.0) / np.float32(1.0 - dropout_p))


def dropout_scale_reference(seed: int, n_bh: int, t: int, dropout_p: float,
                            block: int = DEFAULT_BLOCK, device="cpu"):
    """Plain version of the kernels' dropout: the (n_bh, t, t) f32 scale
    {0, 1/(1-p)} that flash attention with this ``seed`` and ``block``
    applies to its probabilities.  Materialises the whole matrix."""
    t_pad = padded_length(t, block)
    dev = torch.device(device)
    bh = torch.arange(n_bh, dtype=torch.int64, device=dev)[:, None, None]
    r = torch.arange(t, dtype=torch.int64, device=dev)[None, :, None]
    c = torch.arange(t, dtype=torch.int64, device=dev)[None, None, :]
    ids = ((bh * t_pad + r) * t_pad + c).bitwise_and_(_U32)
    u = uniform_hash(ids, seed)
    return (u >= dropout_p).to(torch.float32) / (1.0 - dropout_p)


# -- plain versions ----------------------------------------------------------

def _compute_dtype(dtype):
    """f32, or f64 for f64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def flash_mha_reference(q, k, v, sm_scale, dropout_p: float = 0.0,
                        seed: int = 0, block: int = DEFAULT_BLOCK):
    """Plain forward: materialises softmax(q kᵀ·scale) in f32 and multiplies
    it by the dropout scale of ``seed`` when ``dropout_p > 0``.

    q, k, v: (B, heads, T, head_dim).  Returns O in q's dtype and the row
    lse (B, heads, T) in f32."""
    ct = _compute_dtype(q.dtype)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * sm_scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    if dropout_p > 0.0:
        b, h, t, _ = q.shape
        p = p * dropout_scale_reference(seed, b * h, t, dropout_p, block,
                                        q.device).view(b, h, t, t).to(ct)
    return torch.matmul(p, v.to(ct)).to(q.dtype), lse


def _input_scale(dropout_p: float, dtype) -> float:
    """1/(1-p) rounded to the input dtype, as the TPU's backward kernels
    fold it into their v and dO tiles (1 for p = 0)."""
    if dropout_p <= 0.0:
        return 1.0
    return float(torch.tensor(drop_scale(dropout_p)).to(dtype).double())


def flash_mha_bwd_reference(q, k, v, o, lse, do, sm_scale,
                            dropout_p: float = 0.0, seed: int = 0,
                            block: int = DEFAULT_BLOCK):
    """Plain backward of :func:`flash_mha_reference`: materialises
    P = exp(s·scale − lse) and, with keep and c = 1/(1-p) in the input
    dtype and dvec = rowsum(dO∘O) in f32,

        dP_d = keep∘(dO (c·v)ᵀ)      dS = P∘(dP_d − dvec)·scale
        dv = (keep∘P)ᵀ (c·dO)        dk = dSᵀ q        dq = dS k

    P and dS are rounded to the input dtype before their products, as on
    the TPU; sums are f32.  Returns (dq, dk, dv) in the input dtype."""
    dtype, ct = q.dtype, _compute_dtype(q.dtype)

    def rnd(x):
        return x.to(dtype).to(ct)

    q32, k32, v32, do32 = (x.to(ct) for x in (q, k, v, do))
    s = torch.matmul(q32, k32.transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse.to(ct)[..., None])
    dvec = (do.to(ct) * o.to(ct)).sum(-1)
    if dropout_p > 0.0:
        b, h, t, _ = q.shape
        keep = dropout_scale_reference(seed, b * h, t, dropout_p, block,
                                       q.device).view(b, h, t, t) > 0
        c = _input_scale(dropout_p, dtype)
        zero = torch.zeros((), dtype=ct, device=q.device)
        dpd = torch.where(keep, torch.matmul(
            do32, rnd(v32 * c).transpose(-1, -2)), zero)
        pd = torch.where(keep, p, zero)
        cdo = rnd(do32 * c)
    else:
        dpd = torch.matmul(do32, v32.transpose(-1, -2))
        pd, cdo = p, do32
    dv = torch.matmul(rnd(pd).transpose(-1, -2), cdo)
    ds = rnd(p * (dpd - dvec[..., None]) * sm_scale)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    dq = torch.matmul(ds, k32)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


# -- kernels -----------------------------------------------------------------

_PTR, _INT, _F32, _U32T = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                           ctypes.c_uint32)
# sm_scale, keep_min, drop scale, c_in, seed, t_pad, stream
_DROP_ARGS = [_F32, _U32T, _F32, _F32, _U32T, _INT, _PTR]
_SIGNATURES = {
    "flash_attention_fwd": (KERNEL, [_PTR] * 5 + [_INT] * 4
                            + [_F32, _U32T, _F32, _U32T, _INT, _PTR]),
    "flash_bwd_merged": (BWD_LIBRARY, [_PTR] * 11 + [_INT] * 4 + _DROP_ARGS),
    "flash_bwd_split": (BWD_LIBRARY, [_PTR] * 10 + [_INT] * 4 + _DROP_ARGS),
    # each kernel of the split pair alone, dvec from the caller (timing)
    "flash_bwd_dq": (BWD_LIBRARY, [_PTR] * 7 + [_INT] * 4 + _DROP_ARGS),
    "flash_bwd_dkv": (BWD_LIBRARY, [_PTR] * 8 + [_INT] * 4 + _DROP_ARGS),
    "flash_dropout_mask": (KERNEL_MASK, [_PTR, _INT, _INT, _U32T, _F32,
                                         _U32T, _INT, _PTR]),
}


def _launch(fname: str, count_as, device, *args) -> None:
    library, argtypes = _SIGNATURES[fname]
    _build.launch(library, fname, argtypes, count_as, device, *args)


def _check_kernel_inputs(q, k, v, *more):
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
    for name, x in (("q", q), ("k", k), ("v", v)) + more:
        if x.device != q.device:
            raise ValueError("flash attention's tensors must lie on one "
                             "device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash attention kernel takes contiguous, "
                             f"16-byte aligned tensors; {name} is not")


def _check_bwd_inputs(q, k, v, lse, do, o):
    _check_kernel_inputs(q, k, v, ("do", do), ("lse", lse), ("o", o))
    for name, x in (("do", do), ("o", o)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"flash attention backward takes {name} of q's "
                             f"shape and dtype, got {tuple(x.shape)} "
                             f"{x.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"flash attention backward takes an f32 lse of "
                         f"shape {tuple(q.shape[:3])}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def _device_kind(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {x.device}")
    return x.device.type


def _seed_bits(dropout_p: float, seed) -> int:
    if dropout_p > 0.0 and seed is None:
        raise ValueError("flash attention: dropout_p > 0 requires a seed")
    if not (0.0 <= dropout_p < 1.0 and np.float32(dropout_p) < 1.0):
        raise ValueError(f"dropout_p must lie in [0, 1) as an f32, got "
                         f"{dropout_p}")
    return int(seed or 0) & _U32


def _drop_args(dropout_p: float, seed, t: int, block: int):
    """(p, scale, seed as uint32, t_pad) for a kernel's dropout stream."""
    p = float(dropout_p)
    return (p, drop_scale(p) if p > 0.0 else 1.0, _seed_bits(p, seed),
            padded_length(t, block))


def _fwd_cuda(q, k, v, sm_scale, dropout_p, seed, block):
    """The forward kernel's launch: (O, lse) for a seed already in uint32
    bits; the CUDA kernel of :data:`flash_fwd_op`."""
    _check_kernel_inputs(q, k, v)
    b, h, t, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _fwd_kernel(q, k, v, o, lse, sm_scale, dropout_p, seed, block)
    return o, lse


def _fwd_kernel(q, k, v, o, lse, sm_scale, dropout_p, seed, block):
    """One launch of the forward kernel, writing ``o`` and ``lse``."""
    b, h, t, d = q.shape
    p = float(dropout_p)
    _launch("flash_attention_fwd", KERNEL, q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b * h,
            t, d, int(q.dtype == torch.bfloat16), float(sm_scale),
            keep_threshold(p), drop_scale(p) if p > 0.0 else 1.0, int(seed),
            padded_length(t, block))


OP_NAME = "flash_mha_fwd"
flash_fwd_op = torch.library.custom_op(
    f"{_build.OP_NAMESPACE}::{OP_NAME}", _fwd_cuda, mutates_args=(),
    device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, float sm_scale, float dropout_p, "
           "int seed, int block) -> (Tensor, Tensor)")


@flash_fwd_op.register_kernel("cpu")
def _fwd_cpu(q, k, v, sm_scale, dropout_p, seed, block):
    return flash_mha_reference(q, k, v, sm_scale, dropout_p, seed, block)


@flash_fwd_op.register_fake
def _fwd_fake(q, k, v, sm_scale, dropout_p, seed, block):
    b, h, t, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, t), dtype=_compute_dtype(q.dtype)))


def flash_mha_fwd(q, k, v, *, sm_scale=None, dropout_p: float = 0.0,
                  seed=None, block: int = DEFAULT_BLOCK):
    """softmax(q kᵀ·sm_scale) v, with attention-probability dropout from
    ``seed`` when ``dropout_p > 0``, and its row lse.

    q, k, v: (B, heads, T, head_dim), any T.  Returns (O in the input dtype,
    lse (B, heads, T) f32).  ``sm_scale`` defaults to head_dim**-0.5.
    Through :data:`flash_fwd_op`, except on CPU tensors that autograd
    records, which take the plain version under autograd."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    p, seed_u32 = float(dropout_p), _seed_bits(dropout_p, seed)
    if _device_kind(q) == "cpu" and _build.needs_grad(q, k, v):
        return flash_mha_reference(q, k, v, sm_scale, p, seed_u32, block)
    return flash_fwd_op(q, k, v, float(sm_scale), p, seed_u32, int(block))


def bwd_mode(t_pad: int, d: int) -> str:
    """DEEPSENSE_FLASH_BWD = auto (default) | merged | split, with the JAX
    package's ``auto`` rule: merged when a (t_pad, d) f32 dq fits 4 MiB."""
    mode = os.environ.get("DEEPSENSE_FLASH_BWD", "auto")
    if mode not in ("auto", "merged", "split"):
        raise ValueError(f"DEEPSENSE_FLASH_BWD must be auto|merged|split, "
                         f"got {mode!r}")
    if mode != "auto":
        return mode
    return "merged" if t_pad * d * 4 <= _MERGED_DQ_BYTES else "split"


def flash_mha_bwd(q, k, v, o, lse, do, *, sm_scale, dropout_p: float = 0.0,
                  seed=None, block: int = DEFAULT_BLOCK, mode=None):
    """(dq, dk, dv) of :func:`flash_mha_fwd` for the output gradient ``do``,
    from its output ``o`` and ``lse``.  On CUDA, ``mode`` ("merged" or
    "split"; default :func:`bwd_mode`) picks the kernels."""
    p, scale, seed_u32, t_pad = _drop_args(dropout_p, seed, q.shape[2],
                                           block)
    if _device_kind(q) == "cpu":
        return flash_mha_bwd_reference(q, k, v, o, lse, do, sm_scale, p,
                                       seed_u32, block)
    _check_bwd_inputs(q, k, v, lse, do, o)
    b, h, t, d = q.shape
    mode = mode or bwd_mode(t_pad, d)
    if mode not in ("merged", "split"):
        raise ValueError(f"flash backward mode must be merged or split, got "
                         f"{mode!r}")
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr())
    tail = (b * h, t, d, int(q.dtype == torch.bfloat16), float(sm_scale),
            keep_threshold(p), scale, _input_scale(p, q.dtype), seed_u32,
            t_pad)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    # dvec = rowsum(dO∘O) in f32: scratch that each entry's prologue fills
    dvec = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    head += (o.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr())
    if mode == "merged":
        # the merged kernel adds dq into an f32 buffer that its prologue
        # zeros: dq itself in f32
        acc = dq if q.dtype == torch.float32 else torch.empty(
            q.shape, dtype=torch.float32, device=q.device)
        _launch("flash_bwd_merged", KERNEL_MERGED, q.device, *head,
                acc.data_ptr(), *tail)
    else:
        # one C call: the prologue, then the dq and the dk/dv kernel
        _launch("flash_bwd_split", (KERNEL_DQ, KERNEL_DKV), q.device, *head,
                *tail)
    return dq, dk, dv


def dropout_mask(seed: int, n_bh: int, t: int, dropout_p: float,
                 block: int = DEFAULT_BLOCK, device="cuda"):
    """The (n_bh, t, t) f32 dropout scale that the flash kernels draw for
    ``seed``, exported by its own kernel on CUDA (the plain
    :func:`dropout_scale_reference` on the CPU)."""
    p, scale, seed_u32, t_pad = _drop_args(dropout_p, seed, t, block)
    dev = torch.device(device)
    if dev.type == "cpu":
        return dropout_scale_reference(seed_u32, n_bh, t, p, block)
    if dev.type != "cuda":
        raise ValueError(f"dropout_mask runs on cuda or cpu, got {dev}")
    if not (0 < n_bh <= 65535 and t > 0 and p > 0.0):
        raise ValueError(f"dropout_mask takes 0 < n_bh <= 65535, 0 < t and "
                         f"dropout_p > 0, got {n_bh}, {t}, {dropout_p}")
    out = torch.empty((n_bh, t, t), dtype=torch.float32, device=dev)
    _launch("flash_dropout_mask", KERNEL_MASK, dev, out.data_ptr(), n_bh, t,
            keep_threshold(p), scale, seed_u32, t_pad)
    return out


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward saves q, k, v, O, lse
    and the seed; the backward regenerates the dropout mask from the seed
    and runs :func:`flash_mha_bwd` (the kernels on CUDA, the plain version
    on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, dropout_p, seed, block):
        o, lse = flash_fwd_op(q, k, v, sm_scale, dropout_p, seed, block)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (sm_scale, dropout_p, seed, block)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        sm_scale, dropout_p, seed, block = ctx.args
        dq, dk, dv = flash_mha_bwd(q, k, v, o, lse, do.contiguous(),
                                   sm_scale=sm_scale, dropout_p=dropout_p,
                                   seed=seed, block=block)
        return dq, dk, dv, None, None, None, None


def flash_mha(q, k, v, *, sm_scale=None, dropout_p: float = 0.0, seed=None,
              block: int = DEFAULT_BLOCK):
    """Flash attention: softmax(q kᵀ·sm_scale) v, q/k/v (B, heads, T, D),
    differentiable.  ``dropout_p > 0`` drops attention probabilities by the
    hash stream of ``seed`` (an int32, as the JAX package's ``derive_seed``
    gives it) and raises ``ValueError`` without one.  Without an input that
    requires grad (or under ``torch.no_grad()``) it calls
    :data:`flash_fwd_op` alone, which ``torch.export`` traces; else
    :class:`FlashAttention`."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    _device_kind(q)
    args = (float(sm_scale), float(dropout_p), _seed_bits(dropout_p, seed),
            int(block))
    if not _build.needs_grad(q, k, v):
        return flash_fwd_op(q, k, v, *args)[0]
    return FlashAttention.apply(q, k, v, *args)
