"""Issued-operation roofline of the port's selective-scan kernels on the
card, with the elementwise-rate calibration chain (a hand-written CUDA
kernel) it rests on.

    python -m deepsense6g_tii_tpu_torch.tools.scan_roofline

Counterpart of ``tools/scan_roofline.py`` of the JAX package.  It first
calibrates the card's elementwise rates with chains of known length
(``csrc/scan_roofline_chain.cu``: k dependent FMULs, or k FMUL + MUFU.EX2
steps, per element over a (4096, 8, 1024) f32 array), taking the
difference of two chain lengths so that the loads and stores cancel.  Then
it times the scan forward (chunked and sequential) and its backward at the
tool's production geometry (B=16, L=962, d=1024, n=16, bf16 u/B/C) and
prints one JSON line with the implied operations per (t, d, n) element
beside the count of the kernels' own inner loops::

    implied_ops = t_scan * calibrated_mul_rate / (B * L * n * d)
    overhead_x  = implied_ops / analytic_ops       (1.0: speed of light)

The analytic counts are the recurrence's work, as the one-pass kernels
issued it; the chunk-parallel kernels issue more (a second pass over the
exponentials), and the forward and backward rows print their own issued
counts and ``issued_overhead_x`` beside.

Times are CUDA events around many launches (tools/timing.py).  The chain
lengths are this card's, not the TPU tool's 8/72 multiplies and 4/20
exps: at those the chain is memory-bound on an H100 and the difference of
two times says nothing about arithmetic.  Each length is checked to take
at least twice its bytes' time.  ``main`` needs CUDA; ``calibrate`` and
``chain`` take ``device="cpu"`` for tests, where the chain is its plain
version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from ..ops import _build
from ..ops import selective_scan as ss
from . import timing

LIBRARY = "scan_roofline_chain"
LIBRARIES = (LIBRARY,)
KERNEL_CHAIN = "scan_roofline_chain"      # launch count name
_K = _build.header_constants("scan_roofline_chain.cu")
MUL_K = (_K["MUL_K_LO"], _K["MUL_K_HI"])
EXP_K = (_K["EXP_K_LO"], _K["EXP_K_HI"])
MUL = 1.0000001                 # the mul chain's factor, as f32
EXP_SCALE = -0.41421            # the exp chain: x = exp(x * EXP_SCALE)
LOG2E = 1.4426950408889634
CHAIN_SHAPE = (4096, 8, 1024)
PEAK_BYTES = 3.35e12            # H100 SXM HBM3, data sheet

# production scan geometry: the MambaFuser's stage-4 fusion scans at the
# bench batch 16 (d_inner = 2 * 512, 962 tokens; no padding of L)
B_, L_, D_, N_ = 16, 962, 1024, 16

# f32 instructions per (t, d, n) element on the FP32 pipes, counted in the
# kernels' inner loops (an FFMA counts one, as an FMUL: both issue once),
# beside one exponential (forward) or two (backward) on the SFUs:
# - selective_scan_fwd.cu: dt*A', B*(dt u), the state FFMA and the y FFMA
#   (4); y's two shuffle-adds a lane-step over its 4 states (0.5); dt*u once
#   a channel-step (1/16).
# - selective_scan_seq.cu: the same 4; y's LPC - 1 partial-sum adds and
#   dt*u once a channel-step (LPC / 16: 4/16 at this geometry, where
#   ops/selective_scan.py::seq_launch takes LPC = 4 lanes a channel).
# - selective_scan_bwd.cu: sweep 1, dt*A', a*h, the state FFMA, h*dy (4)
#   and the dC channel sum (4 adds a lane-step: 1); sweep 2, g, dt*A', a*g,
#   g*B, g*ah, *A, dA, g*dt*u (8), the dB channel sum (1) and the gb/gsa
#   shuffle-adds (1); dt*u in each sweep (2/16).
FWD_OPS, SEQ_OPS, BWD_OPS = 4 + 0.5 + 1 / 16, 4 + 4 / 16, 15 + 2 / 16
FWD_EXPS, SEQ_EXPS, BWD_EXPS = 1, 1, 2
# What the chunk-parallel kernels issue per (t, d, n) element instead
# (printed beside the counts above, which stay the recurrence's work so
# that overhead_x compares across designs), at this tool's geometry:
# - the forward runs unsplit at B=16, d=1024 (one group); its y sums take
#   6 adds a lane per 8 steps (0.1875): 4 + 0.1875 + 1/16, one exp.
# - the backward: the local gradient pass (dt*A', C*dy, the add, a*g: 4,
#   its dt sum 1/16), the checkpoint sweep over 3 of 4 sub-chunks (dt*A',
#   a*h, the FFMA, dt*u a lane-step: 3.25 x 0.75), the recompute (dt*A',
#   a*h, FFMA, h*dy, dt*u, the dC channel sum's adds: 5.25) and the
#   gradient sweep (8 as before, dt*u, the dB sum's adds, the scattered
#   du/ddt sums and their products: ~9.7); exps 1 + 0.75 + 1 + 1.
FWD_ISSUED_OPS, FWD_ISSUED_EXPS = 4 + 0.1875 + 1 / 16, 1
BWD_ISSUED_OPS, BWD_ISSUED_EXPS = 4 + 1 / 16 + 3.25 * 0.75 + 5.25 + 9.7, 3.75

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "scan_roofline_chain": (LIBRARY, [_PTR, _PTR, _LL, _INT, _INT,
                                      ctypes.c_float, _PTR]),
}


def chain_reference(x, k: int, use_exp: bool):
    """Plain version of the chain: ``k`` times ``x = x * 1.0000001`` in f32
    (IEEE multiplies, one rounding each), or ``x = exp(x * -0.41421)``."""
    x = x.float()
    if use_exp:
        for _ in range(k):
            x = torch.exp(x * EXP_SCALE)
    else:
        c = torch.tensor(MUL, dtype=torch.float32, device=x.device)
        for _ in range(k):
            x = x * c
    return x


def chain(x, k: int, use_exp: bool):
    """The chain over ``x`` (f32, contiguous, a multiple of 4 elements):
    the CUDA kernel on a CUDA tensor, for the chain lengths it holds
    (``MUL_K``, ``EXP_K``), else it raises; :func:`chain_reference` on a
    CPU tensor."""
    if x.device.type == "cpu":
        return chain_reference(x, k, use_exp)
    lengths = EXP_K if use_exp else MUL_K
    if k not in lengths:
        raise ValueError(f"the chain kernel holds k in {lengths} for "
                         f"use_exp={use_exp}, got {k}")
    if (x.dtype != torch.float32 or not x.is_contiguous()
            or x.numel() % 4 or x.numel() == 0 or x.data_ptr() % 16):
        raise ValueError(f"the chain kernel takes a contiguous, 16-byte "
                         f"aligned float32 tensor of 4n elements, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"chain runs on cuda or cpu tensors, got {x.device}")
    out = torch.empty_like(x)
    c = EXP_SCALE * LOG2E if use_exp else MUL
    library, argtypes = _SIGNATURES["scan_roofline_chain"]
    _build.launch(library, "scan_roofline_chain", argtypes, KERNEL_CHAIN,
                  x.device, x.data_ptr(), out.data_ptr(), x.numel() // 4, k,
                  int(use_exp), c)
    return out


def chain_bytes_ms(n_el: int) -> float:
    """The time of the chain's bytes (each element read and written once)
    at the card's memory rate."""
    return 1e3 * 8 * n_el / PEAK_BYTES


def chain_bound_ms(k: int, use_exp: bool, n_el: int, fmul_rate: float,
                   sfu_rate: float) -> dict:
    """The least time of one chain launch over ``n_el`` elements: k FMULs
    an element at ``fmul_rate``, the SMs' FMUL issue rate (one a lane and
    clock: half the data sheet's f32 rate, which counts an FMA as two), and
    for the exp chain k exponentials at ``sfu_rate``, the special-function
    units' rate, beside them; the two pipes work side by side, so the larger
    of the two counts, with the bytes (:func:`chain_bytes_ms`) as the
    floor.  Returns the three times (``exp_ms`` None for the mul chain),
    ``ops_ms`` (the larger of the pipes), ``bound_ms`` and ``bound_by``."""
    bytes_ms = chain_bytes_ms(n_el)
    fmul_ms = 1e3 * k * n_el / fmul_rate
    exp_ms = 1e3 * k * n_el / sfu_rate if use_exp else None
    ops_ms = max(fmul_ms, exp_ms or 0.0)
    return {"bytes_ms": bytes_ms, "fmul_ms": fmul_ms, "exp_ms": exp_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def calibrate(shape=CHAIN_SHAPE, k_lo=MUL_K[0], k_hi=MUL_K[1],
              use_exp=False, device="cuda", iters=10):
    """The card's elementwise rate (operations a second: FMULs, or
    exponentials for ``use_exp``) from chains of ``k_lo`` and ``k_hi``
    steps over ``shape``: (k_hi - k_lo) * elements / (t_hi - t_lo).
    Returns the rate with both times and their bytes' time."""
    x0 = torch.full(shape, 0.5, dtype=torch.float32, device=device)
    t_lo, t_hi = (timing.time_ms(lambda k=k: chain(x0, k, use_exp), device,
                                 iters=iters) for k in (k_lo, k_hi))
    n_el = x0.numel()
    return {"k_lo": k_lo, "k_hi": k_hi, "ms_lo": t_lo, "ms_hi": t_hi,
            "bytes_ms": chain_bytes_ms(n_el),
            "rate": (k_hi - k_lo) * n_el / max(t_hi - t_lo, 1e-9) * 1e3}


def scan_inputs(seed: int, device="cuda"):
    """u, dt, A, B, C at the production geometry: bf16 u, B, C ~ N(0, 1),
    dt ~ U(0.1, 0.9), A = -U(0.5, 2), as the JAX tool draws them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn(B_, L_, D_, generator=gen, device=device)
    dt = 0.1 + 0.8 * torch.rand(B_, L_, D_, generator=gen, device=device)
    A = -(0.5 + 1.5 * torch.rand(D_, N_, generator=gen, device=device))
    Bm, Cm = (torch.randn(B_, L_, N_, generator=gen, device=device)
              for _ in range(2))
    return u.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16()


def _issued(row, fp32_ops, exps, exp_cost):
    """``row`` with the kernel's own issued instructions per element (its
    FP32 instructions and exponentials, priced as in :func:`_row`) and the
    time they imply against the measured one."""
    ops = fp32_ops + exps * exp_cost
    return {**row, "issued_fp32_ops_per_element": fp32_ops,
            "issued_exps_per_element": exps,
            "issued_overhead_x": row["implied_ops_per_element"] / ops}


def _row(ms, mul_rate, fp32_ops, exp_muls, elements):
    """One kernel's line: its time in FMULs per element against the count
    of its FP32 instructions plus its exponentials priced in FMULs, as the
    JAX tool counts them.  The FP32 pipes and the SFUs of an SM work side by
    side, so a kernel that overlaps them perfectly would show
    ``overlap_floor_x`` (the larger of the two over their sum), not 1."""
    ops = fp32_ops + exp_muls
    implied = ms * 1e-3 * mul_rate / elements
    return {"ms": ms, "implied_ops_per_element": implied,
            "analytic_ops_per_element": ops, "overhead_x": implied / ops,
            "overlap_floor_x": max(fp32_ops, exp_muls) / ops}


def roofline(seed: int = 0, device="cuda") -> dict:
    """The calibration and the scan timings as one dict (the JSON line of
    :func:`main`)."""
    peaks = timing.datasheet_rates() if device == "cuda" else None
    mul = calibrate(CHAIN_SHAPE, *MUL_K, use_exp=False, device=device)
    exp = calibrate(CHAIN_SHAPE, *EXP_K, use_exp=True, device=device)
    for what, c in (("mul", mul), ("exp", exp)):
        print(f"  calibrate({what}): t({c['k_lo']}) = {c['ms_lo']:.6g} ms, "
              f"t({c['k_hi']}) = {c['ms_hi']:.6g} ms; bytes bound "
              f"{c['bytes_ms']:.6g} ms each", file=sys.stderr, flush=True)
    mul_rate, exp_rate = mul["rate"], exp["rate"]
    exp_cost = mul_rate / exp_rate          # an exp in FMULs

    u, dt, A, Bm, Cm = scan_inputs(seed, device)
    elements = B_ * L_ * N_ * D_
    t_fwd = timing.time_ms(lambda: ss.selective_scan_fwd(u, dt, A, Bm, Cm),
                           device)
    t_seq = timing.time_ms(lambda: ss.selective_scan_fwd(
        u, dt, A, Bm, Cm, variant="sequential"), device)
    leaves = [x.detach().clone().requires_grad_() for x in (u, dt, A, Bm, Cm)]
    dy = torch.ones(B_, L_, D_, device=device)        # d sum(y)

    def fwd_bwd():
        y, _ = ss.selective_scan_fwd(*leaves)
        return torch.autograd.grad(y, leaves, dy)

    # as in the JAX tool, the backward is (forward + backward) - forward;
    # the forward under autograd also writes the chunk-entry states
    t_fwdbwd = timing.time_ms(fwd_bwd, device)
    calib = {"mul_Tops": mul_rate / 1e12, "exp_Texp": exp_rate / 1e12,
             "exp_cost_muls": exp_cost, "mul": mul, "exp": exp}
    if peaks:
        calib.update(datasheet_fmul_Tops=peaks["fmul_per_s"] / 1e12,
                     datasheet_exp_Texp=peaks["exp_per_s"] / 1e12,
                     sm_clock_mhz=peaks["sm_clock_mhz"])
    return {
        "geometry": {"B": B_, "L": L_, "d": D_, "n": N_, "TL": ss.CHUNK,
                     "elements": elements},
        "calibration": calib,
        "fwd": _issued(_row(t_fwd, mul_rate, FWD_OPS, FWD_EXPS * exp_cost,
                            elements), FWD_ISSUED_OPS, FWD_ISSUED_EXPS,
                       exp_cost),
        "bwd": _issued(_row(t_fwdbwd - t_fwd, mul_rate, BWD_OPS,
                            BWD_EXPS * exp_cost, elements), BWD_ISSUED_OPS,
                       BWD_ISSUED_EXPS, exp_cost),
        "fwd_sequential": _row(t_seq, mul_rate, SEQ_OPS,
                               SEQ_EXPS * exp_cost, elements),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    timing.require_cuda("scan_roofline")
    card = timing.card()
    print(f"card: {card}", flush=True)
    out = {"card": card, **roofline(args.seed)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
