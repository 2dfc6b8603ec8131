"""What the models' work costs at least: model FLOPs, and the operations
and bytes of the attention and scan kernels, counted from the reference's
shapes and never from the program.

Model FLOPs count matrix products and convolutions (2 per multiply-add),
as ``torch.utils.flop_counter`` counts the reference's forward on the
meta device; a training step is 3 forwards (forward, and a backward of
twice the forward's products), with no recomputation.

Kernel bounds (PERF.md, section 6): the larger of the operations at the
peak rate and the bytes at the HBM rate, each input read once and each
output written once.

- Attention over (bh, T, d) in bf16: forward 4*bh*T^2*d operations, q, k,
  v read and o written (2 bytes each) and the f32 row lse written;
  backward 10*bh*T^2*d operations, q, k, v, o, do and dq, dk, dv (2 bytes
  each) and lse and the row dot product (4 bytes each).
- Selective scan over (b, L, d) with n states, u in bf16: forward
  b*L*d*(7n + 1) f32 operations against the bytes ``scan_fwd`` lists, at
  the f32 CUDA-core rate; backward b*L*d*(16n + 4) against ``scan_bwd``'s.
"""

from __future__ import annotations

import functools
import json

import torch

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
WIDTHS = (64, 128, 256, 512)
CHUNK = 64          # the scan's steps a chunk-entry state covers


@functools.lru_cache(maxsize=None)
def _forward_flops(cfg_json: str) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    from .model import BeamFuserReference
    cfg = json.loads(cfg_json)
    T, H = cfg["seq_len"], cfg["input_resolution"]
    rc = 2 if cfg["add_velocity"] else 1
    with torch.device("meta"):
        model = BeamFuserReference(cfg).eval()
        args = (torch.zeros(1, T, H, H, 3), torch.zeros(1, T, H, H, 1),
                torch.zeros(1, T, H, H, rc), torch.zeros(1, cfg["gps_len"], 2))
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            model(*args)
    return float(counter.get_total_flops())


def forward_flops_per_sample(cfg: dict) -> float:
    """Matrix-product and convolution FLOPs of one sample's forward."""
    return _forward_flops(json.dumps(cfg, sort_keys=True))


def train_flops_per_sample(cfg: dict) -> float:
    return 3.0 * forward_flops_per_sample(cfg)


def n_tokens(cfg: dict) -> int:
    return (cfg["n_views"] + 2) * cfg["seq_len"] * cfg["vert_anchors"] \
        * cfg["horz_anchors"] + cfg["gps_len"]


def _bound_s(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / PEAK_BYTES)


def attention_fwd(bh: int, T: int, d: int) -> float:
    n = bh * T * d
    return _bound_s(4.0 * bh * T * T * d, 4 * n * 2 + bh * T * 4, PEAK_BF16)


def attention_bwd(bh: int, T: int, d: int) -> float:
    n = bh * T * d
    return _bound_s(10.0 * bh * T * T * d, 8 * n * 2 + 2 * bh * T * 4,
                    PEAK_BF16)


def attention_bound_s(cfg: dict, batch: int, train: bool) -> float:
    """Least seconds of one forward's (and with ``train`` its backward's)
    attention over every GPT block at ``batch`` rows."""
    if cfg["FFM"]:
        return 0.0
    T, heads = n_tokens(cfg), cfg["n_head"]
    total = 0.0
    for c in WIDTHS:
        per = attention_fwd(batch * heads, T, c // heads)
        if train:
            per += attention_bwd(batch * heads, T, c // heads)
        total += cfg["n_layer"] * per
    return total


def scan_fwd(b: int, L: int, d: int, n: int, with_states: bool) -> float:
    """u (2 bytes), dt (4), B and C (2 each) and A read; y (4) and the
    final state written; with ``with_states`` (a training forward) also the
    f32 state entering each chunk."""
    nbytes = b * L * d * (2 + 4 + 4) + 2 * b * L * n * 2 + d * n * 4 \
        + b * n * d * 4
    if with_states:
        nbytes += b * (-(-L // CHUNK)) * n * d * 4
    return _bound_s(b * L * d * (7 * n + 1), nbytes, PEAK_F32)


def scan_bwd(b: int, L: int, d: int, n: int) -> float:
    """u, dt, dy, B, C, A and the chunk states read; du, ddt, dA, dB, dC
    written."""
    nbytes = (b * L * d * (2 + 4 + 4) + 2 * b * L * n * 2 + d * n * 4
              + b * (-(-L // CHUNK)) * n * d * 4
              + b * L * d * (2 + 4) + 2 * b * L * n * 2 + d * n * 4)
    return _bound_s(b * L * d * (16 * n + 4), nbytes, PEAK_F32)


def scan_shapes(cfg: dict, batch: int):
    """(b, L, d_inner) of every scan of one forward: two a MambaBlock, and
    the TimeMamba head's one over each modality's track."""
    shapes = []
    if cfg["FFM"]:
        for c in WIDTHS:
            shapes += [(batch, n_tokens(cfg), cfg["expand"] * c)] \
                * (2 * cfg["n_layer"])
    if cfg["TFM"]:
        shapes += [(batch, cfg["seq_len"], cfg["expand"] * 512)] * 3
    return shapes


def scan_bound_s(cfg: dict, batch: int, train: bool) -> float:
    n = cfg["d_state"]
    return sum(scan_fwd(b, L, d, n, train) + (scan_bwd(b, L, d, n)
                                              if train else 0.0)
               for b, L, d in scan_shapes(cfg, batch))
