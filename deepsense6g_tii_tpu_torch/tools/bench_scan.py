"""Microbenchmark of the port's selective-scan kernels (forward, and
forward + backward) on the card.

    python -m deepsense6g_tii_tpu_torch.tools.bench_scan [d ...] [--root PATH ...]

Counterpart of ``tools/bench_scan.py`` of the JAX package, at its shapes:
b=8 instances, L=962 tokens, n=16 states, d = 2*C inner channels (256 and
1024 by default), f32 inputs drawn as it draws them.  ``fwd`` is
``selective_scan_fwd`` without autograd (the serving kernel); ``fwd+bwd``
is the forward under autograd (it also writes the chunk-entry states) and
the gradients of sum(y) in u and dt (the backward kernel and its partial
sums); ``bwd~`` is their difference.

Then one JSON line of per-step totals at the MambaFuser's shapes (bf16 u,
B and C, B and C column slices of one x_dbl, f32 dt and A): each wrapper
timed alone at L = 962 and d = 128, 256, 512, 1024 and at L = 5, d = 1024,
weighted as the model launches it (16 at each d at L = 962, 3 at L = 5):
the backward per Mamba training step (B=8), the forward that writes h_in
per training step (B=8), and the serving forward at B=8 and at B=1, the
chunked kernel's (``fwd``) and the sequential kernel's (``seq``: the same
serving forward, had it run ``variant="sequential"``).

``--root PATH`` (repeatable) times the kernels of the checkout at PATH
instead of this one, each loaded under a name of its own and built under
its own root, so that two checkouts are timed in one process on one card:
``--root build/parent --root . --root . --root build/parent`` runs parent,
change, change, parent.  Times are CUDA events around many calls
(tools/timing.py), each call's every pass and the partials' sums included.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import selective_scan as ss
from . import timing

B, L, N = 8, 962, 16
# the MambaFuser's scans: (L, d) -> launches per forward or training step
SHAPES = {(962, 128): 16, (962, 256): 16, (962, 512): 16, (962, 1024): 16,
          (5, 1024): 3}
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_scan(root=None):
    """``ops/selective_scan.py`` of the checkout at ``root`` (default: this
    one), as :func:`timing.load_checkout` loads it."""
    return timing.load_checkout(root, "ops.selective_scan")


def inputs(d, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, L, d)).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, L, d))).astype(np.float32) * 0.1
    A = -np.abs(rng.normal(size=(d, N))).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    C = rng.normal(size=(B, L, N)).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (u, dt, A, Bm, C)]


def bench(d, device="cuda", scan=ss):
    """(fwd ms, fwd+bwd ms) at width ``d``."""
    u, dt, A, Bm, C = inputs(d, device=device)
    t_f = timing.time_ms(lambda: scan.selective_scan_fwd(u, dt, A, Bm, C),
                         device)
    ug, dtg = (x.clone().requires_grad_() for x in (u, dt))

    def fwdbwd():
        y, _ = scan.selective_scan_fwd(ug, dtg, A, Bm, C)
        return torch.autograd.grad(y.sum(), (ug, dtg))

    return t_f, timing.time_ms(fwdbwd, device)


def model_inputs(b, L_, d, seed=0, device="cuda"):
    """u, dt, A, B, C, dy as the MambaFuser gives them to the scan: bf16
    u, B and C (B and C column slices of an x_dbl (b, L, d/32 + 32)),
    dt = softplus(N(0, 1)), A = -(1..16) a channel, f32 dy."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device=device, generator=gen)  # noqa: E731
    u = rnd(b, L_, d).bfloat16()
    dt = F.softplus(rnd(b, L_, d))
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=device).expand(d, N).contiguous()
    r = d // 32
    x_dbl = rnd(b, L_, r + 2 * N).bfloat16()
    return (u, dt, A, x_dbl[..., r:r + N], x_dbl[..., r + N:],
            rnd(b, L_, d))


def launch_ms(L_, d, device="cuda", scan=ss):
    """ms per call at one scan shape: {"bwd": backward at B=8 (every pass
    and the partials' sums), "fwd_h_in": forward writing h_in at B=8,
    "fwd": serving forward at B=8, "fwd_b1": at B=1, "seq" and "seq_b1":
    the sequential forward at B=8 and B=1}."""
    out = {}
    u, dt, A, Bm, C, dy = model_inputs(B, L_, d, device=device)
    _, _, h_in = scan._launch_fwd(u, dt, A, Bm, C, False, True)
    out["bwd"] = timing.time_ms(lambda: scan.selective_scan_bwd(
        u, dt, A, Bm, C, dy, h_in), device)
    out["fwd_h_in"] = timing.time_ms(lambda: scan._launch_fwd(
        u, dt, A, Bm, C, False, True), device)
    for suffix, b in (("", B), ("_b1", 1)):
        u, dt, A, Bm, C, _ = model_inputs(b, L_, d, device=device)
        out["fwd" + suffix] = timing.time_ms(lambda: scan.selective_scan_fwd(
            u, dt, A, Bm, C), device)
        out["seq" + suffix] = timing.time_ms(lambda: scan.selective_scan_fwd(
            u, dt, A, Bm, C, variant="sequential"), device)
    return out


def weigh(ms):
    """Per-step totals from {(L, d): launch_ms(...)}: each shape's time
    times its launches a forward or training step."""
    def total(key):
        return sum(n * ms[shape][key] for shape, n in SHAPES.items())
    return {"bwd_per_mamba_step_ms": total("bwd"),
            "fwd_h_in_per_mamba_step_ms": total("fwd_h_in"),
            "fwd_per_serving_forward_b8_ms": total("fwd"),
            "fwd_per_serving_forward_b1_ms": total("fwd_b1"),
            "seq_per_serving_forward_b8_ms": total("seq"),
            "seq_per_serving_forward_b1_ms": total("seq_b1")}


def per_step(device="cuda", scan=ss):
    """The per-step totals of :func:`weigh` with each shape's times."""
    ms = {shape: launch_ms(*shape, device=device, scan=scan)
          for shape in SHAPES}
    return {**weigh(ms),
            "launch_ms": {f"L={L_} d={d}": v for (L_, d), v in ms.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dims", nargs="*", type=int, default=[256, 1024])
    ap.add_argument("--root", action="append", default=None,
                    help="a checkout whose kernels to time (repeatable)")
    args = ap.parse_args(argv)
    timing.require_cuda("bench_scan")
    card = timing.card()
    print(f"card: {card}")
    for root in args.root or [None]:
        scan = load_scan(root)
        where = os.path.abspath(root) if root else os.path.dirname(_PACKAGE)
        print(f"root={where} device={torch.cuda.get_device_name(0)} B={B} "
              f"L={L} n={N}")
        for d in args.dims:
            t_f, t_fb = bench(d, scan=scan)
            print(f"d={d:5d}  fwd {t_f:7.3f} ms   fwd+bwd {t_fb:7.3f} ms   "
                  f"bwd~{t_fb - t_f:7.3f} ms", flush=True)
        print(json.dumps({"root": where, "card": card,
                          "per_step": per_step(scan=scan)}), flush=True)


if __name__ == "__main__":
    main()
