"""Microbenchmark of the port's selective-scan kernels (forward, and
forward + backward) on the card.

    python -m deepsense6g_tii_tpu_torch.tools.bench_scan [d ...]   (256 1024)

Counterpart of ``tools/bench_scan.py`` of the JAX package, at its shapes:
b=8 instances, L=962 tokens, n=16 states, d = 2*C inner channels, f32
inputs drawn as it draws them.  ``fwd`` is ``selective_scan_fwd`` without
autograd (the serving kernel); ``fwd+bwd`` is the forward under autograd
(it also writes the chunk-entry states) and the gradients of sum(y) in u
and dt (the backward kernel and its partial sums); ``bwd~`` is their
difference.  Times are CUDA events around many calls (tools/timing.py).
Needs CUDA.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import selective_scan as ss
from . import timing

B, L, N = 8, 962, 16


def inputs(d, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, L, d)).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, L, d))).astype(np.float32) * 0.1
    A = -np.abs(rng.normal(size=(d, N))).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    C = rng.normal(size=(B, L, N)).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (u, dt, A, Bm, C)]


def bench(d, device="cuda"):
    """(fwd ms, fwd+bwd ms) at width ``d``."""
    u, dt, A, Bm, C = inputs(d, device=device)
    t_f = timing.time_ms(lambda: ss.selective_scan_fwd(u, dt, A, Bm, C),
                         device)
    ug, dtg = (x.clone().requires_grad_() for x in (u, dt))

    def fwdbwd():
        y, _ = ss.selective_scan_fwd(ug, dtg, A, Bm, C)
        return torch.autograd.grad(y.sum(), (ug, dtg))

    return t_f, timing.time_ms(fwdbwd, device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ds = [int(a) for a in argv] or [256, 1024]
    timing.require_cuda("bench_scan")
    print(f"card: {timing.card()}")
    print(f"device={torch.cuda.get_device_name(0)} B={B} L={L} n={N}")
    for d in ds:
        t_f, t_fb = bench(d)
        print(f"d={d:5d}  fwd {t_f:7.3f} ms   fwd+bwd {t_fb:7.3f} ms   "
              f"bwd~{t_fb - t_f:7.3f} ms", flush=True)


if __name__ == "__main__":
    main()
