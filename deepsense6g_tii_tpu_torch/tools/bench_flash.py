"""Microbenchmark of the port's flash-attention kernels (forward, and
forward + backward) on the card.

    python -m deepsense6g_tii_tpu_torch.tools.bench_flash [D ...] [--dtype float32]

Counterpart of ``tools/bench_flash.py`` of the JAX package, at its shapes:
B=16, H=4 heads, T=962 fused tokens, head dim D in 16/32/64/128 (the GPT
fusion stages), bf16 by default, dropout 0 and 0.1 (the hash stream; the
dropout on/off delta is the stream's cost).  ``fwd`` is ``flash_mha``
(the forward kernel); ``fwd+bwd`` adds the gradients of sum(O) in q, k and
v (the merged backward kernel).  TF/s counts the forward's 4·B·H·T²·D
matmul operations (T unpadded: the kernels mask the columns past T).
Times are CUDA events around many calls (tools/timing.py).  Needs CUDA.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import flash_attention as fa
from . import timing

B, H, T = 16, 4, 962
SEED = 12345                   # the dropout stream's seed


def inputs(d, dtype, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, H, T, d)).astype(np.float32))
            .to(device=device, dtype=dtype) for _ in range(3)]


def bench(d, p, dtype=torch.bfloat16, device="cuda"):
    """(fwd ms, fwd+bwd ms) at head dim ``d`` and dropout ``p``."""
    q, k, v = inputs(d, dtype, device=device)
    seed = SEED if p else None
    t_f = timing.time_ms(lambda: fa.flash_mha(q, k, v, dropout_p=p,
                                              seed=seed), device)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def fwdbwd():
        o = fa.flash_mha(qg, kg, vg, dropout_p=p, seed=seed)
        return torch.autograd.grad(o.float().sum(), (qg, kg, vg))

    return t_f, timing.time_ms(fwdbwd, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dims", nargs="*", type=int, default=[16, 32, 64, 128])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    timing.require_cuda("bench_flash")
    dtype = getattr(torch, args.dtype)
    print(f"card: {timing.card()}")
    print(f"device={torch.cuda.get_device_name(0)} B={B} H={H} T={T} "
          f"dtype={args.dtype}")
    for d in args.dims:
        row = [f"D={d:4d}"]
        for p in (0.0, 0.1):
            tf, tb = bench(d, p, dtype)
            fl = 4 * B * H * T * T * d
            row.append(f"p={p}: fwd {tf:7.3f} ms ({fl / tf / 1e9:5.1f} TF/s)"
                       f"  fwd+bwd {tb:7.3f} ms")
        print("  ".join(row), flush=True)


if __name__ == "__main__":
    main()
