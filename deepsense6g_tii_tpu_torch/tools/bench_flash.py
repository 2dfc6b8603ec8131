"""Microbenchmark of the port's flash-attention kernels (forward, and
forward + backward) on the card.

    python -m deepsense6g_tii_tpu_torch.tools.bench_flash [D ...] [--dtype float32] [--root PATH ...]

Counterpart of ``tools/bench_flash.py`` of the JAX package, at its shapes:
B=16, H=4 heads, T=962 fused tokens, head dim D in 16/32/64/128 (the GPT
fusion stages), bf16 by default, dropout 0 and 0.1 (the hash stream; the
dropout on/off delta is the stream's cost).  ``fwd`` is ``flash_mha``
(the forward kernel); ``fwd+bwd`` adds the gradients of sum(O) in q, k and
v (the merged backward kernel).  TF/s counts the forward's 4·B·H·T²·D
matmul operations (T unpadded: the kernels mask the columns past T).

Then one JSON line per GPT TransFuser training step: at B=8, bf16, the
forward kernel (``flash_mha_fwd``) and the merged backward
(``flash_mha_bwd(mode="merged")``, with its dvec reduction and dq cast)
each timed alone and summed as a step launches them, 8 times at each head
dim, at dropout 0 and 0.1.

``--root PATH`` (repeatable) times the kernels of the checkout at PATH
instead of this one, each loaded under a name of its own and built under
its own root, so that two checkouts are timed in one process on one card:
``--root build/parent --root . --root . --root build/parent`` runs parent,
change, change, parent.  Times are CUDA events around many calls
(tools/timing.py).  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..ops import flash_attention as fa
from . import timing

B, H, T = 16, 4, 962
SEED = 12345                   # the dropout stream's seed
STEP_BATCH = 8                 # a GPT training step's batch
STEP_LAUNCHES = 8              # launches a step at each head dim
HEAD_DIMS = (16, 32, 64, 128)
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_flash(root=None):
    """``ops/flash_attention.py`` of the checkout at ``root`` (default: this
    one).  Another checkout's package is imported under a name of its own,
    so its kernels load beside this one's; they build under its root."""
    return timing.load_checkout(root, "ops.flash_attention")


def inputs(d, dtype, seed=0, device="cuda", batch=B, n=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(batch, H, T, d))
                             .astype(np.float32))
            .to(device=device, dtype=dtype) for _ in range(n)]


def bench(d, p, dtype=torch.bfloat16, device="cuda", flash=fa):
    """(fwd ms, fwd+bwd ms) at head dim ``d`` and dropout ``p``."""
    q, k, v = inputs(d, dtype, device=device)
    seed = SEED if p else None
    t_f = timing.time_ms(lambda: flash.flash_mha(q, k, v, dropout_p=p,
                                                 seed=seed), device)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def fwdbwd():
        o = flash.flash_mha(qg, kg, vg, dropout_p=p, seed=seed)
        return torch.autograd.grad(o.float().sum(), (qg, kg, vg))

    return t_f, timing.time_ms(fwdbwd, device)


def launch_ms(d, p, device="cuda", flash=fa):
    """(forward, merged backward) ms per launch at a training step's
    shape: B=8, bf16, head dim ``d``, dropout ``p``."""
    q, k, v, do = inputs(d, torch.bfloat16, device=device,
                         batch=STEP_BATCH, n=4)
    kw = dict(sm_scale=d ** -0.5, dropout_p=p, seed=SEED if p else None)
    o, lse = flash.flash_mha_fwd(q, k, v, **kw)
    return (timing.time_ms(lambda: flash.flash_mha_fwd(q, k, v, **kw),
                           device),
            timing.time_ms(lambda: flash.flash_mha_bwd(
                q, k, v, o, lse, do, mode="merged", **kw), device))


def per_step(device="cuda", flash=fa, dims=HEAD_DIMS):
    """{"p=<p>": {"fwd_ms", "bwd_ms", per-launch ms by head dim}} per GPT
    training step: each kernel's launch time summed over 8 launches at
    each head dim, at dropout 0 and 0.1."""
    out = {}
    for p in (0.0, 0.1):
        ms = {d: launch_ms(d, p, device, flash) for d in dims}
        out[f"p={p}"] = {
            "fwd_ms": STEP_LAUNCHES * sum(f for f, _ in ms.values()),
            "bwd_ms": STEP_LAUNCHES * sum(b for _, b in ms.values()),
            "launch_ms": {str(d): list(v) for d, v in ms.items()}}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dims", nargs="*", type=int, default=list(HEAD_DIMS))
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--root", action="append", default=None,
                    help="a checkout whose kernels to time (repeatable)")
    args = ap.parse_args(argv)
    timing.require_cuda("bench_flash")
    dtype = getattr(torch, args.dtype)
    card = timing.card()
    print(f"card: {card}")
    for root in args.root or [None]:
        flash = load_flash(root)
        where = os.path.abspath(root) if root else os.path.dirname(_PACKAGE)
        print(f"root={where} device={torch.cuda.get_device_name(0)} B={B} "
              f"H={H} T={T} dtype={args.dtype}")
        for d in args.dims:
            row = [f"D={d:4d}"]
            for p in (0.0, 0.1):
                tf, tb = bench(d, p, dtype, flash=flash)
                fl = 4 * B * H * T * T * d
                row.append(f"p={p}: fwd {tf:7.3f} ms "
                           f"({fl / tf / 1e9:5.1f} TF/s)  fwd+bwd {tb:7.3f} ms")
            print("  ".join(row), flush=True)
        print(json.dumps({"root": where, "card": card,
                          "per_gpt_step": per_step(flash=flash,
                                                   dims=args.dims)}),
              flush=True)


if __name__ == "__main__":
    main()
