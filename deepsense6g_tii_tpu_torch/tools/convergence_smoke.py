"""End-to-end training convergence smoke (the JAX package's
``tools/convergence_smoke.py``).

Overfits the full-width MambaFuser (bf16, the selective-scan kernels
forward and backward, AdamW, EMA) on one fixed synthetic batch with real
soft beam targets, and asserts that the focal loss at least halves in 40
steps: the strongest correctness signal the whole training path gives
without the dataset.  ``--arch gpt`` trains the GPT TransFuser through the
flash-attention kernels instead.

    python -m deepsense6g_tii_tpu_torch.tools.convergence_smoke \\
        [--steps 40] [--batch 8] [--lr 1e-4] [--arch mamba|gpt] [--device cuda]

``--device`` defaults to ``cuda`` and raises without it; ``--device cpu``
trains the f32 model on the plain paths.  Prints the loss every 10 steps
and one JSON line.  The JAX tool's ``--opt_mu_dtype`` (a TPU memory knob
the port refuses) and ``--flash`` are not taken.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..config import GlobalConfig
from ..data.features import soft_beam_target_np
from ..models.fuser import BeamFuser
from ..serve import serving_config
from ..train.state import create_train_state
from ..train.steps import make_train_step
from ..utils.device import resolve_device
from ..utils.synth import make_synth_batch


def config(arch: str, device) -> GlobalConfig:
    """The full-width model of ``arch``: bf16 through the kernels on the
    card, f32 on the plain paths elsewhere."""
    on_card = resolve_device(device).type == "cuda"
    fused = 0 if arch == "gpt" else 1
    return serving_config(FFM=fused, TFM=fused,
                          add_velocity=GlobalConfig().add_velocity,
                          on_card=on_card)


def run(cfg: GlobalConfig, steps: int = 40, batch: int = 8,
        lr: float = 1e-4, device="cuda", verbose: bool = True) -> dict:
    """Trains ``cfg``'s model (random weights, seed 0) on one synthetic
    batch whose targets are soft beams of random indices; returns the loss
    per step, the first and last loss, the batch's top-1 hit rate and
    whether the loss halved.  The batch and the indices are the JAX tool's
    draws."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 64, batch)
    host = make_synth_batch(cfg, batch)
    # the target to overfit: real soft beam labels, not synthetic noise
    host["beam"] = np.stack([soft_beam_target_np(i) for i in idx]
                            ).astype(np.float32)
    host["beamidx"] = idx.astype(np.int32)
    data = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    model = BeamFuser(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    state = create_train_state(model)
    step = make_train_step(model, cfg, state, use_ema=True, device=dev)
    losses = []
    for i in range(steps):
        out = step(data, lr)
        losses.append(out["loss"])
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"step {i}: loss {float(out['loss']):.4f}", flush=True)
    losses = torch.stack(losses).float().cpu().tolist()
    top1 = float((out["ranks"][:, 0].cpu().numpy() == idx).mean())
    if verbose:
        print(f"top-1 on memorized batch: {top1:.2f}")
    return {"losses": losses, "first": losses[0], "last": losses[-1],
            "top1": top1, "halved": losses[-1] < 0.5 * losses[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--arch", default="mamba", choices=["mamba", "gpt"],
                    help="gpt = GPT TransFuser (FFM=0/TFM=0) through the "
                         "flash-attention kernels")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    res = run(config(a.arch, dev), a.steps, a.batch, a.lr, dev)
    print(json.dumps({"arch": a.arch, "device": (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "steps": a.steps, "batch": a.batch, "lr": a.lr, **res}))
    if not res["halved"]:
        raise SystemExit(f"loss did not halve: {res['first']} -> "
                         f"{res['last']}")
    print("convergence smoke: PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
