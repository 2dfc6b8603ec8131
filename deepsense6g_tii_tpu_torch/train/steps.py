"""Train and eval steps (``deepsense6g_tii_tpu/train/steps.py:59-248,
390-433``): forward in train mode, the focal (or cross-entropy) loss on
soft or integer targets, backward, an optional gradient clip, AdamW and the
EMA shadow; and an eval step that predicts with the EMA weights.

Randomness.  Step s (the state's step counter before the update) and
microbatch i draw from generators seeded by
``numpy.random.SeedSequence([rng_seed, s, i]).generate_state(3)``: the
first word seeds the dropout generator on the model's device (elementwise
masks), the second a CPU generator for the attention kernels' int32 seeds,
the third the device generator of ``modality_missing_type="randlike"``.
A batch with ``rebuild_feats`` (the modality-rebuild hook, (B·T, h, w,
64)) also draws the train-mode injection from a CPU generator seeded by
the fourth word of ``SeedSequence([rng_seed, s + 2, i])``, as the JAX step
folds ``s + 2`` into its ``rebuild`` key.  A run is therefore
reproducible from ``rng_seed``, and no draw touches torch's global RNG.
(The JAX package folds the step into a PRNGKey; its bits cannot be
matched, so a comparison with it runs at dropout 0.)

Run as a script, it trains a full-width model (random weights, seed 0)
on one fixed synthetic batch on the GPU and prints one JSON line: the loss
per step, the step-time p50/p90 and samples/s.  ``--FFM 1 --TFM 1``, the
defaults as in the JAX train CLI, train the MambaFuser through the
selective-scan kernels (``--reverse_scan_kernel`` runs its backward
branches through the reverse ones); ``--FFM 0 --TFM 0`` the GPT
TransFuser through the flash-attention kernels:

    python -m deepsense6g_tii_tpu_torch.train.steps --batch 8 --steps 20
    python -m deepsense6g_tii_tpu_torch.train.steps --FFM 0 --TFM 0

Not in the port: ``steps_per_dispatch`` (the TPU's K-step ``lax.scan``
dispatch) and ``flatten_accum`` (ROADMAP.md Queue 1 item 2).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import GlobalConfig
from ..utils.device import resolve_device
from .losses import cross_entropy_loss, focal_loss
from .state import TrainState, set_learning_rate

_INPUTS = ("image", "lidar", "radar", "gps")
_TENSORS = _INPUTS + ("beam", "beamidx", "valid", "rebuild_feats")


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    """The batch's tensors (numpy arrays or tensors) on ``device``; float
    arrays as f32.  Other entries (scenario names) are dropped."""
    out = {}
    for key in _TENSORS:
        if key not in batch:
            continue
        x = torch.as_tensor(np.asarray(batch[key])
                            if not torch.is_tensor(batch[key])
                            else batch[key])
        if x.is_floating_point():
            x = x.float()
        out[key] = x.to(device)
    return out


def compute_loss(cfg: GlobalConfig, loss_name: str, temp_coef: bool,
                 logits, batch):
    """Soft ``beam`` targets (``temp_coef``) or integer ``beamidx``, the
    optional ``valid`` row weights, focal or cross-entropy loss.  The
    multi-step decoder's (B, P, C) logits and (B, P[, C]) targets are
    flattened to B·P rows, each sample's weight repeated P times
    (``deepsense6g_tii_tpu/train/steps.py:58-78``)."""
    target = batch["beam"] if temp_coef else batch["beamidx"]
    weight = batch.get("valid")
    if logits.ndim == 3:
        if weight is not None:
            weight = weight.repeat_interleave(logits.shape[1])
        logits = logits.reshape(-1, logits.shape[-1])
        target = target.reshape((-1, target.shape[-1]) if temp_coef
                                else (-1,))
    if loss_name == "focal":
        return focal_loss(logits, target, num_classes=cfg.num_beams,
                          sample_weight=weight)
    return cross_entropy_loss(logits, target, sample_weight=weight)


class _Generators:
    """The generators of step ``step``, microbatch ``micro``."""

    def __init__(self, rng_seed: int, step: int, micro: int, device):
        s = np.random.SeedSequence([rng_seed, step, micro]).generate_state(3)
        self.dropout = torch.Generator(device=device).manual_seed(int(s[0]))
        self.seeds = torch.Generator().manual_seed(int(s[1]))
        self.missing = torch.Generator(device=device).manual_seed(int(s[2]))
        r = np.random.SeedSequence([rng_seed, step + 2, micro])
        self.rebuild = torch.Generator().manual_seed(
            int(r.generate_state(4)[3]))


def _missing_generator(cfg, gens):
    randlike = (cfg.modality_missing is not None
                and cfg.modality_missing_type == "randlike")
    return gens.missing if randlike else None


def _rows(x, key: str, n: int, i: int, K: int):
    """Microbatch ``i`` of ``K`` of a batch entry: rows [i::K] of the n
    samples; ``rebuild_feats`` holds T rows a sample, taken together."""
    if key != "rebuild_feats":
        return x[i::K]
    return x.reshape(n, -1, *x.shape[1:])[i::K].flatten(0, 1)


def make_train_step(model, cfg: GlobalConfig, state: TrainState,
                    loss_name: str = "focal", temp_coef: bool = True,
                    use_ema: bool = False, ema_decay: float = 0.999,
                    clip_grad_norm: Optional[float] = None,
                    rng_seed: int = 100, grad_accum: int = 1,
                    device="cuda"):
    """Returns ``step(batch, lr) -> {"loss", "ranks"}``, which updates
    ``state`` (the model's weights and BatchNorm statistics, AdamW, the EMA
    shadow and the step) in place.  ``batch`` holds numpy arrays or tensors
    (``image``, ``lidar``, ``radar``, ``gps``, ``beam`` or ``beamidx``,
    and optionally ``rebuild_feats`` for the encoder's rebuild hook);
    ``loss`` is a 0-d tensor and ``ranks`` the (B, num_beams) beam indices
    by descending logit, both on the device.  A ``valid`` row mask (the JAX
    engine's padded batches, which also mask BatchNorm's statistics) is not
    taken yet and raises.

    ``grad_accum`` K > 1 runs microbatch i on rows [i::K], each with fresh
    dropout draws; BatchNorm statistics chain through the K forwards, and
    the gradients and the loss are the mean over the K microbatches (the JAX
    step's weights d_i, all 1 without ``valid``), which gives the full
    batch's gradient of the mean loss."""
    dev = resolve_device(device)
    if state.model is not model:
        raise ValueError("state was not created for this model")
    if cfg.opt_mu_dtype is not None:
        raise NotImplementedError("opt_mu_dtype is a TPU memory knob the "
                                  "PyTorch port does not take")
    K = int(grad_accum)
    names, params = zip(*model.named_parameters())
    ema = [state.ema[n] for n in names]

    def forward_loss(mb, micro):
        gens = _Generators(rng_seed, state.step, micro, dev)
        logits = model(*(mb[k] for k in _INPUTS),
                       rebuild_feats=mb.get("rebuild_feats"),
                       generator=_missing_generator(cfg, gens),
                       rebuild_generator=gens.rebuild,
                       dropout_generator=gens.dropout,
                       seed_generator=gens.seeds)
        return logits, compute_loss(cfg, loss_name, temp_coef, logits, mb)

    def step(batch, lr):
        if "valid" in batch:
            raise NotImplementedError(
                "a valid row mask (padded batches, masked out of BatchNorm's "
                "statistics) is not in the port yet: ROADMAP.md Queue 1 "
                "item 3, with the engine")
        model.train()
        b = _to_device(batch, dev)
        set_learning_rate(state, lr)
        state.optimizer.zero_grad(set_to_none=True)
        if K <= 1:
            logits, loss = forward_loss(b, 0)
            loss.backward()
        else:
            n = b["image"].shape[0]
            if n % K:
                raise ValueError(f"grad_accum={K} requires the batch ({n}) "
                                 f"to split evenly")
            lsum, micro_logits = 0.0, []
            for i in range(K):
                lg, loss_i = forward_loss(
                    {k: _rows(v, k, n, i, K) for k, v in b.items()}, i)
                loss_i.backward()          # p.grad sums the K gradients
                lsum = lsum + loss_i.detach()
                micro_logits.append(lg.detach())
            for p in params:
                if p.grad is not None:
                    p.grad.div_(K)
            loss = lsum / K
            # row j*K + i of the batch is row j of microbatch i
            logits = torch.stack(micro_logits, 1).reshape(
                n, *micro_logits[0].shape[1:])
        for p in params:           # an unused parameter: a zero gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if clip_grad_norm is not None:
            # the scale min(1, c / (|g| + 1e-6)) of the JAX step
            torch.nn.utils.clip_grad_norm_(params, clip_grad_norm)
        state.optimizer.step()
        with torch.no_grad():
            if use_ema:
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [p.detach() for p in params],
                                    alpha=1.0 - ema_decay)
            else:
                torch._foreach_copy_(ema, [p.detach() for p in params])
        state.step += 1
        ranks = torch.argsort(logits.detach(), dim=-1, descending=True,
                              stable=True)
        return {"loss": loss.detach(), "ranks": ranks}

    return step


def make_eval_step(model, cfg: GlobalConfig, state: TrainState,
                   loss_name: str = "focal", temp_coef: bool = True,
                   use_ema: bool = False, rng_seed: int = 100,
                   device="cuda"):
    """Returns ``eval_step(batch, batch_idx=0) -> {"ranks", "confidence"
    [, "loss"]}`` in eval mode (BatchNorm running statistics, no dropout),
    with the EMA shadow's weights when ``use_ema`` (the model's own weights
    are left as they are).  ``confidence`` is the top f32 softmax
    probability; ``loss`` comes when the batch has ``beam`` targets.
    ``randlike`` missing modalities draw fresh noise per ``batch_idx``."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(batch, batch_idx: int = 0):
        model.eval()
        b = _to_device(batch, dev)
        gens = _Generators(rng_seed, state.step, 1 + batch_idx, dev)
        args = tuple(b[k] for k in _INPUTS)
        kwargs = dict(generator=_missing_generator(cfg, gens),
                      rebuild_feats=b.get("rebuild_feats"))
        if use_ema:
            logits = torch.func.functional_call(model, state.ema, args,
                                                kwargs)
        else:
            logits = model(*args, **kwargs)
        out = {"ranks": torch.argsort(logits, dim=-1, descending=True,
                                      stable=True),
               "confidence": torch.softmax(logits.float(), -1).amax(-1)}
        if "beam" in b:
            out["loss"] = compute_loss(cfg, loss_name, temp_coef, logits, b)
        return out

    return eval_step


def main(argv=None) -> int:
    import argparse
    import json
    import time

    from ..models.fuser import BeamFuser
    from ..serve import gpt_transfuser_config, mambafuser_config
    from ..utils.synth import make_synth_batch
    from .state import create_train_state

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--FFM", type=int, default=1)
    p.add_argument("--TFM", type=int, default=1)
    p.add_argument("--reverse_scan_kernel", action="store_true")
    a = p.parse_args(argv)
    dev = resolve_device("cuda")
    config = mambafuser_config if a.FFM else gpt_transfuser_config
    cfg = config(TFM=a.TFM, reverse_scan_kernel=a.reverse_scan_kernel)
    model = BeamFuser(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    state = create_train_state(model)
    step = make_train_step(model, cfg, state, use_ema=True, device=dev)
    batch = _to_device(make_synth_batch(cfg, a.batch, seed=1), dev)
    losses, times = [], []
    for _ in range(a.steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = step(batch, a.lr)
        losses.append(out["loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
    t = np.asarray(times[1:] if len(times) > 1 else times)
    p50 = float(np.percentile(t, 50))
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev), "FFM": cfg.FFM,
        "TFM": cfg.TFM, "batch": a.batch,
        "steps": a.steps, "lr": a.lr, "loss": losses, "step_ms_p50": p50,
        "step_ms_p90": float(np.percentile(t, 90)),
        "samples_per_s": 1e3 * a.batch / p50,
        "first_step_ms": times[0]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
