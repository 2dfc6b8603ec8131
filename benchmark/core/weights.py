"""Weights made on the device from the run's seed, named as the program's
state_dict names them, so that one dict loads into the program's model and
into the plain reference.

The scheme follows the models' published initialisation: convolutions and
Linears outside the fusion blocks N(0, 1/fan_in); Linears inside the GPT
blocks and MambaBlocks N(0, 0.02); biases, the positional embedding and
BatchNorm's running means 0; norms' scales and running variances 1; each
Mamba's depthwise conv N(0, 1/d_conv), A_log = log(1..d_state), D = 1, and
dt_proj N(0, 0.02) with a zero bias inside the blocks, or U(+-dt_rank^-1/2)
with the bias softplus^-1 of log-uniform[1e-3, 0.1] in the TimeMamba head.
All normal draws come from one ``torch.randn`` call and all uniform draws
from one ``torch.rand`` call on a generator on the card.
"""

from __future__ import annotations

import math

import torch

from ..reference import model as ref


def _rules(reference: torch.nn.Module):
    """name -> ("normal", std) | ("uniform_dt", bound) | ("dt_bias", None) |
    ("const", value) | ("a_log", None)."""
    in_block = set()
    for m in reference.modules():
        if isinstance(m, (ref.GPTBlock, ref.MambaBlock)):
            in_block.update(id(x) for x in m.modules())
    rules = {}
    for prefix, m in reference.named_modules():
        p = prefix + "." if prefix else ""
        if isinstance(m, (ref.Conv, ref.Linear)):
            fan_in = m.weight[0].numel()
            std = 0.02 if id(m) in in_block else fan_in ** -0.5
            rules[p + "weight"] = ("normal", std)
            if getattr(m, "bias", None) is not None:
                rules[p + "bias"] = ("const", 0.0)
        elif isinstance(m, (ref.BN, ref.LayerNorm, ref.LayerNorm2D)):
            rules[p + "weight"] = ("const", 1.0)
            rules[p + "bias"] = ("const", 0.0)
            if isinstance(m, ref.BN):
                rules[p + "running_mean"] = ("const", 0.0)
                rules[p + "running_var"] = ("const", 1.0)
        elif isinstance(m, ref.Mamba):
            rules[p + "conv1d_weight"] = (
                "normal", m.conv1d_weight.shape[-1] ** -0.5)
            rules[p + "conv1d_bias"] = ("const", 0.0)
            rules[p + "A_log"] = ("a_log", None)
            rules[p + "D"] = ("const", 1.0)
            if id(m) in in_block:
                rules[p + "dt_proj_weight"] = ("normal", 0.02)
                rules[p + "dt_proj_bias"] = ("const", 0.0)
            else:
                rules[p + "dt_proj_weight"] = ("uniform_dt", m.dt_rank ** -0.5)
                rules[p + "dt_proj_bias"] = ("dt_bias", None)
        elif isinstance(m, ref.TokenFusion):
            rules[p + "pos_emb"] = ("const", 0.0)
    return rules


def reference_skeleton(cfg: dict) -> torch.nn.Module:
    """The reference model on the meta device: names and shapes only."""
    with torch.device("meta"):
        return ref.BeamFuserReference(cfg)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The state dict (parameters and BatchNorm buffers, float32) of
    ``cfg``'s model for ``seed``, made on ``device``."""
    skel = reference_skeleton(cfg)
    shapes = {k: tuple(v.shape) for k, v in skel.state_dict().items()}
    rules = _rules(skel)
    missing = set(shapes) - set(rules)
    if missing:
        raise ValueError(f"no initialisation rule for {sorted(missing)}")
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    numel = {k: math.prod(s) for k, s in shapes.items()}
    n_normal = sum(numel[k] for k, r in rules.items() if r[0] == "normal")
    n_unif = sum(numel[k] for k, r in rules.items()
                 if r[0] in ("uniform_dt", "dt_bias"))
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
    out, i_n, i_u = {}, 0, 0
    for k, shape in shapes.items():
        kind, arg = rules[k]
        n = numel[k]
        if kind == "normal":
            out[k] = normal[i_n:i_n + n].view(shape) * arg
            i_n += n
        elif kind == "const":
            out[k] = torch.full(shape, arg, device=device)
        elif kind == "a_log":
            out[k] = torch.log(torch.arange(
                1, shape[1] + 1, dtype=torch.float32, device=device)
            ).expand(shape).contiguous()
        else:
            u = unif[i_u:i_u + n].view(shape)
            i_u += n
            if kind == "uniform_dt":
                out[k] = (2.0 * u - 1.0) * arg
            else:
                lo, hi = math.log(1e-3), math.log(0.1)
                dt = torch.exp(u * (hi - lo) + lo).clamp(min=1e-4)
                out[k] = dt + torch.log(-torch.expm1(-dt))
    return out


@torch.no_grad()
def calibrate_bn(cfg: dict, w: dict, rows: dict, device) -> dict:
    """``w`` with each BatchNorm's running mean and variance set to the
    batch statistics of the float32 reference's train-mode forward over
    ``rows`` (image, lidar, radar, gps arrays), without dropout: the
    statistics a served model has of its data, so that eval-mode
    activations, and the logits, keep the scale training gives them."""
    model = ref.BeamFuserReference(cfg).to(device)
    model.load_state_dict(w)
    model.train()
    x = [torch.as_tensor(rows[k]).to(device)
         for k in ("image", "lidar", "radar", "gps")]
    model(*x)
    out = dict(w)
    for name, m in model.named_modules():
        if isinstance(m, ref.BN):
            out[name + ".running_mean"] = m.batch_stats[0].clone()
            out[name + ".running_var"] = m.batch_stats[1].clone()
    return out
