"""Reference PyTorch checkpoints in and out of the port
(``deepsense6g_tii_tpu/models/checkpoint_import.py``).

The reference saves a ``MambaFuser`` or ``TransFuser`` through
DataParallel (``module.`` prefix; ``best_model.pth``/``final_model.pth``).
``import_reference_checkpoint`` maps such a state_dict onto the flax-shaped
``(params, batch_stats)`` tree of numpy arrays that the JAX package builds
from it, leaf for leaf; the port's model then loads that tree through
``models/weights.py::from_jax_variables`` with ``load_state_dict(strict=
True)``, so one map decides every leaf.  ``export_reference_checkpoint``
writes the reference naming back (a port model goes through
``to_jax_variables`` first).

Layouts (torch -> flax):
  Linear weight (out, in)              -> Dense kernel (in, out)
  Conv2d weight (O, I, H, W)           -> Conv kernel (H, W, I, O)
  mamba conv1d weight (d_inner, 1, k)  -> (k, 1, d_inner)
  mamba dt_proj weight (d_inner, rank) -> (rank, d_inner)
  BatchNorm weight/bias + running_mean/var -> scale/bias + batch_stats
  LayerNorm weight/bias                -> scale/bias (same shape)
  GRUCell weight_ih/hh (3H, .) gates (r, z, n) -> ir/iz/in, hr/hz/hn;
  flax has no hr/hz biases, so bias_hh's r and z parts fold into ir/iz.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

import numpy as np
import torch

from .torch_port import _to_np, convert_resnet_state_dict


class _Importer:
    def __init__(self, sd: Dict):
        # strip the DataParallel prefix
        self.sd = {k[len("module."):] if k.startswith("module.") else k: v
                   for k, v in sd.items()}
        self.used: Set[str] = set()

    def take(self, key: str) -> np.ndarray:
        self.used.add(key)
        return _to_np(self.sd[key])

    def linear(self, prefix: str, bias: bool = True) -> dict:
        out = {"kernel": self.take(prefix + ".weight").T}
        if bias:
            out["bias"] = self.take(prefix + ".bias")
        return out

    def layernorm(self, prefix: str) -> dict:
        return {"scale": self.take(prefix + ".weight"),
                "bias": self.take(prefix + ".bias")}

    def mamba(self, prefix: str) -> dict:
        return {
            "in_proj": {"kernel": self.take(prefix + ".in_proj.weight").T},
            "conv1d_weight": self.take(prefix + ".conv1d.weight")
                                 .transpose(2, 1, 0),
            "conv1d_bias": self.take(prefix + ".conv1d.bias"),
            "x_proj": {"kernel": self.take(prefix + ".x_proj.weight").T},
            "dt_proj_weight": self.take(prefix + ".dt_proj.weight").T,
            "dt_proj_bias": self.take(prefix + ".dt_proj.bias"),
            "A_log": self.take(prefix + ".A_log"),
            "D": self.take(prefix + ".D"),
            "out_proj": {"kernel": self.take(prefix + ".out_proj.weight").T},
        }

    def mamba_block(self, prefix: str) -> dict:
        return {
            "ln1": self.layernorm(prefix + ".ln1"),
            "fc1": self.linear(prefix + ".fc1"),
            "fc2": self.linear(prefix + ".fc2"),
            "forward_mamba": self.mamba(prefix + ".forward_mamba"),
            "backward_mamba": self.mamba(prefix + ".backward_mamba"),
        }

    def gpt_block(self, prefix: str) -> dict:
        return {
            "ln1": self.layernorm(prefix + ".ln1"),
            "ln2": self.layernorm(prefix + ".ln2"),
            "attn": {name: self.linear(f"{prefix}.attn.{name}")
                     for name in ("query", "key", "value", "proj")},
            "mlp_fc": self.linear(prefix + ".mlp.0"),
            "mlp_proj": self.linear(prefix + ".mlp.2"),
        }

    def fusion(self, prefix: str, n_layer: int, kind: str) -> dict:
        out = {"pos_emb": self.take(prefix + ".pos_emb"),
               "ln_f": self.layernorm(prefix + ".ln_f")}
        inner = "mambablocks" if kind == "mamba" else "blocks"
        make = self.mamba_block if kind == "mamba" else self.gpt_block
        for i in range(n_layer):
            out[f"block{i}"] = make(f"{prefix}.{inner}.{i}")
        return out

    def resnet(self, prefix: str) -> Tuple[dict, dict]:
        sub = {k[len(prefix) + 1:]: v for k, v in self.sd.items()
               if k.startswith(prefix + ".")}
        blocks = (3, 4, 6, 3) if any(k.startswith("layer1.2") for k in sub) \
            else (2, 2, 2, 2)
        self.used.update(prefix + "." + k for k in sub
                         if not k.startswith("fc."))
        return convert_resnet_state_dict(sub, blocks=blocks)

    def time_mamba(self, prefix: str) -> dict:
        return {
            "mamba": self.mamba(prefix + ".mamba"),
            "mlp": self.linear(prefix + ".mlp.0"),
            "mlp_gps": self.linear(prefix + ".mlp_gps.0"),
        }

    def gru(self, prefix: str) -> dict:
        w_ih = self.take(prefix + ".weight_ih")      # (3H, in)
        w_hh = self.take(prefix + ".weight_hh")      # (3H, H)
        b_ih = self.take(prefix + ".bias_ih")
        b_hh = self.take(prefix + ".bias_hh")
        H = w_hh.shape[1]

        def g(mat, k):
            return mat[k * H:(k + 1) * H].T

        return {
            "ir": {"kernel": g(w_ih, 0), "bias": b_ih[:H] + b_hh[:H]},
            "iz": {"kernel": g(w_ih, 1),
                   "bias": b_ih[H:2 * H] + b_hh[H:2 * H]},
            "in": {"kernel": g(w_ih, 2), "bias": b_ih[2 * H:3 * H]},
            "hr": {"kernel": g(w_hh, 0)},
            "hz": {"kernel": g(w_hh, 1)},
            "hn": {"kernel": g(w_hh, 2), "bias": b_hh[2 * H:3 * H]},
        }


def import_reference_checkpoint(sd: Dict, config
                                ) -> Tuple[dict, dict, Set[str]]:
    """A reference state_dict (tensors or numpy arrays) -> (params,
    batch_stats, unused reference keys) for ``BeamFuser(config)``: nested
    dicts of numpy arrays in the flax layout.  ``config.FFM`` selects the
    Mamba or GPT fusion naming (mambafusionN, transformerN),
    ``config.TFM`` the time_mamba head, ``pred_len > 1`` the GRU decoder.
    ``num_batches_tracked`` never counts as unused."""
    imp = _Importer(sd)
    enc = "encoder"
    enc_p: dict = {}
    enc_s: dict = {}
    for name, prefix in (("image_encoder", "image_encoder.features"),
                         ("lidar_encoder", "lidar_encoder._model"),
                         ("radar_encoder", "radar_encoder._model")):
        enc_p[name], enc_s[name] = imp.resnet(f"{enc}.{prefix}")
    for i in range(1, 5):
        enc_p[f"vel_emb{i}"] = imp.linear(f"{enc}.vel_emb{i}")

    kind = "mamba" if config.FFM else "gpt"
    torch_name = "mambafusion" if config.FFM else "transformer"
    for i in range(1, 5):
        enc_p[f"fusion{i}"] = imp.fusion(f"{enc}.{torch_name}{i}",
                                         config.n_layer, kind)
    if config.TFM:
        enc_p["time_mamba"] = imp.time_mamba(f"{enc}.time_mamba")

    params = {"encoder": enc_p,
              "join_fc1": imp.linear("join.0"),
              "join_fc2": imp.linear("join.2"),
              "join_fc3": imp.linear("join.4")}
    if config.pred_len > 1:
        params["decoder"] = imp.gru("decoder")
        params["output"] = imp.linear("output")

    unused = {k for k in set(imp.sd) - imp.used
              if not k.endswith("num_batches_tracked")}
    return params, {"encoder": enc_s}, unused


def load_reference_checkpoint(path: str, config):
    """Reads a reference ``.pth`` file (``torch.load(weights_only=True)``)
    and imports it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return import_reference_checkpoint(sd, config)


# -- export (flax layout -> reference naming) ---------------------------------

def _exp_linear(sd, prefix, tree):
    sd[prefix + ".weight"] = _to_np(tree["kernel"]).T
    if "bias" in tree:
        sd[prefix + ".bias"] = _to_np(tree["bias"])


def _exp_layernorm(sd, prefix, tree):
    sd[prefix + ".weight"] = _to_np(tree["scale"])
    sd[prefix + ".bias"] = _to_np(tree["bias"])


def _exp_mamba(sd, prefix, t):
    sd[prefix + ".in_proj.weight"] = _to_np(t["in_proj"]["kernel"]).T
    sd[prefix + ".conv1d.weight"] = _to_np(t["conv1d_weight"]) \
        .transpose(2, 1, 0)
    sd[prefix + ".conv1d.bias"] = _to_np(t["conv1d_bias"])
    sd[prefix + ".x_proj.weight"] = _to_np(t["x_proj"]["kernel"]).T
    sd[prefix + ".dt_proj.weight"] = _to_np(t["dt_proj_weight"]).T
    sd[prefix + ".dt_proj.bias"] = _to_np(t["dt_proj_bias"])
    sd[prefix + ".A_log"] = _to_np(t["A_log"])
    sd[prefix + ".D"] = _to_np(t["D"])
    sd[prefix + ".out_proj.weight"] = _to_np(t["out_proj"]["kernel"]).T


def _exp_bn(sd, prefix, p, s):
    sd[prefix + ".weight"] = _to_np(p["scale"])
    sd[prefix + ".bias"] = _to_np(p["bias"])
    sd[prefix + ".running_mean"] = _to_np(s["mean"])
    sd[prefix + ".running_var"] = _to_np(s["var"])


def _conv_out(kernel) -> np.ndarray:
    """flax HWIO -> torch OIHW."""
    return _to_np(kernel).transpose(3, 2, 0, 1)


def _exp_resnet(sd, prefix, p, s):
    sd[prefix + ".conv1.weight"] = _conv_out(p["stem"]["conv1"]["kernel"])
    _exp_bn(sd, prefix + ".bn1", p["stem"]["bn1"], s["stem"]["bn1"])
    for si in range(1, 5):
        stage_p, stage_s = p[f"stage{si}"], s[f"stage{si}"]
        for bname in stage_p:
            bi = int(bname.replace("block", ""))
            t = f"{prefix}.layer{si}.{bi}"
            bp, bs = stage_p[bname], stage_s[bname]
            for ci in (1, 2):
                sd[f"{t}.conv{ci}.weight"] = _conv_out(
                    bp[f"conv{ci}"]["kernel"])
                _exp_bn(sd, f"{t}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            if "downsample_conv" in bp:
                sd[f"{t}.downsample.0.weight"] = _conv_out(
                    bp["downsample_conv"]["kernel"])
                _exp_bn(sd, f"{t}.downsample.1", bp["downsample_bn"],
                        bs["downsample_bn"])


def export_reference_checkpoint(params: dict, batch_stats: dict,
                                config) -> Dict[str, np.ndarray]:
    """A flax-shaped (params, batch_stats) tree -> a state_dict of numpy
    arrays in the reference naming, ``module.``-prefixed; ``torch.save`` of
    it (as tensors) is a reference ``.pth``."""
    sd: Dict[str, np.ndarray] = {}
    enc_p, enc_s = params["encoder"], batch_stats["encoder"]
    for name, prefix in (("image_encoder", "image_encoder.features"),
                         ("lidar_encoder", "lidar_encoder._model"),
                         ("radar_encoder", "radar_encoder._model")):
        _exp_resnet(sd, f"encoder.{prefix}", enc_p[name], enc_s[name])
    for i in range(1, 5):
        _exp_linear(sd, f"encoder.vel_emb{i}", enc_p[f"vel_emb{i}"])

    torch_name = "mambafusion" if config.FFM else "transformer"
    inner = "mambablocks" if config.FFM else "blocks"
    for i in range(1, 5):
        f = enc_p[f"fusion{i}"]
        pre = f"encoder.{torch_name}{i}"
        sd[pre + ".pos_emb"] = _to_np(f["pos_emb"])
        _exp_layernorm(sd, pre + ".ln_f", f["ln_f"])
        for bname, b in f.items():
            if not bname.startswith("block"):
                continue
            t = f"{pre}.{inner}.{int(bname.replace('block', ''))}"
            _exp_layernorm(sd, t + ".ln1", b["ln1"])
            if config.FFM:
                _exp_linear(sd, t + ".fc1", b["fc1"])
                _exp_linear(sd, t + ".fc2", b["fc2"])
                _exp_mamba(sd, t + ".forward_mamba", b["forward_mamba"])
                _exp_mamba(sd, t + ".backward_mamba", b["backward_mamba"])
            else:
                _exp_layernorm(sd, t + ".ln2", b["ln2"])
                for name in ("query", "key", "value", "proj"):
                    _exp_linear(sd, f"{t}.attn.{name}", b["attn"][name])
                _exp_linear(sd, t + ".mlp.0", b["mlp_fc"])
                _exp_linear(sd, t + ".mlp.2", b["mlp_proj"])

    if config.TFM:
        tm = enc_p["time_mamba"]
        _exp_mamba(sd, "encoder.time_mamba.mamba", tm["mamba"])
        _exp_linear(sd, "encoder.time_mamba.mlp.0", tm["mlp"])
        _exp_linear(sd, "encoder.time_mamba.mlp_gps.0", tm["mlp_gps"])

    _exp_linear(sd, "join.0", params["join_fc1"])
    _exp_linear(sd, "join.2", params["join_fc2"])
    _exp_linear(sd, "join.4", params["join_fc3"])

    if config.pred_len > 1 and "decoder" in params:
        d = params["decoder"]
        hn_bias = _to_np(d["hn"]["bias"])
        zeros = np.zeros_like(hn_bias)
        sd["decoder.weight_ih"] = np.concatenate(
            [_to_np(d[k]["kernel"]).T for k in ("ir", "iz", "in")], 0)
        sd["decoder.weight_hh"] = np.concatenate(
            [_to_np(d[k]["kernel"]).T for k in ("hr", "hz", "hn")], 0)
        sd["decoder.bias_ih"] = np.concatenate(
            [_to_np(d[k]["bias"]) for k in ("ir", "iz", "in")])
        sd["decoder.bias_hh"] = np.concatenate(
            [zeros, zeros, hn_bias])
        _exp_linear(sd, "output", params["output"])

    return {"module." + k: v for k, v in sd.items()}


def save_reference_checkpoint(model, path: str) -> Dict[str, np.ndarray]:
    """Writes a port ``BeamFuser`` as a reference ``.pth`` (f32 tensors in
    the reference naming); returns the exported state_dict."""
    from .weights import to_jax_variables

    v = to_jax_variables(model.state_dict())
    sd = export_reference_checkpoint(v["params"], v["batch_stats"],
                                     model.config)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in sd.items()}, path)
    return sd
