"""Weights carried across from the JAX package.

The port's module names follow the flax scope names
(``encoder.image_encoder.stage1.block0.conv1``,
``encoder.fusion1.block0.attn.query``, ``join_fc1``, ...), so a JAX
``BeamFuser``'s variables map onto the port's ``state_dict`` leaf by leaf
(naming as in ``deepsense6g_tii_tpu/models/checkpoint_import.py:250-315``):

  conv kernel (kh, kw, in, out)   -> weight (out, in, kh, kw)
  Dense kernel (in, out)          -> weight (out, in)
  BatchNorm / LayerNorm scale     -> weight;   bias -> bias
                                     (a MambaBlock's ln1 is (n_tokens, C))
  batch_stats mean / var          -> running_mean / running_var
  pos_emb                         -> pos_emb (unchanged)
  Mamba conv1d_weight (K, 1, d)   -> conv1d_weight (d, 1, K)
  Mamba conv1d_bias, dt_proj_weight (dt_rank, d), dt_proj_bias, A_log
  (d, n), D                       -> the same names, unchanged

The GRU decoder of the 30-to-5 variant (``decoder.ir/iz/in/hr/hz/hn``)
and its ``output`` head are Dense layers, mapped as such.  So are the
modality-rebuild heads (``rebuild/trainer.py::RebuildHeads``: Dense
``fc1..3`` and BatchNorm ``bn1``, ``bn2`` under ``{image,lidar,radar}_
projection_l1`` and ``feat_trans_l1``): a JAX ``RebuildHeads`` tree, or one
head's, goes through the same two functions.  Any other leaf
raises ``KeyError``.  ``to_jax_variables`` is the inverse map: a port
state_dict (a trained ``.pt`` file) becomes the flax-shaped tree that
``models/checkpoint_import.py::export_reference_checkpoint`` writes out
in the reference's naming.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_AS_IS = ("bias", "pos_emb", "conv1d_bias", "dt_proj_weight", "dt_proj_bias",
          "A_log", "D")
# the port's LayerNorm and BatchNorm modules: their ``weight`` is a scale
# (a MambaBlock's ln1 is 2-D, so the shape cannot tell)
_NORMS = ("ln1", "ln2", "ln_f", "bn1", "bn2", "downsample_bn")


def _leaf(key: str, arr: np.ndarray, stats: bool):
    if stats:
        return _STATS[key], arr
    if key == "kernel":
        return "weight", (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                          else arr.T)
    if key == "scale":
        return "weight", arr
    if key == "conv1d_weight":
        return key, arr.transpose(2, 1, 0)
    if key in _AS_IS:
        return key, arr
    raise KeyError(f"no port counterpart for JAX leaf {key!r}")


def _f32(val) -> np.ndarray:
    """A leaf (numpy array or tensor, bf16 included) as f32 numpy."""
    if torch.is_tensor(val):
        return val.detach().to("cpu", torch.float32).numpy()
    return np.asarray(val, dtype=np.float32)


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
    arrays (or tensors) -> the port ``BeamFuser``'s (or ``RebuildHeads``')
    state_dict (f32, CPU), loadable with ``load_state_dict(strict=True)``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str, stats: bool) -> None:
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.", stats)
                continue
            name, arr = _leaf(key, _f32(val), stats)
            sd[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(variables["params"], "", False)
    walk(variables.get("batch_stats", {}), "", True)
    return sd


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port ``BeamFuser``'s state_dict -> ``{"params": ...,
    "batch_stats": ...}`` as nested dicts of f32 numpy arrays, the inverse
    of :func:`from_jax_variables` leaf for leaf."""
    out: Dict = {"params": {}, "batch_stats": {}}
    stats = {v: k for k, v in _STATS.items()}
    for key, val in state_dict.items():
        *path, name = key.split(".")
        arr = _f32(val)
        if name in stats:
            tree, leaf = out["batch_stats"], stats[name]
        else:
            tree = out["params"]
            if name == "weight" and path[-1] in _NORMS:
                leaf = "scale"
            elif name == "weight":
                leaf = "kernel"
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            elif name == "conv1d_weight":
                leaf, arr = name, arr.transpose(2, 1, 0)
            elif name in _AS_IS:
                leaf = name
            else:
                raise KeyError(f"no JAX counterpart for port leaf {key!r}")
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = np.ascontiguousarray(arr)
    return out
