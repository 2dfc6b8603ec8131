"""Weights carried across from the JAX package.

The port's module names follow the flax scope names
(``encoder.image_encoder.stage1.block0.conv1``,
``encoder.fusion1.block0.attn.query``, ``join_fc1``, ...), so a JAX
``BeamFuser``'s variables map onto the port's ``state_dict`` leaf by leaf
(naming as in ``deepsense6g_tii_tpu/models/checkpoint_import.py:250-315``):

  conv kernel (kh, kw, in, out)   -> weight (out, in, kh, kw)
  Dense kernel (in, out)          -> weight (out, in)
  BatchNorm / LayerNorm scale     -> weight;   bias -> bias
  batch_stats mean / var          -> running_mean / running_var
  pos_emb                         -> pos_emb (unchanged)
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaf(key: str, arr: np.ndarray, stats: bool):
    if stats:
        return _STATS[key], arr
    if key == "kernel":
        return "weight", (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                          else arr.T)
    if key == "scale":
        return "weight", arr
    if key in ("bias", "pos_emb"):
        return key, arr
    raise KeyError(f"no port counterpart for JAX leaf {key!r}")


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
    arrays -> the port ``BeamFuser``'s state_dict (f32, CPU), loadable with
    ``load_state_dict(strict=True)``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str, stats: bool) -> None:
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.", stats)
                continue
            name, arr = _leaf(key, np.asarray(val, dtype=np.float32), stats)
            sd[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(variables["params"], "", False)
    walk(variables.get("batch_stats", {}), "", True)
    return sd
