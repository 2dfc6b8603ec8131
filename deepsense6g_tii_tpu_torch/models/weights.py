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

Any other leaf raises ``KeyError``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_AS_IS = ("bias", "pos_emb", "conv1d_bias", "dt_proj_weight", "dt_proj_bias",
          "A_log", "D")


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
