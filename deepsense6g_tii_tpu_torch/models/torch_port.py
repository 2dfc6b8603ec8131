"""Torchvision ResNet weights for the port's backbones
(``deepsense6g_tii_tpu/models/torch_port.py:26-79``).

The reference initialises its encoders from torchvision ImageNet
checkpoints (``models.resnet34(weights=True)`` for the camera,
``models.resnet18(weights=True)`` for LiDAR and radar, whose 1/2-channel
conv1 keeps its random init).  ``convert_resnet_state_dict`` turns a
torchvision-format state_dict (tensors or numpy arrays, standard key names:
``conv1.weight``, ``layerX.Y.bn1.running_mean``, ...) into the flax-shaped
``(params, batch_stats)`` trees of the JAX package's ``ResNetBackbone``;
``graft_backbone`` loads such trees into one backbone of a port
``BeamFuser`` through ``models/weights.py::from_jax_variables``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _to_np(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _conv(sd, key) -> np.ndarray:
    """torch OIHW -> flax HWIO."""
    return _to_np(sd[key]).transpose(2, 3, 1, 0)


def _bn(sd, prefix) -> Tuple[dict, dict]:
    params = {"scale": _to_np(sd[prefix + ".weight"]),
              "bias": _to_np(sd[prefix + ".bias"])}
    stats = {"mean": _to_np(sd[prefix + ".running_mean"]),
             "var": _to_np(sd[prefix + ".running_var"])}
    return params, stats


def convert_resnet_state_dict(sd: Dict, blocks=(2, 2, 2, 2),
                              port_conv1: bool = True):
    """Returns (params, batch_stats) for one backbone, as nested dicts of
    numpy arrays.  ``port_conv1=False`` skips the stem conv (the
    reference's swapped 1/2-channel conv1 for LiDAR/radar keeps its random
    init)."""
    params: dict = {"stem": {}}
    stats: dict = {"stem": {}}
    if port_conv1:
        params["stem"]["conv1"] = {"kernel": _conv(sd, "conv1.weight")}
    params["stem"]["bn1"], stats["stem"]["bn1"] = _bn(sd, "bn1")

    for si, nb in enumerate(blocks, start=1):
        sp: dict = {}
        ss: dict = {}
        for bi in range(nb):
            t = f"layer{si}.{bi}"
            bp: dict = {}
            bs: dict = {}
            for ci in (1, 2):
                bp[f"conv{ci}"] = {"kernel": _conv(sd, f"{t}.conv{ci}.weight")}
                bp[f"bn{ci}"], bs[f"bn{ci}"] = _bn(sd, f"{t}.bn{ci}")
            if f"{t}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {
                    "kernel": _conv(sd, f"{t}.downsample.0.weight")}
                bp["downsample_bn"], bs["downsample_bn"] = _bn(
                    sd, f"{t}.downsample.1")
            sp[f"block{bi}"] = bp
            ss[f"block{bi}"] = bs
        params[f"stage{si}"] = sp
        stats[f"stage{si}"] = ss
    return params, stats


def load_torchvision_checkpoint(path: str, blocks=(2, 2, 2, 2),
                                port_conv1: bool = True):
    """Loads a torchvision ResNet .pth file (a state_dict, or a module that
    has one) and converts it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_resnet_state_dict(sd, blocks=blocks, port_conv1=port_conv1)


def graft_backbone(model, backbone_name: str, ported_params: dict,
                   ported_stats: dict) -> None:
    """Loads converted weights into ``model.encoder.<backbone_name>`` (a
    port ``BeamFuser``; ``image_encoder``, ``lidar_encoder`` or
    ``radar_encoder``) in place.  Leaves the trees do not hold (a skipped
    conv1) keep their current values; a leaf the backbone does not have
    raises ``KeyError``."""
    from .weights import from_jax_variables

    sd = from_jax_variables({
        "params": {"encoder": {backbone_name: ported_params}},
        "batch_stats": {"encoder": {backbone_name: ported_stats}}})
    own = model.state_dict()
    unknown = sorted(set(sd) - set(own))
    if unknown:
        raise KeyError(f"{backbone_name}: no such leaves in the model: "
                       f"{unknown[:3]}")
    with torch.no_grad():
        for key, val in sd.items():
            if own[key].shape != val.shape:
                raise ValueError(f"{key}: shape {tuple(val.shape)}, the "
                                 f"model's {tuple(own[key].shape)}")
            own[key].copy_(val)
