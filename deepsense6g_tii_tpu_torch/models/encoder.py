"""Multi-scale multi-modal fusion encoder
(``deepsense6g_tii_tpu/models/encoder.py:49-331``), GPT or Mamba fusion
(``FFM``) with the token-sum or the TimeMamba head (``TFM``).

Per-modality ResNet stem + stage1, then four rounds of { adaptive-avgpool
to the vh x hz anchors; fuse with the GPS embedding chain; bilinear-upsample
back by 8, 4, 2, 1; residual add; next ResNet stage }, then a global average
pool into per-frame 512-d tracks and the temporal head.  Batch and time are
flattened into one leading axis for the convolutions.  The Mamba fusion
rotates channel thirds between the modalities (``channel_swap``).

Dtype boundaries follow the JAX package: the image is normalised in f32 and
then cast to the compute dtype; the GPS stream stays f32 between stages;
fusion outputs are cast to the feature dtype before the residual; the tracks
are pooled and then cast to f32.

``modality_missing`` replaces a modality's input after normalisation with
zeros (``zerolike``) or uniform [0, 1) noise (``randlike``) drawn from the
``generator`` the caller passes to ``forward``; JAX's random bits cannot be
matched.  Not in the port (they raise): the rebuild-feature hook and the
merged lidar/radar backbones.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import GlobalConfig
from ..data.features import normalize_imagenet
from ..ops.dropout import DropoutRNG
from ..ops.pooling import adaptive_avg_pool, global_avg_pool
from ..ops.resize import interpolate_bilinear
from .fusion import TimeMamba, TokenFusion
from .resnet import (RESNET18_BLOCKS, RESNET34_BLOCKS, STAGE_FEATURES,
                     ResNetBackbone)

STAGE_UPSAMPLE = (8, 4, 2, 1)


def _flatten_bt(x):
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _unflatten_bt(x, b: int):
    return x.reshape((b, x.shape[0] // b) + tuple(x.shape[1:]))


MISSING = {"image": ("image",), "lidar": ("lidar",), "radar": ("radar",),
           "lidar_radar": ("lidar", "radar"),
           "radar_lidar": ("lidar", "radar")}


def _check_supported(cfg: GlobalConfig) -> None:
    unsupported = {
        "merge_lidar_radar": cfg.merge_lidar_radar,
        "merge_lr_stage1": cfg.merge_lr_stage1,
    }
    bad = [k for k, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(
            "not in the PyTorch port: " + ", ".join(bad)
            + " (TPU lowering knobs, ROADMAP.md Queue 1, Out of scope)")
    if cfg.modality_missing is not None and (
            cfg.modality_missing not in MISSING
            or cfg.modality_missing_type not in ("zerolike", "randlike")):
        raise ValueError(f"unknown modality_missing {cfg.modality_missing!r} "
                         f"/ {cfg.modality_missing_type!r}")


class FusionEncoder(nn.Module):
    def __init__(self, config: GlobalConfig):
        super().__init__()
        _check_supported(config)
        cfg = self.config = config
        self.dtype = getattr(torch, cfg.compute_dtype)
        img_blocks = cfg.backbone_blocks or RESNET34_BLOCKS
        oth_blocks = cfg.backbone_blocks or RESNET18_BLOCKS
        self.image_encoder = ResNetBackbone(3, img_blocks)
        self.lidar_encoder = ResNetBackbone(1, oth_blocks)
        self.radar_encoder = ResNetBackbone(2 if cfg.add_velocity else 1,
                                            oth_blocks)
        gps_in = (2,) + STAGE_FEATURES[:3]
        for i in range(4):
            self.add_module(f"vel_emb{i + 1}",
                            nn.Linear(gps_in[i], STAGE_FEATURES[i]))
            self.add_module(f"fusion{i + 1}", TokenFusion(
                n_embd=STAGE_FEATURES[i], n_layer=cfg.n_layer,
                n_tokens=cfg.n_tokens, n_head=cfg.n_head,
                block_exp=cfg.block_exp,
                fusion_type="mamba" if cfg.FFM else "gpt",
                use_flash=cfg.use_flash_attention, dtype=self.dtype,
                channel_swap=bool(cfg.FFM), d_state=cfg.d_state,
                d_conv=cfg.d_conv, expand=cfg.expand,
                use_scan_kernel=cfg.use_pallas_scan,
                reverse_scan_kernel=cfg.reverse_scan_kernel,
                padded_stream=cfg.padded_token_stream,
                embd_pdrop=cfg.embd_pdrop, attn_pdrop=cfg.attn_pdrop,
                resid_pdrop=cfg.resid_pdrop))
        if cfg.TFM:
            self.time_mamba = TimeMamba(
                STAGE_FEATURES[3], cfg.seq_len, cfg.gps_len, cfg.d_state,
                cfg.d_conv, cfg.expand, use_kernel=cfg.use_pallas_scan,
                dtype=self.dtype)

    def _apply_missing(self, streams, generator):
        cfg = self.config
        names = MISSING.get(cfg.modality_missing, ())
        if names and cfg.modality_missing_type == "randlike" and (
                generator is None):
            raise ValueError("modality_missing_type='randlike' draws from a "
                             "torch.Generator: pass generator= on the "
                             "streams' device")
        out = []
        for name, x in zip(("image", "lidar", "radar"), streams):
            if name not in names:
                out.append(x)
            elif cfg.modality_missing_type == "zerolike":
                out.append(torch.zeros_like(x))
            else:
                out.append(torch.rand(x.shape, generator=generator,
                                      dtype=x.dtype, device=x.device))
        return out

    def forward(self, image, lidar, radar, gps, rebuild_feats=None,
                generator: Optional[torch.Generator] = None,
                rng: Optional[DropoutRNG] = None):
        """image: (B, T, H, W, 3) in [0, 255]; lidar: (B, T, H, W, 1);
        radar: (B, T, H, W, 1|2); gps: (B, gps_len, 2).  Returns the (B, 512)
        fused features in f32.  ``generator`` feeds
        ``modality_missing_type="randlike"``; ``rng`` the fusion stages'
        dropout in train mode (BatchNorm follows ``self.training`` too)."""
        if rebuild_feats is not None:
            raise NotImplementedError(
                "rebuild_feats (the modality-rebuild hook) is not in the "
                "PyTorch port yet (ROADMAP.md Queue 1 item 9)")
        cfg, dtype = self.config, self.dtype
        B = image.shape[0]
        streams = self._apply_missing(
            (normalize_imagenet(image.float()), lidar.float(), radar.float()),
            generator)
        streams = [_flatten_bt(x).to(dtype) for x in streams]
        backbones = (self.image_encoder, self.lidar_encoder,
                     self.radar_encoder)
        feats = [bb.stage1(bb.stem(x)) for bb, x in zip(backbones, streams)]

        gps_feats = gps.float()
        for i in range(4):
            anchors = [_unflatten_bt(adaptive_avg_pool(
                f, cfg.vert_anchors, cfg.horz_anchors), B) for f in feats]
            gps_emb = getattr(self, f"vel_emb{i + 1}")(gps_feats).to(dtype)
            *outs, gps_feats = getattr(self, f"fusion{i + 1}")(
                *anchors, gps_emb, rng=rng)
            gps_feats = gps_feats.float()
            outs = [interpolate_bilinear(_flatten_bt(o), STAGE_UPSAMPLE[i])
                    for o in outs]
            feats = [f + o.to(f.dtype) for f, o in zip(feats, outs)]
            if i < 3:
                feats = [getattr(bb, f"stage{i + 2}")(f)
                         for bb, f in zip(backbones, feats)]

        tracks = [_unflatten_bt(global_avg_pool(f), B).float() for f in feats]
        if cfg.TFM:
            return self.time_mamba(*tracks, gps_feats)
        return sum(t.sum(dim=1) for t in tracks) + gps_feats.sum(dim=1)
