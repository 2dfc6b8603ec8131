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
matched.

The modality-rebuild hook (``encoder.py:173-191`` of the JAX package):
``rebuild_feats``, (B·T, h, w, 64) features that the rebuild heads
synthesised, replace the stage-1 features of ``modality_missing`` before
the first fusion stage: always in eval mode, and in train mode (``image``
only) on a Bernoulli(0.25) draw per call from ``rebuild_generator``.
``return_stage1`` also returns the three stage-1 maps after that
injection.  :meth:`FusionEncoder.encode_stage1` computes the stage-1 maps
alone (normalise, stem, stage1; no missing-modality substitution), the
rebuild subsystem's tap: JAX's ``encode_stage1`` runs the whole encoder and
XLA drops the fusion stages that nothing reads, which eager PyTorch would
run.  Not in the port (they raise): the merged lidar/radar backbones.
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
                     ResNetBackbone, bn_sample_mask)

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

    def _streams(self, image, lidar, radar):
        """The three inputs as f32, the image normalised."""
        return (normalize_imagenet(image.float()), lidar.float(),
                radar.float())

    def _stage1(self, streams, backbones, masks=(None,) * 3):
        """Flatten (B, T) and cast each stream, then stem and stage1."""
        return [bb.stage1(bb.stem(_flatten_bt(x).to(self.dtype), m), m)
                for bb, x, m in zip(backbones, streams, masks)]

    def encode_stage1(self, image, lidar, radar, backbones=None):
        """The three stage-1 maps, image, lidar, radar, each (B·T, h, w,
        64) in the compute dtype, without the missing-modality substitution
        and without running any fusion stage.  ``backbones`` (three modules
        with ``stem`` and ``stage1``; default the encoder's own) lets the
        rebuild trainer tap its frozen copies."""
        if backbones is None:
            backbones = (self.image_encoder, self.lidar_encoder,
                         self.radar_encoder)
        return self._stage1(self._streams(image, lidar, radar), backbones)

    def _inject_rebuild(self, feats, rebuild, generator):
        """``rebuild`` in place of ``modality_missing``'s stage-1 features:
        always in eval mode; in train mode for ``image`` only, with
        probability 0.25 per call (one draw from ``generator``)."""
        miss = self.config.modality_missing
        if rebuild is None or miss not in ("image", "lidar", "radar"):
            return feats
        i = ("image", "lidar", "radar").index(miss)
        if self.training and miss == "image":
            if generator is None:
                raise ValueError("rebuild_feats in train mode draw whether "
                                 "to inject from rebuild_generator: pass it")
            if not bool(torch.rand((), generator=generator,
                                   device=generator.device) < 0.25):
                return feats
        feats = list(feats)
        feats[i] = rebuild.to(feats[i].dtype)
        return feats

    def forward(self, image, lidar, radar, gps, rebuild_feats=None,
                return_stage1: bool = False, apply_missing: bool = True,
                generator: Optional[torch.Generator] = None,
                rng: Optional[DropoutRNG] = None,
                rebuild_generator: Optional[torch.Generator] = None,
                sample_mask: Optional[torch.Tensor] = None):
        """image: (B, T, H, W, 3) in [0, 255]; lidar: (B, T, H, W, 1);
        radar: (B, T, H, W, 1|2); gps: (B, gps_len, 2).  Returns the (B, 512)
        fused features in f32, and with ``return_stage1`` also the three
        stage-1 maps after the rebuild injection.  ``generator`` feeds
        ``modality_missing_type="randlike"`` (skipped when ``apply_missing``
        is false); ``rng`` the fusion stages' dropout in train mode
        (BatchNorm follows ``self.training`` too).  ``rebuild_feats``
        ((B·T, h, w, 64)) replace the missing modality's stage-1 features;
        ``rebuild_generator`` (a CPU generator, so that the draw never waits
        for the card) decides the train-mode injection (JAX's
        ``make_rng("rebuild")``).  ``sample_mask`` ((B,), 1.0 real / 0.0
        padded) keeps padded rows out of BatchNorm's train-mode statistics,
        each stream by its own frames a sample (``bn_sample_mask``)."""
        cfg = self.config
        B = image.shape[0]
        masks = [None if sample_mask is None
                 else bn_sample_mask(sample_mask, x.shape[1])
                 for x in (image, lidar, radar)]
        streams = self._streams(image, lidar, radar)
        if apply_missing:
            streams = self._apply_missing(streams, generator)
        backbones = (self.image_encoder, self.lidar_encoder,
                     self.radar_encoder)
        feats = self._inject_rebuild(self._stage1(streams, backbones, masks),
                                     rebuild_feats, rebuild_generator)
        stage1_feats = feats

        gps_feats = gps.float()
        for i in range(4):
            anchors = [_unflatten_bt(adaptive_avg_pool(
                f, cfg.vert_anchors, cfg.horz_anchors), B) for f in feats]
            gps_emb = getattr(self, f"vel_emb{i + 1}")(gps_feats).to(
                self.dtype)
            *outs, gps_feats = getattr(self, f"fusion{i + 1}")(
                *anchors, gps_emb, rng=rng)
            gps_feats = gps_feats.float()
            outs = [interpolate_bilinear(_flatten_bt(o), STAGE_UPSAMPLE[i])
                    for o in outs]
            feats = [f + o.to(f.dtype) for f, o in zip(feats, outs)]
            if i < 3:
                feats = [getattr(bb, f"stage{i + 2}")(f, m)
                         for bb, f, m in zip(backbones, feats, masks)]

        tracks = [_unflatten_bt(global_avg_pool(f), B).float() for f in feats]
        if cfg.TFM:
            fused = self.time_mamba(*tracks, gps_feats)
        else:
            fused = sum(t.sum(dim=1) for t in tracks) + gps_feats.sum(dim=1)
        if return_stage1:
            return fused, stage1_feats
        return fused
