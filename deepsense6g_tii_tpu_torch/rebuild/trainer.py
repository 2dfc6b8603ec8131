"""Modality-rebuild training subsystem (``deepsense6g_tii_tpu/rebuild/
trainer.py``).

Frozen per-modality stage-1 features feed three ProjectHeads whose outputs
split into shared and specific halves; a FeatureTrans translates the
sources' shared halves into the target modality's stage-1 features.  The
step's loss is

  total = alpha_trans · MSE(FeatureTrans(cat(source shared)), target_l1)
        + alpha_contrast · NT-Xent over the three shared pairs / 3
        + alpha_distance · (−MSE) over the three specific pairs / 3
        + alpha_fusion · focal loss through the whole fusion model, the
          translated features injected by the encoder's rebuild hook

with the fusion model trained at ``fusion_lr`` (1e-6) while the heads train
at the scheduled learning rate: one AdamW with two parameter groups, the
algebra of the JAX package's optax ``multi_transform``.  The fusion model
runs in eval mode (BatchNorm running statistics, no dropout) with
gradients, the heads in train mode.  At eval, :meth:`rebuild_features`
synthesises the missing modality's stage-1 features from the sources.

The stage-1 tap runs *frozen copies* of the three backbones' stem and
stage1, taken from the fusion model at :meth:`RebuildTrainer.init_state`
(the reference's split-checkpoint encoders, my_test.py; JAX's
``frozen_params``), so the translation and contrastive targets stay fixed
while the fusion model itself trains.  The tap computes the stage-1 maps
alone (``BeamFuser.encode_stage1``): no fusion stage, no kernel launch.

Randomness.  Step s draws the heads' dropout from a generator on the
model's device seeded by ``SeedSequence([seed, s])`` and, for
``modality_missing_type="randlike"``, the substitute noise from one seeded
by ``SeedSequence([seed, s + 2])``; eval batch i of step s from
``SeedSequence([seed, s, i])``.  Over a process group the two train-step
generators take the rank as a last word (``[seed, s, rank]``, ``[seed,
s + 2, rank]``), as ``train/steps.py::_Generators`` does: the same masks
on every rank's rows would correlate them.  JAX's random bits cannot be
matched.

Data parallelism (``mesh``; JAX ``RebuildTrainer(mesh=...)``, which the
JAX rebuild CLI always passes).  With a rank's share of a process group
(``parallel.mesh.make_mesh()`` after ``parallel.distributed.initialize``;
one process per GPU), :meth:`RebuildTrainer.train_step` takes this rank's
rows of the global batch, the contiguous block ``Mesh.rows`` names, and
computes JAX's step on the global batch, whose NT-Xent similarity and
head BatchNorm statistics couple every row:

* :meth:`init_state` broadcasts rank 0's heads and fusion model
  (``parallel.mesh.replicate``) before it copies the frozen stem+stage1;
* the heads' BatchNorms take their statistics over the group
  (``parallel.mesh.sync_batchnorm``; ``models/resnet.py``);
* each loss term is this rank's share of the global batch's mean
  (``rebuild/losses.py``; the focal loss over the global row count), and
  NT-Xent gathers the ranks' normalised embeddings with autograd
  (``parallel.distributed.all_gather_rows``), so that the backward of the
  gather hands each rank the gradient of the global loss with respect to
  its rows;
* after the backward, one all-reduce through a flat buffer
  (``train/steps.py::_flat_all_reduce``) sums the gradients, the zero ones
  of unused parameters included, and the five loss terms; the two-group
  AdamW then steps on the same numbers on every rank, which keeps the
  ranks' heads, fusion model, head statistics and optimizer state
  bit-equal.

The eval path (:meth:`rebuild_features`, :meth:`eval_step`) runs on the
rows it is given with no collective: BatchNorm takes running statistics
there.  JAX's ``shard`` replicates a batch whose rows do not divide over
the devices; the port has no counterpart, since a rank never holds the
global batch, and :meth:`RebuildTrainer.shard` moves this rank's rows to
its device.  The ranks must hold equal row counts in a train step (the
gather raises on every rank otherwise).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import GlobalConfig
from ..models.fuser import init_weights
from ..parallel.mesh import Mesh, replicate, sync_batchnorm
from ..train.losses import focal_loss
from ..train.steps import _flat_all_reduce, _to_device
from ..utils.device import resolve_device
from .heads import FeatureTrans, ProjectHead
from .losses import contrastive_loss, distance_loss, translation_loss

MODALITIES = ("image", "lidar", "radar")
ENCODERS = ("image_encoder", "lidar_encoder", "radar_encoder")
PAIRS = (("image", "lidar"), ("image", "radar"), ("lidar", "radar"))
FEAT_DIM = 64          # stage-1 channels
HEAD_KEYS = tuple(f"{m}_projection_l1" for m in MODALITIES) + (
    "feat_trans_l1",)


class RebuildHeads(nn.Module):
    """The three ProjectHeads and the FeatureTrans as one module, named as
    the JAX package's ``RebuildHeads`` scopes: ``{image,lidar,radar}_
    projection_l1`` and ``feat_trans_l1`` (input: 64 shared channels a
    source)."""

    def __init__(self, source_domain: Sequence[str] = ("lidar", "radar")):
        super().__init__()
        self.source_domain = tuple(source_domain)
        for m in MODALITIES:
            self.add_module(f"{m}_projection_l1", ProjectHead(FEAT_DIM))
        self.feat_trans_l1 = FeatureTrans(
            in_dim=FEAT_DIM * len(self.source_domain))

    def forward(self, feats: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """feats: modality -> (N, spatial, 64) stage-1 features, at least
        the sources.  Returns (projections dict, translated target features
        (N, spatial, 64) f32); ``generator`` feeds FeatureTrans's dropout in
        train mode."""
        proj = {m: getattr(self, f"{m}_projection_l1")(f)
                for m, f in feats.items()}
        shared = {m: p[..., : p.shape[-1] // 2] for m, p in proj.items()}
        source = torch.cat([shared[m] for m in self.source_domain], dim=-1)
        return proj, self.feat_trans_l1(source, generator)


class _Stage1(nn.Module):
    """A copy of one backbone's stem and stage1."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.stem = copy.deepcopy(backbone.stem)
        self.stage1 = copy.deepcopy(backbone.stage1)


@dataclasses.dataclass
class RebuildState:
    heads: RebuildHeads
    fusion_model: nn.Module
    optimizer: torch.optim.AdamW    # group 0 the heads, group 1 the fusion
    # frozen stem+stage1 copies of the image, lidar and radar backbones:
    # the tap that gives the translation and contrastive targets runs these,
    # never the trainable fusion model
    frozen: nn.ModuleList
    step: int = 0


@dataclasses.dataclass
class RebuildOptions:
    source_domain: Tuple[str, ...] = ("lidar", "radar")
    target_domain: str = "image"
    alpha_trans: float = 1.0
    alpha_contrast: float = 1.0
    alpha_distance: float = 1.0
    alpha_fusion: float = 1.0
    temp: float = 0.1                 # NT-Xent temperature (--temp)
    lr: float = 1e-4
    fusion_lr: float = 1e-6
    weight_decay: float = 1e-4
    seed: int = 100


def make_rebuild_optimizer(heads: nn.Module, fusion_model: nn.Module,
                           opts: RebuildOptions) -> torch.optim.AdamW:
    """AdamW over the heads (learning rate set per step) and the fusion
    model at ``fusion_lr``, both with weight decay ``weight_decay``: optax
    ``multi_transform`` of ``inject_hyperparams(adamw)`` and ``adamw``."""
    return torch.optim.AdamW(
        [{"params": list(heads.parameters()), "lr": opts.lr},
         {"params": list(fusion_model.parameters()), "lr": opts.fusion_lr}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=opts.weight_decay)


def _generator(device, *entropy) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


class RebuildTrainer:
    """Owns the heads and a fusion model (a ``BeamFuser`` whose config has
    ``modality_missing`` = the target) and runs the rebuild train, rebuild
    and eval steps on ``device``.  ``device="cuda"`` (the default) raises
    without CUDA; tests pass ``device="cpu"``.  The heads are initialised
    from ``opts.seed`` (the JAX package's initialisers, untruncated).
    ``mesh``: a rank's share of a process group (its device is
    ``device``), which trains data-parallel (the module's docstring);
    ``None`` or a one-rank group, a single process."""

    def __init__(self, fusion_model: nn.Module, cfg: GlobalConfig,
                 opts: RebuildOptions, device="cuda",
                 mesh: Optional[Mesh] = None):
        if cfg.modality_missing != opts.target_domain:
            raise ValueError(
                "config.modality_missing must equal the rebuild target "
                f"({opts.target_domain!r}) so the encoder injects the "
                "rebuilt features")
        if mesh is not None and len(mesh.devices) != 1:
            raise ValueError(
                f"the rebuild trainer trains on one device a rank; a mesh "
                f"of {len(mesh.devices)} local devices is a serving mesh: "
                f"start a rank a device (torch.distributed.run)")
        self.device = resolve_device(device)
        self.fusion_model = fusion_model.to(self.device)
        self.cfg = cfg
        self.opts = opts
        self.mesh = mesh
        self.group = (mesh.group if mesh is not None and mesh.world_size > 1
                      else None)
        # the train step's generators take the rank as a last word
        self._rank = () if self.group is None else (mesh.rank,)
        self.heads = RebuildHeads(opts.source_domain)
        init_weights(self.heads, torch.Generator().manual_seed(opts.seed))
        self.heads.to(self.device)
        sync_batchnorm(self.heads, mesh)
        self.state: Optional[RebuildState] = None

    # -- device placement and state ------------------------------------------

    def shard(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch's tensors on the device (scenario names dropped):
        over a mesh, this rank's rows as they are."""
        return _to_device(batch, self.device)

    def init_state(self) -> RebuildState:
        """The optimizer, the step and the frozen stem+stage1 copies, taken
        from the fusion model's current weights and statistics; over a
        group, rank 0's heads and fusion model first."""
        if self.group is not None:
            replicate(self.heads, self.mesh)
            replicate(self.fusion_model, self.mesh)
        enc = self.fusion_model.encoder
        frozen = nn.ModuleList(_Stage1(getattr(enc, name))
                               for name in ENCODERS)
        frozen.eval().requires_grad_(False)
        self.state = RebuildState(
            heads=self.heads, fusion_model=self.fusion_model,
            optimizer=make_rebuild_optimizer(self.heads, self.fusion_model,
                                             self.opts),
            frozen=frozen)
        return self.state

    def _require_state(self) -> RebuildState:
        if self.state is None:
            raise RuntimeError("RebuildTrainer: call init_state() first")
        return self.state

    # -- internals ---------------------------------------------------------

    @torch.no_grad()
    def _frozen_stage1(self, b) -> Dict[str, torch.Tensor]:
        """modality -> (B·T, h·w, 64) f32 stage-1 features of the frozen
        copies."""
        maps = self.fusion_model.encode_stage1(
            b["image"], b["lidar"], b["radar"], self._require_state().frozen)
        return {m: f.reshape(f.shape[0], -1, f.shape[-1]).float()
                for m, f in zip(MODALITIES, maps)}

    def _missing_generator(self, *entropy):
        if self.cfg.modality_missing_type != "randlike":
            return None
        return _generator(self.device, self.opts.seed, *entropy)

    @staticmethod
    def _as_maps(s2t):
        n, hw, c = s2t.shape
        side = math.isqrt(hw)
        return s2t.reshape(n, side, side, c)

    # -- steps -------------------------------------------------------------

    def train_step(self, batch, lr: float, floats: bool = False
                   ) -> Dict[str, object]:
        """One step at the heads' learning rate ``lr``.  Returns the total
        ``loss`` and the ``trans``, ``contrast``, ``distance`` and
        ``fusion`` terms as 0-d tensors on the device, or as floats (one
        read-back) with ``floats``; over a group, ``batch`` is this rank's
        rows and the losses are the global batch's."""
        st, opts, cfg, group = (self._require_state(), self.opts, self.cfg,
                                self.group)
        b = self.shard(batch)
        self.fusion_model.eval()
        self.heads.train()
        feats = self._frozen_stage1(b)
        proj, s2t = self.heads(
            feats, _generator(self.device, opts.seed, st.step, *self._rank))
        half = proj[MODALITIES[0]].shape[-1] // 2
        l_con = sum(contrastive_loss(proj[a][..., :half],
                                     proj[c][..., :half], cfg.seq_len,
                                     temperature=opts.temp, group=group)
                    for a, c in PAIRS) / 3.0
        l_dis = sum(distance_loss(proj[a][..., half:], proj[c][..., half:],
                                  group=group)
                    for a, c in PAIRS) / 3.0
        l_trans = translation_loss(s2t, feats[opts.target_domain],
                                   group=group)
        logits = self.fusion_model(
            b["image"], b["lidar"], b["radar"], b["gps"],
            rebuild_feats=self._as_maps(s2t),
            generator=self._missing_generator(st.step + 2, *self._rank))
        # over a group, the global batch's row count: the contrastive
        # gather above raised unless every rank holds as many rows
        denom = (None if group is None else torch.full(
            (), float(logits.shape[0] * self.mesh.world_size),
            device=self.device))
        l_fus = focal_loss(logits, b["beam"], num_classes=cfg.num_beams,
                           denom=denom)
        total = (opts.alpha_trans * l_trans + opts.alpha_contrast * l_con
                 + opts.alpha_distance * l_dis + opts.alpha_fusion * l_fus)

        st.optimizer.zero_grad(set_to_none=True)
        total.backward()
        params = [p for g in st.optimizer.param_groups for p in g["params"]]
        for p in params:
            # an unused parameter (the live image stem+stage1, whose
            # features the rebuilt ones replace): a zero gradient, so that
            # AdamW still decays it, as optax does, and every rank's flat
            # buffer has one layout
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        terms = torch.stack([total, l_trans, l_con, l_dis, l_fus]).detach()
        if group is not None:
            # the shares' gradients and terms add up to the global step's
            _flat_all_reduce([p.grad for p in params] + [terms], group)
        st.optimizer.param_groups[0]["lr"] = float(lr)
        st.optimizer.step()
        st.step += 1
        names = ("loss", "trans", "contrast", "distance", "fusion")
        if floats:
            return dict(zip(names, terms.float().tolist()))
        return dict(zip(names, terms.unbind()))

    @torch.no_grad()
    def rebuild_features(self, batch) -> torch.Tensor:
        """The target's stage-1 features rebuilt from the sources' by the
        heads in eval mode: (B·T, h, w, 64) f32."""
        b = self.shard(batch)
        self.heads.eval()
        feats = self._frozen_stage1(b)
        _, s2t = self.heads({m: feats[m] for m in self.opts.source_domain})
        return self._as_maps(s2t)

    @torch.no_grad()
    def eval_step(self, batch, batch_idx: int = 0) -> Dict[str, torch.Tensor]:
        """The fusion model in eval mode on the batch with the rebuilt
        features injected: ``ranks`` (beam indices by descending logit)
        and, when the batch has ``beam``, the focal ``loss``."""
        st = self._require_state()
        b = self.shard(batch)
        rebuild = self.rebuild_features(b)
        self.fusion_model.eval()
        logits = self.fusion_model(
            b["image"], b["lidar"], b["radar"], b["gps"],
            rebuild_feats=rebuild,
            generator=self._missing_generator(st.step, batch_idx))
        out = {"ranks": torch.argsort(logits, dim=-1, descending=True,
                                      stable=True)}
        if "beam" in b:
            out["loss"] = focal_loss(logits, b["beam"],
                                     num_classes=self.cfg.num_beams)
        return out


def split_encoder_checkpoint(state_dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """my_test.py's split: the three backbones' stem+stage1 entries of a
    ``BeamFuser`` state_dict (weights and BatchNorm statistics), keyed
    ``stem.*`` and ``stage1.*`` under ``image_encoder``, ``lidar_encoder``
    and ``radar_encoder``."""
    out = {}
    for name in ENCODERS:
        pre = f"encoder.{name}."
        out[name] = {k[len(pre):]: v for k, v in state_dict.items()
                     if k.startswith(pre)
                     and k[len(pre):].split(".")[0] in ("stem", "stage1")}
    return out
