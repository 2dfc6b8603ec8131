"""EPIC-KITCHENS video/flow/audio cross-modal-translation experiment
(SimMMDG; ``deepsense6g_tii_tpu/rebuild/video_flow_audio.py``).

The trainable part of modality_rebuild/train_video_flow_audio.py, on
pre-extracted backbone features (the reference runs every backbone under
``torch.no_grad()`` and detaches it).  One step:

1. per-modality embedding heads give ``emd`` vectors (video 2304, flow
   2048, audio 512 in the reference),
2. classification cross entropy over the concatenated embeddings,
3. cross-modal translation: an MLP per ordered modality pair, loss
   ``mean ||norm(trans(a)) - norm(b)||`` averaged over the pairs,
4. supervised contrastive loss (SupConLoss, Khosla et al.) over
   projections of the *shared* (first) half of each embedding,
5. feature splitting: ``-MSE(shared_half, specific_half)`` per modality,

combined as ``ce + alpha_trans·trans + alpha_contrast·supcon +
explore_loss_coeff·split`` and optimised by ``torch.optim.Adam(lr,
weight_decay=1e-4)``, the reference's optimizer (the L2 term in the
gradient, before the moments).  Plain tensor code: no kernel.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.fuser import init_weights
from ..utils.device import resolve_device

# -- losses ------------------------------------------------------------------

def _unit(x, dim: int):
    return x / x.norm(dim=dim, keepdim=True).clamp(min=1e-12)


def supcon_loss(features, labels, temperature: float = 0.1,
                base_temperature: float = 0.07):
    """Supervised contrastive loss (Khosla et al. 2020).  features: (B,
    n_views, D), one view per modality projection, L2-normalised here;
    labels: (B,) ints.  Scaled by temperature / base_temperature."""
    B, V, _ = features.shape
    f = _unit(features, -1).reshape(B * V, -1)  # sample-major; all anchors
    lab = labels.repeat_interleave(V)
    logits = f @ f.T / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    eye = torch.eye(B * V, dtype=torch.bool, device=f.device)
    pos_mask = (lab[:, None] == lab[None, :]) & ~eye
    exp = torch.where(eye, torch.zeros_like(logits), torch.exp(logits))
    log_prob = logits - torch.log(exp.sum(dim=1, keepdim=True).clamp(
        min=1e-12))
    n_pos = pos_mask.sum(dim=1).clamp(min=1)
    mean_log_prob_pos = (pos_mask * log_prob).sum(dim=1) / n_pos
    return -(temperature / base_temperature) * mean_log_prob_pos.mean()


def normalized_translation_loss(pred, target):
    """``mean ||norm(pred) - norm(target)||_2`` over the rows."""
    return (_unit(pred, 1) - _unit(target, 1)).norm(dim=1).mean()


def feature_split_loss(emd):
    """``-MSE(shared_half, specific_half)``: pushes the halves apart."""
    half = emd.shape[1] // 2
    return -torch.mean((emd[:, :half] - emd[:, half:]) ** 2)


# -- modules -----------------------------------------------------------------

class _MLP(nn.Sequential):
    """Linear-ReLU stack (``fc1``, ``fc2``, ...; no ReLU after the last)."""

    def __init__(self, in_dim: int, features: Sequence[int]):
        layers = []
        for i, f in enumerate(features):
            layers.append((f"fc{i + 1}", nn.Linear(in_dim, f)))
            if i + 1 < len(features):
                layers.append((f"relu{i + 1}", nn.ReLU()))
            in_dim = f
        super().__init__(OrderedDict(layers))


class VFAHeads(nn.Module):
    """Every trainable piece of the step, named as the JAX package's
    scopes: ``{m}_emd`` embedding heads, ``mlp_cls``, the translators
    ``mlp_{a}2{b}`` and the contrastive projectors ``{m}_proj``.
    ``feat_dims`` are the input features' widths (flax reads them off the
    first batch)."""

    def __init__(self, feat_dims: Dict[str, int],
                 emd_dims: Dict[str, int], n_classes: int = 8,
                 hidden_dim: int = 2048, trans_hidden: int = 2048,
                 proj_dim: int = 128):
        super().__init__()
        self.order = tuple(feat_dims)
        for m in self.order:
            self.add_module(f"{m}_emd", _MLP(feat_dims[m],
                                             (hidden_dim, emd_dims[m])))
            self.add_module(f"{m}_proj", _MLP(emd_dims[m] // 2,
                                              (hidden_dim, proj_dim)))
        self.mlp_cls = _MLP(sum(emd_dims[m] for m in self.order),
                            (512, n_classes))
        for a, b in itertools.permutations(self.order, 2):
            self.add_module(f"mlp_{a}2{b}", _MLP(emd_dims[a],
                                                 (trans_hidden, emd_dims[b])))

    def forward(self, feats: Dict[str, torch.Tensor]):
        """feats: modality -> (B, feat_dim).  Returns (logits, emds,
        translations, projections (B, n_modalities, proj_dim))."""
        emds = {m: getattr(self, f"{m}_emd")(feats[m]) for m in self.order}
        logits = self.mlp_cls(torch.cat([emds[m] for m in self.order], 1))
        trans = {f"{a}2{b}": getattr(self, f"mlp_{a}2{b}")(emds[a])
                 for a, b in itertools.permutations(self.order, 2)}
        projs = torch.stack(
            [getattr(self, f"{m}_proj")(emds[m][:, : emds[m].shape[1] // 2])
             for m in self.order], dim=1)
        return logits, emds, trans, projs


@dataclasses.dataclass
class VFAOptions:
    """The reference flags that reach the math
    (train_video_flow_audio.py:228-260)."""

    modalities: Tuple[str, ...] = ("video", "flow", "audio")
    # the reference's embedding widths (train_video_flow_audio.py:293-296)
    emd_dims: Tuple[int, ...] = (2304, 2048, 512)
    n_classes: int = 8
    lr: float = 1e-4
    alpha_trans: float = 0.1
    alpha_contrast: float = 3.0
    explore_loss_coeff: float = 0.7
    temp: float = 0.1
    hidden_dim: int = 2048
    trans_hidden: int = 2048
    proj_dim: int = 128
    seed: int = 0


class VFATrainer:
    """Train and eval steps of the video/flow/audio experiment on
    ``device`` (``"cuda"`` by default, which raises without CUDA)."""

    def __init__(self, opts: VFAOptions = VFAOptions(), device="cuda"):
        self.opts = opts
        self.device = resolve_device(device)
        self.heads = None
        self.optimizer = None
        self.step = 0

    def init_state(self, feats: Dict[str, torch.Tensor]) -> VFAHeads:
        """Builds the heads for the modalities in ``feats`` (their widths
        from its arrays), initialised from ``opts.seed``, and Adam."""
        opts = self.opts
        order = [m for m in opts.modalities if m in feats]
        emd = dict(zip(opts.modalities, opts.emd_dims))
        self.heads = VFAHeads(
            {m: int(feats[m].shape[1]) for m in order}, emd,
            n_classes=opts.n_classes, hidden_dim=opts.hidden_dim,
            trans_hidden=opts.trans_hidden, proj_dim=opts.proj_dim)
        init_weights(self.heads, torch.Generator().manual_seed(opts.seed))
        self.heads.to(self.device)
        self.optimizer = torch.optim.Adam(self.heads.parameters(), lr=opts.lr,
                                          weight_decay=1e-4)
        self.step = 0
        return self.heads

    def _to_device(self, feats, labels=None):
        feats = {m: torch.as_tensor(x).float().to(self.device)
                 for m, x in feats.items()}
        if labels is None:
            return feats
        return feats, torch.as_tensor(labels).long().to(self.device)

    def _losses(self, feats, labels) -> Dict[str, torch.Tensor]:
        opts = self.opts
        logits, emds, trans, projs = self.heads(feats)
        order = self.heads.order
        ce = F.cross_entropy(logits, labels)
        pairs = list(itertools.permutations(order, 2))
        l_trans = sum(normalized_translation_loss(trans[f"{a}2{b}"], emds[b])
                      for a, b in pairs) / max(len(pairs), 1)
        l_con = supcon_loss(projs, labels, opts.temp)
        l_split = sum(feature_split_loss(emds[m]) for m in order) / len(order)
        total = (ce + opts.alpha_trans * l_trans
                 + opts.alpha_contrast * l_con
                 + opts.explore_loss_coeff * l_split)
        return {"loss": total, "ce": ce, "trans": l_trans, "contrast": l_con,
                "split": l_split, "logits": logits}

    def train_step(self, feats, labels) -> Dict[str, torch.Tensor]:
        """One Adam step; returns the losses and logits (detached, on the
        device)."""
        feats, labels = self._to_device(feats, labels)
        self.heads.train()
        out = self._losses(feats, labels)
        self.optimizer.zero_grad(set_to_none=True)
        out["loss"].backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in out.items()}

    @torch.no_grad()
    def eval_step(self, feats) -> torch.Tensor:
        """The predicted class of each row."""
        self.heads.eval()
        logits, *_ = self.heads(self._to_device(feats))
        return logits.argmax(dim=-1)
