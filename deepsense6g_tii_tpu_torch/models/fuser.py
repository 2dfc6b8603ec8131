"""Top-level beam-prediction model (``deepsense6g_tii_tpu/models/fuser.py:26-75``).

``BeamFuser`` is the GPT TransFuser (``FFM=0, TFM=0``) or the MambaFuser
(``FFM=1, TFM=1``, the default configuration), or any mix of the two
switches: the fusion encoder followed by the join MLP 512 -> 256 -> 128 ->
num_beams in f32.  With ``pred_len > 1`` (the 30-to-5 variant,
``config.config_30to5``) a GRU decoder unrolls ``pred_len`` steps from the
join output (``decode_multistep``).

The model is built in eval mode; ``.train()`` switches BatchNorm to batch
statistics and turns dropout on, which then draws from the two generators
that ``forward`` takes (train/steps.py passes them).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import GlobalConfig
from ..ops.dropout import DropoutRNG
from ..ops.mamba import Mamba
from ..utils.device import resolve_device
from .encoder import FusionEncoder
from .fusion import GPTBlock, MambaBlock
from .resnet import Conv2d


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation after the JAX package's initialisers.  Inside
    the fusion blocks (GPT blocks and MambaBlocks, their inner Mambas
    included) Linears are N(0, 0.02) with zero biases; every other Linear
    and convolution is N(0, 1/fan_in) (flax's lecun_normal, untruncated)
    with zero biases.  Each Mamba then initialises its own SSM parameters
    (conv, dt_proj, A_log, D) in its ``init_style`` (ops/mamba.py).
    LayerNorm, BatchNorm and the positional embedding keep their
    constructors' ones and zeros.  A GRU decoder's recurrent kernels are
    orthogonal, as flax's ``GRUCell`` initialises them."""
    blocks = {id(m) for blk in model.modules()
              if isinstance(blk, (GPTBlock, MambaBlock))
              for m in blk.modules()}
    for m in model.modules():
        if isinstance(m, (nn.Linear, Conv2d)):
            std = 0.02 if id(m) in blocks else m.weight[0].numel() ** -0.5
            m.weight.normal_(0.0, std, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, Mamba):
            m.init_ssm(generator)
    for m in model.modules():
        if isinstance(m, GRUCell):
            for name in GRUCell.RECURRENT:
                nn.init.orthogonal_(getattr(m, name).weight,
                                    generator=generator)


class GRUCell(nn.Module):
    """flax's ``GRUCell`` with its scope names and layout, so that
    ``from_jax_variables`` maps it leaf by leaf: input Linears ``ir``,
    ``iz``, ``in`` with biases, recurrent ``hr``, ``hz`` without and ``hn``
    with one.  ``in`` is a Python keyword: it is registered by name and
    reached with ``getattr``.

        r = sigmoid(ir(x) + hr(h));  z = sigmoid(iz(x) + hz(h))
        n = tanh(in(x) + r * hn(h));  h' = (1 - z) * n + z * h
    """

    RECURRENT = ("hr", "hz", "hn")

    def __init__(self, features: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(features, features))
        self.hr = nn.Linear(features, features, bias=False)
        self.hz = nn.Linear(features, features, bias=False)
        self.hn = nn.Linear(features, features)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class BeamFuser(nn.Module):
    """Built on the CPU from ``generator`` (default: seed 0), then moved to
    ``device``, in eval mode.  ``device="cuda"`` raises without CUDA."""

    def __init__(self, config: GlobalConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.encoder = FusionEncoder(config)
        self.join_fc1 = nn.Linear(512, 256)
        self.join_fc2 = nn.Linear(256, 128)
        self.join_fc3 = nn.Linear(128, config.num_beams)
        if config.pred_len > 1:
            self.decoder = GRUCell(config.num_beams)
            self.output = nn.Linear(config.num_beams, config.num_beams)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.to(dev).eval()

    def forward(self, image, lidar, radar, gps, rebuild_feats=None,
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None,
                seed_generator: Optional[torch.Generator] = None,
                rebuild_generator: Optional[torch.Generator] = None,
                sample_mask: Optional[torch.Tensor] = None):
        """NHWC sensor tensors -> (B, num_beams) f32 logits, or (B,
        pred_len, num_beams) when ``pred_len > 1``.  ``generator``
        feeds ``modality_missing_type="randlike"``; ``rebuild_feats`` and
        ``rebuild_generator`` (on the CPU) the modality-rebuild hook
        (models/encoder.py); ``sample_mask`` ((B,), 1.0 real / 0.0 padded)
        keeps padded rows out of BatchNorm's train-mode statistics.

        In train mode with any dropout rate > 0, ``dropout_generator`` (on
        the model's device: elementwise masks) and ``seed_generator`` (on
        the CPU: the attention kernels' seeds) are required."""
        cfg, rng = self.config, None
        if self.training and max(cfg.embd_pdrop, cfg.attn_pdrop,
                                 cfg.resid_pdrop) > 0.0:
            if dropout_generator is None or seed_generator is None:
                raise ValueError(
                    "BeamFuser in train mode draws dropout from "
                    "dropout_generator (on the model's device) and "
                    "seed_generator (on the CPU): pass both")
            rng = DropoutRNG(dropout_generator, seed_generator)
        z = self.encoder(image, lidar, radar, gps,
                         rebuild_feats=rebuild_feats, generator=generator,
                         rng=rng, rebuild_generator=rebuild_generator,
                         sample_mask=sample_mask).float()
        z = torch.relu(self.join_fc1(z))
        z = torch.relu(self.join_fc2(z))
        z = self.join_fc3(z)
        if cfg.pred_len <= 1:
            return z
        return self.decode_multistep(z)

    def decode_multistep(self, z):
        """Autoregressive multi-step decode (``deepsense6g_tii_tpu/models/
        fuser.py:61-75``): the GRU's hidden state starts at the join output
        ``z``, its input is the running prediction ``x`` (zero at first),
        and each step's ``output`` head is added to ``x``.  (B, C) -> (B,
        pred_len, C)."""
        h, x, outs = z, torch.zeros_like(z), []
        for _ in range(self.config.pred_len):
            h = self.decoder(h, x)
            x = x + self.output(h)
            outs.append(x)
        return torch.stack(outs, dim=1)

    def encode_stage1(self, image, lidar, radar, backbones=None):
        """The stage-1 per-modality features for the rebuild subsystem
        (``deepsense6g_tii_tpu/models/fuser.py:76-83``): the image, lidar
        and radar maps, (B·T, h, w, 64) each, in BatchNorm's current mode,
        without the missing-modality substitution (the rebuild trainer needs
        the real target features as its translation label).  Unlike JAX's,
        it returns the maps alone and runs no fusion stage
        (``FusionEncoder.encode_stage1``)."""
        return self.encoder.encode_stage1(image, lidar, radar, backbones)
