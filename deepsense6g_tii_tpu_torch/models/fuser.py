"""Top-level beam-prediction model (``deepsense6g_tii_tpu/models/fuser.py:26-59``).

``BeamFuser`` is the GPT TransFuser (``FFM=0, TFM=0``) or the MambaFuser
(``FFM=1, TFM=1``, the default configuration), or any mix of the two
switches: the fusion encoder followed by the join MLP 512 -> 256 -> 128 ->
num_beams in f32.  The multi-step GRU decoder (``pred_len > 1``) is not
ported yet and raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import GlobalConfig
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
    constructors' ones and zeros."""
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


class BeamFuser(nn.Module):
    """Built on the CPU from ``generator`` (default: seed 0), then moved to
    ``device``, in eval mode.  ``device="cuda"`` raises without CUDA."""

    def __init__(self, config: GlobalConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.pred_len > 1:
            raise NotImplementedError(
                "pred_len > 1 (GRU multi-step decoder) is not in the PyTorch "
                "port yet (ROADMAP.md Queue 1 item 8)")
        dev = resolve_device(device)
        self.config = config
        self.encoder = FusionEncoder(config)
        self.join_fc1 = nn.Linear(512, 256)
        self.join_fc2 = nn.Linear(256, 128)
        self.join_fc3 = nn.Linear(128, config.num_beams)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.to(dev).eval()

    def forward(self, image, lidar, radar, gps,
                generator: Optional[torch.Generator] = None):
        """NHWC sensor tensors -> (B, num_beams) f32 logits.  ``generator``
        feeds ``modality_missing_type="randlike"`` (models/encoder.py)."""
        z = self.encoder(image, lidar, radar, gps, generator=generator).float()
        z = torch.relu(self.join_fc1(z))
        z = torch.relu(self.join_fc2(z))
        return self.join_fc3(z)
