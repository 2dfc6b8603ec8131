"""Train-mode dropout from explicit generators (flax ``nn.Dropout``
semantics: keep with probability 1 - p, scale kept values by 1/(1-p)).

The port draws no randomness from torch's global RNG.  A training step
hands the model a :class:`DropoutRNG`: a ``torch.Generator`` on the
activations' device for elementwise masks, and one on the CPU for the int32
seeds of the flash-attention dropout stream, so that drawing a seed never
waits for the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class DropoutRNG:
    generator: torch.Generator   # on the activations' device
    seeds: torch.Generator       # on the CPU

    def seed(self) -> int:
        """A fresh int32 seed for the attention kernels' dropout stream."""
        return int(torch.randint(-2 ** 31, 2 ** 31, (1,),
                                 generator=self.seeds))


def dropout(x, p: float, generator, training: bool):
    """``x`` with each element zeroed with probability ``p`` and the rest
    scaled by 1/(1-p), the mask drawn from ``generator``; ``x`` itself in
    eval or at p = 0 (nothing is drawn then)."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout draws from a torch.Generator: "
                         "pass the step's generators")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
