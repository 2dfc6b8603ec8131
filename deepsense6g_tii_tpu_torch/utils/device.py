"""Device selection for the port's entry points.

The port runs on the GPU.  An entry point that is handed ``"cuda"`` (the
default everywhere) and finds no CUDA device raises; it never moves to the
CPU on its own.  Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepsense6g_tii_tpu_torch runs on a CUDA GPU and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
