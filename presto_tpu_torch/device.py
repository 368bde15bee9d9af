"""The device rule of the port's entry points: the GPU unless the caller
names a device, and an error when no device is named and no GPU is
present (never a quiet run on the CPU)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device a caller asked for; no device means the GPU, which must
    then exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
