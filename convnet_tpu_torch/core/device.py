"""Where an entry point runs: the CUDA card unless the caller asks for
another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card: raise rather than fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)
