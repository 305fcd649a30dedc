"""Weight initializers (counterpart of convnet_tpu/core/initializers.py).

Each is a function of ``(shape, generator)`` returning a new float32
tensor; the random draws come from the explicit ``torch.Generator``
(``None``: the global one). Shapes are in PyTorch's layout: conv weights
OIHW (out, in/groups, kh, kw), linear weights (out, in). The distributions
are the JAX package's.
"""

from __future__ import annotations

import math

import torch


def kaiming_normal(shape, generator=None):
    """He-normal, fan-out mode, for conv (OIHW) weights."""
    fan_out = shape[0] * math.prod(shape[2:])
    std = math.sqrt(2.0 / max(fan_out, 1))
    return std * torch.randn(shape, generator=generator)


def uniform(shape, bound, generator=None):
    """U(-bound, bound)."""
    return (2.0 * torch.rand(shape, generator=generator) - 1.0) * bound


def torch_linear_default(shape, generator=None):
    """torch.nn.Linear's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    shape (out, in)."""
    return uniform(shape, 1.0 / math.sqrt(max(shape[1], 1)), generator)
