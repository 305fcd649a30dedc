"""Activations (counterpart of convnet_tpu/ops/activation.py).

Both gradients are taken from the output, as the JAX package's custom VJPs
take them: dy passes where 0 < y (relu) or 0 < y < 6 (relu6) and is 0
elsewhere, so at x == 0 and at x == 6 the gradient is 0.
"""

from __future__ import annotations

import torch


def relu(x):
    return torch.relu(x)


class _ReLU6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.clamp(x, 0.0, 6.0)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return torch.where((y > 0) & (y < 6), dy, torch.zeros_like(dy))


def relu6(x):
    return _ReLU6.apply(x)
