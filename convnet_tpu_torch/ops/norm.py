"""Eval-mode BatchNorm (counterpart of convnet_tpu/ops/norm.py:91-102).

Training BatchNorm (batch statistics, running-stat updates) comes with the
training slice.
"""

from __future__ import annotations

import torch


def batch_norm_inference(x, scale, bias, running_mean, running_var, *,
                         eps: float = 1e-5):
    """NHWC BN with running statistics: float32 math, cast back to x's dtype."""
    inv = torch.rsqrt(running_var + eps)
    if scale is not None:
        inv = inv * scale.float()
    shift = running_mean * inv
    if bias is not None:
        shift = shift - bias.float()
    y = x.float() * inv - shift
    return y.to(x.dtype)
