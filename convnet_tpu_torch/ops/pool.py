"""NHWC pooling (counterpart of convnet_tpu/ops/pool.py:475-498, 605-608)."""

from __future__ import annotations

import torch.nn.functional as F

from convnet_tpu_torch.ops.conv import to_nchw, to_nhwc


def max_pool2d(x, kernel, stride=None, padding=0):
    """Max pool; padded positions never win (they act as -inf)."""
    stride = stride if stride is not None else kernel
    return to_nhwc(F.max_pool2d(to_nchw(x), kernel, stride, padding))


def global_avg_pool(x):
    """(B, H, W, C) → (B, C) mean; float32 accumulation."""
    out = x.float().mean(dim=(1, 2))
    return out.to(x.dtype)
