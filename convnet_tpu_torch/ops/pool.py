"""NHWC pooling (counterpart of convnet_tpu/ops/pool.py:49-79, 475-498,
501-608).

``max_pool2d`` runs the forward-with-index kernel and, when a gradient is
needed, saves its uint8 index for the backward kernel
(``ops/kernels/max_pool.py``): the route the JAX package takes with
``impl="pallas"`` (``max_pool2d_pallas``), on every max pool the kernels
take. Without a gradient (eval, serving) the forward writes no index.

``avg_pool2d`` is XLA in the JAX package, not Pallas, so it runs the
library's average pool here. Its custom backward there (``_ap_bwd_padsum``)
works around the TPU's pad-scatter; autograd gives the same gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from convnet_tpu_torch.ops.conv import pair, to_nchw, to_nhwc
from convnet_tpu_torch.ops.kernels import max_pool


class _MaxPool2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        y, idx = max_pool.max_pool2d_fwd_idx(x, kernel, stride, padding)
        ctx.save_for_backward(idx)
        ctx.geometry = (tuple(x.shape), kernel, stride, padding)
        return y

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        x_shape, kernel, stride, padding = ctx.geometry
        dx = max_pool.max_pool2d_bwd(dy.contiguous(), idx, x_shape, kernel,
                                     stride, padding)
        return dx, None, None, None


def max_pool2d(x, kernel, stride=None, padding=0):
    """Max pool; padded positions never win (they act as -inf), ties go to
    the first tap in window order."""
    stride = stride if stride is not None else kernel
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool2d.apply(x, kernel, stride, padding)
    return max_pool.max_pool2d_fwd_idx(x, kernel, stride, padding,
                                       with_index=False)[0]


def global_avg_pool(x):
    """(B, H, W, C) → (B, C) mean; float32 accumulation."""
    out = x.float().mean(dim=(1, 2))
    return out.to(x.dtype)


def avg_pool2d(x, kernel, stride=None, padding=0, count_include_pad=True):
    """Average pool on NHWC in x's dtype; the library's pool sums a bf16
    window in float32 and rounds once. ``count_include_pad`` True divides
    every window by the kernel's area (torchvision's Inception v3); False
    by its in-bounds taps (the Inception-v4 and Inception-ResNet-v2 branch
    pools)."""
    stride = stride if stride is not None else kernel
    y = F.avg_pool2d(to_nchw(x), pair(kernel), pair(stride), pair(padding),
                     count_include_pad=count_include_pad)
    return to_nhwc(y)
