"""NHWC pooling (counterpart of convnet_tpu/ops/pool.py:49-79, 475-498,
605-608).

``max_pool2d`` runs the forward-with-index kernel and, when a gradient is
needed, saves its uint8 index for the backward kernel
(``ops/kernels/max_pool.py``): the route the JAX package takes with
``impl="pallas"`` (``max_pool2d_pallas``), on every max pool the kernels
take. Without a gradient (eval, serving) the forward writes no index.
"""

from __future__ import annotations

import torch

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
