"""BatchNorm on NHWC (counterpart of convnet_tpu/ops/norm.py:24-102).

Training: batch moments in float32 over (N, H, W), normalisation with the
biased variance E[x²] − E[x]² (clamped at 0), running statistics updated with
torch's momentum and the unbiased n/(n − 1) variance. The math is plain torch
ops written as the JAX package writes it, so autograd differentiates the same
formula; ``F.batch_norm`` computes the variance another way. Cross-replica and
spatially sharded statistics are not ported yet.
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


def batch_norm_train(x, scale, bias, running_mean, running_var, *,
                     momentum: float = 0.1, eps: float = 1e-5):
    """Training-mode BN. Returns (y in x's dtype, new running mean, new
    running var); the new statistics carry no gradient."""
    x32 = x.float()
    dims = tuple(range(x.dim() - 1))  # all but channels
    mean = x32.mean(dim=dims)
    mean_sq = x32.square().mean(dim=dims)
    var = torch.clamp_min(mean_sq - mean.square(), 0.0)
    inv = torch.rsqrt(var + eps)
    if scale is not None:
        inv = inv * scale.float()
    y = (x32 - mean) * inv
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)

    new_mean, new_var = running_update(running_mean, running_var, mean, var,
                                       x.numel() // x.shape[-1], momentum)
    return y, new_mean, new_var


def running_update(running_mean, running_var, mean, var, n, momentum):
    """The new running statistics from a batch's mean and biased variance
    over ``n`` values a channel: torch momentum, and the unbiased
    n/(n − 1) variance. Carries no gradient."""
    correction = n / max(n - 1, 1)
    new_mean = (1 - momentum) * running_mean + momentum * mean.detach()
    new_var = ((1 - momentum) * running_var
               + momentum * (var.detach() * correction))
    return new_mean, new_var
