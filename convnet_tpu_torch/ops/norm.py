"""BatchNorm on NHWC (counterpart of convnet_tpu/ops/norm.py:24-102).

Training: batch moments in float32 over (N, H, W), normalisation with the
biased variance E[x²] − E[x]² (clamped at 0), running statistics updated with
torch's momentum and the unbiased n/(n − 1) variance. The math is plain torch
ops written as the JAX package writes it, so autograd differentiates the same
formula; ``F.batch_norm`` computes the variance another way.

Cross-replica statistics (sync-BN): with a process ``group`` the float32
mean and E[x²] are averaged over the group in one all-reduce (``parallel.mesh.group_mean``, a
differentiable all-reduce whose backward averages the cotangent over the
group, the transpose of the JAX package's ``lax.pmean``), and the running
variance's unbiased correction counts the values of every rank. Spatially
sharded statistics are not ported yet (ROADMAP.md §1 item 10).
"""

from __future__ import annotations

import torch

from convnet_tpu_torch.parallel.mesh import group_mean, group_size


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
                     momentum: float = 0.1, eps: float = 1e-5, group=None):
    """Training-mode BN. Returns (y in x's dtype, new running mean, new
    running var); the new statistics carry no gradient. ``group``: the
    process group whose ranks' moments are averaged (None: this rank's
    batch alone)."""
    x32 = x.float()
    dims = tuple(range(x.dim() - 1))  # all but channels
    mean = x32.mean(dim=dims)
    mean_sq = x32.square().mean(dim=dims)
    if group is not None:
        # the two moments in one all-reduce
        mean, mean_sq = group_mean(torch.stack([mean, mean_sq]),
                                   group).unbind()
    var = torch.clamp_min(mean_sq - mean.square(), 0.0)
    inv = torch.rsqrt(var + eps)
    if scale is not None:
        inv = inv * scale.float()
    y = (x32 - mean) * inv
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)

    new_mean, new_var = running_update(running_mean, running_var, mean, var,
                                       x.numel() // x.shape[-1]
                                       * group_size(group), momentum)
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
