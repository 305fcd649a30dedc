"""Leaf layer modules on NHWC activations (counterpart of
convnet_tpu/nn/layers.py).

Parameters are float32 and are cast to the activations' dtype at use;
BatchNorm running statistics stay float32. Weights are in PyTorch's layout:
conv OIHW, linear (out, in). ``reset_parameters(generator)`` draws a layer's
parameters from an explicit ``torch.Generator``.

``Conv2d`` routes two kinds of conv to hand-written kernels by the JAX
package's structural predicates, with no env flag and no ``impl`` knob: an
eval grouped conv (cin == cout) to ``ops/kernels/grouped_conv.py`` and a
depthwise conv, in training and in eval, to
``ops/kernels/depthwise_conv.py``. Every other conv runs ``ops.conv2d``.
A conv's bias, where it has one, is added in float32 after any route.
Under int8 serving (``nn/quant.py``: a ``QuantState`` set on the conv) an
eligible 1x1 conv takes the int8 kernel before any other route
(``ops/kernels/matmul_int8.py``), its bias as the kernel's shift.

Not ported: ``SpaceToDepth`` and the spatially sharded branches of
``Flatten``, ``MaxPool2d``, ``AvgPool2d`` and ``GlobalAvgPool``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from convnet_tpu_torch import ops
from convnet_tpu_torch.core import initializers as init
from convnet_tpu_torch.nn import quant
from convnet_tpu_torch.ops.kernels import (depthwise_conv, grouped_conv,
                                           matmul_int8)
from convnet_tpu_torch.ops.norm import running_update


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv2d(nn.Module):
    """NHWC conv; weight OIHW, optional bias. ``padding`` is an int or a
    per-axis pair (ph, pw). ``quant``: the model's ``nn.quant.QuantState``
    under int8 serving or its calibration, else None."""

    quant = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self.kernel_size))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if bias
                     else None)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.copy_(init.kaiming_normal(self.weight.shape, generator))
        if self.bias is not None:
            # the JAX package's U(-1/sqrt(fan_in), 1/sqrt(fan_in))
            fan_in = (self.kernel_size[0] * self.kernel_size[1]
                      * self.in_channels // self.groups)
            self.bias.copy_(init.uniform((self.out_channels,),
                                         1.0 / max(fan_in, 1) ** 0.5,
                                         generator))

    def uses_grouped_kernel(self):
        """The reference's ``_pallas_grouped_ok`` (``nn/layers.py:66-84``)
        without its v5e shape gate (H == 56, C == 128): eval, stride 1,
        integer padding, and ``grouped_conv.supported``."""
        return (not self.training
                and _pair(self.stride) == (1, 1)
                and _pair(self.dilation) == (1, 1)
                and isinstance(self.padding, int)
                and grouped_conv.supported(
                    (self.in_channels,), self.weight.shape, self.groups,
                    self.stride))

    def uses_depthwise_kernel(self):
        """The reference's ``_pallas_depthwise_ok`` (``nn/layers.py:50-64``)
        without its env flag: groups == cin == cout, stride <= 2, integer
        padding; in training and in eval."""
        return (self.groups == self.in_channels == self.out_channels
                and _pair(self.dilation) == (1, 1)
                and isinstance(self.padding, int)
                and depthwise_conv.supported(self.stride))

    def int8_scale(self, x):
        """The static activation scale of this conv's int8 route for x, or
        None: without a quant state, where the conv or x's shape is not
        eligible, and while calibrating (x's range is then recorded)."""
        if self.quant is None or not quant.conv_eligible(self, x.shape):
            return None
        return self.quant.take(x)

    def forward(self, x):
        act_scale = self.int8_scale(x)
        if act_scale is not None:
            return matmul_int8.conv1x1_int8_bn_act(x, self.weight, act_scale,
                                                   shift=self.bias)
        if self.uses_grouped_kernel():
            y = grouped_conv.grouped_conv2d(x, self.weight, self.stride,
                                            self.padding, self.groups)
        elif self.uses_depthwise_kernel():
            y = depthwise_conv.depthwise_conv2d(x, self.weight, self.stride,
                                                self.padding)
        else:
            y = ops.conv2d(x, self.weight, stride=self.stride,
                           padding=self.padding, dilation=self.dilation,
                           groups=self.groups)
        if self.bias is not None:
            y = (y.float() + self.bias.float()).to(y.dtype)
        return y


class BatchNorm2d(nn.Module):
    """BN over NHWC channels: ``weight``/``bias`` (γ/β) and the float32
    ``running_mean``/``running_var`` buffers. In training it normalises with
    the batch statistics and updates the buffers in place (torch momentum).
    ``zero_init`` sets γ to 0 instead of 1 (a zero-init residual branch);
    ``reset_parameters`` keeps it. With ``update_stats`` off (while
    ``CheckpointModule`` recomputes a block) the buffers stay as they are;
    the recompute still takes the same cross-replica moments, so every rank
    issues the same collectives in the same order.

    ``group`` (None: per-replica statistics) is a process group whose ranks'
    batch moments are averaged (sync-BN, set on every BN of a model by
    ``parallel.set_bn_group``); the running variance's correction then
    counts the values of every rank.
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1,
                 zero_init=False):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.zero_init = zero_init
        self.update_stats = True
        self.group = None
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.fill_(0.0 if self.zero_init else 1.0)
        self.bias.zero_()

    def folded(self):
        """(scale, shift), float32, with ``bn(x) == x * scale + shift``."""
        inv = torch.rsqrt(self.running_var + self.eps)
        scale = self.weight.float() * inv
        shift = self.bias.float() - self.running_mean * scale
        return scale, shift

    @torch.no_grad()
    def track(self, mean, var, n):
        """Updates the running statistics from a batch's mean and biased
        variance over ``n`` values a channel (every rank's under sync-BN),
        as :meth:`forward` does in training (for a fused block that computes
        the moments itself)."""
        if not self.update_stats:
            return
        new_mean, new_var = running_update(self.running_mean,
                                           self.running_var, mean, var, n,
                                           self.momentum)
        self.running_mean.copy_(new_mean)
        self.running_var.copy_(new_var)

    def forward(self, x):
        if self.training:
            y, mean, var = ops.batch_norm_train(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, momentum=self.momentum, eps=self.eps,
                group=self.group)
            if self.update_stats:
                with torch.no_grad():
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
            return y
        return ops.batch_norm_inference(x, self.weight, self.bias,
                                        self.running_mean, self.running_var,
                                        eps=self.eps)


class Linear(nn.Module):
    def __init__(self, in_features, out_features):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.copy_(init.torch_linear_default(self.weight.shape,
                                                    generator))
        bound = 1.0 / max(self.in_features, 1) ** 0.5
        self.bias.copy_(init.uniform((self.out_features,), bound, generator))

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)


class ReLU(nn.Module):
    def forward(self, x):
        return ops.relu(x)


class ReLU6(nn.Module):
    def forward(self, x):
        return ops.relu6(x)


class HardSwish(nn.Module):
    def forward(self, x):
        return F.hardswish(x)


class Sigmoid(nn.Module):
    def forward(self, x):
        return torch.sigmoid(x)


class Dropout(nn.Module):
    """In training, keeps each element with probability 1 − rate and scales
    it by 1/(1 − rate) (the JAX package's ``Dropout``); the identity in eval
    or at rate 0. The mask is drawn from ``generator``, a ``torch.Generator``
    on the activations' device (``Trainer`` seeds one from its ``seed``),
    never from the global generator."""

    def __init__(self, rate=0.5):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if (self.generator is None
                or self.generator.device.type != x.device.type):
            raise RuntimeError(f"Dropout in training needs a torch.Generator "
                               f"on {x.device} in .generator (Trainer sets "
                               f"one from its seed)")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class MaxPool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x):
        return ops.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2d(nn.Module):
    """``count_include_pad`` as in torch.nn.AvgPool2d: True divides every
    window by the kernel's area (Inception v3), False by its in-bounds taps
    (the Inception-v4 and Inception-ResNet-v2 branch pools)."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 count_include_pad=True):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.count_include_pad = count_include_pad

    def forward(self, x):
        return ops.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                              self.count_include_pad)


class GlobalAvgPool(nn.Module):
    """AdaptiveAvgPool2d(1) + flatten equivalent."""

    def forward(self, x):
        return ops.global_avg_pool(x)


class Flatten(nn.Module):
    """(B, ...) → (B, -1); on NHWC maps it flattens (H, W, C), not torch's
    (C, H, W) (``utils/torch_import.py`` permutes the next linear)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class LocalResponseNorm(nn.Module):
    """LRN across channels, in float32: x / (k + α·Σ_window x² / size)^β
    over ``size`` neighbouring channels, zero-padded at the ends."""

    def __init__(self, size=5, alpha=1e-4, beta=0.75, k=2.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        x32 = x.float()
        half = self.size // 2
        sq = F.pad(x32.square(), (half, self.size - 1 - half))
        c = x.shape[-1]
        win = sum(sq[..., i:i + c] for i in range(self.size))
        denom = torch.pow(self.k + self.alpha * win / self.size, self.beta)
        return (x32 / denom).to(x.dtype)
