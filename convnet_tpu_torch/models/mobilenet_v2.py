"""MobileNet-V2: inverted residuals and linear bottlenecks (counterpart of
convnet_tpu/models/mobilenet_v2.py): the width multiplier with its rounding
to multiples of 8, dropout before the classifier, and both regimes.

Module names follow the JAX package's parameter tree (``features.0.conv``,
``features.1.block.0.bn``, ``fc``).

Routes, by the reference's predicate (``mobilenet_v2.py:52-69``) without its
env flag and its v5e window on the hidden width: every stride-1 block is one
fused MBConv (``ops/kernels/mbconv.py``), 13 of the 17 at width 1.0. In eval
that is ``mbconv_infer`` with the three BNs folded (once per version of each
BN's parameters and statistics, as ``ConvBN`` folds), one Full kernel a block;
in training ``mbconv_train``, a Stats and a Raw kernel a block, whose
backward recomputes the block layer by layer; under sync-BN (the BNs'
``group``) the kernels' sums are all-reduced between the two launches and
after the second. The 4 stride-2 blocks run
layer by layer: in eval the expand and the project on the fused 1x1 kernel
(with the last 320→1280 conv, 9 launches a forward), the depthwise conv on
its kernel in both modes. Under int8 serving no block is fused: the
expand and project convs take the int8 kernel, the depthwise convs theirs.
"""

from __future__ import annotations

from torch import nn

from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.models.resnet import (ConvBN, folded_bn,
                                             weight_decay_config)
from convnet_tpu_torch.nn import Dropout, GlobalAvgPool, Linear
from convnet_tpu_torch.ops.kernels import mbconv
from convnet_tpu_torch.parallel.mesh import group_size
from convnet_tpu_torch.regimes import schedules


class ConvBNReLU6(ConvBN):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
                 relu6=True):
        super().__init__(in_ch, out_ch, kernel, stride, padding,
                         groups=groups, relu=relu6,
                         act="relu6" if relu6 else "none")


class InvertedResidual(nn.Module):
    quant = None   # the model's nn.quant.QuantState, set by nn.quant.attach

    def __init__(self, in_ch, out_ch, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        self.use_res = stride == 1 and in_ch == out_ch
        self.stride = stride
        self.hidden = hidden
        self.has_expand = expand_ratio != 1
        layers = []
        if self.has_expand:
            layers.append(ConvBNReLU6(in_ch, hidden, 1))
        layers.append(ConvBNReLU6(hidden, hidden, 3, stride, 1, groups=hidden))
        layers.append(ConvBNReLU6(hidden, out_ch, 1, relu6=False))  # linear
        self.block = Sequential(*layers)

    def uses_kernel(self):
        """The fused route, in training and in eval: stride 1, 3x3; never
        under int8 serving or its calibration (the reference's
        ``mobilenet_v2.py:66``), where the block runs layer by layer."""
        return self.quant is None and mbconv.supported(self.stride, 3)

    def _fused(self, x):
        kids = list(self.block)
        ex, dw, pj = (kids[0] if self.has_expand else None), kids[-2], kids[-1]
        hidden, out_ch = dw.conv.out_channels, pj.conv.out_channels
        we = None if ex is None else ex.conv.weight.reshape(hidden, -1).t()
        wd = dw.conv.weight.reshape(hidden, 9).t()       # (9, Ch)
        wp = pj.conv.weight.reshape(out_ch, hidden).t()  # (Ch, Cout)
        if not self.training:
            s1 = t1 = None
            if ex is not None:
                s1, t1 = folded_bn(ex.bn)
            return mbconv.mbconv_infer(x, we, s1, t1, wd, *folded_bn(dw.bn),
                                       wp, *folded_bn(pj.bn),
                                       residual=self.use_res)
        g1 = b1 = None
        if ex is not None:
            g1, b1 = ex.bn.weight, ex.bn.bias
        # sync-BN: the three BNs share the group parallel.set_bn_group set
        group = dw.bn.group
        y, stats = mbconv.mbconv_train(
            x, we, g1, b1, wd, dw.bn.weight, dw.bn.bias, wp, pj.bn.weight,
            pj.bn.bias, eps=dw.bn.eps, residual=self.use_res, group=group)
        n = x.numel() // x.shape[-1] * group_size(group)
        for cb, moments in zip((ex, dw, pj), stats):
            if cb is not None:
                cb.bn.track(*moments, n)
        return y

    def forward(self, x):
        if self.uses_kernel():
            return self._fused(x)
        out = self.block(x)
        return out + x if self.use_res else out


class MobileNetV2(nn.Module):
    # t (expansion), c (channels), n (repeats), s (stride)
    CFG = [
        (1, 16, 1, 1),
        (6, 24, 2, 2),
        (6, 32, 3, 2),
        (6, 64, 4, 2),
        (6, 96, 3, 1),
        (6, 160, 3, 2),
        (6, 320, 1, 1),
    ]

    def __init__(self, num_classes=1000, width=1.0, dropout=0.2,
                 regime="normal", batch_size=256, epochs=150):
        super().__init__()

        def c(ch):
            v = max(int(ch * width + 4) // 8 * 8, 8)  # round to multiple of 8
            if v < 0.9 * ch * width:
                v += 8
            return v

        in_ch = c(32)
        blocks = [ConvBNReLU6(3, in_ch, 3, 2, 1)]
        for t, ch, n, s in self.CFG:
            out_ch = c(ch)
            for i in range(n):
                blocks.append(InvertedResidual(in_ch, out_ch,
                                               s if i == 0 else 1, t))
                in_ch = out_ch
        last = c(1280) if width > 1.0 else 1280
        blocks.append(ConvBNReLU6(in_ch, last, 1))
        self.features = Sequential(*blocks)
        self.pool = GlobalAvgPool()
        self.drop = Dropout(dropout)
        self.fc = Linear(last, num_classes)
        self.input_size = 224
        steps_per_epoch = max(1281167 // batch_size, 1)
        wd = weight_decay_config(4e-5)
        if regime == "cosine":
            self.regime = [{
                "epoch": 0, "optimizer": "SGD", "momentum": 0.9,
                "regularizer": wd,
                "lr": schedules.cosine_lr(0.05 * batch_size / 256,
                                          epochs * steps_per_epoch,
                                          warmup_steps=steps_per_epoch),
            }]
        else:
            # RMSprop-style regime per the MobileNetV2 paper lineage,
            # expressed with this framework's exponential epoch decay
            self.regime = [{
                "epoch": 0, "optimizer": "RMSprop", "alpha": 0.9,
                "momentum": 0.9, "eps": 1.0,
                "regularizer": wd,
                "lr": schedules.step_decay_lr(0.045, 0.98, 1),
            }]

    def forward(self, x):
        return self.fc(self.drop(self.pool(self.features(x))))


def mobilenet_v2(**config):
    config.pop("dataset", None)
    return MobileNetV2(**config)
