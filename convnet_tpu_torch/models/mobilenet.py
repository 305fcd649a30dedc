"""MobileNet v1, the depthwise-separable stack (counterpart of
convnet_tpu/models/mobilenet.py): width multiplier, the optional shallow
stack, and the embedded regimes.

Module names follow the JAX package's parameter tree (``features.0.conv``,
``features.1.dw.bn``, ``features.1.pw.conv``, ``fc``). Each block's 3x3
depthwise conv runs the depthwise kernel (``nn.Conv2d.uses_depthwise_kernel``)
in training and in eval: 13 per forward at full depth. In eval each
block's 1x1 pointwise ``ConvBN`` runs the fused 1x1 kernel: 13 more.
"""

from __future__ import annotations

from torch import nn

from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.models.resnet import ConvBN, weight_decay_config
from convnet_tpu_torch.nn import GlobalAvgPool, Linear
from convnet_tpu_torch.regimes import schedules


class DepthwiseSeparable(nn.Module):
    """3x3 depthwise (+BN+ReLU) → 1x1 pointwise (+BN+ReLU)."""

    def __init__(self, in_ch, out_ch, stride=1):
        super().__init__()
        self.dw = ConvBN(in_ch, in_ch, 3, stride, 1, groups=in_ch)
        self.pw = ConvBN(in_ch, out_ch, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNet(nn.Module):
    # (out_channels, stride) per depthwise-separable block
    CFG = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]

    def __init__(self, num_classes=1000, width=1.0, shallow=False,
                 regime="normal", batch_size=256):
        super().__init__()

        def c(ch):
            return max(int(ch * width), 8)

        cfg = self.CFG
        if shallow:  # drop the five repeated 512 blocks
            cfg = cfg[:6] + cfg[11:]
        blocks = [ConvBN(3, c(32), 3, 2, 1)]
        in_ch = c(32)
        for out_ch, stride in cfg:
            blocks.append(DepthwiseSeparable(in_ch, c(out_ch), stride))
            in_ch = c(out_ch)
        self.features = Sequential(*blocks)
        self.pool = GlobalAvgPool()
        self.fc = Linear(in_ch, num_classes)
        self.input_size = 224
        wd = weight_decay_config(1e-4)
        if regime in ("large", "large_batch"):
            steps_per_epoch = max(1281167 // batch_size, 1)
            lr = schedules.scaled_lr(0.1, batch_size)
            self.regime = [
                {"epoch": 0, "optimizer": "SGD", "momentum": 0.9,
                 "regularizer": wd,
                 "lr": schedules.linear_warmup_lr(0.1, lr,
                                                  5 * steps_per_epoch)},
                {"epoch": 30, "lr": lr * 1e-1},
                {"epoch": 60, "lr": lr * 1e-2},
                {"epoch": 80, "lr": lr * 1e-3},
            ]
        else:
            self.regime = [
                {"epoch": 0, "optimizer": "SGD", "lr": 0.1, "momentum": 0.9,
                 "regularizer": wd},
                {"epoch": 30, "lr": 1e-2},
                {"epoch": 60, "lr": 1e-3},
                {"epoch": 80, "lr": 1e-4},
            ]

    def forward(self, x):
        return self.fc(self.pool(self.features(x)))


def mobilenet(**config):
    config.pop("dataset", None)
    return MobileNet(**config)
