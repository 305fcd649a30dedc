"""Inception-ResNet-v2 (counterpart of
convnet_tpu/models/inception_resnet_v2.py), input 299²: stem → Mixed5b →
10 Block35 (x + 0.17·branch) → Mixed6a → 20 Block17 (+ 0.10·branch) →
Mixed7a → 9 Block8 (+ 0.20·branch) → a final Block8 (unscaled, no ReLU) →
1x1 ``ConvBN`` to 1536 → global pool → fc.

Each residual block's ``up`` projection is a plain biased 1x1 conv (no BN,
no activation; weight decay spares its bias); every other conv is a
``ConvBN``. Mixed5b's average pool divides by its in-bounds taps
(``count_include_pad=False``). In eval each 1x1 ``ConvBN`` runs the fused
kernel, 100 a forward; the four 3x3/s2 max pools (two in the stem, one in
each of Mixed6a and Mixed7a) run the pool kernels.
"""

from __future__ import annotations

from torch import nn

from convnet_tpu_torch import ops
from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.models.inception import _MultiBranch
from convnet_tpu_torch.models.resnet import ConvBN, weight_decay_config
from convnet_tpu_torch.nn import (AvgPool2d, Conv2d, GlobalAvgPool, Linear,
                                  MaxPool2d)


class Mixed5b(_MultiBranch):
    """35² block: 192 → 320 channels."""

    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(192, 96, 1))
        self.b2 = Sequential(ConvBN(192, 48, 1), ConvBN(48, 64, 5, 1, 2))
        self.b3 = Sequential(ConvBN(192, 64, 1), ConvBN(64, 96, 3, 1, 1),
                             ConvBN(96, 96, 3, 1, 1))
        self.b4 = Sequential(AvgPool2d(3, 1, 1, count_include_pad=False),
                             ConvBN(192, 64, 1))
        self.out_channels = 96 + 64 + 96 + 64


class Mixed6a(_MultiBranch):
    """Grid reduction 35 → 17: 320 → 1088 channels."""

    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(320, 384, 3, 2))
        self.b2 = Sequential(ConvBN(320, 256, 1), ConvBN(256, 256, 3, 1, 1),
                             ConvBN(256, 384, 3, 2))
        self.b3 = Sequential(MaxPool2d(3, 2))
        self.out_channels = 384 + 384 + 320


class Mixed7a(_MultiBranch):
    """Grid reduction 17 → 8: 1088 → 2080 channels."""

    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(1088, 256, 1), ConvBN(256, 384, 3, 2))
        self.b2 = Sequential(ConvBN(1088, 256, 1), ConvBN(256, 288, 3, 2))
        self.b3 = Sequential(ConvBN(1088, 256, 1), ConvBN(256, 288, 3, 1, 1),
                             ConvBN(288, 320, 3, 2))
        self.b4 = Sequential(MaxPool2d(3, 2))
        self.out_channels = 384 + 288 + 320 + 1088


class _ResidualBlock(nn.Module):
    """Block35/17/8: branches → concat → biased 1x1 ``up`` conv →
    x + scale·up (→ ReLU unless ``final``)."""

    scale = 1.0
    final = False

    def forward(self, x):
        out = x + self.scale * self.up(self.branches(x))
        return out if self.final else ops.relu(out)


class _Branches35(_MultiBranch):
    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(320, 32, 1))
        self.b2 = Sequential(ConvBN(320, 32, 1), ConvBN(32, 32, 3, 1, 1))
        self.b3 = Sequential(ConvBN(320, 32, 1), ConvBN(32, 48, 3, 1, 1),
                             ConvBN(48, 64, 3, 1, 1))


class Block35(_ResidualBlock):
    scale = 0.17

    def __init__(self):
        super().__init__()
        self.branches = _Branches35()
        self.up = Conv2d(128, 320, 1, bias=True)


class _Branches17(_MultiBranch):
    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(1088, 192, 1))
        self.b2 = Sequential(ConvBN(1088, 128, 1),
                             ConvBN(128, 160, (1, 7), 1, (0, 3)),
                             ConvBN(160, 192, (7, 1), 1, (3, 0)))


class Block17(_ResidualBlock):
    scale = 0.10

    def __init__(self):
        super().__init__()
        self.branches = _Branches17()
        self.up = Conv2d(384, 1088, 1, bias=True)


class _Branches8(_MultiBranch):
    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(2080, 192, 1))
        self.b2 = Sequential(ConvBN(2080, 192, 1),
                             ConvBN(192, 224, (1, 3), 1, (0, 1)),
                             ConvBN(224, 256, (3, 1), 1, (1, 0)))


class Block8(_ResidualBlock):
    scale = 0.20

    def __init__(self, final=False):
        super().__init__()
        self.branches = _Branches8()
        self.up = Conv2d(448, 2080, 1, bias=True)
        if final:
            self.scale = 1.0
            self.final = True


class InceptionResNetV2(nn.Module):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.stem = Sequential(
            ConvBN(3, 32, 3, 2), ConvBN(32, 32, 3), ConvBN(32, 64, 3, 1, 1),
            MaxPool2d(3, 2), ConvBN(64, 80, 1), ConvBN(80, 192, 3),
            MaxPool2d(3, 2))
        self.blocks = Sequential(
            Mixed5b(),
            *[Block35() for _ in range(10)],
            Mixed6a(),
            *[Block17() for _ in range(20)],
            Mixed7a(),
            *[Block8() for _ in range(9)],
            Block8(final=True),
            ConvBN(2080, 1536, 1))
        self.pool = GlobalAvgPool()
        self.fc = Linear(1536, num_classes)
        self.input_size = 299
        self.regime = [
            {"epoch": 0, "optimizer": "SGD", "lr": 0.045, "momentum": 0.9,
             "regularizer": weight_decay_config(1e-4)},
            {"epoch": 30, "lr": 4.5e-3},
            {"epoch": 60, "lr": 4.5e-4},
        ]

    def forward(self, x):
        return self.fc(self.pool(self.blocks(self.stem(x))))


def inception_resnet_v2(**config):
    config.pop("dataset", None)
    return InceptionResNetV2(**config)
