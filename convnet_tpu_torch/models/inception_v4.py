"""Inception-v4 (counterpart of convnet_tpu/models/inception_v4.py), input
299², the Cadene/timm channel plan: a stem of three convs, Mixed3a, Mixed4a
and Mixed5a (384 channels at 35²), 4 InceptionA, ReductionA (1024 at 17²),
7 InceptionB, ReductionB (1536 at 8²), 3 InceptionC, global pool, dropout,
fc.

The branch average pools divide by their in-bounds taps
(``count_include_pad=False``). In eval each 1x1 ``ConvBN`` runs the fused
kernel, 61 a forward; the four 3x3/s2 max pools (Mixed3a, Mixed5a and the
two reductions) run the pool kernels.
"""

from __future__ import annotations

from torch import nn

from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.models.inception import _MultiBranch
from convnet_tpu_torch.models.resnet import ConvBN, weight_decay_config
from convnet_tpu_torch.nn import (AvgPool2d, Dropout, GlobalAvgPool, Linear,
                                  MaxPool2d)


def _branch_pool():
    return AvgPool2d(3, 1, 1, count_include_pad=False)


class Mixed3a(_MultiBranch):
    """64 → 160 at 73²: max pool ‖ 3x3/2 conv."""

    def __init__(self):
        super().__init__()
        self.b1 = Sequential(MaxPool2d(3, 2))
        self.b2 = Sequential(ConvBN(64, 96, 3, 2))


class Mixed4a(_MultiBranch):
    """160 → 192 at 71²."""

    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(160, 64, 1), ConvBN(64, 96, 3))
        self.b2 = Sequential(ConvBN(160, 64, 1),
                             ConvBN(64, 64, (1, 7), 1, (0, 3)),
                             ConvBN(64, 64, (7, 1), 1, (3, 0)),
                             ConvBN(64, 96, 3))


class Mixed5a(_MultiBranch):
    """192 → 384 at 35²: 3x3/2 conv ‖ max pool."""

    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(192, 192, 3, 2))
        self.b2 = Sequential(MaxPool2d(3, 2))


class InceptionA(_MultiBranch):
    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(384, 96, 1))
        self.b2 = Sequential(ConvBN(384, 64, 1), ConvBN(64, 96, 3, 1, 1))
        self.b3 = Sequential(ConvBN(384, 64, 1), ConvBN(64, 96, 3, 1, 1),
                             ConvBN(96, 96, 3, 1, 1))
        self.b4 = Sequential(_branch_pool(), ConvBN(384, 96, 1))


class ReductionA(_MultiBranch):
    """384 → 1024 at 17²."""

    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(384, 384, 3, 2))
        self.b2 = Sequential(ConvBN(384, 192, 1), ConvBN(192, 224, 3, 1, 1),
                             ConvBN(224, 256, 3, 2))
        self.b3 = Sequential(MaxPool2d(3, 2))


class InceptionB(_MultiBranch):
    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(1024, 384, 1))
        self.b2 = Sequential(ConvBN(1024, 192, 1),
                             ConvBN(192, 224, (1, 7), 1, (0, 3)),
                             ConvBN(224, 256, (7, 1), 1, (3, 0)))
        self.b3 = Sequential(ConvBN(1024, 192, 1),
                             ConvBN(192, 192, (7, 1), 1, (3, 0)),
                             ConvBN(192, 224, (1, 7), 1, (0, 3)),
                             ConvBN(224, 224, (7, 1), 1, (3, 0)),
                             ConvBN(224, 256, (1, 7), 1, (0, 3)))
        self.b4 = Sequential(_branch_pool(), ConvBN(1024, 128, 1))


class ReductionB(_MultiBranch):
    """1024 → 1536 at 8²."""

    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(1024, 192, 1), ConvBN(192, 192, 3, 2))
        self.b2 = Sequential(ConvBN(1024, 256, 1),
                             ConvBN(256, 256, (1, 7), 1, (0, 3)),
                             ConvBN(256, 320, (7, 1), 1, (3, 0)),
                             ConvBN(320, 320, 3, 2))
        self.b3 = Sequential(MaxPool2d(3, 2))


class _SplitHead(_MultiBranch):
    """Two parallel convs, (1, 3) and (3, 1), over the same input."""

    def __init__(self, in_ch):
        super().__init__()
        self.b1 = Sequential(ConvBN(in_ch, 256, (1, 3), 1, (0, 1)))
        self.b2 = Sequential(ConvBN(in_ch, 256, (3, 1), 1, (1, 0)))


class InceptionC(_MultiBranch):
    def __init__(self):
        super().__init__()
        self.b1 = Sequential(ConvBN(1536, 256, 1))
        self.b2 = Sequential(ConvBN(1536, 384, 1), _SplitHead(384))
        self.b3 = Sequential(ConvBN(1536, 384, 1),
                             ConvBN(384, 448, (3, 1), 1, (1, 0)),
                             ConvBN(448, 512, (1, 3), 1, (0, 1)),
                             _SplitHead(512))
        self.b4 = Sequential(_branch_pool(), ConvBN(1536, 256, 1))


class InceptionV4(nn.Module):
    def __init__(self, num_classes=1000, dropout=0.2):
        super().__init__()
        self.features = Sequential(
            ConvBN(3, 32, 3, 2), ConvBN(32, 32, 3), ConvBN(32, 64, 3, 1, 1),
            Mixed3a(), Mixed4a(), Mixed5a(),
            *[InceptionA() for _ in range(4)],
            ReductionA(),
            *[InceptionB() for _ in range(7)],
            ReductionB(),
            *[InceptionC() for _ in range(3)])
        self.pool = GlobalAvgPool()
        self.drop = Dropout(dropout)
        self.fc = Linear(1536, num_classes)
        self.input_size = 299
        self.regime = [
            {"epoch": 0, "optimizer": "SGD", "lr": 0.045, "momentum": 0.9,
             "regularizer": weight_decay_config(1e-4)},
            {"epoch": 30, "lr": 4.5e-3},
            {"epoch": 60, "lr": 4.5e-4},
        ]

    def forward(self, x):
        return self.fc(self.drop(self.pool(self.features(x))))


def inception_v4(**config):
    config.pop("dataset", None)
    return InceptionV4(**config)
