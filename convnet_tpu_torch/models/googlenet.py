"""GoogLeNet, Inception-v1 with BatchNorm (counterpart of
convnet_tpu/models/googlenet.py).

Each ``Inception`` block has four branches: a 1x1, 1x1 → 3x3, 1x1 → 5x5, and
a stride-1 3x3 max pool (``MaxPool2d(3, 1, 1)``, on the pool kernels) → 1x1.
In eval each 1x1 ``ConvBN`` runs the fused kernel: 37 a forward (the stem's
and four in each of the nine blocks); the stem's two pools, the two between
stages and the nine branch pools run the pool kernels (13 a forward).

``aux_classifiers=True`` adds the two training-only heads ``aux1`` (after
``i4a``) and ``aux2`` (after ``i4d``): a 1x1 ``ConvBN`` to 128 channels, a
global average pool, then 1024 → dropout 0.7 → classes. They run only in a
training forward given a collector, ``model(x, aux=[])``, which gets
``(aux_weight, logits)`` per head (the JAX package's ``Context.aux``;
``Trainer`` adds ``weight · criterion(logits, y)`` to the loss). In eval the
heads' 1x1s are not run.
"""

from __future__ import annotations

import torch
from torch import nn

from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.models.resnet import ConvBN, weight_decay_config
from convnet_tpu_torch.nn import (Dropout, GlobalAvgPool, Linear, MaxPool2d,
                                  ReLU)


class AuxHead(nn.Module):
    """The JAX package's input-size-robust head: a 1x1 ``ConvBN``
    bottleneck, then a global average pool, so it runs at any trunk
    resolution."""

    def __init__(self, in_ch, num_classes, hidden=1024, dropout=0.7):
        super().__init__()
        self.conv = ConvBN(in_ch, 128, 1)
        self.pool = GlobalAvgPool()
        self.classifier = Sequential(
            Linear(128, hidden), ReLU(), Dropout(dropout),
            Linear(hidden, num_classes),
            names=["fc1", "relu", "drop", "fc2"])

    def forward(self, x):
        return self.classifier(self.pool(self.conv(x)))


class Inception(nn.Module):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, pool_proj):
        super().__init__()
        self.b1 = ConvBN(in_ch, c1, 1)
        self.b2 = Sequential(ConvBN(in_ch, c3r, 1), ConvBN(c3r, c3, 3, 1, 1))
        self.b3 = Sequential(ConvBN(in_ch, c5r, 1), ConvBN(c5r, c5, 5, 1, 2))
        self.b4_pool = MaxPool2d(3, 1, 1)
        self.b4 = ConvBN(in_ch, pool_proj, 1)
        self.out_channels = c1 + c3 + c5 + pool_proj

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x),
                          self.b4(self.b4_pool(x))], dim=-1)


class GoogLeNet(nn.Module):
    def __init__(self, num_classes=1000, dropout=0.4,
                 aux_classifiers=False, aux_weight=0.3):
        super().__init__()
        self.aux_weight = aux_weight
        self.stem = Sequential(
            ConvBN(3, 64, 7, 2, 3), MaxPool2d(3, 2, 1),
            ConvBN(64, 64, 1), ConvBN(64, 192, 3, 1, 1), MaxPool2d(3, 2, 1))
        self.i3a = Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = MaxPool2d(3, 2, 1)
        self.i4a = Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = MaxPool2d(3, 2, 1)
        self.i5a = Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = Inception(832, 384, 192, 384, 48, 128, 128)
        self.pool = GlobalAvgPool()
        self.drop = Dropout(dropout)
        self.fc = Linear(1024, num_classes)
        # training-only heads after 4a (512 channels) and 4d (528)
        self.aux1 = AuxHead(512, num_classes) if aux_classifiers else None
        self.aux2 = AuxHead(528, num_classes) if aux_classifiers else None
        self.input_size = 224
        self.regime = [
            {"epoch": 0, "optimizer": "SGD", "lr": 1e-1, "momentum": 0.9,
             "regularizer": weight_decay_config(1e-4)},
            {"epoch": 30, "lr": 1e-2},
            {"epoch": 60, "lr": 1e-3},
            {"epoch": 80, "lr": 1e-4},
        ]

    def forward(self, x, aux=None):
        """``aux``: a list that collects ``(aux_weight, logits)`` of each
        head in a training forward; None (the default) runs no head."""
        collect = self.aux1 is not None and self.training and aux is not None
        x = self.i3b(self.i3a(self.stem(x)))
        x = self.pool3(x)
        for name in ("i4a", "i4b", "i4c", "i4d", "i4e"):
            x = getattr(self, name)(x)
            if collect and name in ("i4a", "i4d"):
                head = self.aux1 if name == "i4a" else self.aux2
                aux.append((self.aux_weight, head(x)))
        x = self.i5b(self.i5a(self.pool4(x)))
        return self.fc(self.drop(self.pool(x)))


def googlenet(**config):
    config.pop("dataset", None)
    return GoogLeNet(**config)
