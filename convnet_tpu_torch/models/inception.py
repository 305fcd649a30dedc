"""Inception v3 (counterpart of convnet_tpu/models/inception.py), input 299².

Blocks A (35², a 3x3/s1/p1 average-pool branch with ``count_include_pad``
True), B (35 → 17, a 3x3/s2 max-pool branch), C (factorized 7x7: (1, 7) and
(7, 1) kernels with (0, 3) and (3, 0) padding), D (17 → 8) and E (the split
(1, 3) ‖ (3, 1) branches of ``_SplitBranch``). Module names follow the JAX
package's tree (``blocks.9.b2.branch_a.0.conv.weight``).

In eval each 1x1 ``ConvBN`` runs the fused kernel, 40 a forward; the four
max pools (two in the stem, one in each reduction block) run the pool
kernels, in training and in eval.

``aux_classifiers=True`` adds ``aux``, the training-only head after the
last 17² block (child ``"7"`` of ``blocks``): 1x1 ``ConvBN`` to 128, a 5x5
``ConvBN`` to 768 (padded, so that it runs at any trunk size), a global
average pool and a linear layer, weighted 0.4. It runs only in a training
forward given a collector, ``model(x, aux=[])`` (see ``models/googlenet.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.models.resnet import ConvBN, weight_decay_config
from convnet_tpu_torch.nn import (AvgPool2d, Dropout, GlobalAvgPool, Linear,
                                  MaxPool2d)


class _MultiBranch(nn.Module):
    """Runs its children (the branches) on the same input and concatenates
    their outputs along the channels, in definition order."""

    def forward(self, x):
        return torch.cat([branch(x) for branch in self.children()], dim=-1)


class InceptionA(_MultiBranch):
    def __init__(self, in_ch, pool_features):
        super().__init__()
        self.b1 = Sequential(ConvBN(in_ch, 64, 1))
        self.b2 = Sequential(ConvBN(in_ch, 48, 1), ConvBN(48, 64, 5, 1, 2))
        self.b3 = Sequential(ConvBN(in_ch, 64, 1), ConvBN(64, 96, 3, 1, 1),
                             ConvBN(96, 96, 3, 1, 1))
        self.b4 = Sequential(AvgPool2d(3, 1, 1),
                             ConvBN(in_ch, pool_features, 1))
        self.out_channels = 64 + 64 + 96 + pool_features


class InceptionB(_MultiBranch):
    """Grid reduction 35 → 17."""

    def __init__(self, in_ch):
        super().__init__()
        self.b1 = Sequential(ConvBN(in_ch, 384, 3, 2))
        self.b2 = Sequential(ConvBN(in_ch, 64, 1), ConvBN(64, 96, 3, 1, 1),
                             ConvBN(96, 96, 3, 2))
        self.b3 = Sequential(MaxPool2d(3, 2))
        self.out_channels = 384 + 96 + in_ch


class InceptionC(_MultiBranch):
    """Factorized 7x7 (1x7 and 7x1 pairs)."""

    def __init__(self, in_ch, c7):
        super().__init__()
        self.b1 = Sequential(ConvBN(in_ch, 192, 1))
        self.b2 = Sequential(ConvBN(in_ch, c7, 1),
                             ConvBN(c7, c7, (1, 7), 1, (0, 3)),
                             ConvBN(c7, 192, (7, 1), 1, (3, 0)))
        self.b3 = Sequential(ConvBN(in_ch, c7, 1),
                             ConvBN(c7, c7, (7, 1), 1, (3, 0)),
                             ConvBN(c7, c7, (1, 7), 1, (0, 3)),
                             ConvBN(c7, c7, (7, 1), 1, (3, 0)),
                             ConvBN(c7, 192, (1, 7), 1, (0, 3)))
        self.b4 = Sequential(AvgPool2d(3, 1, 1), ConvBN(in_ch, 192, 1))
        self.out_channels = 192 * 4


class InceptionD(_MultiBranch):
    """Grid reduction 17 → 8."""

    def __init__(self, in_ch):
        super().__init__()
        self.b1 = Sequential(ConvBN(in_ch, 192, 1), ConvBN(192, 320, 3, 2))
        self.b2 = Sequential(ConvBN(in_ch, 192, 1),
                             ConvBN(192, 192, (1, 7), 1, (0, 3)),
                             ConvBN(192, 192, (7, 1), 1, (3, 0)),
                             ConvBN(192, 192, 3, 2))
        self.b3 = Sequential(MaxPool2d(3, 2))
        self.out_channels = 320 + 192 + in_ch


class _SplitBranch(nn.Module):
    """stem → [branch_a, branch_b], concatenated (InceptionE's inner
    fork)."""

    def __init__(self, stem, branch_a, branch_b):
        super().__init__()
        self.stem = stem
        self.branch_a = branch_a
        self.branch_b = branch_b

    def forward(self, x):
        h = self.stem(x)
        return torch.cat([self.branch_a(h), self.branch_b(h)], dim=-1)


class InceptionE(_MultiBranch):
    def __init__(self, in_ch):
        super().__init__()
        self.b1 = Sequential(ConvBN(in_ch, 320, 1))
        self.b2 = _SplitBranch(
            Sequential(ConvBN(in_ch, 384, 1)),
            Sequential(ConvBN(384, 384, (1, 3), 1, (0, 1))),
            Sequential(ConvBN(384, 384, (3, 1), 1, (1, 0))))
        self.b3 = _SplitBranch(
            Sequential(ConvBN(in_ch, 448, 1), ConvBN(448, 384, 3, 1, 1)),
            Sequential(ConvBN(384, 384, (1, 3), 1, (0, 1))),
            Sequential(ConvBN(384, 384, (3, 1), 1, (1, 0))))
        self.b4 = Sequential(AvgPool2d(3, 1, 1), ConvBN(in_ch, 192, 1))
        self.out_channels = 320 + 768 + 768 + 192


class InceptionAux(nn.Module):
    """The v3 head: 1x1 bottleneck → 5x5 ``ConvBN`` (padded) → global pool
    → linear."""

    def __init__(self, in_ch, num_classes):
        super().__init__()
        self.conv0 = ConvBN(in_ch, 128, 1)
        self.conv1 = ConvBN(128, 768, 5, 1, 2)
        self.pool = GlobalAvgPool()
        self.classifier = Linear(768, num_classes)

    def forward(self, x):
        return self.classifier(self.pool(self.conv1(self.conv0(x))))


class InceptionV3(nn.Module):
    def __init__(self, num_classes=1000, dropout=0.5,
                 aux_classifiers=False, aux_weight=0.4):
        super().__init__()
        self.aux_weight = aux_weight
        self.stem = Sequential(
            ConvBN(3, 32, 3, 2), ConvBN(32, 32, 3), ConvBN(32, 64, 3, 1, 1),
            MaxPool2d(3, 2), ConvBN(64, 80, 1), ConvBN(80, 192, 3),
            MaxPool2d(3, 2))
        self.blocks = Sequential(
            InceptionA(192, 32), InceptionA(256, 64), InceptionA(288, 64),
            InceptionB(288),
            InceptionC(768, 128), InceptionC(768, 160), InceptionC(768, 160),
            InceptionC(768, 192),
            InceptionD(768),
            InceptionE(1280), InceptionE(2048))
        self.pool = GlobalAvgPool()
        self.drop = Dropout(dropout)
        self.fc = Linear(2048, num_classes)
        # the head taps the trunk after the last 17x17 block, child "7"
        self.aux = InceptionAux(768, num_classes) if aux_classifiers else None
        self.input_size = 299
        self.regime = [
            {"epoch": 0, "optimizer": "SGD", "lr": 0.045, "momentum": 0.9,
             "regularizer": weight_decay_config(1e-4)},
            {"epoch": 30, "lr": 4.5e-3},
            {"epoch": 60, "lr": 4.5e-4},
        ]

    def forward(self, x, aux=None):
        """``aux``: a list that collects ``(aux_weight, logits)`` of the
        head in a training forward; None (the default) runs no head."""
        collect = self.aux is not None and self.training and aux is not None
        x = self.stem(x)
        for name, block in self.blocks.named_children():
            x = block(x)
            if collect and name == "7":
                aux.append((self.aux_weight, self.aux(x)))
        return self.fc(self.drop(self.pool(x)))


def inception_v3(**config):
    config.pop("dataset", None)
    return InceptionV3(**config)
