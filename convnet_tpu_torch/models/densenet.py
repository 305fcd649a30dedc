"""DenseNet-BC (counterpart of convnet_tpu/models/densenet.py): a 7x7/s2
stem with a 3x3/s2/p1 max pool (on the pool kernels), dense blocks of
pre-activation ``DenseLayer``s (BN → ReLU → 1x1 → BN → ReLU → 3x3,
concatenated to the input) and ``Transition``s (BN → ReLU → 1x1 → 2x2
average pool). ``growth`` and ``block_config`` default to the depth's
(121, 161, 169, 201). Its 1x1 convs are plain convs, not ``ConvBN``s, so
none runs the fused kernel (as in the JAX package)."""

from __future__ import annotations

import torch
from torch import nn

from convnet_tpu_torch import ops
from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.models.resnet import weight_decay_config
from convnet_tpu_torch.nn import (AvgPool2d, BatchNorm2d, Conv2d,
                                  GlobalAvgPool, Linear, MaxPool2d)

DEPTH_CFG = {121: (32, [6, 12, 24, 16]), 169: (32, [6, 12, 32, 32]),
             201: (32, [6, 12, 48, 32]), 161: (48, [6, 12, 36, 24])}


class DenseLayer(nn.Module):
    """BN → ReLU → 1x1 conv → BN → ReLU → 3x3 conv, concatenated to x."""

    def __init__(self, in_ch, growth, bn_size=4):
        super().__init__()
        self.bn1 = BatchNorm2d(in_ch)
        self.conv1 = Conv2d(in_ch, bn_size * growth, 1)
        self.bn2 = BatchNorm2d(bn_size * growth)
        self.conv2 = Conv2d(bn_size * growth, growth, 3, 1, 1)

    def forward(self, x):
        y = self.conv1(ops.relu(self.bn1(x)))
        y = self.conv2(ops.relu(self.bn2(y)))
        return torch.cat([x, y], dim=-1)


class Transition(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.bn = BatchNorm2d(in_ch)
        self.conv = Conv2d(in_ch, out_ch, 1)
        self.pool = AvgPool2d(2, 2)

    def forward(self, x):
        return self.pool(self.conv(ops.relu(self.bn(x))))


class DenseNet(nn.Module):
    def __init__(self, depth=121, num_classes=1000, growth=None,
                 block_config=None):
        super().__init__()
        g, cfg = DEPTH_CFG.get(depth, (32, [6, 12, 24, 16]))
        growth = growth or g
        block_config = block_config or cfg
        ch = 2 * growth
        self.stem = Sequential(
            Conv2d(3, ch, 7, 2, 3), BatchNorm2d(ch), MaxPool2d(3, 2, 1),
            names=["conv", "bn", "pool"])
        stages = []
        for i, n in enumerate(block_config):
            layers = []
            for _ in range(n):
                layers.append(DenseLayer(ch, growth))
                ch += growth
            stages.append(Sequential(*layers))
            if i != len(block_config) - 1:
                stages.append(Transition(ch, ch // 2))
                ch //= 2
        self.blocks = Sequential(*stages)
        self.bn_final = BatchNorm2d(ch)
        self.pool = GlobalAvgPool()
        self.fc = Linear(ch, num_classes)
        self.input_size = 224
        self.regime = [
            {"epoch": 0, "optimizer": "SGD", "lr": 1e-1, "momentum": 0.9,
             "regularizer": weight_decay_config(1e-4)},
            {"epoch": 30, "lr": 1e-2},
            {"epoch": 60, "lr": 1e-3},
            {"epoch": 80, "lr": 1e-4},
        ]

    def forward(self, x):
        x = self.blocks(ops.relu(self.stem(x)))
        return self.fc(self.pool(ops.relu(self.bn_final(x))))


def densenet(**config):
    config.pop("dataset", None)
    return DenseNet(**config)
