"""Leaf layers (counterpart of convnet_tpu/nn)."""

from convnet_tpu_torch.nn.checkpoint import CheckpointModule
from convnet_tpu_torch.nn.layers import (BatchNorm2d, Conv2d, Dropout,
                                         GlobalAvgPool, Linear, MaxPool2d,
                                         ReLU, ReLU6)
from convnet_tpu_torch.nn.se import SEBlock, SESwishBlock

__all__ = ["BatchNorm2d", "CheckpointModule", "Conv2d", "Dropout",
           "GlobalAvgPool", "Linear", "MaxPool2d", "ReLU", "ReLU6",
           "SEBlock", "SESwishBlock"]
