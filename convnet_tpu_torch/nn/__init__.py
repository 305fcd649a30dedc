"""Leaf layers (counterpart of convnet_tpu/nn)."""

from convnet_tpu_torch.nn.checkpoint import CheckpointModule
from convnet_tpu_torch.nn.layers import (AvgPool2d, BatchNorm2d, Conv2d,
                                         Dropout, Flatten, GlobalAvgPool,
                                         HardSwish, Linear, LocalResponseNorm,
                                         MaxPool2d, ReLU, ReLU6, Sigmoid)
from convnet_tpu_torch.nn.se import SEBlock, SESwishBlock

__all__ = ["AvgPool2d", "BatchNorm2d", "CheckpointModule", "Conv2d",
           "Dropout", "Flatten", "GlobalAvgPool", "HardSwish", "Linear",
           "LocalResponseNorm", "MaxPool2d", "ReLU", "ReLU6", "SEBlock",
           "SESwishBlock", "Sigmoid"]
