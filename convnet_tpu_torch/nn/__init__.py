"""Leaf layers (counterpart of convnet_tpu/nn)."""

from convnet_tpu_torch.nn.layers import (BatchNorm2d, Conv2d, Dropout,
                                         GlobalAvgPool, Linear, MaxPool2d,
                                         ReLU, ReLU6)

__all__ = ["BatchNorm2d", "Conv2d", "Dropout", "GlobalAvgPool", "Linear",
           "MaxPool2d", "ReLU", "ReLU6"]
