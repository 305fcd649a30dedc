"""The small MNIST convnet (counterpart of convnet_tpu/models/mnist.py):
two biased 5x5 convs, each with a ReLU and a 2x2 max pool (both on the pool
kernels), then ``Flatten`` → 1024 → dropout → classes.

``in_channels`` (1) is the port's own attribute: the CLI reads it to make a
synthetic dataset of one channel at ``input_size`` for this model.
"""

from __future__ import annotations

from torch import nn

from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.nn import (Conv2d, Dropout, Flatten, Linear,
                                  MaxPool2d, ReLU)


class MnistNet(nn.Module):
    def __init__(self, num_classes=10):
        super().__init__()
        self.features = Sequential(
            Conv2d(1, 32, 5, padding=2, bias=True), ReLU(), MaxPool2d(2),
            Conv2d(32, 64, 5, padding=2, bias=True), ReLU(), MaxPool2d(2),
            names=["conv1", "relu1", "pool1", "conv2", "relu2", "pool2"])
        self.classifier = Sequential(
            Flatten(), Linear(7 * 7 * 64, 1024), ReLU(), Dropout(0.5),
            Linear(1024, num_classes),
            names=["flatten", "fc1", "relu", "drop", "fc2"])
        self.input_size = 28
        self.in_channels = 1
        self.regime = [
            {"epoch": 0, "optimizer": "SGD", "lr": 0.01, "momentum": 0.9},
            {"epoch": 10, "lr": 1e-3},
        ]

    def forward(self, x):
        return self.classifier(self.features(x))


def mnist_model(**config):
    config.pop("dataset", None)
    return MnistNet(**config)
