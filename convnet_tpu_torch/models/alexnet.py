"""AlexNet-OWT with BatchNorm (counterpart of convnet_tpu/models/alexnet.py):
input 224², three 3x3/s2 max pools with no padding (on the pool kernels),
then ``Flatten`` of the (6, 6, 256) map into ``Linear(256·6·6, 4096)``, and
the stepped SGD regime."""

from __future__ import annotations

from torch import nn

from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.models.resnet import weight_decay_config
from convnet_tpu_torch.nn import (BatchNorm2d, Conv2d, Dropout, Flatten,
                                  Linear, MaxPool2d, ReLU)


def _conv_bn_relu(in_ch, out_ch, k, stride=1, pad=0):
    return [Conv2d(in_ch, out_ch, k, stride, pad), BatchNorm2d(out_ch), ReLU()]


class AlexNetOWT_BN(nn.Module):
    def __init__(self, num_classes=1000):
        super().__init__()
        layers = (
            _conv_bn_relu(3, 64, 11, 4, 2) + [MaxPool2d(3, 2)]
            + _conv_bn_relu(64, 192, 5, 1, 2) + [MaxPool2d(3, 2)]
            + _conv_bn_relu(192, 384, 3, 1, 1)
            + _conv_bn_relu(384, 256, 3, 1, 1)
            + _conv_bn_relu(256, 256, 3, 1, 1) + [MaxPool2d(3, 2)])
        self.features = Sequential(*layers)
        self.classifier = Sequential(
            Flatten(),
            Dropout(0.5), Linear(256 * 6 * 6, 4096), ReLU(),
            Dropout(0.5), Linear(4096, 4096), ReLU(),
            Linear(4096, num_classes),
            names=["flatten", "drop1", "fc1", "relu1", "drop2", "fc2",
                   "relu2", "fc3"])
        self.input_size = 224
        self.regime = [
            {"epoch": 0, "optimizer": "SGD", "lr": 1e-2, "momentum": 0.9,
             "regularizer": weight_decay_config(5e-4)},
            {"epoch": 10, "lr": 5e-3},
            {"epoch": 15, "lr": 1e-3},
            {"epoch": 20, "lr": 5e-4},
            {"epoch": 25, "lr": 1e-4},
        ]

    def forward(self, x):
        return self.classifier(self.features(x))


def alexnet(**config):
    config.pop("dataset", None)
    return AlexNetOWT_BN(**config)
