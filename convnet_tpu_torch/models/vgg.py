"""VGG with BatchNorm (counterpart of convnet_tpu/models/vgg.py): depths 11,
13, 16 and 19 of 3x3 ``ConvBN``s, five 2x2 max pools (on the pool kernels);
at 224² a three-layer classifier over the flattened (7, 7, 512) map, on a
CIFAR dataset (32²) one linear layer over 512 features."""

from __future__ import annotations

from torch import nn

from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.models.resnet import ConvBN, weight_decay_config
from convnet_tpu_torch.nn import Dropout, Flatten, Linear, MaxPool2d, ReLU

CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
         "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    def __init__(self, depth=16, num_classes=1000, dataset="imagenet"):
        super().__init__()
        layers = []
        in_ch = 3
        for v in CFGS[depth]:
            if v == "M":
                layers.append(MaxPool2d(2, 2))
            else:
                layers.append(ConvBN(in_ch, v, 3, 1, 1))
                in_ch = v
        self.features = Sequential(*layers)
        small = "cifar" in str(dataset)
        self.input_size = 32 if small else 224
        flat = 512 if small else 512 * 7 * 7
        if small:
            self.classifier = Sequential(Flatten(), Linear(flat, num_classes))
        else:
            self.classifier = Sequential(
                Flatten(),
                Linear(flat, 4096), ReLU(), Dropout(0.5),
                Linear(4096, 4096), ReLU(), Dropout(0.5),
                Linear(4096, num_classes))
        self.regime = [
            {"epoch": 0, "optimizer": "SGD", "lr": 1e-1, "momentum": 0.9,
             "regularizer": weight_decay_config(5e-4)},
            {"epoch": 30, "lr": 1e-2},
            {"epoch": 60, "lr": 1e-3},
            {"epoch": 80, "lr": 1e-4},
        ]

    def forward(self, x):
        return self.classifier(self.features(x))


def vgg(**config):
    dataset = config.pop("dataset", "imagenet")
    if "cifar" in str(dataset):
        config.setdefault("num_classes", 100 if "100" in str(dataset) else 10)
    return VGG(dataset=dataset, **config)
