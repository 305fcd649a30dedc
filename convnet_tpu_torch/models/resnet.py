"""ImageNet ResNets (counterpart of convnet_tpu/models/resnet.py).

NHWC activations, OIHW weights; module names follow the JAX package's
parameter tree (``stem.conv1.conv.weight``,
``layers.layer1.0.cb1.bn.running_var``, ``fc.weight``).

In eval, every 1x1 stride-1 ungrouped ``ConvBN`` runs as one fused kernel
(conv + folded BN + activation, ``ops/kernels/matmul_fused.py``), the route
the JAX package takes with ``impl="pallas"``; on a CUDA tensor that is the
hand-written kernel. At depth 50 that is 33 launches per forward.

Not ported yet: the CIFAR ResNets, SE blocks, remat, ``zero_init_residual``,
the ``s2d`` stem and the embedded training regimes.
"""

from __future__ import annotations

from torch import nn

from convnet_tpu_torch import ops
from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.nn import (BatchNorm2d, Conv2d, GlobalAvgPool, Linear,
                                  MaxPool2d)
from convnet_tpu_torch.ops.kernels.matmul_fused import conv1x1_bn_act


class ConvBN(nn.Module):
    """conv → BN (→ ReLU): the fusable unit."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
                 relu=True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride, padding,
                           groups=groups)
        self.bn = BatchNorm2d(out_ch)
        self.act = "relu" if relu else "none"

    def uses_kernel(self):
        """The JAX package's fusion predicate: eval, 1x1, stride 1, groups 1."""
        return (not self.training
                and self.conv.kernel_size == (1, 1)
                and self.conv.stride in (1, (1, 1))
                and self.conv.groups == 1)

    def forward(self, x):
        if self.uses_kernel():
            scale, shift = self.bn.folded()
            return conv1x1_bn_act(x, self.conv.weight, scale, shift,
                                  act=self.act)
        x = self.bn(self.conv(x))
        return ops.relu(x) if self.act == "relu" else x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.cb1 = ConvBN(inplanes, planes, 3, stride, 1)
        self.cb2 = ConvBN(planes, planes, 3, 1, 1, relu=False)
        self.downsample = downsample

    def forward(self, x):
        out = self.cb2(self.cb1(x))
        identity = x if self.downsample is None else self.downsample(x)
        return ops.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.cb1 = ConvBN(inplanes, planes, 1)
        self.cb2 = ConvBN(planes, planes, 3, stride, 1)
        self.cb3 = ConvBN(planes, planes * self.expansion, 1, relu=False)
        self.downsample = downsample

    def forward(self, x):
        out = self.cb3(self.cb2(self.cb1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return ops.relu(out + identity)


def _make_layer(block_cls, inplanes, planes, num_blocks, stride=1):
    out_ch = planes * block_cls.expansion
    downsample = None
    if stride != 1 or inplanes != out_ch:
        downsample = ConvBN(inplanes, out_ch, 1, stride, relu=False)
    blocks = [block_cls(inplanes if i == 0 else out_ch, planes,
                        stride=stride if i == 0 else 1,
                        downsample=downsample if i == 0 else None)
              for i in range(num_blocks)]
    return Sequential(*blocks), out_ch


class ResNet_imagenet(nn.Module):
    DEPTHS = {
        18: (BasicBlock, [2, 2, 2, 2]),
        34: (BasicBlock, [3, 4, 6, 3]),
        50: (Bottleneck, [3, 4, 6, 3]),
        101: (Bottleneck, [3, 4, 23, 3]),
        152: (Bottleneck, [3, 8, 36, 3]),
    }

    def __init__(self, depth=50, num_classes=1000, width=None, block=None,
                 layers=None):
        super().__init__()
        if block is None or layers is None:
            if depth not in self.DEPTHS:
                raise ValueError(f"unknown ImageNet ResNet depth {depth} "
                                 f"(have {sorted(self.DEPTHS)})")
            block, layers = self.DEPTHS[depth]
        width = width or [64, 128, 256, 512]
        self.stem = Sequential(ConvBN(3, width[0], 7, 2, 3),
                               MaxPool2d(3, 2, 1), names=["conv1", "maxpool"])
        stages = []
        inplanes = width[0]
        for i, (planes, n) in enumerate(zip(width, layers)):
            stage, inplanes = _make_layer(block, inplanes, planes, n,
                                          stride=1 if i == 0 else 2)
            stages.append(stage)
        self.layers = Sequential(
            *stages, names=[f"layer{i + 1}" for i in range(len(stages))])
        self.pool = GlobalAvgPool()
        self.fc = Linear(inplanes, num_classes)
        self.input_size = 224

    def forward(self, x):
        return self.fc(self.pool(self.layers(self.stem(x))))


def resnet(**config):
    """Factory with the JAX package's dataset/depth dispatch (ImageNet only)."""
    dataset = config.pop("dataset", "imagenet")
    if "cifar" in str(dataset):
        raise NotImplementedError("the CIFAR ResNets are not ported yet")
    num_classes = config.pop("num_classes", 1000)
    config.setdefault("depth", 50)
    return ResNet_imagenet(num_classes=num_classes, **config)
