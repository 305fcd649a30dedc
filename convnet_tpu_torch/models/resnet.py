"""ImageNet ResNets (counterpart of convnet_tpu/models/resnet.py).

NHWC activations, OIHW weights; module names follow the JAX package's
parameter tree (``stem.conv1.conv.weight``,
``layers.layer1.0.cb1.bn.running_var``, ``fc.weight``).

In eval, every 1x1 stride-1 ungrouped ``ConvBN`` runs as one fused kernel
(conv + folded BN + activation, ``ops/kernels/matmul_fused.py``), the route
the JAX package takes with ``impl="pallas"``; on a CUDA tensor that is the
hand-written kernel. At depth 50 that is 33 launches per forward. The
folded BN (like the kernel's weight layouts) is made once per version of
the BN's parameters and statistics (``ops/kernels/_prepared.py``). In
training a ``ConvBN`` is conv → batch-statistics BN → ReLU. The stem's max
pool runs the pool kernels (``ops/kernels/max_pool.py``) in both modes. In
ResNeXt (``groups`` > 1) every eval stride-1 grouped 3x3 runs the grouped
conv kernel (``nn.Conv2d.uses_grouped_kernel``): 13 per ResNeXt-50 forward.

The model carries its own optimizer schedule, ``model.regime``, built by
``_make_regime`` (a copy of the JAX package's regimes).

``se_reduction`` puts an SE block (``nn/se.py``) after each block's last
``ConvBN``, before the residual add; it runs in plain ops and leaves the
kernel routes as they are (33 fused 1x1 launches per SE-ResNet-50 forward).
``remat`` wraps blocks in ``nn.CheckpointModule``: every stage (True) or the
stages named (``("layer1",)``); the CIFAR ResNets take a bool. The CIFAR
ResNets (``ResNet_cifar``, depth 6n + 2, a 3x3 stem and no max pool) run
no kernel: no pool, and no stride-1 1x1 ``ConvBN``.

``regime="mixmatch"`` adds the model's own ``data_regime``, Mix & Match's
progressive resizing: input sizes 128, 160, 192 and 224 from 0, 30%, 60%
and 80% of the epochs (``data/data_regime.py`` rebuilds the loader at each).

Not ported yet: the ``s2d`` stem.
"""

from __future__ import annotations

from torch import nn

from convnet_tpu_torch import ops
from convnet_tpu_torch.core.module import Sequential
from convnet_tpu_torch.nn import (BatchNorm2d, CheckpointModule, Conv2d,
                                  GlobalAvgPool, Linear, MaxPool2d, SEBlock)
from convnet_tpu_torch.ops.kernels import _prepared
from convnet_tpu_torch.ops.kernels.matmul_fused import conv1x1_bn_act
from convnet_tpu_torch.regimes import schedules


def weight_decay_config(value=1e-4):
    """Decoupled weight decay, applied to the weights that
    ``utils.param_filter.wd_mask`` selects (no biases, no BN parameters)."""
    return {"name": "WeightDecay", "value": value}


_ACTS = {"relu": ops.relu, "relu6": ops.relu6, "none": lambda x: x}


def folded_bn(bn):
    """bn's (scale, shift), made once per version of its parameters and
    statistics (``_prepared``)."""
    return _prepared.get(
        "batch_norm.folded",
        (bn.weight, bn.bias, bn.running_mean, bn.running_var),
        lambda *_: bn.folded())


class ConvBN(nn.Module):
    """conv → BN (→ activation): the fusable unit. ``act`` is ``"relu"``,
    ``"relu6"`` or ``"none"``; ``relu=False`` means ``"none"`` whatever
    ``act`` says (the JAX package's rule)."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
                 relu=True, zero_init_gamma=False, act="relu"):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"act={act!r}: choose from {sorted(_ACTS)}")
        self.conv = Conv2d(in_ch, out_ch, kernel, stride, padding,
                           groups=groups)
        self.bn = BatchNorm2d(out_ch, zero_init=zero_init_gamma)
        self.act = act if relu else "none"

    def uses_kernel(self):
        """The JAX package's fusion predicate: eval, 1x1, stride 1, groups 1."""
        return (not self.training
                and self.conv.kernel_size == (1, 1)
                and self.conv.stride in (1, (1, 1))
                and self.conv.groups == 1)

    def forward(self, x):
        if self.uses_kernel():
            scale, shift = folded_bn(self.bn)
            return conv1x1_bn_act(x, self.conv.weight, scale, shift,
                                  act=self.act)
        return _ACTS[self.act](self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 se_reduction=None, zero_init_residual=False):
        super().__init__()
        self.cb1 = ConvBN(inplanes, planes, 3, stride, 1, groups=groups)
        self.cb2 = ConvBN(planes, planes, 3, 1, 1, groups=groups, relu=False,
                          zero_init_gamma=zero_init_residual)
        self.se = SEBlock(planes, se_reduction) if se_reduction else None
        self.downsample = downsample

    def forward(self, x):
        out = self.cb2(self.cb1(x))
        if self.se is not None:
            out = self.se(out)
        identity = x if self.downsample is None else self.downsample(x)
        return ops.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 se_reduction=None, zero_init_residual=False):
        super().__init__()
        self.cb1 = ConvBN(inplanes, planes, 1)
        self.cb2 = ConvBN(planes, planes, 3, stride, 1, groups=groups)
        self.cb3 = ConvBN(planes, planes * self.expansion, 1, relu=False,
                          zero_init_gamma=zero_init_residual)
        self.se = (SEBlock(planes * self.expansion, se_reduction)
                   if se_reduction else None)
        self.downsample = downsample

    def forward(self, x):
        out = self.cb3(self.cb2(self.cb1(x)))
        if self.se is not None:
            out = self.se(out)
        identity = x if self.downsample is None else self.downsample(x)
        return ops.relu(out + identity)


def _make_layer(block_cls, inplanes, planes, num_blocks, stride=1, groups=1,
                se_reduction=None, zero_init_residual=False, remat=False):
    out_ch = planes * block_cls.expansion
    downsample = None
    if stride != 1 or inplanes != out_ch:
        downsample = ConvBN(inplanes, out_ch, 1, stride, relu=False)
    blocks = []
    for i in range(num_blocks):
        b = block_cls(inplanes if i == 0 else out_ch, planes,
                      stride=stride if i == 0 else 1,
                      downsample=downsample if i == 0 else None,
                      groups=groups, se_reduction=se_reduction,
                      zero_init_residual=zero_init_residual)
        blocks.append(CheckpointModule(b) if remat else b)
    return Sequential(*blocks), out_ch


class ResNet(nn.Module):
    """The shared trunk; the ImageNet and CIFAR subclasses make the stem."""

    def forward(self, x):
        return self.fc(self.pool(self.layers(self.stem(x))))


class ResNet_imagenet(ResNet):
    DEPTHS = {
        18: (BasicBlock, [2, 2, 2, 2]),
        34: (BasicBlock, [3, 4, 6, 3]),
        50: (Bottleneck, [3, 4, 6, 3]),
        101: (Bottleneck, [3, 4, 23, 3]),
        152: (Bottleneck, [3, 8, 36, 3]),
    }

    def __init__(self, depth=50, num_classes=1000, width=None, block=None,
                 layers=None, regime="normal", batch_size=256, epochs=90,
                 groups=1, zero_init_residual=False, se_reduction=None,
                 remat=False):
        super().__init__()
        if block is None or layers is None:
            if depth not in self.DEPTHS:
                raise ValueError(
                    f"unknown ImageNet ResNet depth {depth} (have "
                    f"{sorted(self.DEPTHS)}); CIFAR-style 6n+2 depths "
                    f"(8, 20, 32, ...) need dataset='cifar10'/'cifar100' "
                    f"in the model config")
            block, layers = self.DEPTHS[depth]
        width = width or [64, 128, 256, 512]
        self.stem = Sequential(ConvBN(3, width[0], 7, 2, 3),
                               MaxPool2d(3, 2, 1), names=["conv1", "maxpool"])
        stages = []
        inplanes = width[0]
        for i, (planes, n) in enumerate(zip(width, layers)):
            # remat: a bool (every stage) or the names of the stages to wrap
            stage_remat = (remat if isinstance(remat, bool)
                           else f"layer{i + 1}" in remat)
            stage, inplanes = _make_layer(
                block, inplanes, planes, n, stride=1 if i == 0 else 2,
                groups=groups, se_reduction=se_reduction,
                zero_init_residual=zero_init_residual, remat=stage_remat)
            stages.append(stage)
        self.layers = Sequential(
            *stages, names=[f"layer{i + 1}" for i in range(len(stages))])
        self.pool = GlobalAvgPool()
        self.fc = Linear(inplanes, num_classes)
        self.input_size = 224
        self.regime = self._make_regime(regime, batch_size, epochs)
        if regime == "mixmatch":
            # Mix & Match: smaller images early, full size for the last
            # fifth; eval always runs at full resolution
            self.data_regime = [
                {"epoch": 0, "input_size": 128},
                {"epoch": int(epochs * 0.3), "input_size": 160},
                {"epoch": int(epochs * 0.6), "input_size": 192},
                {"epoch": int(epochs * 0.8), "input_size": 224},
            ]

    def _make_regime(self, name, batch_size, epochs):
        wd = weight_decay_config(1e-4)
        if name in ("large", "large_batch"):
            # Goyal-style linear scaling + 5-epoch warmup ramp
            steps_per_epoch = max(1281167 // batch_size, 1)
            lr = schedules.scaled_lr(0.1, batch_size)
            return [
                {"epoch": 0, "optimizer": "SGD", "momentum": 0.9,
                 "regularizer": wd,
                 "lr": schedules.linear_warmup_lr(0.1, lr, 5 * steps_per_epoch)},
                {"epoch": 30, "lr": lr * 1e-1},
                {"epoch": 60, "lr": lr * 1e-2},
                {"epoch": 80, "lr": lr * 1e-3},
            ]
        if name in ("large_lars", "lars"):
            # LARS past the linear-scaling regime's ~8k-batch ceiling
            # (You et al. 2017; the MLPerf RN50 convention: polynomial
            # decay power 2, 5-epoch warmup, wd inside the trust ratio,
            # bias/BN excluded). lr anchored at the published 4k-batch
            # operating point and scaled linearly.
            steps_per_epoch = max(1281167 // batch_size, 1)
            return [
                {"epoch": 0, "optimizer": "LARS", "momentum": 0.9,
                 "weight_decay": 1e-4, "trust_coef": 0.001,
                 "lr": schedules.polynomial_lr(
                     7.4 * batch_size / 4096,
                     epochs * steps_per_epoch, power=2.0,
                     warmup_steps=5 * steps_per_epoch)},
            ]
        if name == "small":
            # small-batch regime ("Train longer, generalize better" lineage)
            return [
                {"epoch": 0, "optimizer": "SGD", "momentum": 0.9,
                 "regularizer": wd, "lr": 0.1 * batch_size / 256},
                {"epoch": 30, "lr": 0.01 * batch_size / 256},
                {"epoch": 60, "lr": 0.001 * batch_size / 256},
                {"epoch": 80, "lr": 0.0001 * batch_size / 256},
            ]
        if name == "mixmatch":
            # optimizer schedule identical to 'normal'; the progressive
            # resizing is the model's data_regime
            return [
                {"epoch": 0, "optimizer": "SGD", "lr": 0.1, "momentum": 0.9,
                 "regularizer": wd},
                {"epoch": 30, "lr": 1e-2},
                {"epoch": 60, "lr": 1e-3},
                {"epoch": 80, "lr": 1e-4},
            ]
        if name == "cosine":
            steps_per_epoch = max(1281167 // batch_size, 1)
            return [{"epoch": 0, "optimizer": "SGD", "momentum": 0.9,
                     "regularizer": wd,
                     "lr": schedules.cosine_lr(
                         schedules.scaled_lr(0.1, batch_size),
                         epochs * steps_per_epoch,
                         warmup_steps=5 * steps_per_epoch)}]
        # 'normal': the classic 90-epoch stepped schedule
        return [
            {"epoch": 0, "optimizer": "SGD", "lr": 0.1, "momentum": 0.9,
             "regularizer": wd},
            {"epoch": 30, "lr": 1e-2},
            {"epoch": 60, "lr": 1e-3},
            {"epoch": 80, "lr": 1e-4},
        ]


class ResNet_cifar(ResNet):
    """CIFAR ResNet of depth 6n + 2 (the JAX package's ``ResNet_cifar``):
    a 3x3/s1 stem ``ConvBN``, no max pool, three stages of n blocks at
    widths 16, 32, 64 times ``width_factor`` and strides 1, 2, 2. ``remat``
    is a bool here: any true value wraps every block, as in the JAX
    package."""

    def __init__(self, depth=20, num_classes=10, width_factor=1,
                 se_reduction=None, zero_init_residual=False, remat=False,
                 block=BasicBlock):
        super().__init__()
        n = (depth - 2) // 6
        w = 16 * width_factor
        self.stem = ConvBN(3, w, 3, 1, 1)
        stages = []
        inplanes = w
        for planes, stride in ((w, 1), (2 * w, 2), (4 * w, 2)):
            stage, inplanes = _make_layer(
                block, inplanes, planes, n, stride,
                se_reduction=se_reduction,
                zero_init_residual=zero_init_residual, remat=remat)
            stages.append(stage)
        self.layers = Sequential(*stages,
                                 names=["layer1", "layer2", "layer3"])
        self.pool = GlobalAvgPool()
        self.fc = Linear(inplanes, num_classes)
        self.input_size = 32
        # He et al.'s CIFAR schedule, as the JAX package embeds it
        self.regime = [
            {"epoch": 0, "optimizer": "SGD", "lr": 0.1, "momentum": 0.9,
             "regularizer": weight_decay_config(1e-4)},
            {"epoch": 81, "lr": 1e-2},
            {"epoch": 122, "lr": 1e-3},
            {"epoch": 164, "lr": 1e-4},
        ]


def resnet(**config):
    """Factory with the JAX package's dataset/depth dispatch: a dataset
    whose name holds ``cifar`` gives ``ResNet_cifar`` (100 classes where the
    name holds ``100``, else 10; depth 20 by default), any other
    ``ResNet_imagenet`` (1000 classes, depth 50)."""
    dataset = config.pop("dataset", "imagenet")
    if "cifar" in str(dataset):
        num_classes = config.pop("num_classes",
                                 100 if "100" in str(dataset) else 10)
        config.setdefault("depth", 20)
        return ResNet_cifar(num_classes=num_classes, **config)
    num_classes = config.pop("num_classes", 1000)
    config.setdefault("depth", 50)
    return ResNet_imagenet(num_classes=num_classes, **config)


def resnet_se(**config):
    """``resnet`` with an SE block in every block (reduction 16)."""
    config.setdefault("se_reduction", 16)
    return resnet(**config)


class ResNeXtBottleneck(Bottleneck):
    """ResNeXt bottleneck: wide grouped 3x3 with expansion 2 (so 32x4d stage
    widths 128/256/512/1024 → outputs 256/.../2048)."""
    expansion = 2


def resnext(**config):
    """ResNeXt (cardinality 32, 32x4d widths by default), the JAX package's
    ``resnext`` (``models/resnet.py:368-376``)."""
    config.setdefault("groups", 32)
    config.setdefault("depth", 50)
    config.setdefault("width", [128, 256, 512, 1024])
    config.setdefault("block", ResNeXtBottleneck)
    config.setdefault("layers", ResNet_imagenet.DEPTHS[config["depth"]][1])
    return resnet(**config)


def wide_resnet(**config):
    """Wide ResNet for CIFAR: ``ResNet_cifar`` widened by ``width_factor``
    (WRN-26-4 on CIFAR-10 by default); depth 6n + 2."""
    config.setdefault("dataset", "cifar10")
    config.setdefault("width_factor", 4)
    config.setdefault("depth", 26)
    return resnet(**config)
