"""Model registry — ``models.build(name, **config)`` (counterpart of
convnet_tpu/models/__init__.py). Ported so far: the ImageNet and CIFAR
ResNets (with SE blocks and remat), ResNeXt, the zero-init-residual ResNet,
the wide CIFAR ResNet, MobileNet v1 and MobileNet-V2."""

from convnet_tpu_torch.models.mobilenet import MobileNet, mobilenet
from convnet_tpu_torch.models.mobilenet_v2 import MobileNetV2, mobilenet_v2
from convnet_tpu_torch.models.resnet import (ResNet_cifar, ResNet_imagenet,
                                             resnet, resnet_se, resnext,
                                             wide_resnet)
from convnet_tpu_torch.models.resnet_zi import resnet_zi

REGISTRY = {
    "resnet": resnet,
    "resnet_se": resnet_se,
    "resnext": resnext,
    "resnet_zi": resnet_zi,
    "mobilenet": mobilenet,
    "mobilenet_v2": mobilenet_v2,
    "wide_resnet": wide_resnet,
}


def build(name, **config):
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(REGISTRY)}") from None
    return factory(**config)


__all__ = ["REGISTRY", "MobileNet", "MobileNetV2", "ResNet_cifar",
           "ResNet_imagenet", "build", "mobilenet", "mobilenet_v2", "resnet",
           "resnet_se", "resnet_zi", "resnext", "wide_resnet"]
