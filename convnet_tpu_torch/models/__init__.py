"""Model registry — ``models.build(name, **config)`` (counterpart of
convnet_tpu/models/__init__.py). Ported so far: the ImageNet ResNets,
ResNeXt, the zero-init-residual ResNet, MobileNet v1 and MobileNet-V2."""

from convnet_tpu_torch.models.mobilenet import MobileNet, mobilenet
from convnet_tpu_torch.models.mobilenet_v2 import MobileNetV2, mobilenet_v2
from convnet_tpu_torch.models.resnet import ResNet_imagenet, resnet, resnext
from convnet_tpu_torch.models.resnet_zi import resnet_zi

REGISTRY = {
    "resnet": resnet,
    "resnext": resnext,
    "resnet_zi": resnet_zi,
    "mobilenet": mobilenet,
    "mobilenet_v2": mobilenet_v2,
}


def build(name, **config):
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(REGISTRY)}") from None
    return factory(**config)


__all__ = ["REGISTRY", "MobileNet", "MobileNetV2", "ResNet_imagenet", "build",
           "mobilenet", "mobilenet_v2", "resnet", "resnet_zi", "resnext"]
