"""Model registry — ``models.build(name, **config)`` (counterpart of
convnet_tpu/models/__init__.py), with the JAX package's 15 names: the
ImageNet and CIFAR ResNets (with SE blocks and remat), ResNeXt, the
zero-init-residual ResNet, the wide CIFAR ResNet, MobileNet v1 and
MobileNet-V2, AlexNet, VGG, the MNIST net, DenseNet, GoogLeNet, Inception
v3, Inception-v4 and Inception-ResNet-v2."""

from convnet_tpu_torch.models.alexnet import alexnet
from convnet_tpu_torch.models.densenet import densenet
from convnet_tpu_torch.models.googlenet import googlenet
from convnet_tpu_torch.models.inception import inception_v3
from convnet_tpu_torch.models.inception_resnet_v2 import inception_resnet_v2
from convnet_tpu_torch.models.inception_v4 import inception_v4
from convnet_tpu_torch.models.mnist import mnist_model
from convnet_tpu_torch.models.mobilenet import MobileNet, mobilenet
from convnet_tpu_torch.models.mobilenet_v2 import MobileNetV2, mobilenet_v2
from convnet_tpu_torch.models.resnet import (ResNet_cifar, ResNet_imagenet,
                                             resnet, resnet_se, resnext,
                                             wide_resnet)
from convnet_tpu_torch.models.resnet_zi import resnet_zi
from convnet_tpu_torch.models.vgg import vgg

REGISTRY = {
    "resnet": resnet,
    "resnet_se": resnet_se,
    "resnext": resnext,
    "wide_resnet": wide_resnet,
    "resnet_zi": resnet_zi,
    "alexnet": alexnet,
    "mobilenet": mobilenet,
    "mobilenet_v2": mobilenet_v2,
    "googlenet": googlenet,
    "vgg": vgg,
    "mnist": mnist_model,
    "densenet": densenet,
    "inception_v3": inception_v3,
    "inception_resnet_v2": inception_resnet_v2,
    "inception_v4": inception_v4,
}


def build(name, **config):
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(REGISTRY)}") from None
    return factory(**config)


__all__ = ["REGISTRY", "MobileNet", "MobileNetV2", "ResNet_cifar",
           "ResNet_imagenet", "alexnet", "build", "densenet", "googlenet",
           "inception_resnet_v2", "inception_v3", "inception_v4",
           "mnist_model", "mobilenet", "mobilenet_v2", "resnet", "resnet_se",
           "resnet_zi", "resnext", "vgg", "wide_resnet"]
