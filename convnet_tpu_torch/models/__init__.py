"""Model registry — ``models.build(name, **config)`` (counterpart of
convnet_tpu/models/__init__.py). Only ``"resnet"`` is ported so far."""

from convnet_tpu_torch.models.resnet import ResNet_imagenet, resnet

REGISTRY = {
    "resnet": resnet,
}


def build(name, **config):
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(REGISTRY)}") from None
    return factory(**config)


__all__ = ["REGISTRY", "ResNet_imagenet", "build", "resnet"]
