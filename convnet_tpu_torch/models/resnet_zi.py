"""Zero-init-residual ResNet (counterpart of convnet_tpu/models/resnet_zi.py):
the last BatchNorm of every residual branch starts with γ = 0, so every
block begins as the identity."""

from convnet_tpu_torch.models.resnet import resnet


def resnet_zi(**config):
    config.setdefault("zero_init_residual", True)
    return resnet(**config)
