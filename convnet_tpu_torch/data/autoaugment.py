"""AutoAugment policies (ImageNet / CIFAR-10), PIL-based host transforms
(counterpart of convnet_tpu/data/autoaugment.py, a copy), so the port never
imports the JAX package.

The standard Cubuk et al. 2019 learned policies. They run on the host at
decode time; everything batchable runs on the device (data/transforms.py).
"""

from __future__ import annotations

import random

from PIL import Image, ImageEnhance, ImageOps

_FILL = (128, 128, 128)


def _shear_x(img, mag):
    return img.transform(img.size, Image.AFFINE, (1, mag, 0, 0, 1, 0),
                         fillcolor=_FILL)


def _shear_y(img, mag):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, mag, 1, 0),
                         fillcolor=_FILL)


def _translate_x(img, mag):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, mag * img.size[0], 0, 1, 0), fillcolor=_FILL)


def _translate_y(img, mag):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, 0, 0, 1, mag * img.size[1]), fillcolor=_FILL)


def _rotate(img, mag):
    return img.rotate(mag, fillcolor=_FILL)


OPS = {
    "ShearX": (_shear_x, 0.0, 0.3),
    "ShearY": (_shear_y, 0.0, 0.3),
    "TranslateX": (_translate_x, 0.0, 150 / 331),
    "TranslateY": (_translate_y, 0.0, 150 / 331),
    "Rotate": (_rotate, 0.0, 30.0),
    "Color": (lambda img, m: ImageEnhance.Color(img).enhance(1 + m), 0.0, 0.9),
    "Posterize": (lambda img, m: ImageOps.posterize(img, int(m)), 8, 4),
    "Solarize": (lambda img, m: ImageOps.solarize(img, int(m)), 256, 0),
    "Contrast": (lambda img, m: ImageEnhance.Contrast(img).enhance(1 + m), 0.0, 0.9),
    "Sharpness": (lambda img, m: ImageEnhance.Sharpness(img).enhance(1 + m), 0.0, 0.9),
    "Brightness": (lambda img, m: ImageEnhance.Brightness(img).enhance(1 + m), 0.0, 0.9),
    "AutoContrast": (lambda img, m: ImageOps.autocontrast(img), 0, 0),
    "Equalize": (lambda img, m: ImageOps.equalize(img), 0, 0),
    "Invert": (lambda img, m: ImageOps.invert(img), 0, 0),
}

# (op, probability, magnitude-level/10) pairs — Cubuk et al. Table 9/10
IMAGENET_POLICY = [
    [("Posterize", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("Posterize", 0.6, 7), ("Posterize", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("Posterize", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("Posterize", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]

CIFAR10_POLICY = [
    [("Invert", 0.1, 7), ("Contrast", 0.2, 6)],
    [("Rotate", 0.7, 2), ("TranslateX", 0.3, 9)],
    [("Sharpness", 0.8, 1), ("Sharpness", 0.9, 3)],
    [("ShearY", 0.5, 8), ("TranslateY", 0.7, 9)],
    [("AutoContrast", 0.5, 8), ("Equalize", 0.9, 2)],
    [("ShearY", 0.2, 7), ("Posterize", 0.3, 7)],
    [("Color", 0.4, 3), ("Brightness", 0.6, 7)],
    [("Sharpness", 0.3, 9), ("Brightness", 0.7, 9)],
    [("Equalize", 0.6, 5), ("Equalize", 0.5, 1)],
    [("Contrast", 0.6, 7), ("Sharpness", 0.6, 5)],
    [("Color", 0.7, 7), ("TranslateX", 0.5, 8)],
    [("Equalize", 0.3, 7), ("AutoContrast", 0.4, 8)],
    [("TranslateY", 0.4, 3), ("Sharpness", 0.2, 6)],
    [("Brightness", 0.9, 6), ("Color", 0.2, 8)],
    [("Solarize", 0.5, 2), ("Invert", 0.0, 3)],
    [("Equalize", 0.2, 0), ("AutoContrast", 0.6, 0)],
    [("Equalize", 0.2, 8), ("Equalize", 0.6, 4)],
    [("Color", 0.9, 9), ("Equalize", 0.6, 6)],
    [("AutoContrast", 0.8, 4), ("Solarize", 0.2, 8)],
    [("Brightness", 0.1, 3), ("Color", 0.7, 0)],
    [("Solarize", 0.4, 5), ("AutoContrast", 0.9, 3)],
    [("TranslateY", 0.9, 9), ("TranslateY", 0.7, 9)],
    [("AutoContrast", 0.9, 2), ("Solarize", 0.8, 3)],
    [("Equalize", 0.8, 8), ("Invert", 0.1, 3)],
    [("TranslateY", 0.7, 9), ("AutoContrast", 0.9, 1)],
]


def _apply_op(img, name, level, rng: random.Random):
    fn, lo, hi = OPS[name]
    mag = lo + (hi - lo) * level / 10.0
    if name in ("ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate"):
        if rng.random() < 0.5:
            mag = -mag
    return fn(img, mag)


class AutoAugmentPolicy:
    """Apply one randomly-chosen sub-policy per call."""

    def __init__(self, policy):
        self.policy = policy

    def __call__(self, img: Image.Image, rng: random.Random = random) -> Image.Image:
        sub = rng.choice(self.policy)
        for name, prob, level in sub:
            if rng.random() < prob:
                img = _apply_op(img, name, level, rng)
        return img


def ImageNetPolicy():
    return AutoAugmentPolicy(IMAGENET_POLICY)


def CIFAR10Policy():
    return AutoAugmentPolicy(CIFAR10_POLICY)
