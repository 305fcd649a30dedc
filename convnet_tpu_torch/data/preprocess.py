"""Transform zoo: host (PIL, per sample) + device (batched, on the card)
(counterpart of convnet_tpu/data/preprocess.py; the constants, the host
transforms and ``get_transform``'s dispatch are copies, so the port never
imports the JAX package).

Per-sample decode-time geometry (random-resized-crop, scale + center crop,
AutoAugment) runs on the host; everything batchable (pad + random crop,
flips, cutout, normalize, PCA lighting, Mix & Match's resize) runs batched
on the device (``data/transforms.py``).

``get_transform(...)`` returns a ``Transform`` with:
- ``.host(sample, rng, dup) -> np.uint8 HWC`` fixed-size array (identity
  for array datasets like CIFAR);
- ``.device(generator, batch) -> float32 batch``, a plain function of the
  batch's tensor and a ``torch.Generator`` on its device;
- ``.duplicates``, the batch-augmentation factor (each sample expanded to K
  differently augmented copies, packed contiguously);
- ``.native_spec``, the parameters of the native JPEG pipeline where it
  can express the host transform.
"""

from __future__ import annotations

import dataclasses
import logging
import random
from functools import partial
from typing import Callable, Optional

import numpy as np

from convnet_tpu_torch.data import transforms as T

DATASET_STATS = {
    "imagenet": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
    "cifar10": {"mean": [0.491, 0.482, 0.447], "std": [0.247, 0.243, 0.262]},
    "cifar100": {"mean": [0.507, 0.487, 0.441], "std": [0.267, 0.256, 0.276]},
    "mnist": {"mean": [0.1307], "std": [0.3081]},
    "stl10": {"mean": [0.447, 0.440, 0.407], "std": [0.260, 0.257, 0.271]},
    "svhn": {"mean": [0.438, 0.444, 0.473], "std": [0.198, 0.201, 0.197]},
}

# AlexNet-lineage PCA lighting
IMAGENET_PCA = {
    "eigval": [0.2175, 0.0188, 0.0045],
    "eigvec": [[-0.5675, 0.7192, 0.4009],
               [-0.5808, -0.0045, -0.8140],
               [-0.5836, -0.6948, 0.4203]],
}

_SMALL = ("cifar10", "cifar100", "svhn", "stl10", "mnist")


@dataclasses.dataclass
class Transform:
    host: Callable        # (sample, random.Random, dup) -> np.uint8 HWC
    device: Callable      # (torch.Generator, uint8 batch) -> float32 batch
    input_size: int
    duplicates: int = 1
    # When the host transform is expressible by the native C++ decode
    # pipeline (csrc/jpegdec.cpp), its parameters: {"kind": "rrc" |
    # "center", "out_size": int, "scale_size": int, "scale": (lo, hi),
    # "ratio": (lo, hi)}. None → PIL path only (autoaugment, multicrop,
    # array datasets).
    native_spec: dict = None


def _identity_host(sample, rng, dup=0):
    return np.asarray(sample)


def _pil_of(sample):
    from PIL import Image
    if isinstance(sample, np.ndarray):
        return Image.fromarray(sample)
    return sample.convert("RGB")


def inception_host(sample, rng: random.Random, dup=0, out_size=224,
                   scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                   autoaugment_policy=None):
    """RandomResizedCrop on the host at decode time."""
    from PIL import Image
    img = _pil_of(sample)
    w, h = img.size
    area = w * h
    for _ in range(10):
        target = rng.uniform(*scale) * area
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        bw = int(round(np.sqrt(target * aspect)))
        bh = int(round(np.sqrt(target / aspect)))
        if bw <= w and bh <= h:
            x0 = rng.randint(0, w - bw)
            y0 = rng.randint(0, h - bh)
            img = img.resize((out_size, out_size), Image.BILINEAR,
                             box=(x0, y0, x0 + bw, y0 + bh))
            break
    else:  # fallback: center crop
        img = scale_center(img, out_size)
    if autoaugment_policy is not None:
        img = autoaugment_policy(img, rng)
    return np.asarray(img, np.uint8)


def scale_center(img, out_size, scale_size=None):
    """Resize the shortest side to ``scale_size`` then center-crop."""
    from PIL import Image
    scale_size = scale_size or int(out_size * 256 / 224)
    w, h = img.size
    if w < h:
        nw, nh = scale_size, int(h * scale_size / w)
    else:
        nw, nh = int(w * scale_size / h), scale_size
    img = img.resize((nw, nh), Image.BILINEAR)
    x0 = (nw - out_size) // 2
    y0 = (nh - out_size) // 2
    return img.crop((x0, y0, x0 + out_size, y0 + out_size))


def scale_crop_host(sample, rng, dup=0, out_size=224, scale_size=None):
    img = _pil_of(sample)
    return np.asarray(scale_center(img, out_size, scale_size), np.uint8)


def multicrop_host(sample, rng, dup=0, out_size=224, scale_size=None):
    """Deterministic multi-crop TTA: duplicate d selects the center or one of
    the 4 corner crops (mirrored for d ≥ 5). Pair with ``duplicates=k`` and
    eval output averaging."""
    from PIL import Image
    img = _pil_of(sample)
    scale_size = scale_size or int(out_size * 256 / 224)
    w, h = img.size
    if w < h:
        nw, nh = scale_size, int(h * scale_size / w)
    else:
        nw, nh = int(w * scale_size / h), scale_size
    img = img.resize((nw, nh), Image.BILINEAR)
    variant = dup % 10
    if variant >= 5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        variant -= 5
    positions = [
        ((nw - out_size) // 2, (nh - out_size) // 2),   # center
        (0, 0), (nw - out_size, 0),                     # corners
        (0, nh - out_size), (nw - out_size, nh - out_size),
    ]
    x0, y0 = positions[variant]
    return np.asarray(img.crop((x0, y0, x0 + out_size, y0 + out_size)),
                      np.uint8)


def default_image_size(dataset: str) -> int:
    """The eval-geometry default per dataset, shared by the training
    transforms and serving."""
    name = str(dataset).lower()
    if name in _SMALL:
        return {"stl10": 96, "mnist": 28}.get(name, 32)
    return 224


def get_transform(transform_name: str = "imagenet",
                  input_size: Optional[int] = None,
                  scale_size: Optional[int] = None,
                  augment: bool = True,
                  cutout: Optional[dict] = None,
                  autoaugment: bool = False,
                  duplicates: int = 1,
                  lighting: bool = False,
                  multicrop: bool = False,
                  normalize=None) -> Transform:
    """The reference's dispatch by dataset name."""
    name = transform_name.lower()
    stats = normalize or DATASET_STATS.get(
        name, DATASET_STATS["imagenet"])
    mean, std = stats["mean"], stats["std"]

    if not augment and duplicates > 1 and not multicrop:
        # eval duplicates of a deterministic transform would average K
        # identical logits: PIL-path datasets switch to multi-crop TTA,
        # array datasets (identity host) can only warn
        if name in _SMALL:
            logging.getLogger(__name__).warning(
                "eval duplicates=%d on %s average IDENTICAL copies "
                "(deterministic transform, no multicrop) — this burns "
                "compute without TTA benefit", duplicates, name)
        else:
            logging.getLogger(__name__).warning(
                "eval duplicates=%d without --multicrop would average "
                "identical copies — enabling deterministic multi-crop "
                "TTA (center/corner crops + mirrors)", duplicates)
            multicrop = True

    if name in _SMALL:
        size = input_size or default_image_size(name)
        pad = max(size // 8, 4)

        def device_fn(generator, batch):
            x = T.to_float(batch)
            if x.shape[1] != size or x.shape[2] != size:
                # progressive-resizing regimes (Mix & Match): bring the
                # native-resolution batch to the scheduled input size
                x = T.resize(x, size)
            if augment:
                if name != "mnist":
                    x = T.random_hflip(generator, x)
                x = T.pad_random_crop(generator, x, pad)
                if cutout:
                    x = T.random_cutout(generator, x,
                                        cutout.get("length", size // 2),
                                        cutout.get("holes", 1))
            return T.normalize(x, mean, std)

        host = _identity_host
        if autoaugment and augment and name.startswith("cifar"):
            from convnet_tpu_torch.data.autoaugment import CIFAR10Policy
            policy = CIFAR10Policy()

            def host(sample, rng, dup=0):  # noqa: F811 — intentional override
                return np.asarray(policy(_pil_of(np.asarray(sample)), rng),
                                  np.uint8)

        return Transform(host, device_fn, size, duplicates)

    # imagenet-style
    size = input_size or default_image_size(name)
    native_spec = None
    if augment:
        policy = None
        if autoaugment:
            from convnet_tpu_torch.data.autoaugment import ImageNetPolicy
            policy = ImageNetPolicy()
        host = partial(inception_host, out_size=size,
                       autoaugment_policy=policy)
        if policy is None:
            native_spec = {"kind": "rrc", "out_size": size,
                           "scale_size": 0, "scale": (0.08, 1.0),
                           "ratio": (3 / 4, 4 / 3)}

        def device_fn(generator, batch):
            x = T.random_hflip(generator, T.to_float(batch))
            if lighting:
                x = T.random_lighting(generator, x, 0.1,
                                      IMAGENET_PCA["eigval"],
                                      IMAGENET_PCA["eigvec"])
            if cutout:
                x = T.random_cutout(generator, x,
                                    cutout.get("length", size // 4),
                                    cutout.get("holes", 1))
            return T.normalize(x, mean, std)
    else:
        host_fn = (multicrop_host if (multicrop and duplicates > 1)
                   else scale_crop_host)
        host = partial(host_fn, out_size=size, scale_size=scale_size)
        if (host_fn is scale_crop_host
                and not (scale_size and scale_size < size)):
            # scale_size < out_size makes PIL's crop pad the borders black,
            # which the C++ resampler does not reproduce (it clamps taps to
            # the image): such configs stay on PIL
            native_spec = {"kind": "center", "out_size": size,
                           "scale_size": scale_size or 0}

        def device_fn(generator, batch):
            return T.normalize(T.to_float(batch), mean, std)

    return Transform(host, device_fn, size, duplicates,
                     native_spec=native_spec)
