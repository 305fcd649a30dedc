"""MixUp and CutMix on NHWC batches (counterpart of
convnet_tpu/train/mixup.py).

Each sample is mixed with the batch flipped along axis 0, and the targets
become soft: λ · onehot(y) + (1 − λ) · onehot(flip(y)). The functions take
λ, and CutMix's box centre, already drawn. ``MixUp`` and ``CutMix`` draw
them on the host from a numpy generator of their own, so a step never waits
on the device for a scalar, and the card and the CPU draw the same values
from the same seed. (The JAX package draws them with ``jax.random`` inside
its step; that stream is not reproduced.)
"""

from __future__ import annotations

import numpy as np
import torch

from convnet_tpu_torch.train.losses import onehot


def _mix_targets(target, num_classes, lam):
    soft = onehot(target, num_classes)
    return lam * soft + (1.0 - lam) * torch.flip(soft, dims=(0,))


def mixup_batch(x, target, num_classes, lam):
    """(mixed x, soft targets). λ is rounded to float32, and for the images
    to x's dtype, as the JAX package rounds its float32 draw."""
    lam = float(np.float32(lam))
    lam_x = torch.full((), lam, dtype=x.dtype, device=x.device)
    mixed = lam_x * x + (1.0 - lam_x) * torch.flip(x, dims=(0,))
    return mixed, _mix_targets(target, num_classes, lam)


def rand_bbox_mask(height, width, lam, cy, cx, device=None):
    """The (height, width) bool mask of the box of area about (1 − λ)·H·W
    centred at (``cy``, ``cx``) and clipped to the image, and its bounds
    (y1, y2, x1, x2). The box's sides are computed in float32, as the JAX
    package computes them."""
    cut_rat = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.float32(height) * cut_rat)
    cut_w = int(np.float32(width) * cut_rat)
    y1 = int(np.clip(cy - cut_h // 2, 0, height))
    y2 = int(np.clip(cy + cut_h // 2, 0, height))
    x1 = int(np.clip(cx - cut_w // 2, 0, width))
    x2 = int(np.clip(cx + cut_w // 2, 0, width))
    rows = torch.arange(height, device=device)[:, None]
    cols = torch.arange(width, device=device)[None, :]
    mask = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    return mask, (y1, y2, x1, x2)


def cutmix_batch(x, target, num_classes, lam, cy, cx):
    """NHWC CutMix: the box of :func:`rand_bbox_mask` comes from the flipped
    batch; λ is corrected to the exact share of the image left unpasted."""
    h, w = x.shape[1], x.shape[2]
    mask, (y1, y2, x1, x2) = rand_bbox_mask(h, w, lam, cy, cx, x.device)
    mixed = torch.where(mask[None, :, :, None], torch.flip(x, dims=(0,)), x)
    lam_adj = float(np.float32(1.0) - np.float32((y2 - y1) * (x2 - x1))
                    / np.float32(h * w))
    return mixed, _mix_targets(target, num_classes, lam_adj)


class MixUp:
    """Mixes a batch with λ ~ Beta(α, α) drawn from ``seed``'s numpy
    generator."""

    def __init__(self, alpha=1.0, num_classes=None, seed=0):
        self.alpha = alpha
        self.num_classes = num_classes
        self.rng = np.random.default_rng(seed)

    def sample(self, x):
        """The draws for batch ``x``, as keyword arguments of the mix."""
        return {"lam": float(self.rng.beta(self.alpha, self.alpha))}

    def __call__(self, x, target, num_classes=None):
        return mixup_batch(x, target, num_classes or self.num_classes,
                           **self.sample(x))


class CutMix(MixUp):
    """CutMix with λ ~ Beta(α, α) and a box centre uniform over the image,
    drawn from ``seed``'s numpy generator."""

    def sample(self, x):
        lam = float(self.rng.beta(self.alpha, self.alpha))
        return {"lam": lam, "cy": int(self.rng.integers(0, x.shape[1])),
                "cx": int(self.rng.integers(0, x.shape[2]))}

    def __call__(self, x, target, num_classes=None):
        return cutmix_batch(x, target, num_classes or self.num_classes,
                            **self.sample(x))
