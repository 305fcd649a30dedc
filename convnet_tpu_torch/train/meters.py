"""Meters and top-k counts (counterpart of convnet_tpu/train/meters.py:17-106).
"""

from __future__ import annotations

import math

import numpy as np
import torch


class AverageMeter:
    """val/avg/sum/count tracker."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class OnlineMeter:
    """Running mean and variance (Welford)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0

    def update(self, val):
        val = float(val)
        self.count += 1
        delta = val - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (val - self.mean)

    @property
    def var(self):
        return self._m2 / max(self.count - 1, 1)

    @property
    def std(self):
        return math.sqrt(self.var)


def correct_topk(logits, target, topk=(1,)):
    """On the device: the number of correct predictions for each k, as
    float32 scalars. ``target`` may be soft (its argmax is used)."""
    if target.dim() == logits.dim():
        target = torch.argmax(target, dim=-1)
    _, top = torch.topk(logits.float(), max(topk), dim=-1)
    correct = top == target[..., None]
    return tuple(correct[..., :k].sum().float() for k in topk)


def accuracy(output, target, topk=(1,)):
    """On the host: top-k accuracy in percent of array-likes ``output``
    (B, classes) and ``target`` (labels, or soft targets: their argmax)."""
    output = np.asarray(output)
    target = np.asarray(target)
    if target.ndim == output.ndim:
        target = target.argmax(-1)
    pred = np.argsort(-output, axis=-1)[:, :max(topk)]
    correct = pred == target[:, None]
    return [100.0 * correct[:, :k].sum() / target.shape[0] for k in topk]


class AccuracyMeter:
    """Tracks top-1/top-5 accuracy over a phase."""

    def __init__(self, topk=(1, 5)):
        self.topk = topk
        self.reset()

    def reset(self):
        self.correct = {k: 0.0 for k in self.topk}
        self.count = 0

    def update(self, correct_counts, n):
        for k, c in zip(self.topk, correct_counts):
            self.correct[k] += float(c)
        self.count += n

    def value(self, k=None):
        k = k or self.topk[0]
        return 100.0 * self.correct[k] / max(self.count, 1)
