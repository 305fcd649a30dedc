"""Meters and top-k counts (counterpart of convnet_tpu/train/meters.py:17-34,
64-106)."""

from __future__ import annotations

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


def correct_topk(logits, target, topk=(1,)):
    """On the device: the number of correct predictions for each k, as
    float32 scalars. ``target`` may be soft (its argmax is used)."""
    if target.dim() == logits.dim():
        target = torch.argmax(target, dim=-1)
    _, top = torch.topk(logits.float(), max(topk), dim=-1)
    correct = top == target[..., None]
    return tuple(correct[..., :k].sum().float() for k in topk)


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
