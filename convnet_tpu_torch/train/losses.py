"""Cross-entropy with hard or soft targets and label smoothing (counterpart
of convnet_tpu/train/losses.py:18-128).

All math in float32 whatever the logits' dtype. Not ported yet: per-class
weights, a non-uniform smoothing distribution and binary cross-entropy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits, target, ignore_index: int = -100,
                  reduction: str = "mean", smooth_eps: float = 0.0):
    """CE over the last axis of ``logits``. ``target``: integer class labels
    (``ignore_index`` rows count neither in the loss nor in the mean), or
    float soft targets of ``logits``'s shape. ``smooth_eps`` mixes the
    target with the uniform distribution."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    if not target.is_floating_point():
        valid = target != ignore_index
        safe_target = torch.where(valid, target, 0)
        soft = F.one_hot(safe_target.long(), num_classes).float()
    else:
        valid = torch.ones(target.shape[:-1], dtype=torch.bool,
                           device=target.device)
        soft = target.float()
    if smooth_eps > 0:
        soft = soft * (1.0 - smooth_eps) + smooth_eps / num_classes
    loss = torch.where(valid, -torch.sum(soft * logp, dim=-1), 0.0)

    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    denom = torch.clamp_min(valid.float().sum(), 1.0)
    return torch.sum(loss) / denom


class CrossEntropyLoss:
    """Callable config object."""

    def __init__(self, ignore_index=-100, reduction="mean", smooth_eps=0.0):
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.smooth_eps = smooth_eps

    def __call__(self, logits, target):
        return cross_entropy(logits, target, ignore_index=self.ignore_index,
                             reduction=self.reduction,
                             smooth_eps=self.smooth_eps)
