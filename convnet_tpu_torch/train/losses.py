"""Cross-entropy with hard or soft targets, label smoothing (uniform or
toward a given distribution) and per-class weights, and binary
cross-entropy (counterpart of convnet_tpu/train/losses.py:18-128).

All math in float32 whatever the logits' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def onehot(target, num_classes, dtype=torch.float32):
    """One-hot rows of integer ``target``."""
    return F.one_hot(target.long(), num_classes).to(dtype)


def _smooth(soft, smooth_eps, smooth_dist, num_classes):
    if smooth_eps and smooth_eps > 0:
        if smooth_dist is None:
            return soft * (1.0 - smooth_eps) + smooth_eps / num_classes
        dist = torch.as_tensor(smooth_dist, dtype=torch.float32,
                               device=soft.device)
        return soft * (1.0 - smooth_eps) + smooth_eps * dist
    return soft


def cross_entropy(logits, target, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", smooth_eps: float = 0.0,
                  smooth_dist=None):
    """CE over the last axis of ``logits``. ``target``: integer class labels
    (``ignore_index`` rows count neither in the loss nor in the mean), or
    float soft targets of ``logits``'s shape. ``smooth_eps`` mixes the
    target with ``smooth_dist`` (a distribution over the classes; None:
    uniform). ``weight``: one weight a class, gathered by the hard target,
    or by the argmax of the (smoothed) soft one."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    hard = not target.is_floating_point()
    if hard:
        valid = target != ignore_index
        safe_target = torch.where(valid, target, 0)
        soft = onehot(safe_target, num_classes)
    else:
        valid = torch.ones(target.shape[:-1], dtype=torch.bool,
                           device=target.device)
        soft = target.float()
    soft = _smooth(soft, smooth_eps, smooth_dist, num_classes)
    loss = -torch.sum(soft * logp, dim=-1)
    if weight is not None:
        cls = safe_target.long() if hard else torch.argmax(soft, dim=-1)
        loss = loss * torch.as_tensor(weight, dtype=torch.float32,
                                      device=loss.device)[cls]
    loss = torch.where(valid, loss, 0.0)

    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    denom = torch.clamp_min(valid.float().sum(), 1.0)
    return torch.sum(loss) / denom


def binary_cross_entropy(logits, target, reduction: str = "mean",
                         smooth_eps: float = 0.0, from_logits: bool = True):
    """BCE of ``logits`` (probabilities where ``from_logits`` is False,
    clipped to [1e-7, 1 − 1e-7]) against hard or soft ``target`` of the same
    shape, squeezed toward [eps/2, 1 − eps/2] by ``smooth_eps``."""
    target = torch.as_tensor(target).float()
    if smooth_eps and smooth_eps > 0:
        target = target * (1.0 - smooth_eps) + 0.5 * smooth_eps
    logits = logits.float()
    if from_logits:
        # stable: max(x, 0) − x·z + log(1 + e^−|x|)
        loss = (torch.clamp_min(logits, 0) - logits * target
                + torch.log1p(torch.exp(-logits.abs())))
    else:
        p = torch.clamp(logits, 1e-7, 1 - 1e-7)
        loss = -(target * torch.log(p) + (1 - target) * torch.log1p(-p))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    return torch.mean(loss)


class BCELoss:
    """Callable config object."""

    def __init__(self, reduction="mean", smooth_eps=0.0, from_logits=True):
        self.reduction = reduction
        self.smooth_eps = smooth_eps
        self.from_logits = from_logits

    def __call__(self, logits, target):
        return binary_cross_entropy(logits, target, self.reduction,
                                    self.smooth_eps, self.from_logits)


class CrossEntropyLoss:
    """Callable config object."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 smooth_eps=0.0, smooth_dist=None):
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.smooth_eps = smooth_eps
        self.smooth_dist = smooth_dist

    def __call__(self, logits, target):
        return cross_entropy(logits, target, weight=self.weight,
                             ignore_index=self.ignore_index,
                             reduction=self.reduction,
                             smooth_eps=self.smooth_eps,
                             smooth_dist=self.smooth_dist)
