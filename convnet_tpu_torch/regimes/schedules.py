"""Schedule helpers that generate regime entries or callable settings:
a copy of convnet_tpu/regimes/schedules.py (pure Python), so the port never
imports the JAX package. A CPU test holds the two copies equal.

Values may be callables ``f(epoch, step)`` evaluated when the regime is
resolved, once per step on the host.
"""

from __future__ import annotations

import math
from typing import List, Dict


def linear_warmup_lr(base_lr: float, target_lr: float, warmup_steps: int):
    """Callable setting: ramp lr linearly from base to target over steps."""

    def lr(epoch, step):
        if warmup_steps <= 0 or step >= warmup_steps:
            return target_lr
        return base_lr + (target_lr - base_lr) * (step / warmup_steps)

    lr.base_lr = target_lr  # nominal (post-warmup) lr, for rescale_regime_lr
    return lr


def ramp_up_lr(lr0: float, lr_end: float, ramp_up_steps: int) -> List[Dict]:
    """Reference-style warmup: a single step-0 entry whose lr is a ramp
    callable (models/resnet.py ramp_up_lr equivalent)."""
    return [{"step": 0, "lr": linear_warmup_lr(lr0, lr_end, ramp_up_steps)}]


def step_decay_lr(base_lr: float, decay: float, every_epochs: int):
    """lr = base * decay^(epoch // every_epochs) as a callable setting."""

    def lr(epoch, step):
        return base_lr * (decay ** (int(epoch) // every_epochs))

    lr.base_lr = base_lr  # nominal lr, for rescale_regime_lr
    return lr


def cosine_lr(base_lr: float, total_steps: int, final_lr: float = 0.0,
              warmup_steps: int = 0):
    def lr(epoch, step):
        if warmup_steps > 0 and step < warmup_steps:
            return base_lr * (step + 1) / warmup_steps
        t = min(max(step - warmup_steps, 0) / max(total_steps - warmup_steps, 1), 1.0)
        return final_lr + 0.5 * (base_lr - final_lr) * (1 + math.cos(math.pi * t))

    lr.base_lr = base_lr  # nominal (peak) lr, for rescale_regime_lr
    return lr


def polynomial_lr(base_lr: float, total_steps: int, power: float = 2.0,
                  final_lr: float = 0.0, warmup_steps: int = 0):
    """Polynomial decay with linear warmup — the canonical LARS
    large-batch schedule (You et al. 2017; MLPerf ResNet convention is
    power=2)."""

    def lr(epoch, step):
        if warmup_steps > 0 and step < warmup_steps:
            return base_lr * (step + 1) / warmup_steps
        t = min(max(step - warmup_steps, 0) / max(total_steps - warmup_steps, 1), 1.0)
        return final_lr + (base_lr - final_lr) * (1.0 - t) ** power

    lr.base_lr = base_lr  # nominal (peak) lr, for rescale_regime_lr
    return lr


def scaled_lr(lr: float, batch_size: int, base_batch: int = 256) -> float:
    """Goyal et al. linear scaling rule."""
    return lr * batch_size / base_batch
