"""Activations (forward only; counterpart of convnet_tpu/ops/activation.py)."""

from __future__ import annotations

import torch


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)
