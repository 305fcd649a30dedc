"""Squeeze-and-Excitation blocks on NHWC activations (counterpart of
convnet_tpu/nn/se.py:20-81).

Global average over (H, W) → ``fc1`` → ReLU (or swish) → ``fc2`` → sigmoid
gate → x · gate. The types follow the JAX package's: the squeeze is a
float32 mean cast back to x's dtype, the two FCs run in x's dtype (their
biases added in float32, as ``ops.linear`` does), and the sigmoid is taken
in float32 and cast to x's dtype before the multiply.

The JAX package's spatially sharded squeeze and gate (``pmean_paired``,
``_gate``) belong to ``parallel/spatial.py`` and are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from convnet_tpu_torch import ops
from convnet_tpu_torch.nn.layers import Linear


class SEBlock(nn.Module):
    """SE with a ReLU between the FCs; ``hidden = max(channels //
    reduction, 1)``."""

    def __init__(self, channels, reduction=16):
        super().__init__()
        self.channels = channels
        hidden = max(channels // reduction, 1)
        self.fc1 = Linear(channels, hidden)
        self.fc2 = Linear(hidden, channels)

    def _act(self, s):
        return ops.relu(s)

    def forward(self, x):
        s = x.float().mean(dim=(1, 2)).to(x.dtype)
        s = self.fc2(self._act(self.fc1(s)))
        gate = torch.sigmoid(s.float()).to(x.dtype)
        return x * gate[:, None, None, :]


class SESwishBlock(SEBlock):
    """SE with swish (x · sigmoid(x), in x's dtype) between the FCs."""

    def _act(self, s):
        return s * torch.sigmoid(s)
