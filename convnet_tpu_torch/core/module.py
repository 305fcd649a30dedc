"""Module helpers (counterpart of convnet_tpu/core/module.py).

The JAX package builds models from plain objects and threads parameters,
state and a ``Context`` through every call. Here a model is a
``torch.nn.Module``: parameters and BatchNorm running statistics live in the
module, ``Context.train`` is ``Module.training`` (``model.eval()``), and
``Context.policy`` is applied where the input enters the model, since each
layer casts its parameters to the activations' dtype.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn


def Sequential(*layers, names=None) -> nn.Sequential:
    """``nn.Sequential`` with the JAX package's child names (``"0"``, ... by
    default), so state_dict keys follow its parameter tree."""
    if names is None:
        names = [str(i) for i in range(len(layers))]
    return nn.Sequential(OrderedDict(zip(names, layers)))


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator):
    """Re-draw every parameter from ``generator``, in definition order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
