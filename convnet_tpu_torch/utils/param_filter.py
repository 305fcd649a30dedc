"""The weight-decay mask over a model's named parameters (counterpart of
convnet_tpu/utils/param_filter.py:24-56).

The JAX package decays every leaf that is not a bias (``b``, ``bias``) or a
BatchNorm scale (``scale``): the weights of convs and linear layers. The
port's names differ (BN γ is ``weight``, a linear bias ``bias``), so the mask
is decided by module type: the ``weight`` of a ``Conv2d`` or a ``Linear``.
"""

from __future__ import annotations

from torch import nn

from convnet_tpu_torch.nn import Conv2d, Linear


def wd_mask(model: nn.Module) -> dict:
    """{parameter name: True where weight decay applies}, in
    ``named_parameters`` order."""
    decayed = {f"{name}.weight" if name else "weight"
               for name, mod in model.named_modules()
               if isinstance(mod, (Conv2d, Linear))}
    return {name: name in decayed for name, _ in model.named_parameters()}
