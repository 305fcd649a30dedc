"""BatchNorm folding for inference (counterpart of
convnet_tpu/utils/absorb_bn.py), on the port's modules.

Math: y = γ·(W*x + b − μ)/σ + β  ⇒  W' = W·γ/σ, shift = β + (b − μ)·γ/σ,
with σ = sqrt(var + eps) and b the conv's bias (0 without one, and zeroed
once folded). The conv weight takes γ/σ; the BN stays in the graph as a
pure ``x + shift``: mean 0, var 1 − eps (so 1/sqrt(var + eps) = 1), weight
1, bias = shift. Folding is idempotent.
"""

from __future__ import annotations

import torch
from torch import nn

from convnet_tpu_torch.nn import BatchNorm2d, Conv2d, Linear

_CONVLIKE = (Conv2d, Linear)


@torch.no_grad()
def absorb_bn_pair(conv: nn.Module, bn: BatchNorm2d):
    """Fold ``bn`` into the preceding ``conv`` in place."""
    inv_sigma = 1.0 / torch.sqrt(bn.running_var + bn.eps)
    factor = bn.weight.float() * inv_sigma
    b = conv.bias
    shift = bn.bias.float() + ((0.0 if b is None else b.float())
                               - bn.running_mean) * factor
    w = conv.weight
    # the output channel is axis 0 of an OIHW conv and of an (out, in) linear
    w.copy_((w.float() * factor.view(-1, *([1] * (w.dim() - 1)))).to(w.dtype))
    if b is not None:
        b.zero_()       # absorbed into the shift
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - bn.eps)
    bn.weight.fill_(1.0)
    bn.bias.copy_(shift)


def search_absorb_bn(model: nn.Module) -> nn.Module:
    """Fold every conv-like child into the first later BatchNorm sibling,
    unless another conv-like sibling comes between (the walk of the JAX
    package's ``search_absorb_bn``). Returns ``model``, changed in place."""
    for module in model.modules():
        kids = list(module.children())
        for i, kid in enumerate(kids):
            if not isinstance(kid, _CONVLIKE):
                continue
            for later in kids[i + 1:]:
                if isinstance(later, BatchNorm2d):
                    absorb_bn_pair(kid, later)
                    break
                if isinstance(later, _CONVLIKE):
                    break
    return model
