"""Regularizers driven by regime specs (counterpart of
convnet_tpu/regimes/regularization.py).

``WeightDecay`` (decoupled) and ``L2Regularization`` (coupled) are scalar
hyper-parameters that ``OptimRegime.hyperparams`` hands the optimizer step
(``decoupled_weight_decay``, ``weight_decay``). ``BoundedWeightNorm`` (the
"Norm matters" variant) is structural: after each step every decayed weight
tensor is rescaled to the norm it had at initialisation. Its norms live in
the optimizer state under ``norms``.

Specs have the reference's shape: ``{'name': 'BoundedWeightNorm', ...}``
under a regime entry's ``'regularizer'`` key.
"""

from __future__ import annotations

from typing import Optional

import torch


def _selected(params, mask):
    return list(mask) if mask is not None else [True] * len(params)


def init_norms(params, mask=None):
    """The float32 norm of each tensor of ``params`` that ``mask`` (one bool
    per tensor; None: all) selects, 0 for the others."""
    return [torch.linalg.vector_norm(p.detach().float()) if m
            else torch.zeros((), device=p.device)
            for p, m in zip(params, _selected(params, mask))]


@torch.no_grad()
def bounded_weight_norm(params, norms, mask=None):
    """Rescales each selected tensor of ``params`` in place back to its norm
    in ``norms`` (a zero tensor is left as it is)."""
    chosen = [i for i, m in enumerate(_selected(params, mask)) if m]
    if not chosen:
        return
    ps = [params[i] for i in chosen]
    cur = torch.stack(torch._foreach_norm([p.float() for p in ps]))
    target = torch.stack([norms[i] for i in chosen])
    scale = torch.where(cur > 0, target / torch.clamp_min(cur, 1e-12), 1.0)
    for p, s in zip(ps, torch.unbind(scale)):
        p.copy_((p.float() * s).to(p.dtype))


def spec_kind(spec) -> Optional[str]:
    """The name of a regime's ``'regularizer'`` spec, or None."""
    if isinstance(spec, dict):
        return spec.get("name")
    return None
