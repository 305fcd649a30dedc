"""Regime-driven SGD (counterpart of convnet_tpu/regimes/optim.py:40-120,
342-418).

``OptimRegime`` resolves its regime on the host once per step and hands the
step a dict of float hyper-parameters; ``sgd_step`` applies them to the
parameter tensors in place, with the JAX package's order of operations:

    g  ← g + weight_decay · p                      (coupled L2, masked)
    mu ← momentum · mu + (1 − dampening) · g       (mu starts at 0)
    d  ← g + momentum · mu  if nesterov  else  mu
    p  ← p · (1 − lr · decoupled_weight_decay) − lr · d   (decay masked)

``torch.optim.SGD`` is not used: its weight decay is the coupled kind only,
its momentum buffer starts at the first gradient, and it orders the
operations differently. Only SGD and NesterovSGD are ported; the other
optimizers of the JAX package (Adam, AdamW, RMSprop, LARS, LAMB), the
regularizers of ``regimes/regularization.py`` and the flattened update are
listed in ROADMAP.md.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from convnet_tpu_torch.regimes.regime import Regime

# hyper-parameter defaults of every step; regime settings override them
HP_DEFAULTS: Dict[str, float] = {
    "lr": 0.1,
    "momentum": 0.0,
    "dampening": 0.0,
    "weight_decay": 0.0,        # coupled L2 (torch SGD-style), masked
    "decoupled_weight_decay": 0.0,  # decoupled (regularizer path), masked
    "beta1": 0.9,
    "beta2": 0.999,
    "eps": 1e-8,
    "alpha": 0.99,              # RMSprop smoothing
    "grad_clip": -1.0,          # global-norm clip; <0 disables
    "loss_scale": 1.0,
    "bounded_norm": 0.0,        # >0 → BoundedWeightNorm active
    "trust_coef": 0.001,        # LARS eta / LAMB has no coef (ratio direct)
}

# optimizer name → keyword arguments of sgd_step
OPTIMIZERS = {"SGD": {"nesterov": False}, "NesterovSGD": {"nesterov": True}}


def global_norm(tensors):
    """sqrt(Σ ||t||²) over a list of tensors, in float32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place so that their global norm is at most
    ``max_norm`` (when ``max_norm`` > 0). Returns the norm before
    clipping."""
    norm = global_norm(grads)
    if max_norm > 0:
        scale = torch.where(norm > max_norm,
                            max_norm / torch.clamp_min(norm, 1e-12), 1.0)
        torch._foreach_mul_(grads, scale)
    return norm


@torch.no_grad()
def sgd_step(params, grads, opt_state, hp, *, nesterov=False, mask=None):
    """One SGD step on the lists ``params`` and ``grads``, in place, with
    ``opt_state["mu"]`` the momentum buffers. ``mask``: one bool per
    parameter, True where weight decay applies (``utils.param_filter``);
    None decays every parameter."""
    decayed = [i for i, m in enumerate(mask or [True] * len(params)) if m]
    grads = list(grads)
    if hp["weight_decay"]:
        coupled = torch._foreach_add([grads[i] for i in decayed],
                                     [params[i] for i in decayed],
                                     alpha=hp["weight_decay"])
        for i, g in zip(decayed, coupled):
            grads[i] = g
    mu = opt_state["mu"]
    torch._foreach_mul_(mu, hp["momentum"])
    torch._foreach_add_(mu, grads, alpha=1.0 - hp["dampening"])
    d = torch._foreach_add(grads, mu, alpha=hp["momentum"]) if nesterov else mu
    decay = 1.0 - hp["lr"] * hp["decoupled_weight_decay"]
    if decay != 1.0:
        torch._foreach_mul_([params[i] for i in decayed], decay)
    torch._foreach_add_(list(params), d, alpha=-hp["lr"])
    opt_state["step"] += 1


def optimizer_step(name: str):
    """The step function of the optimizer called ``name``."""
    if name not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (see ROADMAP.md); the "
            f"port has {sorted(OPTIMIZERS)}")
    return functools.partial(sgd_step, **OPTIMIZERS[name])


class OptimRegime:
    """Regime-driven optimizer configuration.

    ``update(epoch, train_steps)`` resolves the regime; ``hyperparams()``
    returns the dense hyper-parameter dict of the step; ``optimizer_name``
    is the optimizer the regime has reached.
    """

    def __init__(self, regime, defaults: Optional[Dict[str, Any]] = None):
        if isinstance(regime, Regime):
            self.regime = regime
        else:
            self.regime = Regime(regime, defaults={"optimizer": "SGD",
                                                   **(defaults or {})})
        self.regime.update(0, 0)

    @property
    def optimizer_name(self) -> str:
        return str(self.regime.setting.get("optimizer", "SGD"))

    def init_state(self, params):
        """Momentum buffers (zeros) for the list ``params``; raises if the
        regime starts with an optimizer that is not ported."""
        optimizer_step(self.optimizer_name)
        return {"step": 0, "mu": [torch.zeros_like(p) for p in params]}

    def update(self, epoch: float, train_steps: int) -> bool:
        """Returns True when the optimizer changes."""
        before = self.optimizer_name
        self.regime.update(epoch, train_steps)
        return self.optimizer_name != before

    def hyperparams(self) -> Dict[str, float]:
        setting = self.regime.resolved()
        hp = dict(HP_DEFAULTS)
        for k in hp:
            if k in setting:
                hp[k] = float(setting[k])
        # reference spelling: regularizer spec {'name': 'WeightDecay', 'value': v}
        reg = setting.get("regularizer")
        if isinstance(reg, dict) and reg.get("name") == "WeightDecay":
            hp["decoupled_weight_decay"] = float(reg.get("value", 0.0))
        elif isinstance(reg, dict) and reg.get("name") == "L2Regularization":
            hp["weight_decay"] = float(reg.get("value", 0.0))
        elif isinstance(reg, dict) and reg.get("name") == "BoundedWeightNorm":
            raise NotImplementedError("the BoundedWeightNorm regularizer is "
                                      "not ported yet (see ROADMAP.md)")
        return hp
