"""Regime-driven SGD and RMSprop (counterpart of
convnet_tpu/regimes/optim.py:40-157, 342-418).

``OptimRegime`` resolves its regime on the host once per step and hands the
step a dict of float hyper-parameters; ``sgd_step`` and ``rmsprop_step``
apply them to the parameter tensors in place, with the JAX package's order
of operations:

    g  ← g + weight_decay · p                      (coupled L2, masked)
  SGD:
    mu ← momentum · mu + (1 − dampening) · g       (mu starts at 0)
    d  ← g + momentum · mu  if nesterov  else  mu
  RMSprop:
    v  ← alpha · v + (1 − alpha) · g²              (v starts at 0)
    mu ← momentum · mu + g / (√v + eps)
    d  ← mu
  both:
    p  ← p · (1 − lr · decoupled_weight_decay) − lr · d   (decay masked)

``torch.optim.SGD`` and ``RMSprop`` are not used: their weight decay is the
coupled kind only, SGD's momentum buffer starts at the first gradient, and
both order the operations differently. Only SGD, NesterovSGD and RMSprop
are ported; the other optimizers of the JAX package (Adam, AdamW, LARS,
LAMB), the regularizers of ``regimes/regularization.py`` and the flattened
update are listed in ROADMAP.md.
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


def _decayed(params, mask):
    return [i for i, m in enumerate(mask or [True] * len(params)) if m]


def _coupled(params, grads, hp, decayed):
    """The gradients with the coupled L2 added where ``decayed``."""
    grads = list(grads)
    if hp["weight_decay"]:
        coupled = torch._foreach_add([grads[i] for i in decayed],
                                     [params[i] for i in decayed],
                                     alpha=hp["weight_decay"])
        for i, g in zip(decayed, coupled):
            grads[i] = g
    return grads


def _apply(params, d, hp, decayed):
    """p ← p · (1 − lr · decoupled_weight_decay) − lr · d, decay masked."""
    decay = 1.0 - hp["lr"] * hp["decoupled_weight_decay"]
    if decay != 1.0:
        torch._foreach_mul_([params[i] for i in decayed], decay)
    torch._foreach_add_(list(params), d, alpha=-hp["lr"])


@torch.no_grad()
def sgd_step(params, grads, opt_state, hp, *, nesterov=False, mask=None):
    """One SGD step on the lists ``params`` and ``grads``, in place, with
    ``opt_state["mu"]`` the momentum buffers. ``mask``: one bool per
    parameter, True where weight decay applies (``utils.param_filter``);
    None decays every parameter."""
    decayed = _decayed(params, mask)
    grads = _coupled(params, grads, hp, decayed)
    mu = opt_state["mu"]
    torch._foreach_mul_(mu, hp["momentum"])
    torch._foreach_add_(mu, grads, alpha=1.0 - hp["dampening"])
    d = torch._foreach_add(grads, mu, alpha=hp["momentum"]) if nesterov else mu
    _apply(params, d, hp, decayed)
    opt_state["step"] += 1


@torch.no_grad()
def rmsprop_step(params, grads, opt_state, hp, *, mask=None):
    """One RMSprop step in place (``rmsprop_step`` of the JAX package):
    ``opt_state["v"]`` the squared-gradient averages, ``opt_state["mu"]``
    the momentum buffers; ``mask`` as for :func:`sgd_step`."""
    decayed = _decayed(params, mask)
    grads = _coupled(params, grads, hp, decayed)
    v = opt_state["v"]
    torch._foreach_mul_(v, hp["alpha"])
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1.0 - hp["alpha"])
    torch._foreach_add_(v, sq)
    denom = torch._foreach_sqrt(v)
    torch._foreach_add_(denom, hp["eps"])
    mu = opt_state["mu"]
    torch._foreach_mul_(mu, hp["momentum"])
    torch._foreach_add_(mu, torch._foreach_div(grads, denom))
    _apply(params, mu, hp, decayed)
    opt_state["step"] += 1


# optimizer name → (step function, its keyword arguments, state slots)
OPTIMIZERS = {
    "SGD": (sgd_step, {"nesterov": False}, ("mu",)),
    "NesterovSGD": (sgd_step, {"nesterov": True}, ("mu",)),
    "RMSprop": (rmsprop_step, {}, ("mu", "v")),
}


def _optimizer(name: str):
    if name not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (see ROADMAP.md); the "
            f"port has {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name]


def optimizer_step(name: str):
    """The step function of the optimizer called ``name``."""
    step, kwargs, _ = _optimizer(name)
    return functools.partial(step, **kwargs)


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
        """The state slots (zeros) of the regime's optimizer for the list
        ``params``: ``mu``, and ``v`` for RMSprop. Raises if the regime
        starts with an optimizer that is not ported."""
        _, _, slots = _optimizer(self.optimizer_name)
        return {"step": 0, **{slot: [torch.zeros_like(p) for p in params]
                              for slot in slots}}

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
