"""Regime-driven optimizers (counterpart of
convnet_tpu/regimes/optim.py:40-244, 342-418).

``OptimRegime`` resolves its regime on the host once per step and hands the
step a dict of float hyper-parameters; each step function applies them to
the parameter tensors in place, with the JAX package's order of operations:

    g  ← g + weight_decay · p                      (coupled L2, masked)
  SGD:
    mu ← momentum · mu + (1 − dampening) · g       (mu starts at 0)
    d  ← g + momentum · mu  if nesterov  else  mu
  RMSprop:
    v  ← alpha · v + (1 − alpha) · g²              (v starts at 0)
    mu ← momentum · mu + g / (√v + eps)
    d  ← mu
  Adam, AdamW (t the step count from 1):
    m  ← β1 · m + (1 − β1) · g,  v ← β2 · v + (1 − β2) · g²
    d  ← (m / (1 − β1^t)) / (√(v / (1 − β2^t)) + eps)
  all three:
    p  ← p · (1 − lr · wd) − lr · d                (decay masked)

where ``wd`` is ``decoupled_weight_decay``, plus ``weight_decay`` for AdamW:
the JAX package's AdamW adds ``weight_decay`` to the gradient (coupled) and
again to the decoupled decay, so it decays twice; the port keeps that
(ROADMAP.md §3). LARS and LAMB scale each tensor's step by a trust ratio of
norms in float32 (:func:`lars_step`, :func:`lamb_step`).

``torch.optim`` is not used: its weight decay is the coupled kind only, SGD's
momentum buffer starts at the first gradient, and its optimizers order the
operations differently. The flattened update of the JAX package
(``--flat-optim``) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from convnet_tpu_torch.regimes.regime import Regime
from convnet_tpu_torch.regimes.regularization import init_norms, spec_kind

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


def _f32(x) -> float:
    """``x`` rounded to float32, as the JAX package's hyper-parameters are
    (they enter its step as float32 device scalars)."""
    return float(np.float32(x))


def _bias_corrections(hp, step):
    """1 − β1^t and 1 − β2^t from the float32 βs."""
    return 1.0 - _f32(hp["beta1"]) ** step, 1.0 - _f32(hp["beta2"]) ** step


def _moments(m, v, grads, hp):
    """m ← β1 · m + (1 − β1) · g and v ← β2 · v + (1 − β2) · g², in place."""
    torch._foreach_mul_(m, hp["beta1"])
    torch._foreach_add_(m, grads, alpha=1.0 - hp["beta1"])
    torch._foreach_mul_(v, hp["beta2"])
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - hp["beta2"])


def _adam_direction(m, v, c1, c2, eps):
    """(m / c1) / (√(v / c2) + eps)."""
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    d = torch._foreach_div(m, c1)
    torch._foreach_div_(d, denom)
    return d


@torch.no_grad()
def adam_step(params, grads, opt_state, hp, *, adamw=False, mask=None):
    """One Adam step in place (``adam_step`` of the JAX package), with
    ``opt_state["m"]`` and ``["v"]`` the moments. ``adamw`` folds
    ``weight_decay`` into the decoupled decay as well (the JAX package's
    AdamW, which also keeps it coupled); ``mask`` as for :func:`sgd_step`."""
    decayed = _decayed(params, mask)
    grads = _coupled(params, grads, hp, decayed)
    step = opt_state["step"] + 1
    _moments(opt_state["m"], opt_state["v"], grads, hp)
    d = _adam_direction(opt_state["m"], opt_state["v"],
                        *_bias_corrections(hp, step), hp["eps"])
    wd = hp["decoupled_weight_decay"] + (hp["weight_decay"] if adamw else 0.0)
    _apply(params, d, {**hp, "decoupled_weight_decay": wd}, decayed)
    opt_state["step"] = step


def _scales(ratios, mask, lr):
    """lr · ratio for each tensor ``mask`` selects and lr for the others, as
    0-d tensors on the ratios' device (no host-to-device copy)."""
    lr_alone = ratios.new_full((), lr)
    return [r if m else lr_alone
            for r, m in zip(torch.unbind(ratios * lr), mask)]


@torch.no_grad()
def lars_step(params, grads, opt_state, hp, *, mask=None):
    """One LARS step in place (``lars_step`` of the JAX package; You et al.
    2017), with ``opt_state["mu"]`` the momentum buffers. For each decayed
    tensor, in float32: trust = trust_coef·‖w‖ / (‖g‖ + wd·‖w‖ + 1e-9)
    (1 where either norm is 0), g ← g + wd·w, and the momentum takes the
    scaled gradient: mu ← momentum·mu + lr·trust·g, w ← w − mu. Tensors
    that ``mask`` leaves out get no decay and no trust (plain momentum
    SGD)."""
    mask = list(mask) if mask is not None else [True] * len(params)
    lr, eta, wd = hp["lr"], hp["trust_coef"], hp["weight_decay"]
    p32 = [p.float() for p in params]
    g32 = [g.float() for g in grads]
    w_norm = torch.stack(torch._foreach_norm(p32))
    g_norm = torch.stack(torch._foreach_norm(g32))
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wd * w_norm + 1e-9), 1.0)
    g32 = _coupled(p32, g32, hp, _decayed(params, mask))
    mu = opt_state["mu"]
    torch._foreach_mul_(mu, hp["momentum"])
    torch._foreach_addcmul_(mu, g32, _scales(trust, mask, lr))
    torch._foreach_sub_(list(params), mu)
    opt_state["step"] += 1


@torch.no_grad()
def lamb_step(params, grads, opt_state, hp, *, mask=None):
    """One LAMB step in place (``lamb_step`` of the JAX package; You et al.
    2019): Adam's bias-corrected moments in ``opt_state["m"]`` and ``["v"]``,
    u = m̂ / (√v̂ + eps) + wd·w on decayed tensors, and w ← w − lr·r·u with
    r = ‖w‖ / (‖u‖ + 1e-9) on decayed tensors whose norms are both positive,
    1 elsewhere."""
    mask = list(mask) if mask is not None else [True] * len(params)
    step = opt_state["step"] + 1
    p32 = [p.float() for p in params]
    g32 = [g.float() for g in grads]
    _moments(opt_state["m"], opt_state["v"], g32, hp)
    u = _adam_direction(opt_state["m"], opt_state["v"],
                        *_bias_corrections(hp, step), hp["eps"])
    u = _coupled(p32, u, hp, _decayed(params, mask))
    w_norm = torch.stack(torch._foreach_norm(p32))
    u_norm = torch.stack(torch._foreach_norm(u))
    ratio = torch.where((w_norm > 0) & (u_norm > 0),
                        w_norm / (u_norm + 1e-9), 1.0)
    torch._foreach_mul_(u, _scales(ratio, mask, hp["lr"]))
    torch._foreach_sub_(list(params), u)
    opt_state["step"] = step


# optimizer name → (step function, its keyword arguments, state slots)
OPTIMIZERS = {
    "SGD": (sgd_step, {"nesterov": False}, ("mu",)),
    "NesterovSGD": (sgd_step, {"nesterov": True}, ("mu",)),
    "Adam": (adam_step, {"adamw": False}, ("m", "v")),
    "AdamW": (adam_step, {"adamw": True}, ("m", "v")),
    "RMSprop": (rmsprop_step, {}, ("mu", "v")),
    "LARS": (lars_step, {}, ("mu",)),
    "LAMB": (lamb_step, {}, ("m", "v")),
}


def _optimizer(name: str):
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; the port has "
                         f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name]


def optimizer_step(name: str):
    """The step function of the optimizer called ``name``."""
    step, kwargs, _ = _optimizer(name)
    return functools.partial(step, **kwargs)


def optimizer_slots(name: str):
    """The state slots the optimizer called ``name`` reads."""
    return _optimizer(name)[2]


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

    @property
    def needed_slots(self):
        """The state slots of every optimizer the regime names, or
        ``{"mu"}`` where it names none. Raises for an unknown name."""
        names = {str(e["optimizer"]) for e in self.regime.regime
                 if e.get("optimizer")}
        names.add(self.optimizer_name)
        slots = set()
        for name in names:
            slots.update(optimizer_slots(name))
        return slots or {"mu"}

    @property
    def uses_bounded_norm(self) -> bool:
        return any(spec_kind(e.get("regularizer")) == "BoundedWeightNorm"
                   for e in self.regime.regime)

    def init_state(self, params, mask=None):
        """The optimizer state for the list ``params``: ``step``, and one
        zeroed slot per name over the whole regime (``mu``; ``m`` and ``v``
        together where either is needed), so a switch of optimizer finds its
        slots; under a BoundedWeightNorm regime also the initial ``norms``
        of the tensors ``mask`` selects (one bool per tensor, None: all)."""
        slots = self.needed_slots
        names = (["mu"] if "mu" in slots else []) + (
            ["m", "v"] if slots & {"m", "v"} else [])
        state = {"step": 0, **{name: [torch.zeros_like(p) for p in params]
                               for name in names}}
        if self.uses_bounded_norm:
            state["norms"] = init_norms(params, mask)
        return state

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
            hp["bounded_norm"] = 1.0
        return hp

    def state_dict(self):
        return {"epoch": self.regime.epoch, "steps": self.regime.steps}

    def load_state_dict(self, sd):
        """A regime's setting is a function of (epoch, step): updating to
        the saved ones restores it."""
        self.regime.update(sd.get("epoch", 0), sd.get("steps", 0))
