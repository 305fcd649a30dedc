"""Regime engine, time-indexed declarative configuration: a copy of
convnet_tpu/regimes/regime.py (pure Python), so the port never imports the
JAX package. A CPU test holds the two copies equal.

A *regime* is a list of dicts, each with an ``'epoch'`` and/or ``'step'``
trigger plus settings. As training time advances, every entry whose trigger
time has been reached is merged (in order) into the active setting. Setting
values may be callables ``f(epoch, step) -> value``, evaluated at resolution
time. The optimizer's hyper-parameters (``OptimRegime``) and the models'
own schedules (``model.regime``) are regimes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def eval_setting(setting: Dict[str, Any], epoch: float, step: int) -> Dict[str, Any]:
    """Evaluate callable entries of a resolved setting dict."""
    out = {}
    for k, v in setting.items():
        out[k] = v(epoch, step) if callable(v) else v
    return out


class Regime:
    """Interprets a list of ``{'epoch': e, 'step': s, **settings}`` dicts.

    ``update(epoch, train_steps)`` returns True when the active setting
    changed. ``setting`` holds the merged raw setting; use
    ``eval_setting`` (or ``resolved``) for callable evaluation.
    """

    def __init__(self, regime: Optional[List[Dict[str, Any]]], defaults: Optional[Dict[str, Any]] = None):
        self.regime = list(regime) if regime else []
        self.defaults = dict(defaults or {})
        self.setting: Dict[str, Any] = dict(self.defaults)
        self.current_regime_phase: Optional[int] = None
        self.epoch = 0.0
        self.steps = 0

    def update(self, epoch: Optional[float] = None, train_steps: Optional[int] = None) -> bool:
        """Advance time; re-merge entries; True if the setting changed."""
        if epoch is not None:
            self.epoch = epoch
        if train_steps is not None:
            self.steps = train_steps
        if not self.regime:
            return False

        new_setting = dict(self.defaults)
        phase = None
        for i, entry in enumerate(self.regime):
            e = entry.get("epoch")
            s = entry.get("step")
            triggered = True
            if e is not None and self.epoch < e:
                triggered = False
            if s is not None and self.steps < s:
                triggered = False
            if e is None and s is None:
                triggered = True  # unconditional entry (base settings)
            if triggered:
                phase = i
                new_setting.update(
                    {k: v for k, v in entry.items() if k not in ("epoch", "step")})

        changed = (new_setting != self.setting) or (phase != self.current_regime_phase)
        if changed:
            self.setting = new_setting
            self.current_regime_phase = phase
        return changed

    def resolved(self) -> Dict[str, Any]:
        return eval_setting(self.setting, self.epoch, self.steps)

    def get(self, key, default=None):
        value = self.setting.get(key, default)
        return value(self.epoch, self.steps) if callable(value) else value

    def __repr__(self):
        return f"Regime(phases={len(self.regime)}, setting={self.setting})"


def _nominal_lr(base) -> float:
    """Nominal lr of a regime entry's ``lr`` value.

    Scalars are their own nominal. For callables, prefer the
    ``.base_lr`` attribute the ``schedules.py`` factories attach (the
    advertised peak lr of warmup/decay schedules). A foreign callable
    without it is probed: max over an epoch × log-step grid — for any
    ramp-then-decay shape the grid lands within a few percent of the
    peak, which is the value a user means by "the schedule's lr".
    """
    if not callable(base):
        return float(base)
    attr = getattr(base, "base_lr", None)
    if attr is not None:
        return float(attr)
    steps = [0] + [int(10 ** (k / 4)) for k in range(0, 29)]  # 1 .. 1e7
    epochs = [0.0, 0.5, 1, 2, 5, 10, 20, 30, 45, 60, 80, 90, 120, 200]
    return max(float(base(e, s)) for e in epochs for s in steps)


def rescale_regime_lr(regime: List[Dict[str, Any]],
                      target_base_lr: float) -> List[Dict[str, Any]]:
    """Multiplicatively rescale EVERY lr in a regime so the base
    (first-phase, epoch-0/step-0) lr becomes ``target_base_lr``.

    This is the CLI ``--lr`` semantics: the embedded schedule's decay
    structure (step drops, warmup ramps, cosine lambdas) is preserved
    and the whole curve is scaled — a ``--lr 0.05`` does NOT silently
    revert to the model's schedule at the first phase boundary.
    Callable lr entries (``f(epoch, step)``) are wrapped; the base is
    the first phase's NOMINAL lr — the factory-attached ``.base_lr``
    (all ``schedules.py`` factories set it), falling back to the
    callable's maximum over a probe grid. Never ``f(0, 0)``: for a
    warmup schedule that is the tiny first micro-step, and dividing by
    it would blow the whole schedule up by ~warmup_steps.
    """
    base = None
    for entry in regime:
        if "lr" in entry:
            base = entry["lr"]
            break
    if base is None:  # no lr anywhere → inject flat
        return [{**regime[0], "lr": target_base_lr}] + list(regime[1:])
    base_val = float(_nominal_lr(base))
    if base_val == 0.0:
        raise ValueError("cannot rescale a regime whose base lr is 0; "
                         "pass the schedule explicitly instead of --lr")
    factor = float(target_base_lr) / base_val
    out = []
    for entry in regime:
        if "lr" in entry:
            v = entry["lr"]
            if callable(v):
                scaled = lambda e, s, _f=v: _f(e, s) * factor  # noqa: E731
                scaled.base_lr = _nominal_lr(v) * factor
            else:
                scaled = v * factor
            entry = {**entry, "lr": scaled}
        out.append(entry)
    return out


def replace_regime_key(regime: List[Dict[str, Any]], key: str,
                       value: Any) -> List[Dict[str, Any]]:
    """Set ``key`` flat across the whole regime: injected into the
    first phase and stripped from every later one, so the override
    never reverts at a phase boundary (CLI ``--momentum`` /
    ``--optimizer`` / ``--weight-decay`` semantics)."""
    if not regime:
        return [{"epoch": 0, key: value}]
    out = [{**regime[0], key: value}]
    for entry in regime[1:]:
        out.append({k: v for k, v in entry.items() if k != key})
    return out
