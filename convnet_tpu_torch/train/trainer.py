"""Trainer: the training step, the epoch loop and validation (counterpart of
convnet_tpu/train/trainer.py:58-440, 613-760).

The model is an ``nn.Module`` that holds its float32 parameters and BatchNorm
statistics. One step casts the batch to the compute dtype (each layer casts
its parameters at use, so there is no ``torch.autocast``, whose casting rules
differ from the JAX policy), runs the forward in training mode, scales the
cross-entropy by ``loss_scale``, lets autograd compute the gradients, unscales
them, clips them by their global norm and applies the regime's optimizer
step (SGD, NesterovSGD or RMSprop). Dropout draws its masks from one
``torch.Generator`` on the model's device, seeded from ``seed``.

``grad_clip`` and ``loss_scale`` come from the optimizer regime where it sets
them, else from ``TrainerConfig``. (The JAX trainer reads them from the
regime only, so its config fields have no effect there.)

Not ported yet (ROADMAP.md): mixup/cutmix, ``chunk_batch``, duplicates and
``adapt_grad_norm``, model EMA, ``calibrate_bn``, meshes, sync-BN, ZeRO and
the flattened optimizer update.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from convnet_tpu_torch.core.device import resolve_device
from convnet_tpu_torch.core.dtypes import get_policy
from convnet_tpu_torch.core.module import init_parameters
from convnet_tpu_torch.nn import Dropout
from convnet_tpu_torch.regimes.optim import (OptimRegime, clip_by_global_norm,
                                             optimizer_step)
from convnet_tpu_torch.train.losses import CrossEntropyLoss
from convnet_tpu_torch.train.meters import (AccuracyMeter, AverageMeter,
                                            correct_topk)
from convnet_tpu_torch.utils.param_filter import wd_mask

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainerConfig:
    dtype: str = "float32"          # dtype policy name: compute dtype
    label_smoothing: float = 0.0
    grad_clip: float = -1.0         # global-norm clip; <= 0 disables
    loss_scale: float = 1.0
    print_freq: int = 50


class Trainer:
    def __init__(self, model, optim_regime: OptimRegime, num_classes: int,
                 config: Optional[TrainerConfig] = None, device=None,
                 seed: int = 0):
        """``device``: where the model trains; ``None`` is the CUDA card.
        ``seed`` seeds the weights :meth:`initialize` draws and the
        generator of the model's ``Dropout`` layers."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_generator
        self.optim = optim_regime
        self.num_classes = num_classes
        self.cfg = config or TrainerConfig()
        self.policy = get_policy(self.cfg.dtype)
        self.seed = seed
        self.criterion = CrossEntropyLoss(smooth_eps=self.cfg.label_smoothing)
        self.epoch = 0
        self.training_steps = 0
        self.opt_state = None

    def initialize(self, state_dict=None):
        """Draws the model's weights from ``seed``, or loads
        ``state_dict`` (for instance ``utils.from_jax.from_jax_params``);
        makes the weight-decay mask and the optimizer state."""
        if state_dict is None:
            init_parameters(self.model,
                            torch.Generator().manual_seed(self.seed))
        else:
            self.model.load_state_dict(state_dict)
        named = list(self.model.named_parameters())
        mask = wd_mask(self.model)
        self._params = [p for _, p in named]
        self._mask = [mask[name] for name, _ in named]
        self.opt_state = self.optim.init_state(self._params)
        return self.opt_state

    def hyperparams(self):
        hp = self.optim.hyperparams()
        for key in ("grad_clip", "loss_scale"):
            if key not in self.optim.regime.setting:
                hp[key] = float(getattr(self.cfg, key))
        return hp

    def _to_device(self, x, y):
        x = torch.as_tensor(x).to(self.device, non_blocking=True)
        y = torch.as_tensor(y).to(self.device, non_blocking=True)
        return self.policy.cast_to_compute(x), y

    def train_step(self, x, y):
        """One step on the batch (x (B, H, W, C), y (B,) class labels) at the
        regime's current setting. Returns device scalars ``loss``,
        ``correct1``, ``correct5`` and ``grad_norm``."""
        hp = self.hyperparams()
        step = optimizer_step(self.optim.optimizer_name)
        x, y = self._to_device(x, y)
        self.model.train()
        for p in self._params:
            p.grad = None
        logits = self.model(x)
        loss = self.criterion(logits, y)
        (loss * hp["loss_scale"]).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        torch._foreach_div_(grads, hp["loss_scale"])
        grad_norm = clip_by_global_norm(grads, hp["grad_clip"])
        step(self._params, grads, self.opt_state, hp, mask=self._mask)
        self.training_steps += 1
        c1, c5 = correct_topk(logits.detach(), y, (1, 5))
        return {"loss": loss.detach(), "correct1": c1, "correct5": c5,
                "grad_norm": grad_norm}

    def train_epoch(self, loader, epoch: int,
                    steps_per_epoch: Optional[int] = None):
        """One epoch over ``loader``, any iterable of (x, y) batches.
        Returns the epoch's loss, top-1/top-5 accuracy (%), mean gradient
        norm, step times (host clock) and images per second."""
        self.epoch = epoch
        meters = {k: AverageMeter() for k in ("loss", "grad_norm",
                                              "step_time")}
        acc = AccuracyMeter()
        step_times = []
        spe = steps_per_epoch or getattr(loader, "__len__", lambda: None)()
        # metrics are read two steps late, so the host never waits for the
        # step it has just queued
        pending = collections.deque()

        def drain():
            m, n, st = pending.popleft()
            meters["loss"].update(float(m["loss"]), n)
            meters["grad_norm"].update(float(m["grad_norm"]))
            meters["step_time"].update(st)
            step_times.append(st)
            acc.update((float(m["correct1"]), float(m["correct5"])), n)

        samples = 0
        t_epoch = time.perf_counter()
        for i, (x, y) in enumerate(loader):
            t_step = time.perf_counter()
            if self.optim.update(epoch + (i / spe if spe else 0),
                                 self.training_steps):
                log.info("optimizer switched to %s",
                         self.optim.optimizer_name)
            metrics = self.train_step(x, y)
            samples += len(x)
            pending.append((metrics, len(x), time.perf_counter() - t_step))
            while len(pending) > 2:
                drain()
            if self.cfg.print_freq and i % self.cfg.print_freq == 0:
                log.info("epoch %d step %d/%s loss %.4f prec1 %.2f prec5 "
                         "%.2f lr %.4g", epoch, i, spe or "?",
                         meters["loss"].avg, acc.value(1), acc.value(5),
                         self.hyperparams()["lr"])
        while pending:
            drain()
        epoch_time = time.perf_counter() - t_epoch
        return {"loss": meters["loss"].avg, "prec1": acc.value(1),
                "prec5": acc.value(5), "grad_norm": meters["grad_norm"].avg,
                "step_time": meters["step_time"].avg,
                # p50 past the first step, which pays the start-up
                "step_time_p50": float(np.median(step_times[1:] or step_times
                                                 or [0.0])),
                "epoch_time": epoch_time,
                "img_per_sec": samples / max(epoch_time, 1e-9)}

    @torch.no_grad()
    def validate(self, loader):
        """Loss and top-1/top-5 accuracy (%) over ``loader`` in eval mode.
        Labels of -100 mark padding rows, which count nowhere."""
        criterion = CrossEntropyLoss(reduction="sum")
        loss_m = AverageMeter()
        acc = AccuracyMeter()
        pending = collections.deque()

        def drain():
            m = pending.popleft()
            n = int(float(m["count"]))
            loss_m.update(float(m["loss"]), n)
            acc.update((float(m["correct1"]), float(m["correct5"])), n)

        self.model.eval()
        try:
            for x, y in loader:
                x, y = self._to_device(x, y)
                logits = self.model(x)
                c1, c5 = correct_topk(logits, y, (1, 5))
                count = (y >= 0).float().sum()
                loss = criterion(logits, y) / torch.clamp_min(count, 1.0)
                pending.append({"loss": loss, "correct1": c1,
                                "correct5": c5, "count": count})
                while len(pending) > 2:
                    drain()
            while pending:
                drain()
        finally:
            self.model.train()
        return {"loss": loss_m.avg, "prec1": acc.value(1),
                "prec5": acc.value(5)}
