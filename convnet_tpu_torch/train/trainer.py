"""Trainer: the training step, the epoch loop, validation and BN calibration
(counterpart of convnet_tpu/train/trainer.py:58-440, 613-826).

The model is an ``nn.Module`` that holds its float32 parameters and BatchNorm
statistics. One step casts the batch to the compute dtype (each layer casts
its parameters at use, so there is no ``torch.autocast``, whose casting rules
differ from the JAX policy), mixes it (mixup or cutmix, on the whole batch,
λ drawn on the host), runs the forward in training mode one micro-batch at a
time (``chunk_batch``: each chunk's scaled loss is back-propagated before the
next chunk's forward, so one chunk's activations are alive at a time and the
gradients add up in ``.grad``), unscales the gradients, rescales them to a
single duplicate's norm (``duplicates`` with ``adapt_grad_norm``), clips them
by their global norm, applies the regime's optimizer step, renormalises the
weights under a BoundedWeightNorm regime and updates the weights' EMA
(``model_ema``). Dropout draws its masks from one ``torch.Generator`` on the
model's device, seeded from ``seed``.

A model with auxiliary classifiers (GoogLeNet, Inception v3 built with
``aux_classifiers=True``) takes a collector, ``model(x, aux=[])``; every loss
a step computes (each chunk's, with mixed targets too, and the gradient-norm
scale's extra pass) adds ``weight · criterion(aux_logits, y)`` for each head
to the main logits' loss, as the JAX package's ``_loss_fn`` does. The
metrics use the main logits; ``validate`` and ``calibrate_bn`` run no head,
and ``calibrate_bn`` leaves the heads' BatchNorm statistics as they are.

``grad_clip`` and ``loss_scale`` come from the optimizer regime where it sets
them, else from ``TrainerConfig``. (The JAX trainer reads them from the
regime only, so its config fields have no effect there.)

A run saves and resumes through ``checkpoint_dict`` and ``load_checkpoint``
(the npz archive of ``utils/checkpoint.py``, readable by the JAX package);
``train_epoch(start_batch=, step_hook=)`` resumes inside an epoch, and
``set_watcher`` streams one JSON line a step.

Data parallelism (``mesh=``, a ``parallel.make_mesh``): one process a card,
each rank passing its own part of the batch to every call, the rest as the
JAX package's step on a ``'data'`` mesh does it, in its order. The model is
wrapped in ``DistributedDataParallel`` (``broadcast_buffers=False``, so each
rank keeps its BN statistics; a comm hook that sums the gradients and then
divides by the world, in ``allreduce_dtype`` where set: the rounding of
``lax.pmean`` on the cast gradients); chunks but the last run under
``no_sync``. After the backward the BN running statistics are averaged over
the ranks and the loss too, the correct counts summed (one all-reduce);
``adapt_grad_norm``'s sub-gradient, which DDP does not see, is averaged by
hand. ``sync_bn`` sets the mesh's group on every BatchNorm
(``parallel.set_bn_group``: cross-replica moments, in the fused MobileNet-V2
blocks too); without it each rank normalises with its own batch (ghost BN).
The gradients are averaged before they are divided by the chunks and the
loss scale (the JAX step divides first: the same for powers of two).
``shard_opt_state`` (ZeRO-1, ``parallel/zero.py``) runs the bare model and
reduce-scatters the gradients instead; it raises with ``adapt_grad_norm``,
``model_ema`` and BoundedWeightNorm, and turns itself off without a mesh, as
in the JAX package. Parameters and BN statistics are broadcast from rank 0
at :meth:`initialize`. Rank r > 0 seeds its dropout generator and its mixup
sampler from (seed, r), as the JAX step folds the replica's index into its
key; rank 0 keeps ``seed``. ``validate`` and ``calibrate_bn`` sum and
average over the ranks; ``checkpoint_dict`` is then a collective (every
rank calls it; rank 0 writes).

Not ported yet (ROADMAP.md): spatial partitioning and the flattened
optimizer update.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import inspect
import json
import logging
import time
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from convnet_tpu_torch.core.device import resolve_device
from convnet_tpu_torch.core.dtypes import get_policy
from convnet_tpu_torch.core.module import init_parameters
from convnet_tpu_torch.nn import BatchNorm2d, Dropout
from convnet_tpu_torch.parallel import zero
from convnet_tpu_torch.parallel.mesh import (DATA_AXIS, all_mean_, replicate,
                                             restore_bn_groups, set_bn_group)
from convnet_tpu_torch.regimes.optim import (OptimRegime, clip_by_global_norm,
                                             global_norm, optimizer_slots,
                                             optimizer_step)
from convnet_tpu_torch.regimes.regularization import bounded_weight_norm
from convnet_tpu_torch.train.losses import CrossEntropyLoss
from convnet_tpu_torch.train.meters import (AccuracyMeter, AverageMeter,
                                            correct_topk)
from convnet_tpu_torch.train.mixup import CutMix, MixUp
from convnet_tpu_torch.utils.checkpoint import (adapt_opt_state,
                                                slots_to_tree, tree_to_slots)
from convnet_tpu_torch.utils.from_jax import from_jax_params, to_jax_params
from convnet_tpu_torch.utils.param_filter import wd_mask

log = logging.getLogger(__name__)


def slot_is_flat(v):
    """A ZeRO-1 slot: one 1-D tensor (a rank's slice)."""
    return isinstance(v, torch.Tensor) and v.dim() == 1


@dataclasses.dataclass
class TrainerConfig:
    dtype: str = "float32"          # dtype policy name: compute dtype
    label_smoothing: float = 0.0
    grad_clip: float = -1.0         # global-norm clip; <= 0 disables
    loss_scale: float = 1.0
    print_freq: int = 50
    mixup_alpha: float = 0.0        # > 0: mixup with λ ~ Beta(α, α)
    cutmix_alpha: float = 0.0       # > 0 (and no mixup): cutmix
    chunk_batch: int = 1            # micro-batches a step (gradients add up)
    duplicates: int = 1             # copies of each sample, contiguous
    adapt_grad_norm: Optional[int] = None  # measure the scale every n steps
    average_output: bool = False    # validate: mean logits over duplicates
    model_ema: float = 0.0          # decay of the weights' EMA; 0: off
    sync_bn: bool = False           # cross-replica BN statistics (a mesh)
    shard_opt_state: bool = False   # ZeRO-1: moments sharded over 'data'
    allreduce_dtype: Optional[str] = None  # cast gradients for the all-reduce


# --allreduce-dtype names (the JAX package maps "half" to bfloat16 too)
_ALLREDUCE_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                     "half": torch.bfloat16, "fp16": torch.float16,
                     "float16": torch.float16, "float32": None}


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s streams: ``seed`` itself on rank 0."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def _mean_hook(state, bucket):
    """DDP comm hook: the bucket's sum over the group, then divided by the
    group's size, in ``dtype`` where given (cast, sum, divide, cast back)."""
    group, dtype = state
    world = dist.get_world_size(group)
    buf = bucket.buffer()
    t = buf if dtype is None else buf.to(dtype)
    fut = dist.all_reduce(t, group=group, async_op=True).get_future()

    def done(f):
        total = f.value()[0].div_(world)
        return total if dtype is None else buf.copy_(total)

    return fut.then(done)


class Trainer:
    def __init__(self, model, optim_regime: OptimRegime, num_classes: int,
                 config: Optional[TrainerConfig] = None, device=None,
                 seed: int = 0, mesh=None):
        """``device``: where the model trains; ``None`` is the CUDA card.
        ``seed`` seeds the weights :meth:`initialize` draws, the generator
        of the model's ``Dropout`` layers and the host-side draws of mixup
        and cutmix. ``mesh``: the data-parallel mesh
        (``parallel.make_mesh``) this rank trains on, None for one
        device."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = config or TrainerConfig()
        self.mesh = mesh
        self.group = None if mesh is None else mesh.get_group(DATA_AXIS)
        self.world = 1 if mesh is None else dist.get_world_size(self.group)
        self.rank = 0 if mesh is None else dist.get_rank(self.group)
        if self.cfg.shard_opt_state:
            if mesh is None:
                self.cfg = dataclasses.replace(self.cfg,
                                               shard_opt_state=False)
            elif self.cfg.adapt_grad_norm or self.cfg.model_ema > 0:
                raise ValueError("shard_opt_state is incompatible with "
                                 "adapt_grad_norm and model_ema")
        if self.cfg.allreduce_dtype not in (None, *_ALLREDUCE_DTYPES):
            raise ValueError(f"allreduce_dtype {self.cfg.allreduce_dtype!r}: "
                             f"one of {sorted(_ALLREDUCE_DTYPES)}")
        if self.cfg.sync_bn and mesh is not None:
            set_bn_group(self.model, self.group)
        own_seed = rank_seed(seed, self.rank)
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(own_seed)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_generator
        self.optim = optim_regime
        self.num_classes = num_classes
        self.policy = get_policy(self.cfg.dtype)
        self.seed = seed
        self.criterion = CrossEntropyLoss(smooth_eps=self.cfg.label_smoothing)
        self.mix = (MixUp(self.cfg.mixup_alpha, num_classes, own_seed)
                    if self.cfg.mixup_alpha > 0 else
                    CutMix(self.cfg.cutmix_alpha, num_classes, own_seed)
                    if self.cfg.cutmix_alpha > 0 else None)
        self._ddp = None
        self._zero = None
        self.epoch = 0
        self.training_steps = 0
        self.opt_state = None
        self._watcher = None
        self._takes_aux = "aux" in inspect.signature(
            self.model.forward).parameters

    def set_watcher(self, path_or_file):
        """Live telemetry: ``train_epoch`` appends one JSON line a step with
        the JAX trainer's keys (``epoch``, ``step``, ``loss``,
        ``grad_norm``, ``lr``, ``step_time``, ``data_time``) to a path (opened
        for appending) or an open file. The line is written when the step's
        metrics are read, two steps late, so the watcher adds no wait on the
        device; ``step`` and ``lr`` are that step's own. ``None`` closes
        it."""
        if path_or_file is None:
            if self._watcher is not None:
                self._watcher.close()
            self._watcher = None
        elif hasattr(path_or_file, "write"):
            self._watcher = path_or_file
        else:
            self._watcher = open(path_or_file, "a")

    def initialize(self, state_dict=None):
        """Draws the model's weights from ``seed``, or loads
        ``state_dict`` (for instance ``utils.from_jax.from_jax_params``);
        makes the weight-decay mask and the optimizer state (with the
        gradient-norm scale under ``adapt_grad_norm`` and float32 copies of
        the weights under ``model_ema``). On a mesh the weights and BN
        statistics are then broadcast from rank 0, and the model is wrapped
        in DDP, or the ZeRO-1 layout made (each rank's slice of the flat
        moments)."""
        if state_dict is None:
            init_parameters(self.model,
                            torch.Generator().manual_seed(self.seed))
        else:
            self.model.load_state_dict(state_dict)
        if self.mesh is not None:
            replicate(self.model, self.group)
        named = list(self.model.named_parameters())
        mask = wd_mask(self.model)
        self._params = [p for _, p in named]
        self._mask = [mask[name] for name, _ in named]
        if self.cfg.shard_opt_state:
            self.opt_state = self._init_zero()
            return self.opt_state
        self.opt_state = self.optim.init_state(self._params, self._mask)
        if self._adapts_grad_norm:
            self.opt_state["agn_scale"] = torch.ones((), device=self.device)
        if self.cfg.model_ema > 0:
            self.opt_state["ema"] = [p.detach().float().clone()
                                     for p in self._params]
        if self.mesh is not None and self._ddp is None:
            from torch.nn.parallel import DistributedDataParallel
            # no buffer broadcast in the forward (each rank keeps its BN
            # statistics); torch >= 2.13 names that forward_sync_buffers
            no_sync_buffers = (
                {"forward_sync_buffers": False} if "forward_sync_buffers"
                in inspect.signature(DistributedDataParallel).parameters
                else {"broadcast_buffers": False})
            self._ddp = DistributedDataParallel(
                self.model, device_ids=(
                    [torch.cuda.current_device() if self.device.index is None
                     else self.device.index]
                    if self.device.type == "cuda" else None),
                process_group=self.group, init_sync=False, **no_sync_buffers)
            self._ddp.register_comm_hook(
                (self.group, _ALLREDUCE_DTYPES.get(self.cfg.allreduce_dtype)),
                _mean_hook)
        return self.opt_state

    def _init_zero(self):
        """The ZeRO-1 state: {"step", each slot as this rank's slice of the
        flat padded vector}, and the layout's constants."""
        if self.optim.uses_bounded_norm:
            raise ValueError("shard_opt_state is incompatible with "
                             "BoundedWeightNorm")
        params, n = self._params, self.world
        padded = zero.flat_size(params, n)
        per = padded // n
        self._zero = {
            "padded": padded, "size": sum(p.numel() for p in params),
            "mask01": zero.shard_slice(
                zero.flat_mask01(params, self._mask, n), self.group),
            "seg": zero.shard_slice(zero.leaf_segment_ids(params, n),
                                    self.group),
            "leaf_mask": zero.leaf_mask01(params, self._mask),
            "segments": zero.slice_segments(params, n, self.rank),
            "jax_index": zero.jax_order_index(self.model)}
        state = self.optim.init_state(
            [torch.zeros(per, device=self.device)])
        return {k: v[0] if isinstance(v, list) else v
                for k, v in state.items()}

    @property
    def _adapts_grad_norm(self):
        return bool(self.cfg.adapt_grad_norm) and self.cfg.duplicates > 1

    def ema_params(self):
        """{parameter name: its float32 EMA} under ``model_ema``, else
        None."""
        ema = self.opt_state.get("ema") if self.opt_state else None
        if ema is None:
            return None
        names = [n for n, _ in self.model.named_parameters()]
        return dict(zip(names, ema))

    def ema_state_dict(self):
        """The model's ``state_dict`` with the EMA in place of each
        parameter (the BN statistics as they are): load it into a model to
        validate or serve the averaged weights. None without ``model_ema``.
        """
        ema = self.ema_params()
        if ema is None:
            return None
        sd = self.model.state_dict()
        return {k: ema[k].to(v.dtype) if k in ema else v.clone()
                for k, v in sd.items()}

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

    def _loss(self, x, y, net=None):
        """The training forward of x through ``net`` (the model, or its DDP
        wrapper) and its loss against y (class labels or soft targets): the
        main logits' loss plus, for a model with auxiliary heads, each
        head's ``weight · criterion(logits, y)``. Returns (loss, main
        logits)."""
        net = net or self.model
        if not self._takes_aux:
            logits = net(x)
            return self.criterion(logits, y), logits
        heads = []
        logits = net(x, aux=heads)
        loss = self.criterion(logits, y)
        for weight, aux_logits in heads:
            loss = loss + weight * self.criterion(aux_logits, y)
        return loss, logits

    def train_step(self, x, y):
        """One step on the batch (x (B, H, W, C), y (B,) class labels; on a
        mesh this rank's part) at the regime's current setting. Returns
        device scalars ``loss`` (the mean over the chunks, and the ranks),
        ``correct1``, ``correct5`` (summed over the chunks, and the ranks)
        and ``grad_norm``, and the step's ``lr`` (a float)."""
        hp = self.hyperparams()
        name = self.optim.optimizer_name
        missing = [s for s in optimizer_slots(name) if s not in self.opt_state]
        if missing:
            raise RuntimeError(f"optimizer {name} needs the state slots "
                               f"{missing}, which the state lacks")
        step = optimizer_step(name)
        x, y = self._to_device(x, y)
        if self.mix is not None:
            x, y = self.mix(x, y)
        net = self._ddp or self.model
        net.train()
        for p in self._params:
            p.grad = None
        chunks = self.cfg.chunk_batch
        if x.shape[0] % chunks:
            raise ValueError(f"a batch of {x.shape[0]} does not split into "
                             f"{chunks} chunks")
        size = x.shape[0] // chunks
        loss = c1 = c5 = 0.0
        for k, (xi, yi) in enumerate(zip(torch.split(x, size),
                                         torch.split(y, size))):
            # DDP all-reduces in the last chunk's backward only
            with (self._ddp.no_sync() if self._ddp is not None
                  and k < chunks - 1 else nullcontext()):
                chunk_loss, logits = self._loss(xi, yi, net)
                (chunk_loss * hp["loss_scale"]).backward()
            cc1, cc5 = correct_topk(logits.detach(), yi, (1, 5))
            loss, c1, c5 = loss + chunk_loss.detach(), c1 + cc1, c5 + cc5
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        if chunks > 1:
            torch._foreach_div_(grads, chunks)
            loss = loss / chunks
        torch._foreach_div_(grads, hp["loss_scale"])
        if self.mesh is not None:
            loss, c1, c5 = self._reduce_metrics_and_stats(loss, c1, c5)
        if self._zero is not None:
            grad_norm = self._zero_step(grads, hp, name)
            self.training_steps += 1
            return {"loss": loss, "correct1": c1, "correct5": c5,
                    "grad_norm": grad_norm, "lr": hp["lr"]}
        if self._adapts_grad_norm:
            self._adapt_grad_norm(grads, x, y, hp["loss_scale"])
        grad_norm = clip_by_global_norm(grads, hp["grad_clip"])
        step(self._params, grads, self.opt_state, hp, mask=self._mask)
        if self.optim.uses_bounded_norm and hp["bounded_norm"] > 0:
            bounded_weight_norm(self._params, self.opt_state["norms"],
                                self._mask)
        if self.cfg.model_ema > 0:
            decay = self.cfg.model_ema
            ema = self.opt_state["ema"]
            with torch.no_grad():
                torch._foreach_mul_(ema, decay)
                torch._foreach_add_(ema, [p.float() for p in self._params],
                                    alpha=1.0 - decay)
        self.training_steps += 1
        return {"loss": loss, "correct1": c1, "correct5": c5,
                "grad_norm": grad_norm, "lr": hp["lr"]}

    @torch.no_grad()
    def _reduce_metrics_and_stats(self, loss, c1, c5):
        """One all-reduce over the mesh: the BN running statistics and the
        loss averaged, the correct counts summed (the JAX step's ``pmean``
        of its state and loss, ``psum`` of the counts)."""
        buffers = [b for m in self.model.modules()
                   if isinstance(m, BatchNorm2d)
                   for b in (m.running_mean, m.running_var)]
        flat = torch.cat([b.reshape(-1) for b in buffers]
                         + [torch.stack([loss.float(), c1, c5])])
        dist.all_reduce(flat, group=self.group)
        head = flat[:-3]
        head /= self.world
        offset = 0
        for b in buffers:
            b.copy_(head[offset:offset + b.numel()].view_as(b))
            offset += b.numel()
        return flat[-3] / self.world, flat[-2], flat[-1]

    @torch.no_grad()
    def _zero_step(self, grads, hp, name):
        """ZeRO-1 (the JAX step's ``shard_opt_state`` branch): the mean
        gradient's slice by one reduce-scatter, its global norm, the clip,
        the optimizer on this rank's slice, the parameters all-gathered.
        Returns the gradient's norm."""
        z = self._zero
        g_slice = zero.reduce_scatter_mean(grads, z["padded"], self.group)
        sq = g_slice.square().sum()
        dist.all_reduce(sq, group=self.group)
        grad_norm = torch.sqrt(sq)
        clip = hp["grad_clip"]
        if clip > 0:
            g_slice.mul_(torch.where(grad_norm > clip,
                                     clip / torch.clamp_min(grad_norm, 1e-12),
                                     1.0))
        p_slice = zero.shard_slice(zero.flatten(self._params, z["padded"]),
                                   self.group)
        if name in ("LARS", "LAMB"):
            w_sq = torch.stack([p.float().square().sum()
                                for p in self._params])
            kw = dict(mask01=z["mask01"], seg_slice=z["seg"], w_sq=w_sq,
                      n_leaves=len(self._params), group=self.group)
            if name == "LARS":
                zero.lars_step_sharded(p_slice, g_slice, self.opt_state, hp,
                                       **kw)
            else:
                zero.lamb_step_sharded(p_slice, g_slice, self.opt_state, hp,
                                       leaf_mask=z["leaf_mask"], **kw)
        else:
            zero.elementwise_step_sharded(
                optimizer_step(name), p_slice, g_slice, self.opt_state, hp,
                segments=z["segments"], mask=self._mask)
        zero.gather_params(p_slice, self._params, self.group)
        return grad_norm

    def _adapt_grad_norm(self, grads, x, y, loss_scale):
        """Batch augmentation's gradient rescaling: every
        ``adapt_grad_norm`` optimizer steps, the gradient of one copy of
        each sample (``x[::duplicates]``: the copies are contiguous) is
        computed in one extra forward and backward, and the ratio of its
        norm to the full gradient's is kept as ``opt_state["agn_scale"]``;
        every step scales ``grads`` by it in place. The extra forward's
        BatchNorm statistics are discarded, as the JAX package discards
        them."""
        if self.opt_state["step"] % self.cfg.adapt_grad_norm == 0:
            d = self.cfg.duplicates
            full = global_norm(grads)
            buffers = [b for _, b in self.model.named_buffers()]
            saved = [b.clone() for b in buffers]
            loss = self._loss(x[::d].contiguous(), y[::d])[0] * loss_scale
            sub = torch.autograd.grad(loss, self._params, allow_unused=True)
            with torch.no_grad():
                for b, v in zip(buffers, saved):
                    b.copy_(v)
            sub = [g if g is not None else torch.zeros_like(p)
                   for g, p in zip(sub, self._params)]
            torch._foreach_div_(sub, loss_scale)
            if self.mesh is not None:
                # the model's forward, not DDP's: averaged here, as the
                # main gradient is, so every rank measures the same norm
                with torch.no_grad():
                    all_mean_(sub, self.group)
            self.opt_state["agn_scale"] = (
                global_norm(sub) / torch.clamp_min(full, 1e-12))
        torch._foreach_mul_(grads, self.opt_state["agn_scale"])

    def train_epoch(self, loader, epoch: int,
                    steps_per_epoch: Optional[int] = None,
                    start_batch: int = 0, step_hook=None):
        """One epoch over ``loader``, any iterable of (x, y) batches.
        Returns the epoch's loss, top-1/top-5 accuracy (%), mean gradient
        norm, step and data times (host clock) and images per second.

        ``start_batch``: skips the first K batches (a resume inside the
        epoch; the loader must give the same batches again). A skipped batch
        draws nothing from any generator (no λ, cutmix box or dropout mask)
        and moves neither ``training_steps`` nor the regime, so a trainer
        loaded from a checkpoint taken after batch K goes on as the
        uninterrupted run did. The results cover the remaining batches.

        ``step_hook(trainer, batch_idx)``: called after each step with this
        trainer and the number of the epoch's batches done (``i + 1``), to
        save a checkpoint with :meth:`checkpoint_dict`, for instance. (The
        JAX trainer passes ``(params, state, opt_state, i + 1)``: the port's
        trainer holds its state itself.)

        ``data_time`` is the host time from the end of one step to the start
        of the next: the loader's. On a mesh each rank passes its own
        batches; the counts and images per second are the whole mesh's."""
        self.epoch = epoch
        meters = {k: AverageMeter() for k in ("loss", "grad_norm",
                                              "step_time", "data_time")}
        acc = AccuracyMeter()
        step_times = []
        spe = steps_per_epoch or getattr(loader, "__len__", lambda: None)()
        # metrics are read two steps late, so the host never waits for the
        # step it has just queued
        pending = collections.deque()

        def drain():
            m, n, st, dt, step = pending.popleft()
            loss, grad_norm = float(m["loss"]), float(m["grad_norm"])
            meters["loss"].update(loss, n)
            meters["grad_norm"].update(grad_norm)
            meters["step_time"].update(st)
            meters["data_time"].update(dt)
            step_times.append(st)
            acc.update((float(m["correct1"]), float(m["correct5"])), n)
            if self._watcher is not None:
                self._watcher.write(json.dumps({
                    "epoch": epoch, "step": step, "loss": loss,
                    "grad_norm": grad_norm, "lr": m["lr"], "step_time": st,
                    "data_time": dt}) + "\n")
                self._watcher.flush()

        samples = 0
        t_epoch = t_last = time.perf_counter()
        for i, (x, y) in enumerate(loader):
            if i < start_batch:
                t_last = time.perf_counter()
                continue
            t_data = time.perf_counter()
            if self.optim.update(epoch + (i / spe if spe else 0),
                                 self.training_steps):
                log.info("optimizer switched to %s",
                         self.optim.optimizer_name)
            metrics = self.train_step(x, y)
            samples += len(x) * self.world
            if step_hook is not None:
                step_hook(self, i + 1)
            t_step = time.perf_counter()
            pending.append((metrics, len(x) * self.world, t_step - t_data,
                            t_data - t_last, self.training_steps))
            while len(pending) > 2:
                drain()
            if self.cfg.print_freq and i % self.cfg.print_freq == 0:
                log.info("epoch %d step %d/%s loss %.4f prec1 %.2f prec5 "
                         "%.2f lr %.4g step_time %.3fs data_time %.3fs",
                         epoch, i, spe or "?", meters["loss"].avg,
                         acc.value(1), acc.value(5), metrics["lr"],
                         meters["step_time"].avg, meters["data_time"].avg)
            t_last = time.perf_counter()
        while pending:
            drain()
        epoch_time = time.perf_counter() - t_epoch
        return {"loss": meters["loss"].avg, "prec1": acc.value(1),
                "prec5": acc.value(5), "grad_norm": meters["grad_norm"].avg,
                "step_time": meters["step_time"].avg,
                # p50 past the first step, which pays the start-up
                "step_time_p50": float(np.median(step_times[1:] or step_times
                                                 or [0.0])),
                "data_time": meters["data_time"].avg,
                "epoch_time": epoch_time,
                "img_per_sec": samples / max(epoch_time, 1e-9)}

    def checkpoint_dict(self, **meta):
        """What ``utils.checkpoint.save_checkpoint`` writes for this
        trainer: the weights and BN statistics (``params``, ``state``) and
        the optimizer state (``step``, each slot as a tree like ``params``,
        ``agn_scale``) in the JAX package's names and layouts, host copies
        made before this returns; ``epoch`` and ``training_steps``; the
        regime's position; and ``streams``, the states of the dropout
        generator and of the mixup or cutmix sampler (the counterpart of the
        JAX checkpoint's ``rng``). ``meta`` adds entries (``model``,
        ``config``, ``batch_idx``, ``best_prec1``, ...) or overrides
        ``epoch``.

        On a mesh every rank must call it (rank 0 writes what it returns):
        under ZeRO-1 each slot is gathered into the full padded flat vector
        the JAX package stores (its ``ravel_pytree`` order), and above one
        rank ``rank_streams`` holds every rank's streams."""
        params, state = to_jax_params(self.model.state_dict())
        opt = {}
        for slot, v in self.opt_state.items():
            if slot == "step":
                opt[slot] = np.int32(v)
            elif isinstance(v, list):
                opt[slot] = slots_to_tree(self.model, v)
            elif self._zero is not None and slot_is_flat(v):
                opt[slot] = self._zero_to_jax_flat(v)
            else:
                opt[slot] = v.detach().float().cpu().numpy()
        streams = self._streams()
        extra = {}
        if self.world > 1:
            extra["rank_streams"] = [None] * self.world
            dist.all_gather_object(extra["rank_streams"], streams,
                                   group=self.group)
        return {"epoch": self.epoch, "training_steps": self.training_steps,
                "regime": self.optim.state_dict(), "streams": streams,
                **extra, **meta, "params": params, "state": state,
                "opt_state": opt}

    def _streams(self):
        gen = self.dropout_generator.get_state()
        streams = {"dropout": {"device": self.device.type,
                               "state": base64.b64encode(
                                   gen.numpy().tobytes()).decode()}}
        if self.mix is not None:
            streams["mix"] = self.mix.rng.bit_generator.state
        return streams

    def _zero_to_jax_flat(self, v):
        """A ZeRO slot's slice → the full padded flat vector in the JAX
        package's order (a host array)."""
        z = self._zero
        full = zero.gather_flat(v.float(), self.group)[:z["size"]]
        out = np.zeros(z["padded"], np.float32)
        out[:z["size"]] = full.cpu().numpy()[z["jax_index"]]
        return out

    def _zero_from_jax_flat(self, flat):
        """The inverse of :meth:`_zero_to_jax_flat`: this rank's slice."""
        z = self._zero
        port = np.zeros(z["padded"], np.float32)
        port[z["jax_index"]] = np.asarray(flat, np.float32)[:z["size"]]
        per = z["padded"] // self.world
        return torch.from_numpy(
            port[self.rank * per:(self.rank + 1) * per]).to(self.device)

    def load_checkpoint(self, ckpt):
        """Restores a checkpoint (``utils.checkpoint.load_checkpoint``'s
        dict, written by the port or by the JAX package; an uninitialised
        trainer is initialised first): the weights and BN statistics, the
        optimizer state fitted to the current regime's slots
        (``adapt_opt_state``), ``epoch``, ``training_steps`` and, from a port
        checkpoint, the regime's position and the generators' states. A JAX
        checkpoint's ``rng`` key cannot drive the port's streams: after one,
        dropout and mixup draw from this trainer's own seed, so an exact
        replay of the uninterrupted run holds from port to port only.

        Every rank reads the same checkpoint. Under ZeRO-1 each rank takes
        its slice of the stored flat vectors (or of the trees a checkpoint
        without ZeRO holds), whatever the world size that wrote them; rank r
        takes ``rank_streams[r]`` where the checkpoint holds as many, and
        otherwise keeps its own seed's streams above rank 0."""
        if self.opt_state is None:
            self.initialize()
        # a model without BatchNorm (the MNIST net) saves no state
        self.model.load_state_dict(from_jax_params(ckpt["params"],
                                                   ckpt.get("state")))
        if ckpt.get("opt_state") is not None:
            flat = np.zeros(self._zero["padded"] if self._zero else 0,
                            np.float32)
            template = {k: (slots_to_tree(self.model, v)
                            if isinstance(v, list) else
                            flat if self._zero is not None and slot_is_flat(v)
                            else v)
                        for k, v in self.opt_state.items()}
            fitted = adapt_opt_state(ckpt["opt_state"], template)
            for slot, v in fitted.items():
                if isinstance(v, dict):
                    self.opt_state[slot] = tree_to_slots(self.model, v)
                elif self._zero is not None and slot_is_flat(
                        self.opt_state.get(slot)):
                    self.opt_state[slot] = self._zero_from_jax_flat(v)
                elif slot == "step":
                    self.opt_state[slot] = int(np.asarray(v))
                else:
                    self.opt_state[slot] = torch.as_tensor(
                        np.asarray(v, np.float32), device=self.device)
        self.epoch = int(ckpt.get("epoch", 0))
        self.training_steps = int(ckpt.get("training_steps", 0))
        if ckpt.get("regime"):
            self.optim.load_state_dict(ckpt["regime"])
        streams = ckpt.get("streams") or {}
        ranks = ckpt.get("rank_streams")
        if ranks and len(ranks) == self.world:
            streams = ranks[self.rank] or {}
        elif self.rank > 0:
            if streams:
                log.warning("the checkpoint holds no streams of rank %d: it "
                            "keeps its own seed's", self.rank)
            streams = {}
        dropout = streams.get("dropout")
        if dropout and dropout["device"] == self.device.type:
            self.dropout_generator.set_state(torch.frombuffer(
                bytearray(base64.b64decode(dropout["state"])),
                dtype=torch.uint8))
        elif dropout:
            log.warning("the checkpoint's dropout generator ran on %s, this "
                        "trainer's on %s: it keeps its own seed's stream",
                        dropout["device"], self.device.type)
        if streams.get("mix") and self.mix is not None:
            self.mix.rng.bit_generator.state = streams["mix"]

    @torch.no_grad()
    def validate(self, loader):
        """Loss and top-1/top-5 accuracy (%) over ``loader`` in eval mode.
        Labels of -100 mark padding rows, which count nowhere; a batch is
        padded with such rows to a multiple of ``duplicates``. With
        ``average_output`` the float32 logits of each group of
        ``duplicates`` rows are averaged and scored against the group's
        first label. On a mesh each rank scores its own batches (every rank
        the same number of them) and each batch's loss sum, correct counts
        and count are summed over the ranks (one all-reduce): the result is
        that of one device seeing every rank's rows. A rank's batch needs no
        padding to the data degree, which the JAX package pads to shard it:
        the rows are the ranks' already. The evaluation loaders
        (``data/loader.py``) give every rank the same number of rows, those
        past its share labelled -100, so that no sample of the set is left
        out when the world does not divide it."""
        criterion = CrossEntropyLoss(reduction="sum")
        d = max(self.cfg.duplicates, 1)
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
                if x.shape[0] % d:
                    extra = d - x.shape[0] % d
                    x = torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])
                    y = torch.cat([y, y.new_full((extra,), -100)])
                logits = self.model(x)
                if self.cfg.average_output and d > 1:
                    logits = logits.float().reshape(-1, d,
                                                    logits.shape[-1]).mean(1)
                    y = y.reshape(-1, d)[:, 0]
                c1, c5 = correct_topk(logits, y, (1, 5))
                count = (y >= 0).float().sum()
                loss = criterion(logits, y)
                if self.mesh is not None:
                    sums = torch.stack([loss.float(), c1, c5, count])
                    dist.all_reduce(sums, group=self.group)
                    loss, c1, c5, count = sums.unbind()
                loss = loss / torch.clamp_min(count, 1.0)
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

    @torch.no_grad()
    def calibrate_bn(self, loader, num_steps: int = 100):
        """Re-estimates every BatchNorm's running statistics over the first
        ``num_steps`` batches of ``loader`` (after weight averaging, for
        instance), at the current weights. Each batch runs a training
        forward from the same statistics; the batch's moments are recovered
        exactly from the in-place update with that layer's own momentum m,
        batch = (new − (1 − m)·old) / m, and averaged over the batches. The
        model's buffers are left holding the average (the JAX package
        returns a new state tree instead; the port's model owns its
        buffers). A BatchNorm whose buffers the forward leaves unchanged (an
        auxiliary head's, which does not run) keeps its statistics exactly;
        a fused block's, updated through ``BatchNorm2d.track`` without
        calling the module, counts as run. Returns the number of batches
        used.

        On a mesh the moments are always cross-replica, whatever
        ``sync_bn`` says (the JAX package's ``calibrate_bn``): each rank
        passes its own batches and the result is that of one device seeing
        them all."""
        bns = [m for m in self.model.modules() if isinstance(m, BatchNorm2d)]
        groups = (set_bn_group(self.model, self.group)
                  if self.mesh is not None else None)
        try:
            return self._calibrate_bn(bns, loader, num_steps)
        finally:
            if groups is not None:
                restore_bn_groups(self.model, groups)

    def _calibrate_bn(self, bns, loader, num_steps):
        old = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
        ran = [torch.zeros((), dtype=torch.bool, device=mean0.device)
               for mean0, _ in old]
        avg, count = None, 0
        self.model.train()
        for i, (x, _) in enumerate(loader):
            if i >= num_steps:
                break
            x = self.policy.cast_to_compute(
                torch.as_tensor(x).to(self.device, non_blocking=True))
            self.model(x)
            batch = []
            for m, (mean0, var0), r in zip(bns, old, ran):
                r |= ((m.running_mean != mean0).any()
                      | (m.running_var != var0).any())
                k = m.momentum
                batch.append(((m.running_mean - (1 - k) * mean0) / k,
                              (m.running_var - (1 - k) * var0) / k))
                m.running_mean.copy_(mean0)
                m.running_var.copy_(var0)
            avg = batch if avg is None else [
                (a_m + (b_m - a_m) / (count + 1),
                 a_v + (b_v - a_v) / (count + 1))
                for (a_m, a_v), (b_m, b_v) in zip(avg, batch)]
            count += 1
        for m, stats, r in zip(bns, avg or [], ran):
            if r:
                m.running_mean.copy_(stats[0])
                m.running_var.copy_(stats[1])
        return count
