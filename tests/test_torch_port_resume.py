"""Mid-epoch resume, the step hook and the telemetry watcher of the port's
``Trainer``, on the CPU.

Resume: an epoch run through once, and run again with a ``step_hook`` that
saves a checkpoint (``utils/checkpoint.py``) after batch K; a fresh trainer
loads it and runs ``train_epoch(start_batch=K)``. The weights, BN
statistics and optimizer state at the end must equal the uninterrupted
run's bit for bit: on a narrow CIFAR ResNet with mixup, the weights' EMA and
an optimizer switch inside the epoch (SGD → RMSprop at half the epoch,
saved before and after it), with cutmix, and on a narrow MobileNet-V2 with
dropout (its generator's state is in the checkpoint).

Watcher: one JSON line a step with the JAX trainer's keys; its values
against the JAX trainer's on the same loader at lr 0, so the weights stay
where both started (loss 1e-4 relative, gradient norm 1e-3, the terms of a
single step from the same state in ``test_torch_port_cifar_se.py``).
"""

import io
import json
import time

import jax
import numpy as np
import pytest
import torch

import test_torch_port_cifar_se as C
from convnet_tpu import models as jax_models
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu_torch import models
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                save_checkpoint,
                                                wait_for_pending_save)
from convnet_tpu_torch.utils.from_jax import from_jax_params

CIFAR = ("resnet", {"dataset": "cifar10", "depth": 8})
MNV2 = ("mobilenet_v2", {"width": 0.25, "num_classes": 10,
                         "dropout": 0.5})
# SGD, then RMSprop from half the epoch (batch 4 of 8)
SWITCH = [{"epoch": 0, "optimizer": "SGD", "lr": 0.1, "momentum": 0.9,
           "regularizer": {"name": "WeightDecay", "value": 1e-4}},
          {"epoch": 0.5, "optimizer": "RMSprop", "lr": 0.01, "alpha": 0.9,
           "momentum": 0.9, "eps": 1.0}]
# name → (net, regime (None: the model's), TrainerConfig fields, batch to
# save after)
CASES = {
    "mixup_ema_switch_before": (CIFAR, SWITCH,
                                {"mixup_alpha": 0.2, "model_ema": 0.9}, 3),
    "mixup_ema_switch_after": (CIFAR, SWITCH,
                               {"mixup_alpha": 0.2, "model_ema": 0.9}, 5),
    "cutmix": (CIFAR, None, {"cutmix_alpha": 1.0}, 4),
    "mobilenet_v2_dropout": (MNV2, None, {}, 3),
}
BATCHES, BATCH = 8, 8
WATCH_KEYS = {"epoch", "step", "loss", "grad_norm", "lr", "step_time",
              "data_time"}


def _trainer(net, regime=None, seed=5, **cfg):
    name, config = net
    model = models.build(name, **config)
    tr = Trainer(model, optim.OptimRegime(regime or model.regime), 10,
                 TrainerConfig(print_freq=0, **cfg), device="cpu", seed=seed)
    tr.initialize()
    return tr


def _loader(seed=7):
    return C.batches(BATCHES, BATCH, 10, seed=seed)


def _state(tr):
    """Everything a step reads: the model's state, the optimizer state and
    the counters."""
    opt = {k: (v if k == "step" else [t.clone() for t in v]
               if isinstance(v, list) else v.clone())
           for k, v in tr.opt_state.items()}
    return (dict(tr.model.state_dict()), opt, tr.training_steps,
            tr.dropout_generator.get_state())


def _assert_equal(a, b):
    (sd_a, opt_a, steps_a, gen_a), (sd_b, opt_b, steps_b, gen_b) = a, b
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    assert sorted(opt_a) == sorted(opt_b)
    for k, v in opt_a.items():
        if isinstance(v, list):
            assert all(torch.equal(x, y) for x, y in zip(v, opt_b[k])), k
        elif k == "step":
            assert v == opt_b[k]
        else:
            assert torch.equal(v, opt_b[k]), k
    assert steps_a == steps_b
    assert torch.equal(gen_a, gen_b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mid_epoch_resume_is_bit_exact(case, tmp_path):
    net, regime, cfg, at = CASES[case]
    loader = _loader()
    whole = _trainer(net, regime, **cfg)
    whole.train_epoch(loader, 0)

    def hook(tr, batch_idx):
        if batch_idx == at:
            save_checkpoint(tr.checkpoint_dict(batch_idx=batch_idx,
                                               model=net[0],
                                               config=net[1]),
                            False, str(tmp_path), background=True)

    first = _trainer(net, regime, **cfg)
    first.train_epoch(loader, 0, step_hook=hook)
    _assert_equal(_state(whole), _state(first))
    wait_for_pending_save()
    ck = load_checkpoint(str(tmp_path))
    assert ck["batch_idx"] == at and ck["training_steps"] == at
    resumed = _trainer(net, regime, seed=99, **cfg)
    resumed.load_checkpoint(ck)
    res = resumed.train_epoch(loader, 0, start_batch=at)
    assert np.isfinite(res["loss"])
    _assert_equal(_state(whole), _state(resumed))
    if regime is SWITCH:
        assert resumed.optim.optimizer_name == "RMSprop"
    if cfg.get("mixup_alpha") or cfg.get("cutmix_alpha"):
        assert (resumed.mix.rng.bit_generator.state
                == whole.mix.rng.bit_generator.state)


def test_skipped_batches_draw_nothing():
    """``start_batch`` past every batch: no step, no draw of λ or a dropout
    mask, no move of ``training_steps`` or of the regime."""
    tr = _trainer(MNV2, mixup_alpha=0.2)
    before = _state(tr)
    mix_state = tr.mix.rng.bit_generator.state
    regime = tr.optim.state_dict()
    calls = []
    res = tr.train_epoch(_loader(), 0, start_batch=BATCHES,
                         step_hook=lambda *a: calls.append(a))
    _assert_equal(before, _state(tr))
    assert tr.mix.rng.bit_generator.state == mix_state
    assert tr.optim.state_dict() == regime
    assert calls == [] and res["img_per_sec"] == 0.0


def test_step_hook_sees_the_trainer_and_the_batch_count():
    tr = _trainer(CIFAR)
    seen = []
    tr.train_epoch(_loader()[:3], 0,
                   step_hook=lambda t, i: seen.append((t, i,
                                                       t.training_steps)))
    assert [(t is tr, i, s) for t, i, s in seen] == [(True, 1, 1),
                                                    (True, 2, 2),
                                                    (True, 3, 3)]


def test_watcher_lines_match_jax(tmp_path):
    """At lr 0 both trainers keep their starting weights, so each step's
    loss and gradient norm depend on its batch alone: the port's watcher
    lines hold the JAX trainer's keys and values. ``step`` differs by
    design: the port writes each step's own count, the JAX trainer the
    count when the line is written (two steps later, the last ones all at
    the end)."""
    name, config = CIFAR
    regime = [{"epoch": 0, "optimizer": "SGD", "lr": 0.0, "momentum": 0.9}]
    params, state = C.jax_init(name, config, seed=3)
    loader = _loader()
    j_model = jax_models.build(name, **config)
    j_tr = JaxTrainer(j_model, jax_optim.OptimRegime(regime), 10,
                      JaxTrainerConfig(dtype="float32", print_freq=0))
    j_buf = io.StringIO()
    j_tr.set_watcher(j_buf)
    p, s, o = j_tr.initialize(params, state)
    j_tr.train_epoch(loader, p, s, o, 0)
    model = models.build(name, **config)
    tr = Trainer(model, optim.OptimRegime(regime), 10,
                 TrainerConfig(print_freq=0), device="cpu")
    tr.initialize(from_jax_params(params, state))
    path = tmp_path / "watch.jsonl"
    tr.set_watcher(str(path))
    tr.train_epoch(loader, 0)
    tr.set_watcher(None)
    ours = [json.loads(line) for line in open(path)]
    ref = [json.loads(line) for line in j_buf.getvalue().splitlines()]
    assert len(ours) == len(ref) == BATCHES
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert set(a) == set(b) == WATCH_KEYS
        assert a["epoch"] == b["epoch"] == 0 and a["lr"] == b["lr"] == 0.0
        assert a["step"] == i + 1 and b["step"] == min(i + 3, BATCHES)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-3)
        assert a["step_time"] > 0 and a["data_time"] >= 0


def test_data_time_counts_the_loader():
    """``data_time`` is the time spent waiting for the loader: above the
    sleep of a loader that sleeps before each batch, in the epoch's results
    and in every watcher line."""
    def slow():
        for x, y in _loader()[:4]:
            time.sleep(0.05)
            yield x, y

    tr = _trainer(CIFAR)
    buf = io.StringIO()
    tr.set_watcher(buf)
    res = tr.train_epoch(slow(), 0)
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert len(lines) == 4 and res["data_time"] >= 0.05
    assert all(line["data_time"] >= 0.05 for line in lines)
    assert [line["step"] for line in lines] == [1, 2, 3, 4]
    fast = _trainer(CIFAR).train_epoch(_loader()[:4], 0)
    assert fast["data_time"] < 0.05


def test_jax_checkpoint_keeps_the_ports_streams(tmp_path, caplog):
    """A checkpoint without the port's streams (the JAX package's, whose
    ``rng`` cannot drive them) restores the state; the generators keep the
    trainer's own seed."""
    import logging
    tr = _trainer(MNV2, mixup_alpha=0.2)
    ck = tr.checkpoint_dict()
    ck.pop("streams")
    fresh = _trainer(MNV2, mixup_alpha=0.2, seed=8)
    gen, mix = (fresh.dropout_generator.get_state(),
                fresh.mix.rng.bit_generator.state)
    fresh.load_checkpoint(ck)
    assert torch.equal(fresh.dropout_generator.get_state(), gen)
    assert fresh.mix.rng.bit_generator.state == mix
    ck = tr.checkpoint_dict()
    ck["streams"]["dropout"]["device"] = "cuda"
    with caplog.at_level(logging.WARNING):
        fresh.load_checkpoint(ck)
    assert "keeps its own seed's stream" in caplog.text
    assert torch.equal(fresh.dropout_generator.get_state(), gen)
