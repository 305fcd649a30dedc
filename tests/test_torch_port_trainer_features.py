"""The port's trainer features against the JAX trainer's, on the CPU.

The narrow ResNet-50 of ``test_torch_port_train.py`` (``width=[8, 16, 32,
64]``, all 16 blocks, 10 classes, 32x32 inputs) under the JAX ``Trainer``
(``impl="pallas"``: the Pallas pool in interpret mode) and under the port's
``Trainer(device="cpu")``, in float32, from the same weights and batches.
As there, each of the port's steps starts from the JAX trainer's state
before that step (params, BN statistics, optimizer slots, the gradient-norm
scale). ``CASES``: ``chunk_batch=2``; the ``large_lars`` regime (LARS);
``duplicates=2`` with ``adapt_grad_norm=2`` over a measuring and a cached
step (and ``average_output`` in ``validate``); ``model_ema`` (and
``calibrate_bn`` on the EMA weights); mixup; cutmix; a regime that switches
from SGD to RMSprop over three epochs (so the state must hold RMSprop's
slots from the start).

Mixup and cutmix draw their λ on the host in the port, a stream the JAX
trainer's ``jax.random`` draw cannot reproduce; so the port's step with
mixup is held to the JAX step *without* mixup on the port's mixed batch and
soft targets.

Tolerances. The loss and the BN statistics at the ``LOSS_TOL`` and
``STAT_TOL`` of ``test_torch_port_train.py``. The updates in norm, as for
the narrow ResNeXt and MobileNet-V2: all of them within
``NORM_TOL["all"]``, each tensor within
``NORM_TOL["tensor"]`` of its update's norm plus ``NORM_TOL["floor"]`` of
all updates' norm (the values of ``chip_smoke.py``'s ``STEP_TOL``). Per
element they cannot be held: at this size the JAX trainer's float32 step is
itself several percent from its float64 step, while the port's is not.
``scripts/port_numerics.py trainer_features_float64`` measures it on the
chunked and the mixup step at 64x64, batch 8: JAX float32 against JAX
float64 (its BatchNorm in float64 too) 7.9% and 4.5% in norm, 17% and 7.7%
in the worst tensor; the port's float32 against its float64 7.4e-5 and
6.6e-5; the port's float64 against JAX's float64 8.7e-8 and 1.4e-7. The
reference's float32 BatchNorm moments over few pixels are the cause
(ROADMAP.md §3, the second limit). ``trainer_features`` measures every case
below at this size: the worst port-against-JAX figures are 2.7% in norm and
5.5% in a tensor (the mixup step; the port's float32 0.03% from its
float64), losses 5.2e-5 and BN statistics 3.4e-4 apart at most, the
gradient-norm scales 3.2e-3. The scale is a ratio of gradient norms: held at
``NORM_TOL["all"]``. The EMA is the updates' weighted sum: in norm like
them. The batch of each case was chosen by those measurements: the chunked
step runs at 32 (at 8 and 16 the port's own float32 step is 2.2% and 4.0%
from its float64 step), LARS at 4 (at 8 the JAX loss is 1.3e-4 off).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import models as jax_models
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu_torch import models
from convnet_tpu_torch.core.module import init_parameters
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.from_jax import from_jax_params, to_jax_params

NARROW = {"depth": 50, "width": [8, 16, 32, 64], "num_classes": 10}
SIZE = 32
# as in test_torch_port_train.py: one step from the same state:
# loss (relative), BN statistics
LOSS_TOL, STAT_TOL = 1e-4, 1e-3
# updates in norm: all, each tensor over its norm plus floor · all's norm
NORM_TOL = {"all": 5e-2, "tensor": 1e-1, "floor": 1e-4}
SLOTS = ("mu", "m", "v", "ema")
# a regime that switches optimizers: SGD, then RMSprop from epoch 1 with
# MobileNet-V2's own RMSprop settings
SGD_TO_RMSPROP = [
    {"epoch": 0, "optimizer": "SGD", "lr": 0.1, "momentum": 0.9,
     "weight_decay": 1e-4},
    {"epoch": 1, "optimizer": "RMSprop", "lr": 0.01, "alpha": 0.9,
     "momentum": 0.9, "eps": 1.0, "weight_decay": 4e-5},
]
LARS = {"regime": "large_lars", "batch_size": 4096}
DUP = {"duplicates": 2, "adapt_grad_norm": 2, "average_output": True,
       "label_smoothing": 0.1}
# name → the port's TrainerConfig fields, the model's config, the regime (None:
# the model's), copies of each sample, batch, steps (at epochs)
CASES = {
    "chunk_batch": ({"chunk_batch": 2}, None, None, 1, 32, [0, 0]),
    "large_lars": ({}, LARS, None, 1, 4, [0, 0]),
    "adapt_grad_norm": (DUP, None, None, 2, 8, [0, 0]),
    "model_ema": ({"model_ema": 0.9}, None, None, 1, 8, [0, 0]),
    "mixup": ({"label_smoothing": 0.1, "mixup_alpha": 0.2}, None, None, 1, 8,
              [0, 0]),
    "cutmix": ({"label_smoothing": 0.1, "cutmix_alpha": 1.0}, None, None, 1,
               8, [0, 0]),
    # two batches an epoch over three epochs: SGD, then RMSprop
    "sgd_to_rmsprop": ({}, None, SGD_TO_RMSPROP, 1, 4,
                       [e + i / 2 for e in range(3) for i in range(2)]),
}


def _rng(seed):
    return np.random.default_rng(seed)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _batches(n, batch, seed=7, duplicates=1):
    """``n`` batches of ``batch`` images; with ``duplicates``, each sample
    repeated contiguously (``np.repeat``, as the JAX loaders pack them) and
    each copy perturbed a little, as an augmentation would."""
    rng = _rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((batch // duplicates, SIZE, SIZE, 3))
        y = rng.integers(0, NARROW["num_classes"], batch // duplicates)
        x, y = np.repeat(x, duplicates, 0), np.repeat(y, duplicates, 0)
        x = x + 0.3 * rng.standard_normal(x.shape) * (duplicates > 1)
        out.append((x.astype(np.float32), y.astype(np.int32)))
    return out


# the JAX package's Pallas pool (interpret mode) and fused 1x1, as
# test_torch_port_train.py runs them
PALLAS_ENV = {"CONVNET_TPU_PALLAS_POOL": "1", "CONVNET_TPU_PALLAS_FUSED": "1"}


@pytest.fixture(scope="module", autouse=True)
def pallas_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PALLAS_ENV.items():
            mp.setenv(k, v)
        yield


@pytest.fixture(scope="module")
def weights():
    """The narrow ResNet-50's weights drawn by the port from seed 3, as the
    JAX package's params and state."""
    model = models.build("resnet", **NARROW)
    init_parameters(model, torch.Generator().manual_seed(3))
    return to_jax_params(model.state_dict())


def _jax_trainer(cfg, model_kw=None, regime=None):
    model = jax_models.build("resnet", **NARROW, **(model_kw or {}))
    return JaxTrainer(model, jax_optim.OptimRegime(regime or model.regime),
                      NARROW["num_classes"],
                      JaxTrainerConfig(dtype="float32", impl="pallas",
                                       print_freq=0, **cfg))


def _jax_steps(tr, weights, batches, epochs=None):
    """The JAX trainer over ``batches`` (at ``epochs``): for each step the
    params, state and optimizer state before it, its loss, and after it."""
    params, state, opt = tr.initialize(*weights)
    steps = []
    for i, (x, y) in enumerate(batches):
        epoch = epochs[i] if epochs else 0
        tr.optim.update(epoch, tr.training_steps)
        hp = tr._hp_device(tr.optim.hyperparams())
        before = _numpy((params, state, opt))
        params, state, opt, m = tr._get_train_step()(
            params, state, opt, jnp.asarray(x), jnp.asarray(y), hp,
            jax.random.PRNGKey(0))
        tr.training_steps += 1
        steps.append((epoch, before, float(m["loss"]),
                      _numpy((params, state, opt))))
    return steps


def _port_trainer(cfg, model_kw=None, regime=None):
    model = models.build("resnet", **NARROW, **(model_kw or {}))
    tr = Trainer(model, optim.OptimRegime(regime or model.regime),
                 NARROW["num_classes"], TrainerConfig(print_freq=0, **cfg),
                 device="cpu", seed=3)
    tr.initialize()
    return tr


def _load(tr, params, state, opt):
    """Puts the JAX trainer's params, BN statistics and optimizer state into
    the port's trainer."""
    tr.model.load_state_dict(from_jax_params(params, state))
    names = [n for n, _ in tr.model.named_parameters()]
    for slot in SLOTS:
        if slot in opt:
            by_name = from_jax_params(opt[slot])
            tr.opt_state[slot] = [by_name[n].clone() for n in names]
    tr.opt_state["step"] = int(opt["step"])
    if "agn_scale" in opt:
        tr.opt_state["agn_scale"] = torch.tensor(float(opt["agn_scale"]))


def _port_steps(tr, steps, batches):
    """Each of the port's steps from the JAX state before it: (loss, the
    port's state_dict as JAX trees, its optimizer state) per step."""
    out = []
    for (epoch, before, _, _), (x, y) in zip(steps, batches):
        _load(tr, *before)
        tr.optim.update(epoch, tr.training_steps)
        loss = float(tr.train_step(x, y)["loss"])
        out.append((loss, to_jax_params(tr.model.state_dict()),
                    dict(tr.opt_state)))
    return out


def run_case(name, weights):
    """Both trainers over case ``name``: the JAX trainer, its steps, the
    port's trainer, its steps (each from the JAX state) and the batches.
    With mixup or cutmix the JAX trainer runs on the port's mixed batches and
    soft targets (a copy of the port's sampler draws the same λ)."""
    cfg, model_kw, regime, dup, batch, epochs = CASES[name]
    batches = _batches(len(epochs), batch, seed=7, duplicates=dup)
    tr = _port_trainer(cfg, model_kw, regime)
    j_batches = batches
    if tr.mix is not None:
        sampler = copy.deepcopy(tr.mix)
        j_batches = [tuple(t.numpy() for t in sampler(torch.from_numpy(x),
                                                      torch.from_numpy(y)))
                     for x, y in batches]
    j_cfg = {k: v for k, v in cfg.items()
             if k not in ("mixup_alpha", "cutmix_alpha")}
    j_tr = _jax_trainer(j_cfg, model_kw, regime)
    steps = _jax_steps(j_tr, weights, j_batches, epochs)
    return j_tr, steps, tr, _port_steps(tr, steps, batches), j_batches


@pytest.fixture(scope="module")
def runs(weights):
    """``run_case`` of each case, made once when a test first asks."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_case(name, weights)
        return cache[name]
    return get


def _norm_err(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _update_errs(got, ref):
    """(all updates in norm, the worst tensor over its update's norm plus
    NORM_TOL["floor"] of all updates' norm, its name)."""
    flat_ref = np.concatenate([ref[k].ravel() for k in ref])
    floor = NORM_TOL["floor"] * np.linalg.norm(flat_ref)
    per = {k: np.linalg.norm(got[k] - ref[k]) / (np.linalg.norm(ref[k])
                                                 + floor) for k in ref}
    worst = max(per, key=per.get)
    flat_got = np.concatenate([got[k].ravel() for k in ref])
    return _norm_err(flat_got, flat_ref), per[worst], worst


def _check_updates(got, ref, what):
    assert ref.keys() == got.keys()
    total, tensor, worst = _update_errs(got, ref)
    assert total <= NORM_TOL["all"], (what, total)
    assert tensor <= NORM_TOL["tensor"], (what, worst, tensor)


def _check_stats(ours, theirs, what):
    ref, got = dict(_leaves(theirs)), dict(_leaves(ours))
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=str((what, k)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_match_jax(runs, name):
    """Each step: the loss, the updates in norm, the BN statistics, and the
    optimizer state's slots."""
    _, steps, _, ours, _ = runs(name)
    for i, ((_, before, j_loss, (j_p, j_s, j_opt)), (loss, (p, s), opt)) \
            in enumerate(zip(steps, ours)):
        np.testing.assert_allclose(loss, j_loss, rtol=LOSS_TOL,
                                   err_msg=str(i))
        p0 = dict(_leaves(before[0]))
        _check_updates({k: v - p0[k] for k, v in _leaves(p)},
                       {k: v - p0[k] for k, v in _leaves(j_p)}, (name, i))
        _check_stats(s, j_s, (name, i))
        assert set(opt) == set(j_opt), (set(opt), set(j_opt))


# ----------------------------------------------------------- chunk_batch

def test_chunk_batch_threads_statistics_and_counts_the_batch():
    """A chunked step's statistics equal two half-batch training forwards
    in turn, bit for bit; its counts cover the whole batch; a batch that
    does not split is refused."""
    x, y = _batches(1, 8)[0]
    tr = _port_trainer({"chunk_batch": 2})
    ref = copy.deepcopy(tr.model).train()
    m = tr.train_step(x, y)
    with torch.no_grad():
        for half in (x[:4], x[4:]):
            ref(torch.from_numpy(half))
    for (n, b), (_, b_ref) in zip(tr.model.named_buffers(),
                                  ref.named_buffers()):
        torch.testing.assert_close(b, b_ref, rtol=0, atol=0, msg=n)
    assert 0 <= float(m["correct1"]) <= float(m["correct5"]) <= 8
    with pytest.raises(ValueError, match="does not split"):
        tr.train_step(x[:7], y[:7])


# ------------------------------------ duplicates, adapt_grad_norm, average

def test_adapt_grad_norm_scale_matches_jax(runs):
    """Step 1 measures the scale (an extra forward and backward on
    ``x[::2]``), step 2 reuses it."""
    _, steps, _, ours, _ = runs("adapt_grad_norm")
    scales = [float(s[3][2]["agn_scale"]) for s in steps]
    assert scales[0] == scales[1] != 1.0
    for (_, _, _, (_, _, j_opt)), (_, _, opt) in zip(steps, ours):
        np.testing.assert_allclose(float(opt["agn_scale"]),
                                   float(j_opt["agn_scale"]),
                                   rtol=NORM_TOL["all"])


def test_measuring_pass_leaves_bn_statistics_alone():
    """The statistics after a measuring step equal those after the same
    step without ``adapt_grad_norm``, bit for bit."""
    x, y = _batches(1, 8, duplicates=2)[0]
    with_agn = _port_trainer(DUP)
    without = _port_trainer({**DUP, "adapt_grad_norm": None})
    for tr in (with_agn, without):
        tr.train_step(x, y)
    assert float(with_agn.opt_state["agn_scale"]) != 1.0
    assert "agn_scale" not in without.opt_state
    for (n, b), (_, b_ref) in zip(with_agn.model.named_buffers(),
                                  without.model.named_buffers()):
        torch.testing.assert_close(b, b_ref, rtol=0, atol=0, msg=n)


def test_average_output_validate_matches_jax(runs):
    """``validate`` at the final state on a batch of 7, padded to 8: the
    logits of each sample's two copies averaged."""
    j_tr, steps, tr, _, batches = runs("adapt_grad_norm")
    val_batch = [(batches[0][0][:7], batches[0][1][:7])]
    j_p, j_s, j_opt = steps[-1][3]
    j_val = j_tr.validate(val_batch, j_p, j_s)
    _load(tr, j_p, j_s, j_opt)
    val = tr.validate(val_batch)
    assert val["prec1"] == j_val["prec1"] and val["prec5"] == j_val["prec5"]
    np.testing.assert_allclose(val["loss"], j_val["loss"], rtol=LOSS_TOL)


# -------------------------------------------------- model EMA, calibrate_bn

def test_model_ema_matches_jax(runs):
    """The EMA's change from the weights before each step, in norm."""
    _, steps, tr, ours, _ = runs("model_ema")
    names = [n for n, _ in tr.model.named_parameters()]
    for i, ((_, before, _, (_, _, j_opt)), (_, _, opt)) in enumerate(
            zip(steps, ours)):
        p0 = from_jax_params(before[0])
        j_ema = from_jax_params(j_opt["ema"])
        assert len(opt["ema"]) == len(names) == len(p0)
        _check_updates({n: (e - p0[n]).numpy()
                        for n, e in zip(names, opt["ema"])},
                       {n: (j_ema[n] - p0[n]).numpy() for n in p0},
                       ("ema", i))


def test_ema_weights_never_alias_the_parameters():
    tr = _port_trainer({"model_ema": 0.5})
    params = dict(tr.model.named_parameters())
    for n, e in tr.ema_params().items():
        assert e.dtype == torch.float32
        assert e.data_ptr() != params[n].data_ptr()
        torch.testing.assert_close(e, params[n].detach())
    x, y = _batches(1, 4)[0]
    tr.train_step(x, y)
    sd = tr.ema_state_dict()
    assert sd.keys() == tr.model.state_dict().keys()
    assert any(not torch.equal(sd[n], p.detach()) for n, p in params.items())
    assert _port_trainer({}).ema_params() is None


def test_calibrate_bn_matches_jax(runs):
    """On the EMA weights after the two steps, over 2 of 3 batches."""
    j_tr, steps, tr, _, _ = runs("model_ema")
    batches = _batches(3, 8, seed=10)
    j_p, j_s, j_opt = steps[-1][3]
    j_cal = _numpy(j_tr.calibrate_bn(batches, j_tr.ema_params(j_opt), j_s,
                                     num_steps=2))
    _load(tr, j_p, j_s, j_opt)
    tr.model.load_state_dict(tr.ema_state_dict())
    assert tr.calibrate_bn(batches, num_steps=2) == 2
    _check_stats(to_jax_params(tr.model.state_dict())[1], j_cal,
                 "calibrate_bn")


# ------------------------------------------------------------------ mixup

@pytest.mark.parametrize("name", ["mixup", "cutmix"])
def test_the_jax_step_ran_on_mixed_batches(runs, name):
    *_, j_batches = runs(name)
    x, y = _batches(1, CASES[name][4], seed=7)[0]
    assert not np.array_equal(j_batches[0][0], x)
    assert j_batches[0][1].shape == (len(y), NARROW["num_classes"])


# ------------------------------------------- a switch: SGD, then RMSprop

def test_sgd_to_rmsprop_regime_switches_with_its_slots(runs):
    _, steps, tr, ours, _ = runs("sgd_to_rmsprop")
    assert tr.optim.optimizer_name == "RMSprop"
    for _, _, opt in ours:
        assert set(opt) == {"step", "mu", "m", "v"}


def test_sgd_to_rmsprop_regime_trains_through_its_switch():
    """The port's own epochs, run free: the switch finds its slots."""
    tr = _port_trainer({}, regime=SGD_TO_RMSPROP)
    names = []
    for epoch in range(3):
        res = tr.train_epoch(_batches(2, 4, seed=13 + epoch), epoch)
        names.append(tr.optim.optimizer_name)
        assert np.isfinite(res["loss"])
    assert names == ["SGD", "RMSprop", "RMSprop"]
    assert tr.opt_state["step"] == 6 and any(v.any()
                                             for v in tr.opt_state["v"])


def test_a_missing_slot_is_refused():
    tr = _port_trainer({}, regime=SGD_TO_RMSPROP)
    del tr.opt_state["v"]
    tr.optim.update(1, 0)
    x, y = _batches(1, 4)[0]
    with pytest.raises(RuntimeError, match=r"state slots \['v'\]"):
        tr.train_step(x, y)


def test_bounded_weight_norm_regime_keeps_the_initial_norms():
    regime = [{"epoch": 0, "optimizer": "SGD", "lr": 0.5, "momentum": 0.9,
               "regularizer": {"name": "BoundedWeightNorm"}}]
    tr = _port_trainer({}, regime=regime)
    norms = [n.clone() for n in tr.opt_state["norms"]]
    before = [p.detach().clone() for p in tr._params]
    x, y = _batches(1, 4)[0]
    tr.train_step(x, y)
    for p, n, m in zip(tr._params, norms, tr._mask):
        if m:
            torch.testing.assert_close(torch.linalg.vector_norm(p), n)
        else:
            assert n == 0
    assert any(not torch.equal(p, p0) for p, p0 in zip(tr._params, before))
