"""The port's training slice against the JAX package's, on the CPU.

Each module of the ResNet-50 training step (BatchNorm in training, the
cross-entropy, the SGD step, the regimes, the weight-decay mask) is held to
its JAX original on inputs drawn with numpy. Then the whole step: a narrow
ResNet-50 (``width=[8, 16, 32, 64]``, all 16 blocks, 10 classes, 32x32
inputs, batch 4) under the JAX ``Trainer`` with ``impl="pallas"`` (the
Pallas pool in interpret mode) and under the port's
``Trainer(device="cpu")``, from the same weights and batches: three float32
steps, each of the port's steps started from the JAX trainer's state before
that step (params, BN statistics, momentum), then ``validate``; and the bf16
forward and backward of single blocks.

Tolerances. Module by module: float32 1e-5 (BN's moments and normalisation,
the loss), 1e-6 for the SGD step (the same float32 arithmetic), bf16 1e-2
(one bf16 ulp is 2^-8 relative). The whole step is held to what float32 can
give at this size, measured by ``scripts/port_numerics.py``: at
initialisation the narrow net amplifies rounding about a thousandfold (a
1e-7 relative change of the input moves the logits by 1.3e-4), so the
first step's loss agrees to 5.2e-5, its updates to 2.4e-3 in norm (5.5e-3
in the worst tensor) and its BN statistics to 3.4e-4; the later steps agree
more closely. Run free, the trajectories part: a 1e-7 input change alone
moves the third step's loss by 8%, which is why each step starts from the
JAX state. The tolerances below are two to four times those figures. The
whole bf16 step is not compared: from the same weights the two bf16 losses
are 6.7% apart, bf16 rounding amplified the same way; single blocks are.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import models as jax_models
from convnet_tpu import ops as jops
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.regimes import regime as jax_regime
from convnet_tpu.regimes import schedules as jax_schedules
from convnet_tpu.train import losses as jax_losses
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu.core.module import Context
from convnet_tpu.utils.param_filter import wd_mask as jax_wd_mask
from convnet_tpu_torch import models, ops
from convnet_tpu_torch.nn import BatchNorm2d
from convnet_tpu_torch.regimes import optim, regime, schedules
from convnet_tpu_torch.train import losses
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.from_jax import from_jax_params, to_jax_params
from convnet_tpu_torch.utils.param_filter import wd_mask

NARROW = {"depth": 50, "width": [8, 16, 32, 64], "num_classes": 10}
SIZE, BATCH, STEPS = 32, 4, 3
# one step from the same state: loss (relative), each tensor's update
# (largest error over largest update), all updates (in norm), BN statistics
LOSS_TOL, UPDATE_TOL, UPDATE_NORM_TOL, STAT_TOL = 1e-4, 2e-2, 1e-2, 1e-3
# bf16 block outputs and gradients in norm: the two differ from the float32
# computation of the same block by up to 22% (BN's backward cancels in
# bf16) and from each other by at most 1.04% (scripts/port_numerics.py)
BF16_BLOCK_TOL = 2e-2
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rng(seed):
    return np.random.default_rng(seed)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# -------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax(dtype):
    rng = _rng(0)
    x = (rng.standard_normal((4, 5, 6, 8)) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    mean = rng.standard_normal(8).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)

    def jax_bn(x_, s_, b_):
        return jops.batch_norm_train(x_, s_, b_, jnp.asarray(mean),
                                     jnp.asarray(var), momentum=0.1)

    (y_ref, m_ref, v_ref), vjp = jax.vjp(
        jax_bn, jnp.asarray(x, JNP[dtype]), jnp.asarray(scale),
        jnp.asarray(bias))
    dx_ref, ds_ref, db_ref = vjp((jnp.asarray(dy, JNP[dtype]),
                                 jnp.zeros(8), jnp.zeros(8)))

    xt = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y, m, v = ops.batch_norm_train(xt, st, bt, torch.from_numpy(mean),
                                   torch.from_numpy(var), momentum=0.1)
    y.backward(torch.from_numpy(dy).to(TORCH[dtype]))
    assert y.dtype == TORCH[dtype] and not m.requires_grad
    tol = 1e-5 if dtype == "float32" else 1e-2
    for out, ref in ((y, y_ref), (m, m_ref), (v, v_ref), (xt.grad, dx_ref),
                     (st.grad, ds_ref), (bt.grad, db_ref)):
        np.testing.assert_allclose(out.detach().float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)


def test_batch_norm_module_updates_its_statistics_in_training():
    bn = BatchNorm2d(3)
    x = torch.from_numpy(_rng(1).standard_normal((2, 4, 4, 3))
                         .astype(np.float32) * 2 + 1)
    y = bn(x)
    _, m, v = ops.batch_norm_train(x, None, None, torch.zeros(3),
                                   torch.ones(3))
    torch.testing.assert_close(bn.running_mean, m)
    torch.testing.assert_close(bn.running_var, v)
    assert bn.running_mean.dtype == torch.float32 and y.shape == x.shape


# ----------------------------------------------------------------- loss

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("smooth_eps", [0.0, 0.1])
def test_cross_entropy_hard_targets_match_jax(reduction, smooth_eps):
    rng = _rng(2)
    logits = (rng.standard_normal((6, 10)) * 3).astype(np.float32)
    target = rng.integers(0, 10, 6)
    target[[1, 4]] = -100                          # ignored rows
    ref = jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(target),
                                   reduction=reduction, smooth_eps=smooth_eps)
    out = losses.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(target), reduction=reduction,
                               smooth_eps=smooth_eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_soft_targets_match_jax(dtype):
    """bf16 logits: both compute in float32 from the same bf16 values."""
    rng = _rng(3)
    logits = rng.standard_normal((5, 7)).astype(np.float32)
    soft = rng.dirichlet(np.ones(7), 5).astype(np.float32)
    ref = jax_losses.cross_entropy(jnp.asarray(logits, JNP[dtype]),
                                   jnp.asarray(soft), smooth_eps=0.2)
    out = losses.CrossEntropyLoss(smooth_eps=0.2)(
        torch.from_numpy(logits).to(TORCH[dtype]), torch.from_numpy(soft))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


# ------------------------------------------------------ SGD and regimes

@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("hp_over", [
    {"momentum": 0.9},
    {"momentum": 0.9, "dampening": 0.3, "weight_decay": 1e-2},
    {"momentum": 0.8, "decoupled_weight_decay": 0.05, "lr": 0.3},
])
def test_sgd_step_matches_jax(nesterov, hp_over):
    rng = _rng(4)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    mask = [True, False, True]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    mu0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(2)]
    hp = {**optim.HP_DEFAULTS, **hp_over}

    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    jstate = {"step": jnp.int32(0),
              "mu": {str(i): jnp.asarray(m) for i, m in enumerate(mu0)}}
    mask01 = {str(i): jnp.float32(m) for i, m in enumerate(mask)}
    jhp = {k: jnp.float32(v) for k, v in hp.items()}

    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = {"step": 0, "mu": [torch.from_numpy(m.copy()) for m in mu0]}
    for g in grads:
        jp, jstate = jax_optim.sgd_step(
            jp, {str(i): jnp.asarray(a) for i, a in enumerate(g)}, jstate,
            jhp, nesterov=nesterov, mask01=mask01)
        optim.sgd_step(tp, [torch.from_numpy(a) for a in g], tstate, hp,
                       nesterov=nesterov, mask=mask)
    assert tstate["step"] == int(jstate["step"]) == 2
    for i, p in enumerate(tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[str(i)]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tstate["mu"][i].numpy(),
                                   np.asarray(jstate["mu"][str(i)]),
                                   rtol=1e-6, atol=1e-6)


def test_clip_by_global_norm_matches_jax():
    rng = _rng(5)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (7,))]
    for max_norm in (-1.0, 1.0, 1e3):
        ref, ref_norm = jax_optim.clip_by_global_norm(
            [jnp.asarray(g) for g in grads], jnp.float32(max_norm))
        tg = [torch.from_numpy(g.copy()) for g in grads]
        norm = optim.clip_by_global_norm(tg, max_norm)
        np.testing.assert_allclose(norm.item(), float(ref_norm), rtol=1e-6)
        for a, b in zip(tg, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("epoch", [0, 30, 60, 80])
def test_resnet50_normal_regime_hyperparams_match_jax(epoch):
    ours = optim.OptimRegime(models.build("resnet", depth=50).regime)
    theirs = jax_optim.OptimRegime(
        jax_models.build("resnet", depth=50).regime)
    ours.update(epoch, 0)
    theirs.update(epoch, 0)
    assert ours.optimizer_name == theirs.optimizer_name == "SGD"
    assert ours.hyperparams() == theirs.hyperparams()


@pytest.mark.parametrize("name", ["normal", "small", "mixmatch", "large",
                                  "cosine", "lars"])
def test_embedded_regimes_match_jax(name):
    ours = models.build("resnet", depth=18, regime=name,
                        batch_size=512).regime
    theirs = jax_models.build("resnet", depth=18, regime=name,
                              batch_size=512).regime
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            if callable(a[key]):
                for e, s in ((0, 0), (3, 100), (40, 10 ** 5), (90, 10 ** 6)):
                    assert a[key](e, s) == b[key](e, s)
            else:
                assert a[key] == b[key]


def test_pure_python_copies_match_jax():
    for port_mod, jax_mod in ((regime, jax_regime),
                              (schedules, jax_schedules)):
        ours = inspect.getsource(port_mod).split('"""', 2)[2]
        theirs = inspect.getsource(jax_mod).split('"""', 2)[2]
        assert ours == theirs, port_mod.__name__
    rescaled = regime.rescale_regime_lr(
        models.build("resnet", depth=18, regime="cosine").regime, 0.05)
    assert rescaled[0]["lr"].base_lr == pytest.approx(0.05)


def test_other_optimizers_are_refused():
    """Every optimizer of the JAX package is ported; a name outside them is
    refused where the state is made and where the step is looked up."""
    reg = optim.OptimRegime([{"epoch": 0, "optimizer": "Adagrad", "lr": 1e-3}])
    with pytest.raises(ValueError, match="unknown optimizer 'Adagrad'"):
        reg.init_state([torch.zeros(2)])
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.optimizer_step("Adagrad")


# ---------------------------------------------- weight-decay mask, names

def _jax_names(tree):
    """JAX leaf paths → the port's state_dict names, in leaf order."""
    arrays = {}
    for path, v in _leaves(tree):
        node = arrays
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.zeros(np.shape(v))
    return list(from_jax_params(arrays))


def test_wd_mask_matches_jax():
    model = jax_models.build("resnet", depth=50)
    params, _ = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    theirs = dict(zip(_jax_names(params),
                      (v for _, v in _leaves(jax_wd_mask(params)))))
    ours = wd_mask(models.build("resnet", depth=50))
    assert ours == theirs
    assert sum(ours.values()) == 54      # 53 convs and the fc weight


@pytest.fixture(scope="module")
def jax_weights():
    """The narrow ResNet-50's weights drawn by the port from seed 3, as the
    JAX package's params and state (numpy)."""
    return to_jax_params(_port_trainer("float32").model.state_dict())


def test_to_jax_params_inverts_from_jax_params(jax_weights):
    params, state = jax_weights
    back_p, back_s = to_jax_params(from_jax_params(params, state))
    for tree, back in ((params, back_p), (state, back_s)):
        ref = dict(_leaves(tree))
        got = dict(_leaves(back))
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))


# ------------------------------------------------------- the whole slice

def _batches(n, seed=7):
    rng = _rng(seed)
    return [(rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32),
             rng.integers(0, NARROW["num_classes"], BATCH).astype(np.int32))
            for _ in range(n)]


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jax_trajectory(dtype, batches, params, state):
    """The JAX trainer (Pallas pool in interpret mode) over ``batches``:
    for each step its loss and the params, state and momentum before and
    after it; then validate() on the first batch at the final state."""
    model = jax_models.build("resnet", **NARROW)
    tr = JaxTrainer(model, jax_optim.OptimRegime(model.regime),
                    NARROW["num_classes"],
                    JaxTrainerConfig(dtype=dtype, impl="pallas",
                                     print_freq=0))
    params, state, opt_state = tr.initialize(params, state)
    tr.optim.update(0, 0)
    hp = tr._hp_device(tr.optim.hyperparams())
    step = tr._get_train_step()
    steps = []
    for x, y in batches:
        before = _numpy((params, state, opt_state["mu"]))
        params, state, opt_state, m = step(
            params, state, opt_state, jnp.asarray(x), jnp.asarray(y), hp,
            jax.random.PRNGKey(0))
        steps.append((before, float(m["loss"]), _numpy((params, state))))
    val = tr.validate(batches[:1], params, state)
    return steps, _numpy((params, state)), val


def _port_trainer(dtype):
    model = models.build("resnet", **NARROW)
    tr = Trainer(model, optim.OptimRegime(model.regime),
                 NARROW["num_classes"], TrainerConfig(dtype=dtype,
                                                      print_freq=0),
                 device="cpu", seed=3)
    tr.initialize()
    return tr


def _load(tr, params, state, mu):
    """Puts the JAX trainer's params, BN statistics and momentum into the
    port's trainer."""
    tr.model.load_state_dict(from_jax_params(params, state))
    by_name = from_jax_params(mu)
    names = [n for n, _ in tr.model.named_parameters()]
    tr.opt_state["mu"] = [by_name[n].clone() for n in names]


@pytest.fixture(scope="module")
def trajectory(jax_weights):
    """Three float32 steps of both trainers, then validate(). Each of the
    port's steps starts from the JAX trainer's state before that step."""
    params, state = jax_weights
    batches = _batches(STEPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CONVNET_TPU_PALLAS_POOL", "1")
        mp.setenv("CONVNET_TPU_PALLAS_FUSED", "1")
        steps, final, j_val = _jax_trajectory("float32", batches, params,
                                              state)
        tr = _port_trainer("float32")
        ours = []
        for (before, _, _), (x, y) in zip(steps, batches):
            _load(tr, *before)
            loss = float(tr.train_step(x, y)["loss"])
            ours.append((loss, to_jax_params(tr.model.state_dict())))
        _load(tr, *final, before[2])
        return steps, ours, j_val, tr.validate(batches[:1])


def _updates(before, after):
    return {k: after[k] - before[k] for k in before}


def test_slice_float32_steps_match_jax(trajectory):
    steps, ours, _, _ = trajectory
    for i, ((before, j_loss, (j_p, j_s)), (loss, (p, s))) in enumerate(
            zip(steps, ours)):
        np.testing.assert_allclose(loss, j_loss, rtol=LOSS_TOL)
        p0 = dict(_leaves(before[0]))
        ref = _updates(p0, dict(_leaves(j_p)))
        got = _updates(p0, dict(_leaves(p)))
        assert ref.keys() == got.keys()
        for k in ref:
            err = np.abs(got[k] - ref[k]).max()
            assert err <= UPDATE_TOL * np.abs(ref[k]).max() + 1e-6, (i, k)
        assert _norm_err(np.concatenate([got[k].ravel() for k in ref]),
                         np.concatenate([ref[k].ravel() for k in ref])
                         ) <= UPDATE_NORM_TOL, i
        ref_s, got_s = dict(_leaves(j_s)), dict(_leaves(s))
        for k in ref_s:
            np.testing.assert_allclose(got_s[k], ref_s[k], rtol=STAT_TOL,
                                       atol=STAT_TOL, err_msg=str((i, k)))


def test_slice_validate_matches_jax(trajectory):
    *_, j_val, val = trajectory
    assert val["prec1"] == j_val["prec1"] and val["prec5"] == j_val["prec5"]
    np.testing.assert_allclose(val["loss"], j_val["loss"], rtol=1e-4)


def _blocks(jax_model, port_model, params, state):
    """(name, JAX block, port block, its params, its state) for the stem,
    the 16 bottlenecks and the head, in forward order."""
    yield "stem", jax_model.stem, port_model.stem, params["stem"], \
        state["stem"]
    for stage, j_stage in jax_model.layers.children():
        for i, j_block in j_stage.children():
            yield (f"{stage}.{i}", j_block,
                   getattr(getattr(port_model.layers, stage), i),
                   params["layers"][stage][i], state["layers"][stage][i])


def _norm_err(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_slice_bf16_blocks_match_jax(jax_weights):
    """The bf16 training forward and backward of the stem, the first block
    (with its downsample) and the deepest strided block, each from the same
    bf16 input and output gradient: output, input gradient and each
    parameter gradient within ``BF16_BLOCK_TOL`` of the JAX block's, in
    norm. JAX runs op by op here, so both round to bf16 after every op
    (under ``jit`` XLA may keep float32 between fused ops)."""
    params, state = jax_weights
    j_model = jax_models.build("resnet", **NARROW)
    port = models.build("resnet", **NARROW)
    port.load_state_dict(from_jax_params(params, state))
    port.train()
    ctx = Context(train=True)
    checked = {"stem", "layer1.0", "layer4.0"}
    h = torch.from_numpy(_batches(1)[0][0]).to(torch.bfloat16)
    for name, j_block, p_block, p, s in _blocks(j_model, port, params,
                                                 state):
        if name in checked:
            _check_bf16_block(name, j_block, p_block, p, s, h, ctx)
        with torch.no_grad():
            h = p_block(h)


def _check_bf16_block(name, j_block, p_block, p, s, h, ctx):
    hj = jnp.asarray(h.float().numpy(), jnp.bfloat16)
    out, vjp = jax.vjp(lambda a, b: j_block(a, s, b, ctx)[0], p, hj)
    dy = _rng(len(name)).standard_normal(out.shape).astype(np.float32)
    j_gp, j_gh = vjp(jnp.asarray(dy, jnp.bfloat16))
    ht = h.detach().clone().requires_grad_()
    o = p_block(ht)
    o.backward(torch.from_numpy(dy).to(torch.bfloat16))
    grads = {n: q.grad for n, q in p_block.named_parameters()}
    g_tree, _ = to_jax_params({**grads, **dict(p_block.named_buffers())})
    ours = {"out": o.detach(), "dx": ht.grad, **{
        k: torch.from_numpy(v) for k, v in _leaves(g_tree)}}
    theirs = {"out": out, "dx": j_gh, **dict(_leaves(j_gp))}
    assert ours.keys() == theirs.keys()
    for k, ref in theirs.items():
        err = _norm_err(ours[k].float().numpy(), np.asarray(ref, np.float32))
        assert err <= BF16_BLOCK_TOL, (name, k, err)


def test_train_epoch_runs_the_regime():
    model = models.build("resnet", **NARROW)
    tr = Trainer(model, optim.OptimRegime(model.regime), 10,
                 TrainerConfig(print_freq=0), device="cpu")
    tr.initialize()
    res = tr.train_epoch(_batches(2, seed=9), epoch=0)
    assert tr.training_steps == 2 and np.isfinite(res["loss"])
    assert set(res) >= {"loss", "prec1", "prec5", "grad_norm",
                        "step_time_p50", "img_per_sec"}


def test_trainer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = models.build("resnet", **NARROW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, optim.OptimRegime(model.regime), 10)
