"""The port's MobileNet-V2, RMSprop, Dropout and ``ConvBN(act="relu6")``
against the JAX package's, on the CPU.

Weights are drawn by the JAX package (BatchNorm statistics redrawn with
numpy for the eval test, so that folding is not the identity) and carried
across with ``from_jax_params``. The JAX model runs its default XLA route
(no env flag), the port its fused MBConv route, which runs the kernels'
plain versions on CPU tensors (those are held to the Pallas kernels in
interpret mode in ``test_torch_port_mbconv.py``).

Tolerances (``scripts/port_numerics.py mobilenet_v2`` measured them on this
narrow net: width 0.25, 10 classes, 64x64 inputs, dropout 0). Eval logits:
1e-4 of the largest |logit|, float32 summation order only. One float32
RMSprop step from the same weights at batch 8: the loss within 1e-4 (8.7e-7
measured), the BN running statistics within 1e-4 (1.1e-5), and the updates
held in norm: 5e-2 overall (2.5% measured) and 8e-2 for each tensor (3.7%),
each tensor's error taken over its update's norm plus 1e-4 of the norm of
all updates (the shifts of the project BNs that feed the next block's
expand BN have a zero gradient, so their updates are rounding noise). The
port's float32 step is 0.1% from its float64 step in norm; the JAX step is
2.4% from the port's float64 step, since its BatchNorm takes the moments in
float32 whatever the policy, and the narrow net's BNs over a few pixels
amplify that. RMSprop: three steps on fixed gradients, 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import models as jax_models
from convnet_tpu.core.module import Context
from convnet_tpu.core.module import param_count as jax_param_count
from convnet_tpu.models.mobilenet_v2 import ConvBNReLU6 as JaxConvBNReLU6
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu.utils.param_filter import wd_mask as jax_wd_mask
from convnet_tpu_torch import models
from convnet_tpu_torch.core.module import param_count
from convnet_tpu_torch.models.mobilenet_v2 import (ConvBNReLU6,
                                                   InvertedResidual)
from convnet_tpu_torch.models.resnet import ConvBN
from convnet_tpu_torch.nn import Conv2d, Dropout, ReLU6
from convnet_tpu_torch.ops.kernels import mbconv
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.from_jax import from_jax_params, to_jax_params
from convnet_tpu_torch.utils.param_filter import wd_mask

CONFIG = {"width": 0.25, "num_classes": 10, "dropout": 0.0}
SIZE, BATCH = 64, 8
LOGIT_TOL = 1e-4
LOSS_TOL, STAT_TOL, UPDATE_NORM_TOL, TENSOR_NORM_TOL = 1e-4, 1e-4, 5e-2, 8e-2
TENSOR_FLOOR = 1e-4     # of the norm of all updates


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def jax_init(config=CONFIG, seed=0, redraw_stats=False):
    params, state = jax_models.build("mobilenet_v2", **config).init(
        jax.random.PRNGKey(seed))
    params, state = _numpy(params), _numpy(state)
    if redraw_stats:
        rng = np.random.default_rng(seed)
        draw = {"mean": lambda s: rng.normal(0.0, 0.2, s),
                "var": lambda s: rng.uniform(0.5, 2.0, s)}

        def redraw(tree):
            return {k: redraw(v) if isinstance(v, dict) else
                    draw[k](v.shape).astype(np.float32)
                    for k, v in tree.items()}

        state = redraw(state)
    return params, state


def images(batch, seed, size=SIZE):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def batch(n, seed=9, size=SIZE, num_classes=CONFIG["num_classes"]):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3)).astype(np.float32),
            rng.integers(0, num_classes, n).astype(np.int32))


def jax_step(params, state, x, y, config=CONFIG):
    """One float32 step of the JAX trainer: (loss, params, state)."""
    model = jax_models.build("mobilenet_v2", **config)
    tr = JaxTrainer(model, jax_optim.OptimRegime(model.regime),
                    config["num_classes"],
                    JaxTrainerConfig(dtype="float32", print_freq=0))
    p, s, opt_state = tr.initialize(params, state)
    tr.optim.update(0, 0)
    hp = tr._hp_device(tr.optim.hyperparams())
    p, s, _, m = tr._get_train_step()(p, s, opt_state, jnp.asarray(x),
                                      jnp.asarray(y), hp,
                                      jax.random.PRNGKey(0))
    return float(m["loss"]), _numpy(p), _numpy(s)


def port_trainer(params, state, config=CONFIG):
    model = models.build("mobilenet_v2", **config)
    tr = Trainer(model, optim.OptimRegime(model.regime),
                 config["num_classes"],
                 TrainerConfig(dtype="float32", print_freq=0), device="cpu")
    tr.initialize(from_jax_params(params, state))
    return tr


def norm_err(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------------ model

def test_full_width_model_and_routes():
    """3,504,872 parameters; 13 of the 17 blocks fused in both modes; in
    eval the other routes a forward takes: 9 fused 1x1 ConvBNs (the 4
    stride-2 blocks' expand and project, and the last 320→1280) and 4
    depthwise convs, all inside the stride-2 blocks."""
    model = models.build("mobilenet_v2")
    assert param_count(model) == 3_504_872
    blocks = [m for m in model.modules() if isinstance(m, InvertedResidual)]
    fused = [b for b in blocks if b.uses_kernel()]
    assert len(blocks) == 17 and len(fused) == 13
    assert [(b.block[0].conv.in_channels, b.hidden, b.block[-1].conv
             .out_channels, b.use_res) for b in fused][:3] == \
        [(32, 32, 16, False), (24, 144, 24, True), (32, 192, 32, True)]
    inside = {id(m) for b in fused for m in b.modules()}
    for train in (False, True):
        model.train(train)
        routed = [m for m in model.modules() if id(m) not in inside]
        assert sum(isinstance(m, ConvBN) and m.uses_kernel()
                   for m in routed) == (0 if train else 9)
        assert sum(isinstance(m, Conv2d) and m.uses_depthwise_kernel()
                   for m in routed) == 4


def test_registry_names_and_weight_round_trip():
    assert models.REGISTRY["mobilenet_v2"].__name__ == \
        jax_models.REGISTRY["mobilenet_v2"].__name__
    params, state = jax_init()
    model = models.build("mobilenet_v2", **CONFIG)
    model.load_state_dict(from_jax_params(params, state))
    assert param_count(model) == jax_param_count(params)
    back_p, back_s = to_jax_params(model.state_dict())
    for tree, back in ((params, back_p), (state, back_s)):
        ref, got = dict(_leaves(tree)), dict(_leaves(back))
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    w = dict(model.named_modules())["features.2.block.1.conv"].weight
    assert tuple(w.shape) == (48, 1, 3, 3)


def test_wd_mask_matches_jax():
    """Every conv weight and the fc weight are decayed: 52 convs + fc."""
    params, _ = jax.eval_shape(jax_models.build("mobilenet_v2").init,
                               jax.random.PRNGKey(0))
    arrays = {}
    for path, v in _leaves(params):
        node = arrays
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.zeros(np.shape(v))
    theirs = dict(zip(from_jax_params(arrays),
                      (v for _, v in _leaves(jax_wd_mask(params)))))
    ours = wd_mask(models.build("mobilenet_v2"))
    assert ours == theirs and sum(ours.values()) == 53


def test_eval_logits_match_jax():
    params, state = jax_init(redraw_stats=True)
    x = images(4, 1)
    model = jax_models.build("mobilenet_v2", **CONFIG)
    ref = np.asarray(jax.jit(
        lambda p, s, a: model(p, s, a, Context(train=False))[0])(
            params, state, jnp.asarray(x)))
    port = models.build("mobilenet_v2", **CONFIG)
    port.load_state_dict(from_jax_params(params, state))
    port.eval()
    before = mbconv.full_launches
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert mbconv.full_launches == before          # CPU: plain versions
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= LOGIT_TOL * np.abs(ref).max()


@pytest.fixture(scope="module")
def first_step():
    params, state = jax_init(seed=2)
    x, y = batch(BATCH)
    j_loss, j_params, j_state = jax_step(params, state, x, y)
    tr = port_trainer(params, state)
    assert tr.optim.optimizer_name == "RMSprop"
    # the JAX package's slots for RMSprop: m and v come together
    assert set(tr.opt_state) == {"step", "mu", "m", "v"}
    loss = float(tr.train_step(x, y)["loss"])
    p, s = to_jax_params(tr.model.state_dict())
    return params, (j_loss, j_params, j_state), (loss, p, s)


def test_float32_rmsprop_step_matches_jax(first_step):
    params, (j_loss, j_params, _), (loss, p, _) = first_step
    np.testing.assert_allclose(loss, j_loss, rtol=LOSS_TOL)
    p0 = dict(_leaves(params))
    ref = {k: v - p0[k] for k, v in _leaves(j_params)}
    got = {k: v - p0[k] for k, v in _leaves(p)}
    assert ref.keys() == got.keys()
    all_ref = np.concatenate([ref[k].ravel() for k in ref])
    floor = TENSOR_FLOOR * np.linalg.norm(all_ref)
    for k in ref:
        err = np.linalg.norm(got[k] - ref[k]) / (np.linalg.norm(ref[k])
                                                 + floor)
        assert err <= TENSOR_NORM_TOL, k
    assert norm_err(np.concatenate([got[k].ravel() for k in ref]),
                    all_ref) <= UPDATE_NORM_TOL


def test_fused_blocks_update_bn_statistics_as_jax(first_step):
    """The three BNs of every fused block (features 1, 3, 5, ...) and all
    others: the running mean and variance after one step, the fused ones
    from the Gram trick and the kernels' sums with the unbiased n/(n - 1)
    correction, against the JAX model's plain step."""
    _, (_, _, j_state), (_, _, s) = first_step
    ref, got = dict(_leaves(j_state)), dict(_leaves(s))
    assert ref.keys() == got.keys()
    fused = [k for k in ref if k[:2] == ("features", "1")]
    assert len(fused) == 4                 # no expand: dw and project BNs
    assert any(k[:3] == ("features", "3", "block") for k in ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=str(k))


def test_calibrate_bn_recalibrates_fused_blocks_as_jax():
    """``calibrate_bn`` over 2 of 3 batches, from redrawn statistics: the
    fused blocks update their BNs through ``BatchNorm2d.track`` without
    calling the module, and every BN of the model (the fused ones
    included) must move and land on the JAX trainer's averages, within the
    step's STAT_TOL (2.9e-5 measured, relative to 1 + |statistic|)."""
    params, state = jax_init(seed=4, redraw_stats=True)
    batches = [batch(BATCH, seed=s) for s in (11, 12, 13)]
    model = jax_models.build("mobilenet_v2", **CONFIG)
    j_tr = JaxTrainer(model, jax_optim.OptimRegime(model.regime),
                      CONFIG["num_classes"],
                      JaxTrainerConfig(dtype="float32", print_freq=0))
    ref = dict(_leaves(_numpy(j_tr.calibrate_bn(
        batches, jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), num_steps=2))))
    tr = port_trainer(params, state)
    assert tr.calibrate_bn(batches, num_steps=2) == 2
    got = dict(_leaves(to_jax_params(tr.model.state_dict())[1]))
    before = dict(_leaves(state))
    assert ref.keys() == got.keys() == before.keys()
    assert any(k[:2] == ("features", "1") for k in got)
    for k in ref:
        assert not np.allclose(got[k], before[k]), k
        np.testing.assert_allclose(got[k], ref[k], rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=str(k))


# -------------------------------------------------------------- RMSprop

def test_rmsprop_step_matches_jax_over_three_steps():
    """Masked coupled L2 (weight_decay) and masked decoupled decay
    (decoupled_weight_decay), alpha 0.9, momentum 0.9, eps 1.0."""
    rng = np.random.default_rng(5)
    shapes = {"w": (4, 3), "b": (3,), "scale": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    mask = {"w": True, "b": False, "scale": False}
    hp = dict(optim.HP_DEFAULTS, lr=0.045, alpha=0.9, momentum=0.9, eps=1.0,
              weight_decay=1e-3, decoupled_weight_decay=4e-5)
    update = jax_optim.make_update_fn(
        "RMSprop", params, wd_mask_tree=mask)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, j_params)
    j_state = {"step": jnp.zeros((), jnp.int32), "mu": zeros, "v": zeros}
    names = list(shapes)
    p = [torch.from_numpy(params[k].copy()) for k in names]
    state = optim.OptimRegime([{"epoch": 0, "optimizer": "RMSprop"}]
                              ).init_state(p)
    for g in grads:
        j_params, j_state = update(
            j_params, jax.tree_util.tree_map(jnp.asarray, g), j_state,
            {k: jnp.float32(v) for k, v in hp.items()})
        optim.optimizer_step("RMSprop")(
            p, [torch.from_numpy(g[k]) for k in names], state, hp,
            mask=[mask[k] for k in names])
    assert state["step"] == 3
    for k, t in zip(names, p):
        np.testing.assert_allclose(t.numpy(), np.asarray(j_params[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(state["v"][names.index(k)].numpy(),
                                   np.asarray(j_state["v"][k]), rtol=1e-6)


# -------------------------------------------------------------- Dropout

def test_dropout_identity_scale_and_seed():
    x = torch.ones(64, 100)
    drop = Dropout(0.25)
    assert drop.eval()(x) is x
    assert Dropout(0.0).train()(x) is x
    drop.train()
    with pytest.raises(RuntimeError, match="Generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    y = drop(x)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)          # 1/keep
    assert 0.70 < kept.float().mean().item() < 0.80
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(drop(x), y)                  # same seed, same mask
    assert not torch.equal(drop(x), y)              # the next draw differs


def test_trainer_seeds_the_dropout_generator():
    def first_loss(seed):
        model = models.build("mobilenet_v2", width=0.25, num_classes=10)
        tr = Trainer(model, optim.OptimRegime(model.regime), 10,
                     TrainerConfig(dtype="float32", print_freq=0),
                     device="cpu", seed=seed)
        tr.initialize()
        assert model.drop.generator is tr.dropout_generator
        x, y = batch(2, size=32)
        return float(tr.train_step(x, y)["loss"])

    assert first_loss(0) == first_loss(0)


# ------------------------------------------------ ConvBN(act="relu6")

@pytest.mark.parametrize("kernel,train", [(1, False), (1, True), (3, False),
                                          (3, True)])
def test_convbn_relu6_matches_jax(kernel, train):
    """Eval 1x1 stride 1 takes the fused 1x1 route (conv1x1_bn_act with
    relu6), the rest conv → BN → ops.relu6; the output and, in training,
    the BN statistics against the JAX ConvBNReLU6."""
    j_mod = JaxConvBNReLU6(8, 16, kernel, 1, kernel // 2)
    params, state = j_mod.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(6)
    params, state = _numpy(params), _numpy(state)
    params["bn"]["scale"] = rng.uniform(2.0, 4.0, 16).astype(np.float32)
    params["bn"]["bias"] = rng.normal(0, 1, 16).astype(np.float32)
    state["bn"]["mean"] = rng.normal(0, 0.3, 16).astype(np.float32)
    x = (rng.standard_normal((2, 6, 6, 8)) * 3).astype(np.float32)
    ref, ref_state = j_mod(params, state, jnp.asarray(x), Context(train=train))
    mod = ConvBNReLU6(8, 16, kernel, 1, kernel // 2).train(train)
    mod.load_state_dict(from_jax_params(params, state))
    assert mod.act == "relu6" and mod.uses_kernel() == (kernel == 1
                                                        and not train)
    out = mod(torch.from_numpy(x)).detach().numpy()
    ref = np.asarray(ref)
    assert ref.max() == 6.0 and ref.min() == 0.0        # both ends clipped
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if train:
        np.testing.assert_allclose(mod.bn.running_var.numpy(),
                                   np.asarray(ref_state["bn"]["var"]),
                                   rtol=1e-5)
    assert ConvBNReLU6(8, 16, 1, relu6=False).act == "none"
    assert ConvBN(8, 16, 1, relu=False, act="relu6").act == "none"
    with pytest.raises(ValueError, match="act"):
        ConvBN(8, 16, 1, act="gelu")
    y = torch.tensor([-1.0, 0.0, 3.0, 6.0, 7.0])
    assert torch.equal(ReLU6()(y), torch.tensor([0.0, 0.0, 3.0, 6.0, 6.0]))
