"""The port's ResNeXt, zero-init-residual ResNet and MobileNet v1 against
the JAX package's, on the CPU.

Weights are drawn by one package (BatchNorm statistics redrawn with numpy
where the test runs in eval, so that folding is not the identity) and
carried across with ``from_jax_params``. The JAX models run their default
XLA route, which computes the same functions as the Pallas kernels (those
are held to the port's kernel modules in interpret mode in
``test_torch_port_grouped.py`` and ``test_torch_port_depthwise.py``;
interpret mode over a whole model is too slow here). The port takes its
kernel routes, which run the kernels' plain versions on CPU tensors.

Tolerances. Eval forwards: 1e-4 of the largest |logit| (float32, summation
order only). ResNeXt training: three float32 SGD steps, each of the port's
from the JAX trainer's state before it, then ``validate``. The loss and the
BN statistics keep ``tests/test_torch_port_train.py``'s tolerances; the
updates are held in norm, overall and per tensor, because float32 cannot
hold this net's first step element by element (``scripts/port_numerics.py
resnext``): at batch 8 the port's float32 step is 1.6% from its float64
step in norm (2.4% in the worst tensor, 11% in the worst element), and the
two packages' first steps are 3.6% apart in norm (4.1% in the worst tensor);
the tolerances are about twice those. At batch 4 a 1e-7 input change alone
moves the train-mode logits by 9e-4 of the largest and the two first-step
losses are 1.1e-3 apart, so the steps run at batch 8. MobileNet v1:
the eval-mode loss gradient within 5e-3 of each tensor's largest entry,
tests/test_pallas.py's terms (train-mode BatchNorm over a batch of 2 at 1x1
spatial size is ill-conditioned, as that test says), and one float32
training step's loss within 1e-4, at batch 4: at batch 2 the two losses
are 2.3e-4 apart where the port's float32 loss is 2.1e-5 from its float64
one, at batch 4 7.4e-6 and 3.9e-6 (``scripts/port_numerics.py
mobilenet``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import models as jax_models
from convnet_tpu.core.module import Context
from convnet_tpu.core.module import param_count as jax_param_count
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu.utils.param_filter import wd_mask as jax_wd_mask
from convnet_tpu_torch import models
from convnet_tpu_torch.core.module import init_parameters, param_count
from convnet_tpu_torch.models.resnet import ConvBN
from convnet_tpu_torch.nn import Conv2d
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.from_jax import from_jax_params, to_jax_params
from convnet_tpu_torch.utils.param_filter import wd_mask

RESNEXT = {"depth": 50, "width": [64, 128, 256, 512], "groups": 16,
           "num_classes": 10}
MOBILENET = {"width": 0.25, "num_classes": 10}
ZI = {"depth": 50, "width": [8, 16, 32, 64], "num_classes": 10}
SIZE, STEPS = 32, 3
TRAIN_BATCH = 8
# one step from the same state: loss (relative), all updates and each
# tensor's update (in norm), BN statistics
LOSS_TOL, UPDATE_NORM_TOL, TENSOR_NORM_TOL, STAT_TOL = 1e-4, 8e-2, 1e-1, 1e-3
LOGIT_TOL = 1e-4
GRAD_TOL = 5e-3


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jax_init(name, config, seed=0, redraw_stats=False):
    params, state = jax_models.build(name, **config).init(
        jax.random.PRNGKey(seed))
    params, state = _numpy(params), _numpy(state)
    if redraw_stats:
        rng = np.random.default_rng(seed)
        draw = {"scale": lambda s: rng.uniform(0.5, 1.5, s),
                "bias": lambda s: rng.normal(0.0, 0.2, s),
                "mean": lambda s: rng.normal(0.0, 0.2, s),
                "var": lambda s: rng.uniform(0.5, 2.0, s)}

        def redraw(tree, bn_leaves):
            return {k: redraw(v, bn_leaves) if isinstance(v, dict) else
                    (draw[k](v.shape).astype(np.float32)
                     if k in bn_leaves else v)
                    for k, v in tree.items()}

        params = redraw(params, ("scale", "bias"))
        state = redraw(state, ("mean", "var"))
    return params, state


def _port(name, config, params, state):
    model = models.build(name, **config)
    model.load_state_dict(from_jax_params(params, state))
    return model


def _images(batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, SIZE, SIZE, 3)).astype(np.float32)


def _eval_logits_match(name, config, params, state, batch, seed):
    x = _images(batch, seed)
    model = jax_models.build(name, **config)
    ref = jax.jit(lambda p, s, a: model(p, s, a, Context(train=False))[0])(
        params, state, jnp.asarray(x))
    model = _port(name, config, params, state).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= LOGIT_TOL * np.abs(ref).max()


# ------------------------------------------------------------- ResNeXt

def test_resnext_eval_forward_matches_jax():
    params, state = _jax_init("resnext", RESNEXT, redraw_stats=True)
    model = _port("resnext", RESNEXT, params, state).eval()
    routed = [m for m in model.modules()
              if isinstance(m, Conv2d) and m.uses_grouped_kernel()]
    assert len(routed) == 13 - 3        # stage 1 (64 channels) stays off
    _eval_logits_match("resnext", RESNEXT, params, state, 4, 1)


def _batches(n, batch, num_classes, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, SIZE, SIZE, 3)).astype(np.float32),
             rng.integers(0, num_classes, batch).astype(np.int32))
            for _ in range(n)]


def _jax_trainer(name, config):
    model = jax_models.build(name, **config)
    return JaxTrainer(model, jax_optim.OptimRegime(model.regime),
                      config["num_classes"],
                      JaxTrainerConfig(dtype="float32", print_freq=0))


def _jax_steps(tr, batches, params, state):
    """For each batch: the state before the step, its loss, and the params
    and state after it; then the final state."""
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
    return steps, params, state


def _port_trainer(name, config, params, state):
    model = models.build(name, **config)
    tr = Trainer(model, optim.OptimRegime(model.regime),
                 config["num_classes"],
                 TrainerConfig(dtype="float32", print_freq=0), device="cpu")
    tr.initialize(from_jax_params(params, state))
    return tr


def _load(tr, params, state, mu):
    tr.model.load_state_dict(from_jax_params(params, state))
    by_name = from_jax_params(mu)
    names = [n for n, _ in tr.model.named_parameters()]
    tr.opt_state["mu"] = [by_name[n].clone() for n in names]


@pytest.fixture(scope="module")
def resnext_trajectory():
    """Three float32 steps of both trainers on the narrow ResNeXt, each of
    the port's from the JAX state before it; then validate() on the first
    batch at the final state in both."""
    params, state = _jax_init("resnext", RESNEXT, seed=3)
    batches = _batches(STEPS, TRAIN_BATCH, RESNEXT["num_classes"])
    j_tr = _jax_trainer("resnext", RESNEXT)
    steps, j_params, j_state = _jax_steps(j_tr, batches, params, state)
    j_val = j_tr.validate(batches[:1], j_params, j_state)
    tr = _port_trainer("resnext", RESNEXT, params, state)
    ours = []
    for (before, _, _), (x, y) in zip(steps, batches):
        _load(tr, *before)
        loss = float(tr.train_step(x, y)["loss"])
        ours.append((loss, to_jax_params(tr.model.state_dict())))
    _load(tr, *_numpy((j_params, j_state)), before[2])
    return steps, ours, j_val, tr.validate(batches[:1])


def _norm_err(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_resnext_float32_steps_match_jax(resnext_trajectory):
    steps, ours, _, _ = resnext_trajectory
    for i, ((before, j_loss, (j_p, j_s)), (loss, (p, s))) in enumerate(
            zip(steps, ours)):
        np.testing.assert_allclose(loss, j_loss, rtol=LOSS_TOL)
        p0 = dict(_leaves(before[0]))
        ref = {k: v - p0[k] for k, v in _leaves(j_p)}
        got = {k: v - p0[k] for k, v in _leaves(p)}
        assert ref.keys() == got.keys()
        for k in ref:
            assert _norm_err(got[k], ref[k]) <= TENSOR_NORM_TOL, (i, k)
        assert _norm_err(np.concatenate([got[k].ravel() for k in ref]),
                         np.concatenate([ref[k].ravel() for k in ref])
                         ) <= UPDATE_NORM_TOL, i
        ref_s, got_s = dict(_leaves(j_s)), dict(_leaves(s))
        for k in ref_s:
            np.testing.assert_allclose(got_s[k], ref_s[k], rtol=STAT_TOL,
                                       atol=STAT_TOL, err_msg=str((i, k)))


def test_resnext_validate_matches_jax(resnext_trajectory):
    *_, j_val, val = resnext_trajectory
    assert val["prec1"] == j_val["prec1"] and val["prec5"] == j_val["prec5"]
    np.testing.assert_allclose(val["loss"], j_val["loss"], rtol=1e-4)


# ----------------------------------------------------------- MobileNet v1

@pytest.fixture(scope="module")
def mobilenet_weights():
    return _jax_init("mobilenet", MOBILENET, seed=0, redraw_stats=True)


def test_mobilenet_eval_forward_matches_jax(mobilenet_weights):
    _eval_logits_match("mobilenet", MOBILENET, *mobilenet_weights, 2, 1)


def test_mobilenet_eval_gradients_match_jax(mobilenet_weights):
    """The gradient of mean(logits²) in eval mode: every parameter's within
    5e-3 of its largest entry (the terms of tests/test_pallas.py)."""
    params, state = mobilenet_weights
    x = _images(2, 1)
    j_model = jax_models.build("mobilenet", **MOBILENET)

    def loss(p):
        y, _ = j_model(p, state, jnp.asarray(x), Context(train=False))
        return jnp.mean(jnp.square(y.astype(jnp.float32)))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, params))
    ref = from_jax_params(_numpy(j_grads))
    model = _port("mobilenet", MOBILENET, params, state).eval()
    out = model(torch.from_numpy(x)).float().square().mean()
    out.backward()
    np.testing.assert_allclose(out.item(), float(j_loss), rtol=1e-4)
    grads = dict(model.named_parameters())
    assert ref.keys() == grads.keys()
    for name, g in ref.items():
        g = g.numpy()
        got = grads[name].grad.numpy()
        assert np.abs(got - g).max() <= GRAD_TOL * max(np.abs(g).max(),
                                                       1e-6), name


def test_mobilenet_float32_step_loss_matches_jax():
    params, state = _jax_init("mobilenet", MOBILENET, seed=2)
    batches = _batches(1, 4, MOBILENET["num_classes"], seed=9)
    steps, _, _ = _jax_steps(_jax_trainer("mobilenet", MOBILENET), batches,
                             params, state)
    tr = _port_trainer("mobilenet", MOBILENET, params, state)
    loss = float(tr.train_step(*batches[0])["loss"])
    np.testing.assert_allclose(loss, steps[0][1], rtol=LOSS_TOL)


# ------------------------------------------------------- zero-init residual

def test_resnet_zi_zeroes_every_residual_branch_and_matches_jax():
    params, state = _jax_init("resnet_zi", ZI)
    model = models.build("resnet_zi", **ZI)
    init_parameters(model, torch.Generator().manual_seed(0))
    blocks = [(stage, i) for stage in model.layers._modules
              for i in getattr(model.layers, stage)._modules]
    assert len(blocks) == 16
    for stage, i in blocks:
        assert not params["layers"][stage][i]["cb3"]["bn"]["scale"].any()
        port_bn = getattr(model.layers, stage)._modules[i].cb3.bn
        assert not port_bn.weight.any()
        assert getattr(model.layers, stage)._modules[i].cb1.bn.weight.all()
    _eval_logits_match("resnet_zi", ZI, params, state, 2, 3)


# ------------------------------------------------- registry, names, masks

def test_registry_knows_the_new_models():
    for name in ("resnet", "resnext", "resnet_zi", "mobilenet"):
        assert models.REGISTRY[name].__name__ == \
            jax_models.REGISTRY[name].__name__


@pytest.mark.parametrize("name,config", [("resnext", RESNEXT),
                                         ("mobilenet", MOBILENET)])
def test_weights_round_trip(name, config):
    """JAX weights → the port's state_dict (strict load) → JAX weights,
    unchanged; grouped and depthwise HWIO (kh, kw, cin/g, C) become OIHW
    (C, cin/g, kh, kw)."""
    params, state = _jax_init(name, config)
    model = _port(name, config, params, state)
    assert param_count(model) == jax_param_count(params)
    back_p, back_s = to_jax_params(model.state_dict())
    for tree, back in ((params, back_p), (state, back_s)):
        ref, got = dict(_leaves(tree)), dict(_leaves(back))
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    conv = dict(model.named_modules())["layers.layer2.0.cb2.conv"
                                       if name == "resnext" else
                                       "features.2.dw.conv"]
    w = conv.weight.detach().numpy()
    key = (("layers", "layer2", "0", "cb2", "conv", "w") if name == "resnext"
           else ("features", "2", "dw", "conv", "w"))
    np.testing.assert_array_equal(w.transpose(2, 3, 1, 0),
                                  dict(_leaves(params))[key])
    assert w.shape[1] == conv.in_channels // conv.groups


def _jax_names(tree):
    arrays = {}
    for path, v in _leaves(tree):
        node = arrays
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.zeros(np.shape(v))
    return list(from_jax_params(arrays))


@pytest.mark.parametrize("name,n_decayed", [("resnext", 54),
                                            ("mobilenet", 28)])
def test_wd_mask_matches_jax(name, n_decayed):
    """Full width: every conv weight (grouped and depthwise too) and the fc
    weight are decayed; BN parameters and biases are not."""
    params, _ = jax.eval_shape(jax_models.build(name).init,
                               jax.random.PRNGKey(0))
    theirs = dict(zip(_jax_names(params),
                      (v for _, v in _leaves(jax_wd_mask(params)))))
    ours = wd_mask(models.build(name))
    assert ours == theirs
    assert sum(ours.values()) == n_decayed


@pytest.mark.parametrize("name,grouped,depthwise,fused", [
    ("resnext", 13, 0, 33), ("mobilenet", 0, 13, 13)])
def test_full_width_routes(name, grouped, depthwise, fused):
    """Counted without a forward: the convs each route takes in eval, and
    in training (where only the depthwise route stays)."""
    model = models.build(name)
    for train in (False, True):
        model.train(train)
        convs = [m for m in model.modules() if isinstance(m, Conv2d)]
        assert sum(c.uses_grouped_kernel() for c in convs) == \
            (0 if train else grouped)
        assert sum(c.uses_depthwise_kernel() for c in convs) == depthwise
        assert sum(m.uses_kernel() for m in model.modules()
                   if isinstance(m, ConvBN)) == (0 if train else fused)
