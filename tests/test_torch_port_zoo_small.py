"""The small models of the zoo in the port against the JAX package, on the
CPU: the MNIST net, AlexNet, VGG (CIFAR and ImageNet heads) and a narrow
DenseNet. Each model's eval forward with BN folded as ``Predictor`` folds
it, and one float32 SGD step of the port's ``Trainer`` against the JAX
trainer's from the same state (the MNIST net, VGG-11 on CIFAR, DenseNet).
The helpers here serve the other ``test_torch_port_zoo_*`` files too.

Weights are drawn by the port from a torch seed (BN parameters and
statistics redrawn with numpy, so folding is not the identity) and carried to
the JAX package with ``to_jax_params``; inputs come from a numpy seed.
Dropout is set to rate 0 on both sides where a step is compared (the port
draws its masks from ``Trainer.dropout_generator``, JAX from its context
key).

Tolerances. Eval forwards: 1e-4 of the largest |logit| (float32, summation
order and the fold's rounding). Steps (measured with this file's seeds: the
loss within 2e-6, all updates within 1e-5 in norm, the worst tensor 3e-5
of its update's norm plus 1e-4 of all updates', BN statistics 5e-7): the
loss 1e-4 relative; all updates 1e-3 in norm; each tensor's update error
within 1e-2 of its own norm plus 1e-4 of all updates' (a DenseNet stem BN
scale's update is float32 cancellation, 16% of its own tiny norm); BN
statistics 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import models as jax_models
from convnet_tpu.core.module import Context
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu_torch import models
from convnet_tpu_torch.core.module import init_parameters
from convnet_tpu_torch.nn import BatchNorm2d, Dropout
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.absorb_bn import search_absorb_bn
from convnet_tpu_torch.utils.from_jax import from_jax_params, to_jax_params

LOGIT_TOL = 1e-4
LOSS_TOL, UPDATE_NORM_TOL, TENSOR_NORM_TOL, TENSOR_FLOOR = 1e-4, 1e-3, 1e-2, 1e-4
STAT_TOL = 1e-4

DENSENET = {"growth": 8, "block_config": [2, 2, 2, 2], "num_classes": 10}
VGG11_CIFAR = {"dataset": "cifar10", "depth": 11}


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def init_weights(module, seed):
    """``module``'s weights from ``seed``, its BN parameters and statistics
    redrawn with numpy. Returns ``module``."""
    init_parameters(module, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    draws = {"weight": lambda n: rng.uniform(0.5, 1.5, n),
             "bias": lambda n: rng.normal(0.0, 0.2, n),
             "running_mean": lambda n: rng.normal(0.0, 0.2, n),
             "running_var": lambda n: rng.uniform(0.5, 2.0, n)}
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm2d):
                for leaf, draw in draws.items():
                    t = getattr(m, leaf)
                    t.copy_(torch.from_numpy(
                        draw(t.shape[0]).astype(np.float32)))
    return module


def port_model(name, config, seed=0):
    """The port's model with weights from ``seed`` (:func:`init_weights`)."""
    return init_weights(models.build(name, **config), seed)


def jax_trees(model):
    params, state = to_jax_params(model.state_dict())
    return (jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state))


def zero_dropout(jax_module=None, port_module=None):
    """Dropout rate 0 in a JAX module tree and in a port model."""
    if port_module is not None:
        for m in port_module.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    if jax_module is not None:
        if hasattr(jax_module, "rate"):
            jax_module.rate = 0.0
        for _, child in jax_module.children():
            zero_dropout(child)


def images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def eval_match(name, config, shape, seed=0, jit=True):
    """The port's eval forward with BN folded (``Predictor``'s fold)
    against the JAX model's unfolded forward; returns the relative error.
    The two models' input sizes and regimes must be equal."""
    model = port_model(name, config, seed)
    params, state = jax_trees(model)
    x = images(shape, seed + 1)
    j_model = jax_models.build(name, **config)

    def fwd(p, s, a):
        return j_model(p, s, a, Context(train=False))[0]

    ref = (jax.jit(fwd) if jit else fwd)(params, state, jnp.asarray(x))
    assert model.input_size == j_model.input_size
    assert model.regime == j_model.regime
    model.eval()
    search_absorb_bn(model)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    return rel(out, ref)


def jax_step(name, config, params, state, x, y, num_classes):
    """One float32 step of the JAX trainer (dropout off): the loss and the
    params and state after it."""
    j_model = jax_models.build(name, **config)
    zero_dropout(j_model)
    tr = JaxTrainer(j_model, jax_optim.OptimRegime(j_model.regime),
                    num_classes, JaxTrainerConfig(dtype="float32",
                                                  print_freq=0))
    p, s, opt = tr.initialize(params, state)
    tr.optim.update(0, 0)
    hp = tr._hp_device(tr.optim.hyperparams())
    p, s, _, m = tr._get_train_step()(p, s, opt, jnp.asarray(x),
                                      jnp.asarray(y), hp,
                                      jax.random.PRNGKey(0))
    return float(m["loss"]), p, s


def port_step(model, x, y, num_classes):
    zero_dropout(port_module=model)
    params, state = to_jax_params(model.state_dict())
    tr = Trainer(model, optim.OptimRegime(model.regime), num_classes,
                 TrainerConfig(dtype="float32", print_freq=0), device="cpu")
    tr.initialize(from_jax_params(params, state))
    loss = float(tr.train_step(x, y)["loss"])
    return loss, tr


def assert_step_matches(before, loss, after, j_loss, j_params, j_state):
    """``before``: the JAX trees the step started from; ``after``: the
    port's trees after its step."""
    np.testing.assert_allclose(loss, j_loss, rtol=LOSS_TOL)
    p0 = dict(leaves(before))
    ref = {k: v - p0[k] for k, v in leaves(j_params)}
    got = {k: v - p0[k] for k, v in leaves(after[0])}
    assert ref.keys() == got.keys()
    all_ref = np.concatenate([v.ravel() for v in ref.values()])
    all_got = np.concatenate([got[k].ravel() for k in ref])
    total = np.linalg.norm(all_ref)
    assert np.linalg.norm(all_got - all_ref) <= UPDATE_NORM_TOL * total
    for k in ref:
        err = np.linalg.norm(got[k] - ref[k])
        assert err <= (TENSOR_NORM_TOL * np.linalg.norm(ref[k])
                       + TENSOR_FLOOR * total), k
    ref_s, got_s = dict(leaves(j_state)), dict(leaves(after[1]))
    assert ref_s.keys() == got_s.keys()
    for k in ref_s:
        np.testing.assert_allclose(got_s[k], ref_s[k], rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=str(k))


def step_match(name, config, shape, num_classes, batch_seed=1):
    model = port_model(name, config)
    params, state = to_jax_params(model.state_dict())
    rng = np.random.default_rng(batch_seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, num_classes, shape[0]).astype(np.int32)
    j_loss, j_params, j_state = jax_step(name, config, params, state, x, y,
                                         num_classes)
    loss, tr = port_step(model, x, y, num_classes)
    assert_step_matches(params, loss, to_jax_params(tr.model.state_dict()),
                        j_loss, j_params, j_state)


# ----------------------------------------------------------- eval forwards

EVAL_CASES = [("mnist", {}, (2, 28, 28, 1)),
              ("alexnet", {"num_classes": 10}, (2, 224, 224, 3)),
              ("vgg", VGG11_CIFAR, (2, 32, 32, 3)),
              ("vgg", {"depth": 11, "num_classes": 10}, (1, 224, 224, 3)),
              ("densenet", DENSENET, (2, 64, 64, 3))]


@pytest.mark.parametrize("name,config,shape", EVAL_CASES)
def test_eval_forward_matches_jax(name, config, shape):
    assert eval_match(name, config, shape) <= LOGIT_TOL


# --------------------------------------------------------- training steps

STEP_CASES = [("mnist", {}, (8, 28, 28, 1), 10),
              ("vgg", VGG11_CIFAR, (8, 32, 32, 3), 10),
              ("densenet", DENSENET, (8, 32, 32, 3), 10)]


@pytest.mark.parametrize("name,config,shape,num_classes", STEP_CASES)
def test_float32_step_matches_jax(name, config, shape, num_classes):
    step_match(name, config, shape, num_classes)


# ----------------------------------------------------------- structure

def test_input_sizes_and_regimes_are_the_jax_models():
    for name, config in (("densenet", {}), ("googlenet", {}),
                         ("inception_v3", {}), ("inception_v4", {}),
                         ("inception_resnet_v2", {})):
        with torch.device("meta"):      # structure only: no weights drawn
            ours = models.build(name, **config)
        ref = jax_models.build(name, **config)
        assert ours.input_size == ref.input_size, name
        assert ours.regime == ref.regime, name


def test_mnist_takes_one_channel():
    model = models.build("mnist")
    assert model.in_channels == 1
    assert model.features.conv1.weight.shape == (32, 1, 5, 5)
    assert model.features.conv1.bias is not None


def test_densenet_transition_pools_by_average():
    model = models.build("densenet", **DENSENET)
    transition = model.blocks._modules["1"]
    assert transition.pool.kernel_size == 2 and transition.pool.stride == 2
    x = torch.randn(2, 8, 8, transition.bn.num_features)
    model.eval()
    assert transition(x).shape == (2, 4, 4, transition.conv.out_channels)
