"""The port's CIFAR ResNets, SE blocks, ``resnet_se`` and ``wide_resnet``
against the JAX package's, on the CPU.

Weights are drawn by the JAX package (BatchNorm parameters and statistics
redrawn with numpy where the test runs in eval, so that folding is not the
identity) and carried across with ``from_jax_params``; inputs come from
numpy with a seed. The JAX models run their default XLA route (the CIFAR
ResNets reach no Pallas kernel: no max pool and no stride-1 1x1 ``ConvBN``
in a block's main path).

Tolerances (``scripts/port_numerics.py cifar_se`` measures each case):

- SE blocks alone: float32 1e-5 of the output's scale (a mean over H·W
  and two small matmuls in another order); bf16 2e-2 of it, since both
  round the squeeze, the FCs and the gate to bf16, and one bf16 ulp of the
  gate (2^-8) may land apart.
- Eval forwards: 1e-4 of the largest |logit| (float32, summation order).
- One float32 SGD step from the same state (``STEPS`` steps, each of the
  port's from the JAX trainer's state before it): the loss within
  ``LOSS_TOL``, BN statistics within ``STAT_TOL``, the updates in norm, all
  of them within ``NORM_TOL["all"]`` and each tensor within
  ``NORM_TOL["tensor"]`` of its update's norm plus ``NORM_TOL["floor"]``
  of all updates' norm (the terms of ``test_torch_port_trainer_features``).

Measured (``cifar_se``): SE blocks 1.2e-7 (float32), 0 and 7.7e-3 (bf16,
ReLU and swish); eval logits 6.4e-7 at most; at batch 16 the steps are
1.0e-5 apart in loss, 0.82% in norm and 6.1% in the worst tensor (an SE
``fc1`` bias of the narrow SE-ResNet-50, whose float32 step is 6e-5 from
the port's float64 step: the JAX side's float32 is the noisier, as
ROADMAP.md §3 records for the other narrow nets), BN statistics 2.6e-5.
At batch 8 that net's own float32 step is 4% from its float64 step, so
the steps run at 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import models as jax_models
from convnet_tpu.core.module import Context
from convnet_tpu.core.module import param_count as jax_param_count
from convnet_tpu.nn.se import SEBlock as JaxSEBlock
from convnet_tpu.nn.se import SESwishBlock as JaxSESwishBlock
from convnet_tpu.regimes import optim as jax_optim
from convnet_tpu.train.trainer import Trainer as JaxTrainer
from convnet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from convnet_tpu_torch import models
from convnet_tpu_torch.core.module import param_count
from convnet_tpu_torch.models.resnet import ConvBN
from convnet_tpu_torch.nn import SEBlock, SESwishBlock
from convnet_tpu_torch.regimes import optim
from convnet_tpu_torch.train.trainer import Trainer, TrainerConfig
from convnet_tpu_torch.utils.from_jax import from_jax_params

SIZE = 32
# the nets: (factory, config)
CIFAR10 = ("resnet", {"dataset": "cifar10", "depth": 20})
CIFAR100 = ("resnet", {"dataset": "cifar100", "depth": 20})
SE_IMAGENET = ("resnet_se", {"depth": 50, "width": [16, 32, 64, 128],
                             "num_classes": 10})
SE_CIFAR = ("resnet_se", {"dataset": "cifar10", "depth": 20,
                          "se_reduction": 4})
WIDE = ("wide_resnet", {"depth": 10, "width_factor": 2})
STEP_NETS = {"resnet20_cifar10": CIFAR10, "resnet20_cifar100": CIFAR100,
             "resnet_se_imagenet": SE_IMAGENET, "resnet_se_cifar": SE_CIFAR}
STEPS, STEP_BATCH = 2, 16
LOGIT_TOL = 1e-4
SE_TOL = {"float32": 1e-5, "bf16": 2e-2}
LOSS_TOL, STAT_TOL = 1e-4, 1e-3
NORM_TOL = {"all": 5e-2, "tensor": 1e-1, "floor": 1e-4}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def jax_init(name, config, seed=0, redraw_stats=False):
    params, state = jax_models.build(name, **config).init(
        jax.random.PRNGKey(seed))
    params, state = _numpy(params), _numpy(state)
    if redraw_stats:
        rng = np.random.default_rng(seed)
        draw = {"scale": lambda s: rng.uniform(0.5, 1.5, s),
                "bias": lambda s: rng.normal(0.0, 0.2, s),
                "mean": lambda s: rng.normal(0.0, 0.2, s),
                "var": lambda s: rng.uniform(0.5, 2.0, s)}

        def redraw(tree, names, path=()):
            return {k: redraw(v, names, path + (k,)) if isinstance(v, dict)
                    else (draw[k](v.shape).astype(np.float32)
                          if k in names and "bn" in path else v)
                    for k, v in tree.items()}

        params = redraw(params, ("scale", "bias"))
        state = redraw(state, ("mean", "var"))
    return params, state


def port_model(name, config, params, state):
    model = models.build(name, **config)
    model.load_state_dict(from_jax_params(params, state))
    return model


def images(batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, SIZE, SIZE, 3)).astype(np.float32)


def batches(n, batch, num_classes, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, SIZE, SIZE, 3)).astype(np.float32),
             rng.integers(0, num_classes, batch).astype(np.int32))
            for _ in range(n)]


def eval_logits(name, config, params, state, x):
    """(JAX logits, port logits) of the eval forward."""
    model = jax_models.build(name, **config)
    ref = jax.jit(lambda p, s, a: model(p, s, a, Context(train=False))[0])(
        params, state, jnp.asarray(x))
    port = port_model(name, config, params, state).eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    return np.asarray(ref), out


def num_classes(name, config):
    return models.build(name, **config).fc.out_features


def run_steps(name, config, n=STEPS, batch=STEP_BATCH, seed=3):
    """``n`` float32 SGD steps of the JAX trainer with the model's regime;
    for each: the params, state and momentum before it, its loss and the
    params and state after it; and the port's step from that same state:
    its loss and its params and state after it (as the JAX trees)."""
    from convnet_tpu_torch.utils.from_jax import to_jax_params
    params, state = jax_init(name, config, seed=seed)
    classes = num_classes(name, config)
    data = batches(n, batch, classes)
    j_model = jax_models.build(name, **config)
    j_tr = JaxTrainer(j_model, jax_optim.OptimRegime(j_model.regime), classes,
                      JaxTrainerConfig(dtype="float32", print_freq=0))
    params, state, opt = j_tr.initialize(params, state)
    j_tr.optim.update(0, 0)
    hp = j_tr._hp_device(j_tr.optim.hyperparams())
    step = j_tr._get_train_step()
    model = models.build(name, **config)
    tr = Trainer(model, optim.OptimRegime(model.regime), classes,
                 TrainerConfig(dtype="float32", print_freq=0), device="cpu")
    tr.initialize()
    names = [k for k, _ in tr.model.named_parameters()]
    out = []
    for x, y in data:
        before = _numpy((params, state, opt["mu"]))
        params, state, opt, m = step(params, state, opt, jnp.asarray(x),
                                     jnp.asarray(y), hp,
                                     jax.random.PRNGKey(0))
        tr.model.load_state_dict(from_jax_params(before[0], before[1]))
        mu = from_jax_params(before[2])
        tr.opt_state["mu"] = [mu[k].clone() for k in names]
        loss = float(tr.train_step(x, y)["loss"])
        out.append((before, float(m["loss"]), _numpy((params, state)), loss,
                    to_jax_params(tr.model.state_dict())))
    return out


def step_errors(before, j_after, p_after):
    """(all updates in norm, {tensor: its error in norm over its update's
    norm plus the floor}, worst BN statistic error) of the port's step
    against the JAX step."""
    p0 = dict(_leaves(before[0]))
    ref = {k: v - p0[k] for k, v in _leaves(j_after[0])}
    got = {k: v - p0[k] for k, v in _leaves(p_after[0])}
    assert ref.keys() == got.keys()
    all_ref = np.concatenate([ref[k].ravel() for k in ref])
    all_err = np.concatenate([(got[k] - ref[k]).ravel() for k in ref])
    floor = NORM_TOL["floor"] * np.linalg.norm(all_ref)
    tensors = {k: float(np.linalg.norm(got[k] - ref[k])
                        / (np.linalg.norm(ref[k]) + floor)) for k in ref}
    rs, gs = dict(_leaves(j_after[1])), dict(_leaves(p_after[1]))
    stats = max(float((np.abs(gs[k] - rs[k]) / (1 + np.abs(rs[k]))).max())
                for k in rs)
    return (float(np.linalg.norm(all_err) / np.linalg.norm(all_ref)),
            tensors, stats)


# ------------------------------------------------------------ SE blocks

@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("kind", ["relu", "swish"])
def test_se_block_matches_jax(kind, dtype):
    jax_cls, cls = {"relu": (JaxSEBlock, SEBlock),
                    "swish": (JaxSESwishBlock, SESwishBlock)}[kind]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    blk = jax_cls(64, 16)
    params, _ = blk.init(jax.random.PRNGKey(1))
    x = np.random.default_rng(2).standard_normal((3, 6, 5, 64)).astype(
        np.float32)
    ref = np.asarray(blk(params, {}, jnp.asarray(x, jdt),
                         Context(train=False))[0].astype(jnp.float32))
    mod = cls(64, 16)
    assert mod.fc1.out_features == 4
    mod.load_state_dict(from_jax_params(_numpy(params)))
    with torch.no_grad():
        out = mod(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    out = out.float().numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= SE_TOL[dtype] * scale


def test_se_hidden_width_floor():
    """``hidden = max(channels // reduction, 1)``, as in the JAX package."""
    assert SEBlock(8, 16).fc1.out_features == 1
    assert JaxSEBlock(8, 16).fc1.out_features == 1


# ---------------------------------------------------- models: forwards

@pytest.mark.parametrize("net", [CIFAR10, CIFAR100, SE_IMAGENET, SE_CIFAR,
                                 WIDE], ids=["resnet20_cifar10",
                                             "resnet20_cifar100",
                                             "resnet_se_imagenet",
                                             "resnet_se_cifar",
                                             "wide_resnet_10_2"])
def test_eval_forward_matches_jax(net):
    name, config = net
    params, state = jax_init(name, config, redraw_stats=True)
    ref, out = eval_logits(name, config, params, state, images(4, 1))
    assert out.shape == ref.shape == (4, num_classes(name, config))
    assert np.abs(out - ref).max() <= LOGIT_TOL * np.abs(ref).max()


@pytest.mark.parametrize("name, config, classes", [
    ("resnet", {"dataset": "cifar10"}, 10),
    ("resnet", {"dataset": "cifar100"}, 100),
    ("resnet", {"dataset": "cifar100", "depth": 56}, 100),
    ("resnet_se", {"dataset": "cifar10"}, 10),
    ("resnet_se", {"depth": 50}, 1000),
    ("wide_resnet", {}, 10),
])
def test_factories_match_jax(name, config, classes):
    """Parameter counts, the class count, input size and regime of each
    factory's default net are the JAX package's."""
    port = models.build(name, **config)
    ref = jax_models.build(name, **config)
    params, _ = ref.init(jax.random.PRNGKey(0))
    assert param_count(port) == jax_param_count(params)
    assert port.fc.out_features == classes
    assert port.input_size == ref.input_size
    assert port.regime == ref.regime


def test_imagenet_depth_error_matches_jax():
    with pytest.raises(ValueError) as ours:
        models.build("resnet", depth=20)
    with pytest.raises(ValueError) as ref:
        jax_models.build("resnet", depth=20)
    assert str(ours.value) == str(ref.value)


def test_se_leaves_the_fused_route_unchanged():
    """In eval an SE-ResNet-50 routes the same 33 ConvBNs to the fused 1x1
    kernel as a ResNet-50 (SE runs in plain ops)."""
    def routed(model):
        return sum(isinstance(m, ConvBN) and m.uses_kernel()
                   for m in model.eval().modules())

    se = models.build("resnet_se", **SE_IMAGENET[1])
    plain = models.build("resnet", **SE_IMAGENET[1])
    assert routed(se) == routed(plain) == 33
    cifar = models.build("resnet_se", dataset="cifar10")
    assert routed(cifar) == 0


# ------------------------------------------------------ models: a step

@pytest.fixture(scope="module", params=sorted(STEP_NETS))
def steps(request):
    name, config = STEP_NETS[request.param]
    return request.param, run_steps(name, config)


def test_float32_steps_match_jax(steps):
    net, out = steps
    for i, (before, j_loss, j_after, loss, p_after) in enumerate(out):
        np.testing.assert_allclose(loss, j_loss, rtol=LOSS_TOL)
        total, tensors, stats = step_errors(before, j_after, p_after)
        worst = max(tensors, key=tensors.get)
        assert total <= NORM_TOL["all"], (net, i, total)
        assert tensors[worst] <= NORM_TOL["tensor"], (net, i, worst)
        assert stats <= STAT_TOL, (net, i, stats)
