"""The zoo's layers and ops in the port against the JAX package, on the CPU:
``avg_pool2d`` (both ``count_include_pad`` values, forward and gradient),
``Conv2d`` with a bias, per-axis padding and dilation, ``Flatten``,
``HardSwish``, ``Sigmoid``, ``LocalResponseNorm``; the BN fold of a biased
conv or linear (``absorb_bn_pair``); the weight-decay mask of the biased
models; and the registry's names.

Inputs come from a numpy seed. Tolerances, float32: the average pool sums at
most 9 taps in another order, so 1e-6 of the largest output (and of the
largest gradient); a conv sums up to 7·7·8 products in cuDNN's or oneDNN's
order against XLA's, 1e-5 of the largest output or gradient; the
elementwise layers 1e-6 relative; the BN fold 1e-5 of the largest output.
In bfloat16 the pool's float32 sums are rounded once on each side: one bf16
ulp, 2^-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import models as jax_models
from convnet_tpu import ops as jax_ops
from convnet_tpu.core.module import Context
from convnet_tpu.nn import layers as jax_layers
from convnet_tpu.utils.absorb_bn import absorb_bn_pair as jax_absorb_pair
from convnet_tpu.utils.param_filter import wd_mask as jax_wd_mask
from convnet_tpu_torch import models, ops
from convnet_tpu_torch import nn as tnn
from convnet_tpu_torch.core.module import Sequential, init_parameters
from convnet_tpu_torch.utils.absorb_bn import search_absorb_bn
from convnet_tpu_torch.utils.from_jax import to_jax_params
from convnet_tpu_torch.utils.param_filter import wd_mask

POOL_TOL = 1e-6
CONV_TOL = 1e-5
ELEMENTWISE_TOL = 1e-6
FOLD_TOL = 1e-5
BF16_ULP = 2.0 ** -8


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


# ------------------------------------------------------------ avg pool

# (shape, kernel, stride, padding, count_include_pad): the Inception branch
# pools (3, 1, 1) with both counts at sizes where the border is a large
# share, DenseNet's transition (2, 2, 0), a strided padded pool, odd sizes
POOLS = [((2, 7, 9, 5), 3, 1, 1, True), ((2, 7, 9, 5), 3, 1, 1, False),
         ((2, 3, 3, 4), 3, 1, 1, False), ((2, 8, 8, 4), 2, 2, 0, True),
         ((2, 9, 7, 3), 3, 2, 1, True), ((2, 9, 7, 3), 3, 2, 1, False),
         ((1, 5, 6, 2), 3, 2, 0, True)]


@pytest.mark.parametrize("shape,k,s,p,cip", POOLS)
def test_avg_pool2d_forward_and_gradient_match_jax(shape, k, s, p, cip):
    x = _rand(shape, 0)
    ref, vjp = jax.vjp(lambda a: jax_ops.avg_pool2d(a, k, s, p, cip),
                       jnp.asarray(x))
    w = _rand(ref.shape, 1)
    (ref_dx,) = vjp(jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ops.avg_pool2d(xt, k, s, p, cip)
    (y * torch.from_numpy(w)).sum().backward()
    assert y.shape == ref.shape and y.is_contiguous()
    assert _rel(y.detach().numpy(), ref) <= POOL_TOL
    assert _rel(xt.grad.numpy(), ref_dx) <= POOL_TOL


def test_count_include_pad_changes_only_the_border():
    x = np.abs(_rand((1, 6, 6, 3), 2)) + 1.0
    a = ops.avg_pool2d(torch.from_numpy(x), 3, 1, 1, True).numpy()
    b = ops.avg_pool2d(torch.from_numpy(x), 3, 1, 1, False).numpy()
    np.testing.assert_allclose(a[:, 1:-1, 1:-1], b[:, 1:-1, 1:-1], rtol=1e-6)
    np.testing.assert_allclose(a[:, 0, 0], b[:, 0, 0] * 4 / 9, rtol=1e-6)
    np.testing.assert_allclose(a[:, 0, 2], b[:, 0, 2] * 6 / 9, rtol=1e-6)


@pytest.mark.parametrize("cip", [True, False])
def test_avg_pool2d_bfloat16_sums_in_float32(cip):
    x = _rand((2, 9, 9, 8), 3)
    ref = np.asarray(jax_ops.avg_pool2d(jnp.asarray(x, jnp.bfloat16), 3, 1, 1,
                                        cip).astype(jnp.float32))
    xb = torch.from_numpy(x).bfloat16()
    y = ops.avg_pool2d(xb, 3, 1, 1, cip)
    assert y.dtype == torch.bfloat16
    # the pool of the bf16 tensor is the float32 pool rounded once
    assert torch.equal(y, ops.avg_pool2d(xb.float(), 3, 1, 1, cip).bfloat16())
    np.testing.assert_allclose(y.float().numpy(), ref, rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(ref).max())


def test_avg_pool_layer_is_the_op():
    x = torch.from_numpy(_rand((2, 6, 5, 3), 4))
    layer = tnn.AvgPool2d(3, 1, 1, count_include_pad=False)
    assert torch.equal(layer(x), ops.avg_pool2d(x, 3, 1, 1, False))
    assert torch.equal(tnn.AvgPool2d(2)(x), ops.avg_pool2d(x, 2, 2, 0))


# -------------------------------------------------------------- Conv2d

# (in, out, kernel, stride, padding, dilation, bias): Inception's
# factorized kernels with their per-axis padding (a swapped H/W keeps the
# output shape, so only the numbers show it), a biased 5x5, a strided and a
# dilated conv
CONVS = [(6, 8, (1, 7), 1, (0, 3), 1, False),
         (6, 8, (7, 1), 1, (3, 0), 1, False),
         (5, 4, (1, 3), 1, (0, 1), 1, True),
         (5, 4, (3, 1), 1, (1, 0), 1, True),
         (3, 8, 5, 1, 2, 1, True),
         (4, 6, 3, 2, 0, 1, True),
         (4, 6, 3, 1, 2, 2, False)]


@pytest.mark.parametrize("cin,cout,k,s,p,d,bias", CONVS)
def test_conv2d_forward_and_gradients_match_jax(cin, cout, k, s, p, d, bias):
    conv = tnn.Conv2d(cin, cout, k, s, p, dilation=d, bias=bias)
    init_parameters(conv, torch.Generator().manual_seed(5))
    params, _ = to_jax_params(conv.state_dict())
    assert ("b" in params) == bias
    j_conv = jax_layers.Conv2d(cin, cout, k, s, p, dilation=d, bias=bias)
    x = _rand((2, 9, 11, cin), 6)

    def f(prm, a):
        return j_conv(prm, {}, a, Context())[0]

    ref, vjp = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, params),
                       jnp.asarray(x))
    w = _rand(ref.shape, 7)
    ref_dp, ref_dx = vjp(jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = conv(xt)
    (y * torch.from_numpy(w)).sum().backward()
    assert y.shape == ref.shape
    assert _rel(y.detach().numpy(), ref) <= CONV_TOL
    assert _rel(xt.grad.numpy(), ref_dx) <= CONV_TOL
    assert _rel(conv.weight.grad.numpy().transpose(2, 3, 1, 0),
                ref_dp["w"]) <= CONV_TOL
    if bias:
        assert _rel(conv.bias.grad.numpy(), ref_dp["b"]) <= CONV_TOL


def test_conv2d_bias_draw_is_the_jax_bound():
    conv = tnn.Conv2d(4, 512, (1, 7), bias=True)
    init_parameters(conv, torch.Generator().manual_seed(8))
    bound = 1.0 / np.sqrt(1 * 7 * 4)
    b = conv.bias.detach().numpy()
    assert np.abs(b).max() <= bound and np.abs(b).max() > 0.9 * bound
    assert tnn.Conv2d(4, 8, 3).bias is None
    assert [n for n, _ in tnn.Conv2d(4, 8, 3, bias=True)
            .named_parameters()] == ["weight", "bias"]


# ------------------------------------------------- the elementwise layers

LAYERS = {
    "hard_swish": (tnn.HardSwish(), jax_layers.HardSwish()),
    "sigmoid": (tnn.Sigmoid(), jax_layers.Sigmoid()),
    "lrn": (tnn.LocalResponseNorm(), jax_layers.LocalResponseNorm()),
    "lrn_even": (tnn.LocalResponseNorm(4, 1e-2, 0.5, 1.0),
                 jax_layers.LocalResponseNorm(4, 1e-2, 0.5, 1.0)),
    "flatten": (tnn.Flatten(), jax_layers.Flatten()),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    ours, ref_layer = LAYERS[name]
    x = 4 * _rand((2, 3, 4, 7), 9)
    ref = np.asarray(ref_layer({}, {}, jnp.asarray(x), Context())[0])
    out = ours(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=ELEMENTWISE_TOL,
                               atol=ELEMENTWISE_TOL)


def test_flatten_is_nhwc_order():
    x = torch.arange(24.0).reshape(1, 2, 3, 4)
    np.testing.assert_array_equal(tnn.Flatten()(x)[0].numpy(),
                                  np.arange(24.0))


# ------------------------------------------------------- the BN fold

def _bn_stats(bn, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t, draw in ((bn.weight, lambda n: rng.uniform(0.5, 1.5, n)),
                        (bn.bias, lambda n: rng.normal(0, 0.3, n)),
                        (bn.running_mean, lambda n: rng.normal(0, 0.3, n)),
                        (bn.running_var, lambda n: rng.uniform(0.5, 2, n))):
            t.copy_(torch.from_numpy(draw(t.shape[0]).astype(np.float32)))


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_absorb_bn_folds_a_bias_as_jax_does(kind):
    """A biased conv (or linear) followed by a BN sibling: the port's fold
    matches the JAX fold (weight, and the shift in the BN's bias) and the
    unfolded forward, and leaves the layer's bias at zero."""
    if kind == "conv":
        layer, x = tnn.Conv2d(3, 6, 3, 1, 1, bias=True), _rand((2, 5, 5, 3),
                                                               10)
    else:
        layer, x = tnn.Linear(5, 6), _rand((4, 1, 1, 5), 10)
    model = Sequential(layer, tnn.BatchNorm2d(6), names=["conv", "bn"])
    init_parameters(model, torch.Generator().manual_seed(11))
    _bn_stats(model.bn, 12)
    with torch.no_grad():
        model.conv.bias.copy_(torch.from_numpy(_rand((6,), 13)))
    model.eval()
    params, state = to_jax_params(model.state_dict())
    j_conv, j_bn_p, j_bn_s = jax_absorb_pair(params["conv"], params["bn"],
                                             state["bn"])
    xt = torch.from_numpy(x)
    with torch.no_grad():
        before = model(xt).numpy()
        search_absorb_bn(model)
        after = model(xt).numpy()
    assert not model.conv.bias.any()
    assert _rel(after, before) <= FOLD_TOL
    folded, folded_s = to_jax_params(model.state_dict())
    np.testing.assert_allclose(folded["conv"]["w"], j_conv["w"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(folded["conv"]["b"], j_conv["b"])
    np.testing.assert_allclose(folded["bn"]["bias"], j_bn_p["bias"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(folded["bn"]["scale"], j_bn_p["scale"])
    for leaf in ("mean", "var"):
        np.testing.assert_array_equal(folded_s["bn"][leaf], j_bn_s[leaf])


# ------------------------------------------- the mask, the registry, names

@pytest.mark.parametrize("name", ["mnist", "inception_resnet_v2"])
def test_wd_mask_spares_conv_biases_as_jax_does(name):
    """The MNIST net's conv biases and Inception-ResNet-v2's ``up``
    biases: no weight decay, in the port as in the JAX package."""
    model = models.build(name)
    params, _ = to_jax_params(model.state_dict())
    ref = dict(_leaves(jax_wd_mask(params)))
    ours = wd_mask(model)
    assert len(ours) == len(ref)
    names = [n for n, _ in model.named_parameters()]
    spared = [n for n in names if not ours[n]]
    assert sum(not v for v in ref.values()) == len(spared)
    biases = [n for n in names if n.endswith(".bias")
              and not n.rsplit(".", 2)[-2].startswith("bn")]
    assert biases and not any(ours[n] for n in biases)
    for path, decayed in ref.items():
        leaf = path[-1]
        name_ = ".".join(path[:-1]) + "." + {"w": "weight", "b": "bias",
                                             "scale": "weight",
                                             "bias": "bias"}[leaf]
        assert ours[name_] == decayed, name_


def test_registry_has_every_jax_name():
    assert set(models.REGISTRY) == set(jax_models.REGISTRY)
    for name, factory in models.REGISTRY.items():
        assert factory.__name__ == jax_models.REGISTRY[name].__name__


# the JAX package's canonical counts (tests/test_models.py and the models'
# docstrings) and the rest counted on the JAX models
PARAM_COUNTS = {"alexnet": 61_101_992, "inception_v4": 42_679_816,
                "inception_resnet_v2": 55_843_464}


@pytest.mark.parametrize("name", sorted(PARAM_COUNTS))
def test_parameter_counts_are_canonical(name):
    from convnet_tpu_torch.core.module import param_count
    with torch.device("meta"):          # structure only: no weights drawn
        assert param_count(models.build(name)) == PARAM_COUNTS[name]
