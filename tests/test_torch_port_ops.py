"""The port's leaf ops against the JAX package's, on the CPU in float32.

Inputs are made with numpy from a seed and handed to both. Tolerances:
1e-5 for elementwise ops and reductions, 1e-4 for convs and matmuls (two
libraries summing up to 147 products in another order).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from convnet_tpu import ops as jops
from convnet_tpu_torch import ops


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("kernel,stride,padding,cin,cout", [
    (7, 2, 3, 3, 16),    # the ResNet stem
    (3, 2, 1, 8, 8),     # a stage's first 3x3
    (1, 2, 0, 16, 32),   # a strided downsample
])
def test_conv2d(kernel, stride, padding, cin, cout):
    rng = _rng(kernel * 10 + stride)
    x = rng.standard_normal((2, 15, 15, cin)).astype(np.float32)
    w_hwio = (rng.standard_normal((kernel, kernel, cin, cout))
              / np.sqrt(kernel * kernel * cin)).astype(np.float32)
    ref = jops.conv2d(jnp.asarray(x), jnp.asarray(w_hwio), stride=stride,
                      padding=padding)
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    out = ops.conv2d(torch.from_numpy(x), w, stride=stride, padding=padding)
    assert out.is_contiguous() and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_batch_norm_inference():
    rng = _rng(1)
    x = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(6).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.2, 2.0, 6).astype(np.float32)
    ref = jops.batch_norm_inference(*(jnp.asarray(a) for a in
                                      (x, scale, bias, mean, var)))
    out = ops.batch_norm_inference(*(torch.from_numpy(a) for a in
                                     (x, scale, bias, mean, var)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_max_pool2d_padding_never_wins():
    # all-negative input: a pad that acted as 0 instead of -inf would win
    x = -np.abs(_rng(2).standard_normal((2, 9, 9, 4))).astype(np.float32) - 1
    ref = jops.max_pool2d(jnp.asarray(x), 3, 2, 1)
    out = ops.max_pool2d(torch.from_numpy(x), 3, 2, 1)
    assert out.shape == ref.shape == (2, 5, 5, 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_global_avg_pool():
    x = _rng(3).standard_normal((3, 7, 7, 5)).astype(np.float32)
    ref = jops.global_avg_pool(jnp.asarray(x))
    out = ops.global_avg_pool(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_linear():
    rng = _rng(4)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    w = rng.standard_normal((32, 10)).astype(np.float32)   # JAX (in, out)
    b = rng.standard_normal(10).astype(np.float32)
    ref = jops.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = ops.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                     torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["relu", "relu6"])
def test_activation(name):
    x = (_rng(5).standard_normal((64,)) * 8).astype(np.float32)
    ref = getattr(jops, name)(jnp.asarray(x))
    out = getattr(ops, name)(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
