"""Faults of the port against the JAX package, held to the reference on the
CPU: ``relu6``'s gradient at the clamp's edges, and ``matmul_scale_act``
with no scale or shift.

The relu6 gradient is 0 or 1 exactly in both packages, so it is compared
exactly. ``matmul_scale_act`` with None is held to the Pallas kernel in
interpret mode at tests/test_pallas.py's tolerances (1e-4 in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu.ops import activation as jax_activation
from convnet_tpu.ops.pallas import matmul_fused as jax_mf
from convnet_tpu_torch import ops
from convnet_tpu_torch.ops.kernels import matmul_fused as mf

POINTS = [-1.0, 0.0, 3.0, 6.0, 7.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu6_gradient_matches_the_reference(dtype):
    """dy passes only where 0 < y < 6: the gradient is 0 at x == 0 and at
    x == 6, as the reference's custom VJP gives it."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref = jax.vmap(jax.grad(lambda v: jax_activation.relu6(v)))(
        jnp.asarray(POINTS, jd))
    x = torch.tensor(POINTS, dtype=td, requires_grad=True)
    y = ops.relu6(x)
    y.backward(torch.ones_like(y))
    assert y.dtype == td
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(ref, np.float32))
    np.testing.assert_array_equal(x.grad.float().numpy(), [0, 0, 1, 0, 0])
    np.testing.assert_array_equal(
        y.detach().float().numpy(),
        np.asarray(jax_activation.relu6(jnp.asarray(POINTS, jd)),
                   np.float32))


@pytest.mark.parametrize("given", ["neither", "scale", "shift"])
def test_matmul_scale_act_takes_none_as_one_and_zero(given):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((49, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) / 8).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    shift = rng.standard_normal(32).astype(np.float32)
    scale = scale if given == "scale" else None
    shift = shift if given == "shift" else None
    ref = jax_mf.matmul_scale_act(
        jnp.asarray(x), jnp.asarray(w),
        None if scale is None else jnp.asarray(scale),
        None if shift is None else jnp.asarray(shift), act="relu",
        interpret=True)
    out = mf.matmul_scale_act(
        torch.from_numpy(x), torch.from_numpy(w),
        None if scale is None else torch.from_numpy(scale),
        None if shift is None else torch.from_numpy(shift), act="relu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_conv1x1_bn_act_takes_none_as_one_and_zero():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 5, 16)).astype(np.float32)
    w_hwio = (rng.standard_normal((1, 1, 16, 24)) / 4).astype(np.float32)
    ref = jax_mf.conv1x1_bn_act(jnp.asarray(x), jnp.asarray(w_hwio),
                                act="none", interpret=True)
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    out = mf.conv1x1_bn_act(torch.from_numpy(x), w, act="none")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
