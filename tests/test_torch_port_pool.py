"""The port's max pool (forward with index, backward) against the JAX
package's, on the CPU.

On CPU tensors the port's kernel wrappers run their plain versions, the
oracle the CUDA kernels are held to on the card, so this holds that oracle to
the JAX package: ``_mp_fwd_argmax`` (the live forward), the Pallas pool
``max_pool2d_pallas`` (forward, and its ``bwd_body`` through ``jax.vjp``) and
the Pallas ``max_pool2d_bwd_pallas`` fed the JAX uint8 index, all in
interpret mode. Inputs are drawn with numpy, some from a handful of values so
that ties are common.

Tolerances: the forward's y and index exactly equal. dx: exactly equal when
dy holds quarter-integers, whose sums are exact in any order, in float32 and
bf16; with normal dy, exact in float32 against ``max_pool2d_bwd_pallas``,
which adds the taps in the same ascending order, and within 1e-6 relative
against ``bwd_body``, which groups the taps by row before adding. In bf16,
1e-2 relative-plus-absolute against ``bwd_body``, which accumulates in
float32 as the port does; against ``max_pool2d_bwd_pallas``, which rounds
every partial sum to bf16, 1e-2 of (1 + the sum of the |dy| routed to the
pixel), since its rounding errors scale with the summands, not with their
sum, which may cancel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu.ops.pallas.pool import max_pool2d_pallas
from convnet_tpu.ops.pallas.pool_bwd import max_pool2d_bwd_pallas
from convnet_tpu.ops.pool import _mp_fwd_argmax
from convnet_tpu_torch import ops
from convnet_tpu_torch.ops.kernels import max_pool

CASES = [  # (x shape, kernel, stride, padding)
    ((2, 16, 16, 8), 3, 2, 1),   # the ResNet stem's pool, small
    ((2, 15, 13, 3), 3, 2, 1),   # odd H and W, C = 3
    ((2, 8, 8, 5), 2, 2, 0),     # non-overlapping windows
    ((2, 9, 9, 17), 3, 1, 1),    # stride 1: up to 9 windows per pixel
]
IDS = ["stem", "odd", "k2s2", "s1"]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _x(shape, inputs, seed):
    rng = np.random.default_rng(seed)
    if inputs == "ties":
        return rng.integers(-2, 3, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _dy(shape, kind, seed):
    rng = np.random.default_rng(seed + 1)
    if kind == "quarters":
        return (rng.integers(-8, 9, shape) / 4).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@functools.lru_cache(maxsize=None)
def _pallas_vjp(k, s, p):
    def f(x, dy):
        _, vjp = jax.vjp(lambda a: max_pool2d_pallas(a, k, s, p,
                                                     interpret=True), x)
        return vjp(dy)[0]
    return jax.jit(f)


@pytest.mark.parametrize("inputs", ["normal", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,s,p", CASES, ids=IDS)
def test_forward_with_index_matches_jax(shape, k, s, p, dtype, inputs):
    x = _x(shape, inputs, seed=sum(shape))
    xj = jnp.asarray(x, JNP[dtype])
    y_ref, idx_ref = _mp_fwd_argmax(xj, (k, k), (s, s), (p, p))
    y_pallas = max_pool2d_pallas(xj, k, s, p, interpret=True)
    y, idx = max_pool.max_pool2d_fwd_idx(
        torch.from_numpy(x).to(TORCH[dtype]), k, s, p)
    assert y.dtype == TORCH[dtype] and idx.dtype == torch.uint8
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(y.float().numpy(), _np(y_ref))
    np.testing.assert_array_equal(y.float().numpy(), _np(y_pallas))


@pytest.mark.parametrize("dy_kind", ["quarters", "normal"])
@pytest.mark.parametrize("inputs", ["normal", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,s,p", CASES, ids=IDS)
def test_backward_matches_jax(shape, k, s, p, dtype, inputs, dy_kind):
    x = _x(shape, inputs, seed=sum(shape))
    xj = jnp.asarray(x, JNP[dtype])
    y_ref, idx_ref = _mp_fwd_argmax(xj, (k, k), (s, s), (p, p))
    dy = _dy(y_ref.shape, dy_kind, seed=sum(shape))
    dyj = jnp.asarray(dy, JNP[dtype])
    dx_body = _np(_pallas_vjp(k, s, p)(xj, dyj))
    dx_bwd = _np(max_pool2d_bwd_pallas((k, k), (s, s), (p, p), shape,
                                       dtype, idx_ref, dyj, interpret=True))

    xt = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_()
    y = ops.max_pool2d(xt, k, s, p)
    y.backward(torch.from_numpy(dy).to(TORCH[dtype]))
    dx = xt.grad.float().numpy()
    assert xt.grad.dtype == TORCH[dtype]

    if dy_kind == "quarters":
        np.testing.assert_array_equal(dx, dx_body)
        np.testing.assert_array_equal(dx, dx_bwd)
    elif dtype == "float32":
        np.testing.assert_array_equal(dx, dx_bwd)
        np.testing.assert_allclose(dx, dx_body, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(dx, dx_body, rtol=1e-2, atol=1e-2)
        routed = max_pool.max_pool2d_bwd_plain(
            torch.from_numpy(np.abs(dy)), torch.from_numpy(
                np.array(idx_ref)), shape, k, s, p).numpy()
        assert (np.abs(dx - dx_bwd) <= 1e-2 * (1 + routed)).all()


def test_padding_never_wins_and_first_tap_wins_ties():
    x = torch.full((1, 4, 4, 2), -5.0)      # a pad read as 0 would win
    y, idx = max_pool.max_pool2d_fwd_idx(x, 3, 2, 1)
    assert torch.equal(y, torch.full((1, 2, 2, 2), -5.0))
    # window (0, 0) starts in the padding: its first in-image tap is t = 4
    assert idx[0, 0, 0, 0] == 4 and idx[0, 1, 1, 0] == 0


def test_eval_forward_writes_no_index_and_matches():
    x = torch.from_numpy(_x((2, 9, 9, 4), "ties", 3))
    y, idx = max_pool.max_pool2d_fwd_idx(x, 3, 2, 1, with_index=False)
    assert idx is None
    assert torch.equal(ops.max_pool2d(x, 3, 2, 1),
                       max_pool.max_pool2d_fwd_idx(x, 3, 2, 1)[0])
    assert torch.equal(y, ops.max_pool2d(x, 3, 2, 1))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x = torch.randn(1, 6, 6, 3, requires_grad=True)
    before = (max_pool.fwd_launches, max_pool.bwd_launches)
    ops.max_pool2d(x, 3, 2, 1).sum().backward()
    assert (max_pool.fwd_launches, max_pool.bwd_launches) == before


@pytest.mark.parametrize("kernel,stride,padding", [(2, 3, 0), (3, 2, 3),
                                                   (16, 1, 0)])
def test_rejects_what_the_kernels_do_not_take(kernel, stride, padding):
    with pytest.raises(ValueError):
        max_pool.max_pool2d_fwd_idx(torch.zeros(1, 8, 8, 2), kernel, stride,
                                    padding)
