"""The port's grouped conv (kernel module, route and layer) against the JAX
package's, on the CPU.

On CPU tensors the port's wrapper runs the kernel's plain version (one
float32 einsum per tap), the oracle the CUDA kernel is held to on the card;
here it is held to the Pallas kernel ``grouped_conv_pallas`` in interpret
mode, forward and both gradients through ``jax.vjp``, at the four cases of
``tests/test_pallas_grouped.py`` and with its tolerances: y 1e-4, dx and dw
1e-3 in float32 (the two add the same products in other orders). In bf16
both round the same float32 sums to bf16, so they may land one bf16 ulp
(2^-8 relative) apart: 1e-2. The padding p > k - 1, which the reference
kernel's stride-1 dx cannot take (its padding k - 1 - p goes negative), is
held to the JAX package's XLA conv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import ops as jops
from convnet_tpu.core.module import Context
from convnet_tpu.nn.layers import Conv2d as JaxConv2d
from convnet_tpu.ops.pallas import grouped as jax_grouped
from convnet_tpu_torch.nn import Conv2d
from convnet_tpu_torch.ops.kernels import grouped_conv

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, groups, k=3, seed=7):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, k, c // groups, c)) * 0.1).astype(
        np.float32)                                   # HWIO
    return x, w


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _port(x, w_hwio, stride, padding, groups, dy, dtype="float32"):
    """The port's y, dx and dw (HWIO), as float32 numpy."""
    xt = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_()
    wt = _oihw(w_hwio).requires_grad_()
    y = grouped_conv.grouped_conv2d(xt, wt, stride, padding, groups)
    y.backward(torch.from_numpy(dy).to(TORCH[dtype]))
    return (y.detach().float().numpy(), xt.grad.float().numpy(),
            wt.grad.numpy().transpose(2, 3, 1, 0))


def _dy(shape, seed=8):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cin,g,h,stride", [
    (128, 32, 8, 1),    # cg 4, the ResNeXt stage-1 pattern
    (256, 32, 7, 1),    # cg 8
    (256, 32, 9, 2),    # stride 2: the library dx
    (128, 16, 8, 1),    # cg 8 in one 128-lane tile
])
def test_grouped_conv2d_matches_pallas(cin, g, h, stride):
    x, w = _inputs((2, h, h, cin), g)
    y_ref, vjp = jax.vjp(lambda a, b: jax_grouped.grouped_conv_pallas(
        a, b, stride=stride, padding=1, groups=g, interpret=True),
        jnp.asarray(x), jnp.asarray(w))
    dy = _dy(y_ref.shape)
    dx_ref, dw_ref = vjp(jnp.asarray(dy))
    y, dx, dw = _port(x, w, stride, 1, g, dy)
    np.testing.assert_allclose(y, np.asarray(y_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx, np.asarray(dx_ref), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dw, np.asarray(dw_ref), rtol=1e-3, atol=1e-3)


def test_grouped_conv2d_bf16_matches_pallas():
    """bf16 y, dx and dw within 1e-2 of the largest entry of each."""
    x, w = _inputs((2, 8, 8, 128), 32)
    y_ref, vjp = jax.vjp(lambda a, b: jax_grouped.grouped_conv_pallas(
        a, b, stride=1, padding=1, groups=32, interpret=True),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    dy = _dy(y_ref.shape)
    refs = (y_ref, *vjp(jnp.asarray(dy, jnp.bfloat16)))
    for got, ref in zip(_port(x, w, 1, 1, 32, dy, "bfloat16"), refs):
        ref = np.asarray(ref, np.float32)
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("padding", [3, 4])
def test_padding_beyond_k_minus_1_is_computed(padding):
    """p >= k: the stride-1 dx crops dy by p - (k - 1) on each side (the
    port computes this case; it does not reject it). Held to the JAX
    package's XLA grouped conv and its VJP, float32."""
    x, w = _inputs((2, 6, 5, 128), 32)
    y_ref, vjp = jax.vjp(lambda a, b: jops.conv2d(
        a, b, stride=1, padding=padding, groups=32), jnp.asarray(x),
        jnp.asarray(w))
    dy = _dy(y_ref.shape)
    refs = (y_ref, *vjp(jnp.asarray(dy)))
    assert y_ref.shape == (2, 6 + 2 * padding - 2, 5 + 2 * padding - 2, 128)
    for got, ref, tol in zip(_port(x, w, 1, padding, 32, dy), refs,
                             (1e-4, 1e-3, 1e-3)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


def test_flip_transpose_swaps_within_each_group():
    """w'[g cg + c, o, di, dj] == w[g cg + o, c, k-1-di, k-1-dj]."""
    w = torch.arange(8 * 4 * 3 * 3, dtype=torch.float32).view(8, 4, 3, 3)
    wf = grouped_conv.flip_transpose(w, 2)
    for co in range(8):
        g, c = divmod(co, 4)
        for o in range(4):
            for di in range(3):
                for dj in range(3):
                    assert wf[co, o, di, dj] == w[g * 4 + o, c, 2 - di, 2 - dj]


def test_supported_is_the_reference_rule():
    cases = [((2, 8, 8, 128), (3, 3, 4, 128), 32, 1, 1),
             ((2, 8, 8, 16), (3, 3, 1, 16), 16, 1, 1),     # depthwise
             ((2, 8, 8, 128), (3, 3, 128, 128), 1, 1, 1),  # dense
             ((2, 8, 8, 96), (3, 3, 3, 96), 32, 1, 1),     # C % 128
             ((2, 8, 8, 128), (3, 3, 4, 256), 32, 1, 1),   # cout != cin
             ((2, 8, 8, 128), (3, 3, 4, 128), 32, 4, 1),   # stride 4
             ((2, 8, 8, 128), (3, 3, 4, 128), 32, 2, 1),   # stride 2
             ((2, 8, 8, 128), (3, 3, 4, 128), 32, 1, 2)]   # dilation
    for x_shape, w_hwio, g, s, d in cases:
        w_oihw = (w_hwio[3], w_hwio[2], w_hwio[0], w_hwio[1])
        assert grouped_conv.supported(x_shape, w_oihw, g, s, d) == \
            jax_grouped.supported(x_shape, w_hwio, g, s, d)


@pytest.mark.parametrize("shape,cg", [((1, 56, 56, 128), 4),
                                      ((1, 28, 28, 256), 8)])
def test_route_drops_the_reference_shape_gate(shape, cg):
    """The port routes eval stride-1 grouped convs at both shapes; the
    reference's v5e gate (H == 56 and C == 128) refuses the second."""
    c = shape[-1]
    conv = Conv2d(c, c, 3, 1, 1, groups=c // cg).eval()
    assert conv.uses_grouped_kernel()
    ref = JaxConv2d(c, c, 3, stride=1, padding=1, groups=c // cg)
    assert ref._pallas_grouped_ok(Context(train=False, impl="pallas"),
                                  shape) == (shape[1] == 56)
    assert not conv.train().uses_grouped_kernel()       # training
    assert not Conv2d(c, c, 3, 2, 1, groups=c // cg).eval(
        ).uses_grouped_kernel()                          # stride 2
    assert not conv.eval().uses_depthwise_kernel()


def test_layer_in_eval_matches_the_pallas_layer():
    """Conv2d(128, 128, 3, 1, 1, groups=32) in eval: the port's route
    against the JAX layer with ``impl="pallas"`` (the Pallas kernel in
    interpret mode), float32, 1e-4."""
    ref_layer = JaxConv2d(128, 128, 3, stride=1, padding=1, groups=32)
    params, state = ref_layer.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(3).standard_normal((1, 56, 56, 128)).astype(
        np.float32)
    ctx = Context(train=False, impl="pallas")
    assert ref_layer._pallas_grouped_ok(ctx, x.shape)
    y_ref, _ = ref_layer(params, state, jnp.asarray(x), ctx)
    layer = Conv2d(128, 128, 3, 1, 1, groups=32).eval()
    with torch.no_grad():
        layer.weight.copy_(_oihw(np.asarray(params["w"])))
        before = grouped_conv.launches
        y = layer(torch.from_numpy(x))
    assert grouped_conv.launches == before       # CPU: the plain version
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)


def test_wrapper_rejects_what_it_cannot_run():
    x = torch.zeros(1, 8, 8, 128)
    w = torch.zeros(128, 4, 3, 3)
    with pytest.raises(ValueError, match="device"):
        grouped_conv.grouped_conv2d(x.to("meta"), w.to("meta"), 1, 1, 32)
    with pytest.raises(ValueError, match="cin == cout"):
        grouped_conv.grouped_conv2d(x, torch.zeros(256, 4, 3, 3), 1, 1, 32)
    with pytest.raises(ValueError, match="stride"):
        grouped_conv.grouped_conv2d(x, w, 3, 1, 32)
