"""The port's depthwise conv (kernel module and route) against the JAX
package's, on the CPU.

On CPU tensors the port's wrapper runs the kernel's plain version (per tap,
a strided slice of the padded x times the per-channel weight, added in tap
order in float32), the oracle the CUDA kernel is held to on the card; here
it is held to the Pallas kernel ``depthwise_conv_pallas`` in interpret mode,
forward and both gradients through ``jax.vjp``, at the two cases of
``tests/test_pallas.py`` and at channel counts that are not a multiple of
8, with its tolerances: 1e-4 forward and 1e-3 for the gradients in float32.
bf16 rounds the same float32 sums, one bf16 ulp (2^-8 relative) apart at
most: 1e-2. The padding p > k - 1, which the reference kernel's stride-1 dx
cannot take, is held to the JAX package's XLA depthwise conv.

The kernels read the OIHW weight as it is (no relayout): an emulation of
the tiled kernel's walk (channel c's taps at w[c*9 + t], each staged row
feeding the output rows it belongs to, their sums kept apart) equals the
plain version bit for bit in float32 and in bf16 (whose products are exact
in float32) and the Pallas kernel in interpret mode within the tolerances
above. Without autograd the wrapper's cast of the weight to x's type is
made once per weight version; with autograd recording it is never cached.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import ops as jops
from convnet_tpu.ops.pallas.depthwise import depthwise_conv_pallas
from convnet_tpu_torch.nn import Conv2d
from convnet_tpu_torch.ops.kernels import _conv, _prepared, depthwise_conv

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(shape, k=3, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((k, k, 1, shape[-1])).astype(np.float32)  # HWIO
    return x, w


def _port(x, w_hwio, stride, padding, dy, dtype="float32"):
    """The port's y, dx and dw (HWIO), as float32 numpy."""
    xt = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1))).to(TORCH[dtype]).requires_grad_()
    y = depthwise_conv.depthwise_conv2d(xt, wt, stride, padding)
    y.backward(torch.from_numpy(dy).to(TORCH[dtype]))
    return (y.detach().float().numpy(), xt.grad.float().numpy(),
            wt.grad.float().numpy().transpose(2, 3, 1, 0))


def _reference(fn, x, w, dtype="float32"):
    y, vjp = jax.vjp(fn, jnp.asarray(x, JNP[dtype]),
                     jnp.asarray(w, JNP[dtype]))
    dy = np.random.default_rng(5).standard_normal(y.shape).astype(np.float32)
    dx, dw = vjp(jnp.asarray(dy, JNP[dtype]))
    return dy, [np.asarray(a, np.float32) for a in (y, dx, dw)]


@pytest.mark.parametrize("stride,pad,shape", [
    (1, 1, (2, 14, 14, 128)),
    (2, 1, (2, 14, 14, 64)),
    (1, 1, (2, 9, 9, 17)),      # C % 8 != 0
    (2, 1, (2, 15, 13, 3)),     # odd H and W, C = 3
])
def test_depthwise_conv2d_matches_pallas(stride, pad, shape):
    x, w = _inputs(shape)
    dy, refs = _reference(lambda a, b: depthwise_conv_pallas(
        a, b, stride, pad, interpret=True), x, w)
    for got, ref, tol in zip(_port(x, w, stride, pad, dy), refs,
                             (1e-4, 1e-3, 1e-3)):
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv2d_bf16_matches_pallas(stride):
    """bf16 y and dx within 1e-2 relative-plus-absolute; dw, a sum over
    every pixel, within 1e-2 of its largest entry."""
    x, w = _inputs((2, 9, 9, 24))
    dy, (y_ref, dx_ref, dw_ref) = _reference(
        lambda a, b: depthwise_conv_pallas(a, b, stride, 1, interpret=True),
        x, w, "bfloat16")
    y, dx, dw = _port(x, w, stride, 1, dy, "bfloat16")
    np.testing.assert_allclose(y, y_ref, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(dx, dx_ref, rtol=1e-2, atol=1e-2)
    assert np.abs(dw - dw_ref).max() <= 1e-2 * np.abs(dw_ref).max()


@pytest.mark.parametrize("padding", [3, 4])
def test_padding_beyond_k_minus_1_is_computed(padding):
    """p >= k: the stride-1 dx crops dy by p - (k - 1) on each side (the
    port computes this case; it does not reject it). Held to the JAX
    package's XLA depthwise conv and its VJP, float32."""
    x, w = _inputs((2, 6, 5, 12))
    dy, refs = _reference(lambda a, b: jops.conv2d(
        a, b, stride=1, padding=padding, groups=12), x, w)
    assert refs[0].shape == (2, 6 + 2 * padding - 2, 5 + 2 * padding - 2, 12)
    for got, ref, tol in zip(_port(x, w, 1, padding, dy), refs,
                             (1e-4, 1e-3, 1e-3)):
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_plain_version_adds_the_taps_in_order():
    """The plain version is the tap loop itself: equal, bit for bit, to the
    same multiply-then-add written out in float32."""
    x, w = _inputs((2, 7, 6, 5))
    xt, wt = torch.from_numpy(x), torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    y = depthwise_conv.depthwise_conv2d_plain(xt, wt, 1, 1)
    xp = torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1))
    acc = None
    for di in range(3):
        for dj in range(3):
            term = xp[:, di:di + 7, dj:dj + 6, :] * wt[:, 0, di, dj]
            acc = term if acc is None else acc + term
    assert torch.equal(y, acc)


@pytest.mark.parametrize("train", [True, False])
def test_route_holds_in_training_and_in_eval(train):
    conv = Conv2d(32, 32, 3, 2, 1, groups=32).train(train)
    assert conv.uses_depthwise_kernel() and not conv.uses_grouped_kernel()
    assert not Conv2d(32, 64, 3, 1, 1, groups=32).train(
        train).uses_depthwise_kernel()                 # not depthwise
    assert not Conv2d(32, 32, 3, 3, 1, groups=32).train(
        train).uses_depthwise_kernel()                 # stride 3
    x = torch.from_numpy(_inputs((2, 8, 8, 32))[0]).requires_grad_(train)
    before = depthwise_conv.launches
    y = conv(x)
    if train:
        y.sum().backward()
    assert depthwise_conv.launches == before           # CPU: plain version
    torch.testing.assert_close(
        y, depthwise_conv.depthwise_conv2d_plain(x, conv.weight, 2, 1))


def test_wrapper_rejects_what_it_cannot_run():
    x = torch.zeros(1, 8, 8, 16)
    w = torch.zeros(16, 1, 3, 3)
    with pytest.raises(ValueError, match="device"):
        depthwise_conv.depthwise_conv2d(x.to("meta"), w.to("meta"), 1, 1)
    with pytest.raises(ValueError, match="depthwise"):
        depthwise_conv.depthwise_conv2d(x, torch.zeros(16, 2, 3, 3), 1, 1)
    with pytest.raises(ValueError, match="stride"):
        depthwise_conv.depthwise_conv2d(x, w, 3, 1)


def _tiled_walk(x, w, stride, padding):
    """The tiled kernel's arithmetic: the padded x read row by row; each
    staged row k feeds the output rows r with k = r*stride + di, whose sums
    are kept apart and finished at di = 2; channel c's tap t read at
    w.flatten()[c*9 + t], the OIHW weight as it is; the first tap
    multiplied, the others multiplied and added, in float32."""
    (ho, wo) = _conv.geometry(x.shape, (3, 3), stride, padding)[3]
    xp = _conv.pad_hw(x.float(), (padding, padding))
    flat = w.to(x.dtype).float().flatten()
    c = x.shape[-1]
    taps = [flat[torch.arange(c) * 9 + t] for t in range(9)]
    out, acc = [None] * ho, {}
    for k in range((ho - 1) * stride + 3):
        for di in range(3):
            if k < di or (k - di) % stride:
                continue
            r = (k - di) // stride
            if r >= ho:
                continue
            for dj in range(3):
                cols = xp[:, k, dj:dj + (wo - 1) * stride + 1:stride, :]
                term = cols * taps[3 * di + dj]
                acc[r] = term if di == dj == 0 else acc[r] + term
            if di == 2:
                out[r] = acc.pop(r)
    return torch.stack(out, dim=1).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [3, 17, 64])
def test_oihw_weight_walk_matches_plain_and_pallas(c, stride, dtype):
    x, w = _inputs((2, 11, 9, c), seed=c + stride)
    xt = torch.from_numpy(x).to(TORCH[dtype])
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = _tiled_walk(xt, wt, stride, 1)
    plain = depthwise_conv.depthwise_conv2d_plain(xt, wt, stride, 1)
    assert torch.equal(got, plain)            # bit for bit, both types
    ref = depthwise_conv_pallas(jnp.asarray(x, JNP[dtype]),
                                jnp.asarray(w, JNP[dtype]), stride, 1,
                                interpret=True)
    tol = 1e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _launched(monkeypatch):
    """Records the weight each kernel launch is handed, on meta tensors (so
    the CUDA branch runs without a card) with ``_conv.launch`` stubbed."""
    seen = []

    def launch(fn, name, x, wt, kernel, stride, padding):
        seen.append(wt)
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)

    monkeypatch.setattr(depthwise_conv._conv, "launch", launch)
    return seen


def test_eval_weight_cast_is_made_once_per_version(monkeypatch):
    """The kernels take the OIHW weight itself, in x's type: no relayout.
    In eval (no autograd) the cast comes from ``_prepared``, once per
    version of the weight."""
    _prepared.clear()
    seen = _launched(monkeypatch)
    assert not hasattr(depthwise_conv, "kernel_weight")
    x = torch.empty((2, 8, 8, 16), dtype=torch.bfloat16, device="meta")
    w = torch.nn.Parameter(torch.empty((16, 1, 3, 3), device="meta"))
    try:
        with torch.no_grad():
            depthwise_conv.depthwise_conv2d(x, w, 1, 1)
            depthwise_conv.depthwise_conv2d(x, w, 2, 1)
            w.add_(1)
            depthwise_conv.depthwise_conv2d(x, w, 1, 1)
        assert seen[0] is seen[1] and seen[2] is not seen[0]
        for wt in seen:
            assert wt.shape == (16, 1, 3, 3) and wt.is_contiguous()
            assert wt.dtype == torch.bfloat16
    finally:
        _prepared.clear()


def test_recording_autograd_never_caches_the_cast(monkeypatch):
    """With autograd recording through the weight, the cast is made afresh
    on every call, inside the graph, and nothing enters the cache."""
    _prepared.clear()
    seen = _launched(monkeypatch)
    x = torch.empty((2, 8, 8, 16), dtype=torch.bfloat16, device="meta")
    w = torch.nn.Parameter(torch.empty((16, 1, 3, 3), device="meta"))
    depthwise_conv.depthwise_conv2d(x, w, 1, 1)
    depthwise_conv.depthwise_conv2d(x, w, 1, 1)
    assert seen[0] is not seen[1] and not _prepared._CACHE
    assert all(wt.dtype == torch.bfloat16 and wt.shape == (16, 1, 3, 3)
               for wt in seen)
