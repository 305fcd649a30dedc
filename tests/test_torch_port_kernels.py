"""The port's fused 1x1 conv kernel module against the JAX package's Pallas
kernel (run in interpret mode on the CPU).

On CPU tensors the port's wrappers run the kernel's plain PyTorch version,
so this holds that version, the on-card kernel's oracle, to the TPU kernel.
Tolerances are tests/test_pallas.py's: 1e-4 in float32, 1e-2 in bf16 (one
bf16 ulp is 2^-8 relative; the two sum the same exact products in another
order, so a rounding may land one ulp apart).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from convnet_tpu.ops.pallas import matmul_fused as jax_mf
from convnet_tpu_torch.ops.kernels import matmul_fused as mf

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k) * 4).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    shift = (rng.standard_normal(n) * 2).astype(np.float32)
    return x, w, scale, shift


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu", "relu6"])
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (49, 3 * 49)
                                   for k in (64, 256) for n in (64, 256)])
def test_matmul_scale_act_matches_pallas(m, k, n, act, dtype):
    x, w, scale, shift = _inputs(m, k, n, seed=m + k + n)
    ref = jax_mf.matmul_scale_act(jnp.asarray(x, dtype), jnp.asarray(w),
                                  jnp.asarray(scale), jnp.asarray(shift),
                                  act=act, interpret=True)
    out = mf.matmul_scale_act(torch.from_numpy(x).to(TORCH_DTYPE[dtype]),
                              torch.from_numpy(w), torch.from_numpy(scale),
                              torch.from_numpy(shift), act=act)
    assert out.dtype == TORCH_DTYPE[dtype] and out.shape == (m, n)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_conv1x1_bn_act_nhwc_matches_pallas():
    """The NHWC wrapper, with the port's OIHW weight, against the JAX one
    with its HWIO weight (float32, tolerance 1e-4)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 7, 64)).astype(np.float32)
    w_hwio = (rng.standard_normal((1, 1, 64, 96)) / 8).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 96).astype(np.float32)
    shift = rng.standard_normal(96).astype(np.float32)
    ref = jax_mf.conv1x1_bn_act(jnp.asarray(x), jnp.asarray(w_hwio),
                                jnp.asarray(scale), jnp.asarray(shift),
                                act="relu", interpret=True)
    w_oihw = torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1)))
    out = mf.conv1x1_bn_act(torch.from_numpy(x), w_oihw,
                            torch.from_numpy(scale), torch.from_numpy(shift),
                            act="relu")
    assert out.shape == (2, 7, 7, 96)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, w, scale, shift = (torch.from_numpy(a) for a in _inputs(5, 8, 3, 1))
    before = mf.launches
    out = mf.matmul_scale_act(x, w, scale, shift, act="relu")
    assert mf.launches == before
    torch.testing.assert_close(
        out, mf.matmul_scale_act_plain(x, w, scale, shift, "relu"))


def test_wrapper_rejects_what_it_cannot_run():
    x, w, scale, shift = (torch.from_numpy(a) for a in _inputs(5, 8, 3, 2))
    with pytest.raises(ValueError, match="device"):
        mf.matmul_scale_act(x.to("meta"), w.to("meta"), scale.to("meta"),
                            shift.to("meta"))
    with pytest.raises(ValueError, match="act"):
        mf.matmul_scale_act(x, w, scale, shift, act="gelu")
    with pytest.raises(ValueError, match="shapes"):
        mf.matmul_scale_act(x, w.t(), scale, shift)
    with pytest.raises(ValueError, match="scale"):
        mf.matmul_scale_act(x, w, scale.double(), shift)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu", "relu6"])
def test_matmul_scale_act_gradients_match_jax_vjp(act, dtype):
    """dx, dw, dscale and dshift against the JAX custom VJP (Pallas forward
    in interpret mode): 1e-4 in float32; 1e-2 relative to the largest
    entry in bf16, where both round r = dy * scale to bf16 before the
    matmuls."""
    import jax

    x, w, scale, shift = _inputs(49, 64, 32, seed=7)
    dy = np.random.default_rng(8).standard_normal((49, 32)).astype(
        np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    _, vjp = jax.vjp(lambda a, b, c, d: jax_mf.matmul_scale_act(
        a, b, c, d, act=act, interpret=True), jnp.asarray(x, jd),
        jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift))
    refs = vjp(jnp.asarray(dy, jd))
    ins = [torch.from_numpy(x).to(TORCH_DTYPE[dtype]).requires_grad_(),
           *(torch.from_numpy(a).requires_grad_() for a in (w, scale, shift))]
    out = mf.matmul_scale_act(*ins, act=act)
    out.backward(torch.from_numpy(dy).to(TORCH_DTYPE[dtype]))
    for t, ref in zip(ins, refs):
        ref = np.asarray(ref, np.float32)
        got = t.grad.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
