"""The port's fused inverted residual (``ops/kernels/mbconv.py``) against the
JAX package's (``convnet_tpu/ops/pallas/mbconv.py``), on the CPU.

On CPU tensors the port's wrappers run the kernels' plain versions (the
oracle the CUDA kernels are held to on the card); here they are held to the
Pallas kernels in interpret mode, as ``tests/test_mbconv_fused.py`` runs
them, on the same numpy inputs. Tolerances: the reference's own, 2e-5 for
``mbconv_infer`` and 3e-5 for the training forward in float32 (summation
order only), 5e-4 / 5e-5 for the gradients; the batch moments 1e-4 relative
plus 1e-5 absolute (float32 sums over every pixel in another order). In bf16
the two round the same float32 values to bf16 (the hidden tensor u2 before
the project, the output after it), so they may land one bf16 ulp (2^-8
relative) apart: 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu.ops.pallas import mbconv as jmb
from convnet_tpu_torch.ops.kernels import mbconv

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NAMES = ("x", "we", "g1", "b1", "wd", "g2", "b2", "wpj", "g3", "b3")


def _inputs(b, h, w, cin, ch, cout, seed, expand=True):
    """x (B, H, W, Cin), we (Cin, Ch), wd (3, 3, 1, Ch), wpj (Ch, Cout) and
    per-channel vectors, float32 numpy; the vectors serve as (scale, shift)
    in eval and as (gamma, beta) in training."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0, loc=0.0):
        return (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    return {"x": n(b, h, w, cin), "we": n(cin, ch, scale=0.3) if expand
            else None,
            "g1": n(ch, scale=0.2, loc=1.0) if expand else None,
            "b1": n(ch, scale=0.2, loc=1.0) if expand else None,
            "wd": n(3, 3, 1, ch, scale=0.3), "g2": n(ch, scale=0.2, loc=1.0),
            "b2": n(ch, scale=0.2, loc=1.0), "wpj": n(ch, cout, scale=0.3),
            "g3": n(cout, scale=0.2, loc=0.5), "b3": n(cout, scale=0.2,
                                                        loc=0.5)}


def _jax(a, dtype="float32"):
    return [None if a[k] is None else
            jnp.asarray(a[k], JNP[dtype] if k == "x" else jnp.float32)
            for k in NAMES]


def _torch(a, dtype="float32"):
    return [None if a[k] is None else
            torch.from_numpy(a[k]).to(TORCH[dtype] if k == "x"
                                      else torch.float32)
            for k in NAMES]


def _np(v):
    return np.asarray(v.float().detach().numpy() if torch.is_tensor(v)
                      else jnp.asarray(v, jnp.float32))


# (B, H, W, Cin, Ch, Cout, expand, residual, act_out)
INFER = [
    (2, 8, 8, 8, 24, 8, True, True, "none"),
    (2, 8, 8, 8, 24, 8, True, False, "none"),
    (2, 8, 8, 24, 24, 16, False, False, "relu"),   # the MobileNet-v1 pair
    (1, 12, 6, 8, 16, 8, True, True, "none"),      # W != H
    (1, 56, 4, 8, 8, 8, True, True, "none"),       # two reference row chunks
    (2, 7, 5, 5, 17, 5, True, True, "none"),       # C % 8 != 0, W odd
    (2, 9, 9, 13, 13, 7, False, False, "none"),    # no expand, C % 8 != 0
    (1, 6, 6, 16, 72, 24, True, False, "relu6"),   # hidden above one chunk
]


@pytest.mark.parametrize("b,h,w,cin,ch,cout,expand,residual,act_out", INFER)
def test_mbconv_infer_matches_pallas(b, h, w, cin, ch, cout, expand,
                                     residual, act_out):
    a = _inputs(b, h, w, cin, ch, cout, seed=cin + ch, expand=expand)
    ref = jmb.mbconv_infer(*_jax(a), residual=residual, act_out=act_out,
                           interpret=True)
    got = mbconv.mbconv_infer(*_torch(a), residual=residual, act_out=act_out)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("expand", [True, False])
def test_mbconv_infer_bf16_matches_pallas(expand):
    a = _inputs(2, 8, 8, 16, 48 if expand else 16, 16, seed=3,
                expand=expand)
    ref = jmb.mbconv_infer(*_jax(a, "bfloat16"), residual=True,
                           interpret=True)
    got = mbconv.mbconv_infer(*_torch(a, "bfloat16"), residual=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-2, atol=1e-2)


def test_padding_mask_comes_after_bn_and_relu6():
    """x = 0, so the expand BN gives t1 everywhere and ReLU6 keeps it (0 <
    t1 < 6/9). Outside the image the hidden tensor is 0, not act(t1): with
    all-ones taps and an identity project, y counts the in-image
    neighbours, 4 at a corner, 6 on an edge, 9 inside. Padding x with zeros
    before the expand would give 9 * t1 everywhere."""
    b, h, w, c = 1, 5, 6, 8
    t1 = np.linspace(0.1, 0.6, c).astype(np.float32)
    a = {"x": np.zeros((b, h, w, c), np.float32),
         "we": np.eye(c, dtype=np.float32), "g1": np.ones(c, np.float32),
         "b1": t1, "wd": np.ones((3, 3, 1, c), np.float32),
         "g2": np.ones(c, np.float32), "b2": np.zeros(c, np.float32),
         "wpj": np.eye(c, dtype=np.float32), "g3": np.ones(c, np.float32),
         "b3": np.zeros(c, np.float32)}
    rows = np.array([2] + [3] * (h - 2) + [2], np.float32)
    cols = np.array([2] + [3] * (w - 2) + [2], np.float32)
    want = (rows[:, None, None] * cols[None, :, None]) * t1
    got = _np(mbconv.mbconv_infer(*_torch(a), residual=False))[0]
    ref = _np(jmb.mbconv_infer(*_jax(a), residual=False, interpret=True))[0]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(ref, want, rtol=1e-6)
    assert not np.allclose(got[0, 0], 9 * t1)


def _moments(stats):
    return [None if s is None else [_np(v) for v in s] for s in stats]


@pytest.mark.parametrize("expand,residual", [(True, True), (True, False),
                                             (False, True)])
def test_train_forward_matches_pallas(expand, residual):
    cin, ch = (8, 24) if expand else (16, 16)
    a = _inputs(2, 8, 6, cin, ch, cin if residual else 12, seed=7,
                expand=expand)
    ref, ref_stats = jmb.mbconv_train_forward(*_jax(a), residual=residual,
                                              interpret=True)
    got, stats = mbconv.mbconv_train_forward(*_torch(a), residual=residual)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=3e-5, atol=3e-5)
    assert (stats[0] is None) == (not expand) == (ref_stats[0] is None)
    for mine, theirs in zip(_moments(stats), _moments(ref_stats)):
        if theirs is None:
            continue
        for v, r in zip(mine, theirs):
            assert v.shape == r.shape
            np.testing.assert_allclose(v, r, rtol=1e-4, atol=1e-5)


def test_gram_stats_in_bf16_are_the_float32_moments():
    """The expand-BN moments of a bf16 x from the Gram trick equal those of
    the materialized float32 h = x @ we: X is cast to float32 before XᵀX."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((4, 6, 6, 16)).astype(
        np.float32)).to(torch.bfloat16)
    we = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    mean, var = mbconv._gram_stats(x, we)
    h = x.reshape(-1, 16).double() @ we.double()
    torch.testing.assert_close(mean.double(), h.mean(0), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(var.double(), h.var(0, unbiased=False),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("expand", [True, False])
def test_train_gradients_match_jax(expand):
    """The gradients of sum(out²) through mbconv_train against jax.grad of
    the JAX package's mbconv_train (its custom VJP), every argument."""
    cin, ch = (8, 16) if expand else (8, 8)
    a = _inputs(1, 6, 6, cin, ch, 8, seed=13, expand=expand)

    def loss(*args):
        out, _ = jmb.mbconv_train(*args, residual=True, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    live = [i for i, k in enumerate(NAMES) if a[k] is not None]
    ref = jax.grad(loss, argnums=tuple(live))(*_jax(a))
    args = _torch(a)
    for i in live:
        args[i].requires_grad_()
    out, _ = mbconv.mbconv_train(*args, residual=True)
    out.float().square().sum().backward()
    for i, r in zip(live, ref):
        np.testing.assert_allclose(_np(args[i].grad), _np(r), rtol=5e-4,
                                   atol=5e-5, err_msg=NAMES[i])


def test_tile_fits_the_kernel():
    """Every image size gets a tile of at most 64 output and 104 haloed
    pixels that fits the image; the path's sizes get the tiles the
    kernel's shared-memory budget was sized for."""
    for h in range(1, 40):
        for w in (1, 2, 5, 7, 13, 14, 16, 28, 33, 56, 112):
            th, tw = mbconv.tile(h, w)
            assert 1 <= th <= h and 1 <= tw <= w
            assert th * tw <= mbconv.MAX_Q
            assert (th + 2) * (tw + 2) <= mbconv.MAX_P
    assert [mbconv.tile(s, s) for s in (112, 56, 28, 14, 7)] == \
        [(8, 8), (8, 8), (7, 7), (7, 7), (7, 7)]
    assert mbconv.smem_bytes(7, 7, 160, 320, True, True) < mbconv.SMEM_LIMIT


def test_wrappers_count_no_launch_on_cpu_and_reject_what_they_cannot_run():
    a = _torch(_inputs(1, 5, 5, 8, 16, 8, seed=2))
    x, we, g1, b1, wd, g2, b2, wpj, g3, b3 = a
    wd9 = wd.reshape(9, 16)
    before = (mbconv.full_launches, mbconv.stats_launches,
              mbconv.raw_launches)
    mbconv.mbconv_full(x, we, g1, b1, wd9, g2, b2, wpj, g3, b3,
                       residual=True)
    mbconv.mbconv_stats(x, we, g1, b1, wd9)
    mbconv.mbconv_raw(x, we, g1, b1, wd9, g2, b2, wpj)
    assert (mbconv.full_launches, mbconv.stats_launches,
            mbconv.raw_launches) == before
    with pytest.raises(ValueError, match="device"):
        mbconv.mbconv_stats(x.to("meta"), we.to("meta"), g1.to("meta"),
                            b1.to("meta"), wd9.to("meta"))
    with pytest.raises(ValueError, match="Cin == Cout"):
        mbconv.mbconv_full(x, we, g1, b1, wd9, g2, b2, wpj[:, :4], g3[:4],
                           b3[:4], residual=True)
    with pytest.raises(ValueError, match="expand"):
        mbconv.mbconv_stats(x, None, None, None, wd9)
    with pytest.raises(ValueError, match="act"):
        mbconv.mbconv_stats(x, we, g1, b1, wd9, act_mid="gelu")
    assert mbconv.supported(1, 3) and mbconv.supported((1, 1), (3, 3))
    assert not mbconv.supported(2, 3) and not mbconv.supported(1, 5)
    assert not mbconv.supported(1, 3, dilation=2)
