"""The port's losses, meters and mixup/cutmix against the JAX package's, on
the CPU.

Losses: cross-entropy with per-class weights (hard and soft targets,
ignored rows, every reduction), with a non-uniform smoothing distribution,
and binary cross-entropy from logits and from probabilities, with and
without smoothing: float32 both, held at 1e-5. Meters: ``OnlineMeter`` and
the host-side ``accuracy`` (the same float64 arithmetic: 1e-12).

Mixup and cutmix take λ (and the box centre) as arguments in the port. The
test draws them through the JAX package's own ``_sample_lam`` and the
centre ``rand_bbox_mask`` draws from the same key, passes them to the port's
functions, and holds the mixed images and soft targets to the JAX
functions' outputs for the same key: float32 at 1e-6 (the same products), the
cutmix mask and box exactly, bf16 images at one bf16 ulp (2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu.train import losses as jax_losses
from convnet_tpu.train import meters as jax_meters
from convnet_tpu.train import mixup as jax_mixup
from convnet_tpu_torch.train import losses, meters, mixup

TOL = 1e-5
MIX_TOL = {"float32": 1e-6, "bfloat16": 2 ** -8}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NUM_CLASSES = 7


def _rng(seed):
    return np.random.default_rng(seed)


def _logits_targets(seed, soft):
    rng = _rng(seed)
    logits = (rng.standard_normal((6, NUM_CLASSES)) * 3).astype(np.float32)
    if soft:
        target = rng.dirichlet(np.ones(NUM_CLASSES), 6).astype(np.float32)
    else:
        target = rng.integers(0, NUM_CLASSES, 6)
        target[[1, 4]] = -100
    return logits, target


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("soft", [False, True])
def test_cross_entropy_class_weights_match_jax(reduction, soft):
    logits, target = _logits_targets(30, soft)
    weight = _rng(31).uniform(0.2, 3.0, NUM_CLASSES).astype(np.float32)
    ref = jax_losses.CrossEntropyLoss(weight=jnp.asarray(weight),
                                      reduction=reduction, smooth_eps=0.1)(
        jnp.asarray(logits), jnp.asarray(target))
    out = losses.CrossEntropyLoss(weight=torch.from_numpy(weight),
                                  reduction=reduction, smooth_eps=0.1)(
        torch.from_numpy(logits), torch.from_numpy(target))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("soft", [False, True])
def test_cross_entropy_smooth_dist_matches_jax(soft):
    logits, target = _logits_targets(32, soft)
    dist = _rng(33).dirichlet(np.ones(NUM_CLASSES)).astype(np.float32)
    ref = jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(target),
                                   smooth_eps=0.2, smooth_dist=dist)
    out = losses.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(target), smooth_eps=0.2,
                               smooth_dist=dist)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL)


@pytest.mark.parametrize("from_logits", [True, False])
@pytest.mark.parametrize("smooth_eps", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_binary_cross_entropy_matches_jax(from_logits, smooth_eps, reduction):
    rng = _rng(34)
    x = (rng.standard_normal((5, 4)) * 4).astype(np.float32)
    if not from_logits:
        x = 1 / (1 + np.exp(-x))
        x[0, :2] = [0.0, 1.0]                 # clipped to [1e-7, 1 - 1e-7]
    target = rng.uniform(0, 1, (5, 4)).astype(np.float32)
    target[1] = np.round(target[1])           # a row of hard labels
    ref = jax_losses.BCELoss(reduction, smooth_eps, from_logits)(
        jnp.asarray(x), jnp.asarray(target))
    out = losses.BCELoss(reduction, smooth_eps, from_logits)(
        torch.from_numpy(x), torch.from_numpy(target))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_onehot_matches_jax():
    target = np.array([0, 3, 6, 2])
    np.testing.assert_array_equal(
        losses.onehot(torch.from_numpy(target), NUM_CLASSES).numpy(),
        np.asarray(jax_losses.onehot(jnp.asarray(target), NUM_CLASSES)))


def test_online_meter_and_accuracy_match_jax():
    values = _rng(35).standard_normal(50) * 3 + 1
    ours, theirs = meters.OnlineMeter(), jax_meters.OnlineMeter()
    for v in values:
        ours.update(v)
        theirs.update(v)
    for attr in ("count", "mean", "var", "std"):
        assert getattr(ours, attr) == pytest.approx(getattr(theirs, attr),
                                                    rel=1e-12)
    assert ours.var == pytest.approx(np.var(values, ddof=1), rel=1e-12)
    logits, target = _logits_targets(36, False)
    target = np.abs(target) % NUM_CLASSES
    for t in (target, np.eye(NUM_CLASSES, dtype=np.float32)[target]):
        assert meters.accuracy(logits, t, (1, 3)) == pytest.approx(
            jax_meters.accuracy(logits, t, (1, 3)), rel=1e-12)


# ------------------------------------------------------------ mixup, cutmix

def _batch(dtype, seed=37):
    rng = _rng(seed)
    x = rng.standard_normal((6, 9, 11, 3)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, 6)
    return (jnp.asarray(x, JNP[dtype]), jnp.asarray(y),
            torch.from_numpy(x).to(TORCH[dtype]), torch.from_numpy(y))


def _centre(kbox, height, width):
    """The box centre that ``rand_bbox_mask(kbox, ...)`` draws."""
    ky, kx = jax.random.split(kbox)
    return (int(jax.random.randint(ky, (), 0, height)),
            int(jax.random.randint(kx, (), 0, width)))


def _check_mix(ours, theirs, dtype):
    (mx, soft), (j_mx, j_soft) = ours, theirs
    assert mx.dtype == TORCH[dtype] and soft.dtype == torch.float32
    np.testing.assert_allclose(mx.float().numpy(),
                               np.asarray(j_mx, np.float32),
                               rtol=MIX_TOL[dtype], atol=MIX_TOL[dtype])
    np.testing.assert_allclose(soft.numpy(), np.asarray(j_soft), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_mixup_matches_jax_given_lambda(dtype, alpha):
    jx, jy, tx, ty = _batch(dtype)
    key = jax.random.PRNGKey(int(alpha * 10))
    lam = float(jax_mixup._sample_lam(key, alpha))
    _check_mix(mixup.mixup_batch(tx, ty, NUM_CLASSES, lam),
               jax_mixup.mixup_batch(key, jx, jy, NUM_CLASSES, alpha), dtype)


@pytest.mark.parametrize("seed", range(6))
def test_rand_bbox_mask_matches_jax(seed):
    """Boxes inside the image and clipped at the top, left and right."""
    key = jax.random.PRNGKey(seed)
    klam, kbox = jax.random.split(key)
    lam = float(jax_mixup._sample_lam(klam, 1.0))
    j_mask, j_box = jax_mixup.rand_bbox_mask(kbox, 9, 11, lam)
    mask, box = mixup.rand_bbox_mask(9, 11, lam, *_centre(kbox, 9, 11))
    assert box == tuple(int(b) for b in j_box)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 3])
def test_cutmix_matches_jax_given_lambda_and_centre(dtype, seed):
    jx, jy, tx, ty = _batch(dtype)
    key = jax.random.PRNGKey(seed)
    klam, kbox = jax.random.split(key)
    lam = float(jax_mixup._sample_lam(klam, 1.0))
    ours = mixup.cutmix_batch(tx, ty, NUM_CLASSES, lam,
                              *_centre(kbox, 9, 11))
    _check_mix(ours, jax_mixup.cutmix_batch(key, jx, jy, NUM_CLASSES, 1.0),
               dtype)
    # a box was pasted
    changed = (ours[0] != tx).any(dim=(0, 3))
    assert changed.any()


def test_samplers_draw_from_their_seed():
    x = torch.zeros(4, 9, 11, 3)
    y = torch.arange(4)
    a, b = mixup.CutMix(1.0, NUM_CLASSES, seed=5), mixup.CutMix(1.0, seed=5)
    draws = [a.sample(x) for _ in range(3)]
    assert draws == [b.sample(x) for _ in range(3)]
    assert all(0 <= d["cy"] < 9 and 0 <= d["cx"] < 11 and 0 < d["lam"] < 1
               for d in draws)
    mixed, soft = mixup.MixUp(0.2, NUM_CLASSES, seed=5)(x + y[:, None, None,
                                                            None], y)
    assert soft.shape == (4, NUM_CLASSES)
    torch.testing.assert_close(soft.sum(-1), torch.ones(4))
    torch.testing.assert_close(mixed + mixed.flip(0),
                               (x + y[:, None, None, None]) * 0 + 3.0)
