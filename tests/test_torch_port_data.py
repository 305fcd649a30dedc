"""The port's datasets, device transforms, ``get_transform``,
``ArrayBatcher`` and ``DataRegime`` against the JAX package's, on the CPU.

A ``jax.random`` key cannot drive a ``torch.Generator``: the deterministic
ops are held exactly (or within 1e-6), each random op by feeding its
application the JAX draws, and the port's draws by their ranges and rates.
``resize`` and ``resized_crop`` (antialiased triangle weights, two batched
matmuls) are held within 1e-4 of ``jax.image`` in both directions: Mix &
Match shrinks and grows CIFAR batches.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convnet_tpu import models as jax_models
from convnet_tpu.data import datasets as jax_datasets
from convnet_tpu.data import loader as jax_loader
from convnet_tpu.data import preprocess as jax_pre
from convnet_tpu.data import transforms as JT
from convnet_tpu.data.data_regime import DataRegime as JaxDataRegime
from convnet_tpu_torch import models
from convnet_tpu_torch.data import datasets, loader, preprocess
from convnet_tpu_torch.data import transforms as T
from convnet_tpu_torch.data.data_regime import DataRegime

EXACT = 1e-6
RESAMPLE_TOL = 1e-4


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax(fn, *args):
    return np.asarray(fn(*args))


@pytest.mark.parametrize("name,kwargs", [
    ("synthetic", {"size": 24}),
    ("synthetic_imagenet", {"size": 6, "image_size": 40}),
    ("synthetic_structured", {"size": 20, "image_size": 16, "noise": 0.2}),
    ("synthetic_mnist", {"size": 12, "image_size": 28, "channels": 1}),
])
@pytest.mark.parametrize("split", ["train", "val"])
def test_get_dataset_matches_jax(name, kwargs, split):
    ours = datasets.get_dataset(name, split, **kwargs)
    ref = jax_datasets.get_dataset(name, split, **kwargs)
    assert type(ours).__name__ == type(ref).__name__
    np.testing.assert_array_equal(ours.data, ref.data)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert ours.labels.dtype == ref.labels.dtype
    assert ours.num_classes == ref.num_classes and len(ours) == len(ref)


# ------------------------------------------------------------ transforms


def test_deterministic_ops_match_jax():
    u8 = (np.random.default_rng(1).random((3, 12, 10, 3)) * 255).astype(
        np.uint8)
    np.testing.assert_array_equal(T.to_float(_t(u8)).numpy(),
                                  _jax(JT.to_float, jnp.asarray(u8)))
    x = _x((3, 12, 10, 3))
    stats = preprocess.DATASET_STATS["cifar10"]
    np.testing.assert_allclose(
        T.normalize(_t(x), stats["mean"], stats["std"]).numpy(),
        _jax(JT.normalize, x, stats["mean"], stats["std"]), atol=EXACT)
    np.testing.assert_array_equal(T.center_crop(_t(x), 7).numpy(),
                                  _jax(JT.center_crop, x, 7))


def test_random_ops_match_jax_given_its_draws():
    x = _x((5, 12, 12, 3), seed=2)
    key = jax.random.PRNGKey(3)
    b = x.shape[0]
    # flip: bernoulli(key, p, (b, 1, 1, 1))
    flip = np.asarray(jax.random.bernoulli(key, 0.5, (b, 1, 1, 1))).reshape(b)
    np.testing.assert_array_equal(T.hflip(_t(x), _t(flip)).numpy(),
                                  _jax(JT.random_hflip, key, x))
    # pad + crop: randint of fold_in(key, 0) and fold_in(key, 1)
    pad = 4
    oy = jax.random.randint(jax.random.fold_in(key, 0), (b,), 0, 2 * pad + 1)
    ox = jax.random.randint(jax.random.fold_in(key, 1), (b,), 0, 2 * pad + 1)
    np.testing.assert_array_equal(
        T.pad_crop(_t(x), pad, _t(oy).long(), _t(ox).long()).numpy(),
        _jax(JT.pad_random_crop, key, x, pad))
    oy = jax.random.randint(jax.random.fold_in(key, 0), (b,), 0, 12 - 8 + 1)
    ox = jax.random.randint(jax.random.fold_in(key, 1), (b,), 0, 12 - 8 + 1)
    np.testing.assert_array_equal(
        T.crop(_t(x), 8, 8, _t(oy).long(), _t(ox).long()).numpy(),
        _jax(JT.random_crop, key, x, 8))
    # cutout: per-sample keys, then fold_in(fold_in(k, i), 0 / 1)
    size, count = 5, 2
    keys = jax.random.split(key, b)
    cy = np.array([[int(jax.random.randint(jax.random.fold_in(
        jax.random.fold_in(k, i), 0), (), 0, 12)) for i in range(count)]
        for k in keys])
    cx = np.array([[int(jax.random.randint(jax.random.fold_in(
        jax.random.fold_in(k, i), 1), (), 0, 12)) for i in range(count)]
        for k in keys])
    np.testing.assert_array_equal(
        T.cutout(_t(x), size, _t(cy), _t(cx)).numpy(),
        _jax(JT.cutout, key, x, size, count))
    # lighting: alphastd * normal(key, (b, 3))
    pca = preprocess.IMAGENET_PCA
    alpha = 0.1 * np.asarray(jax.random.normal(key, (b, 3), jnp.float32))
    np.testing.assert_allclose(
        T.lighting(_t(x), _t(alpha), pca["eigval"], pca["eigvec"]).numpy(),
        _jax(JT.lighting, key, x, 0.1, pca["eigval"], pca["eigvec"]),
        atol=EXACT)


@pytest.mark.parametrize("h,w,size", [(32, 32, 24), (32, 32, 40),
                                      (32, 32, 128), (30, 30, 16),
                                      (20, 28, 32), (64, 48, 16)])
def test_resize_and_resized_crop_match_jax(h, w, size):
    x = _x((3, h, w, 3), seed=h + size)
    if h == w:   # the resize of Mix & Match, shrinking and growing
        np.testing.assert_allclose(T.resize(_t(x), size).numpy(),
                                   _jax(JT.resize, jnp.asarray(x), size),
                                   atol=RESAMPLE_TOL)
    key = jax.random.PRNGKey(size)
    # the reference's box draws (transforms.py random_resized_crop)
    k_area, k_ratio, k_y, k_x = jax.random.split(key, 4)
    b = x.shape[0]
    area = jax.random.uniform(k_area, (b,), minval=0.08, maxval=1.0)
    r = jnp.exp(jax.random.uniform(k_ratio, (b,), minval=jnp.log(3 / 4),
                                   maxval=jnp.log(4 / 3)))
    bh = jnp.clip(jnp.sqrt(area * h * w / r), 8.0, float(h))
    bw = jnp.clip(jnp.sqrt(area * h * w / r) * r, 8.0, float(w))
    oy = jax.random.uniform(k_y, (b,)) * (h - bh)
    ox = jax.random.uniform(k_x, (b,)) * (w - bw)
    ours = T.resized_crop(_t(x), size, _t(bh), _t(bw), _t(oy), _t(ox))
    np.testing.assert_allclose(
        ours.numpy(), _jax(JT.random_resized_crop, key, jnp.asarray(x), size),
        atol=RESAMPLE_TOL)


def test_port_draws_ranges_and_rates():
    g = torch.Generator().manual_seed(0)
    n = 20000
    assert abs(float(T.draw_hflip(g, n).float().mean()) - 0.5) < 0.02
    oy, ox = T.draw_offsets(g, n, 9, 5)
    assert int(oy.min()) == 0 and int(oy.max()) == 8
    assert int(ox.min()) == 0 and int(ox.max()) == 4
    cy, cx = T.draw_cutout(g, n, 12, 7, count=2)
    assert cy.shape == (n, 2) and int(cy.max()) == 11 and int(cx.max()) == 6
    alpha = T.draw_lighting(g, n, 0.1)
    assert abs(float(alpha.std()) - 0.1) < 0.005
    assert abs(float(alpha.mean())) < 0.005
    bh, bw, oy, ox = T.draw_resized_crop_boxes(g, n, 40, 30)
    assert float(bh.min()) >= 8 and float(bh.max()) <= 40
    assert float(bw.min()) >= 8 and float(bw.max()) <= 30
    assert float(oy.min()) >= 0 and bool(((oy + bh) <= 40 + 1e-4).all())
    assert float(ox.min()) >= 0 and bool(((ox + bw) <= 30 + 1e-4).all())
    # the area share before clipping is uniform over [0.08, 1)
    share = (bh * bw / (40 * 30))[(bh < 40) & (bw < 30)]
    assert 0.08 - 1e-4 <= float(share.min()) and float(share.max()) <= 1.0
    # the same seed draws the same values
    a = T.random_resized_crop(torch.Generator().manual_seed(5),
                              _t(_x((2, 16, 16, 3))), 8)
    b = T.random_resized_crop(torch.Generator().manual_seed(5),
                              _t(_x((2, 16, 16, 3))), 8)
    assert torch.equal(a, b)


# ------------------------------------------------------------ get_transform


@pytest.mark.parametrize("name,shape", [("cifar10", (32, 32, 3)),
                                        ("mnist", (28, 28, 1)),
                                        ("imagenet", (50, 60, 3))])
@pytest.mark.parametrize("augment", [True, False])
def test_get_transform_matches_jax(name, shape, augment):
    size = 40 if name == "imagenet" else None
    ours = preprocess.get_transform(name, input_size=size, augment=augment,
                                    cutout={"length": 4}, lighting=True)
    ref = jax_pre.get_transform(name, input_size=size, augment=augment,
                                cutout={"length": 4}, lighting=True)
    assert ours.input_size == ref.input_size
    assert ours.duplicates == ref.duplicates
    assert ours.native_spec == ref.native_spec
    rng = np.random.default_rng(7)
    samples = (rng.random((4,) + shape) * 255).astype(np.uint8)
    if shape[-1] == 1:
        samples = samples[..., 0]
    host = [ours.host(s, random.Random(i), 0) for i, s in enumerate(samples)]
    want = [ref.host(s, random.Random(i), 0) for i, s in enumerate(samples)]
    for a, b in zip(host, want):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    batch = np.stack(host)
    if batch.ndim == 3:
        batch = batch[..., None]
    gen = torch.Generator().manual_seed(0)
    out = ours.device(gen, _t(batch))
    expect = np.asarray(ref.device(jax.random.PRNGKey(0), jnp.asarray(batch)))
    assert out.shape == expect.shape and out.dtype == torch.float32
    if augment:   # the draws differ: the same seed gives the same batch
        again = ours.device(torch.Generator().manual_seed(0), _t(batch))
        assert torch.equal(out, again) and torch.isfinite(out).all()
    else:
        np.testing.assert_allclose(out.numpy(), expect, atol=EXACT)


# ------------------------------------------------------------ loaders


def _eval_transform(pkg, size=None, dup=1):
    return pkg.get_transform("cifar10", input_size=size, augment=False,
                             duplicates=dup)


@pytest.mark.parametrize("size,tol", [(None, EXACT), (24, RESAMPLE_TOL),
                                      (40, RESAMPLE_TOL)])
def test_array_batcher_matches_jax(size, tol):
    """Labels, order and un-augmented batches over 2 epochs with
    duplicates=2; at 24 and 40 the batches are Mix & Match's resizes."""
    ds = datasets.get_dataset("synthetic", "train", size=40)
    jds = jax_datasets.get_dataset("synthetic", "train", size=40)
    ours = loader.ArrayBatcher(ds, _eval_transform(preprocess, size, 2), 8,
                               seed=5, device="cpu")
    ref = jax_loader.ArrayBatcher(jds, _eval_transform(jax_pre, size, 2), 8,
                                  seed=5)
    assert len(ours) == len(ref) == 5
    for epoch in range(2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        pairs = list(zip(ours, ref))
        assert len(pairs) == 5
        for (x, y), (jx, jy) in pairs:
            np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
            np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=tol)
            assert x.shape[0] == 16 and torch.equal(x[0::2], x[1::2])


def test_array_batcher_augments_from_its_epoch_seed():
    ds = datasets.get_dataset("synthetic", "train", size=32)
    tf = preprocess.get_transform("cifar10", augment=True)
    a = loader.ArrayBatcher(ds, tf, 8, seed=1, device="cpu")
    b = loader.ArrayBatcher(ds, tf, 8, seed=1, device="cpu")
    first = [x for x, _ in a]
    assert all(torch.equal(x, y) for x, (y, _) in zip(first, b))
    a.set_epoch(1)
    assert not torch.equal(first[0], next(iter(a))[0])


def test_data_regime_mixmatch_matches_jax():
    """The model's Mix & Match schedule rebuilds the loader at the same
    epochs with the same input sizes as the JAX DataRegime's."""
    epochs = 10
    model = models.build("resnet", depth=18, regime="mixmatch",
                         epochs=epochs)
    ref_model = jax_models.build("resnet", depth=18, regime="mixmatch",
                                 epochs=epochs)
    assert model.data_regime == ref_model.data_regime
    defaults = {"name": "synthetic", "batch_size": 8, "num_workers": 0,
                "dataset_kwargs": {"size": 16}}
    ours = DataRegime(model.data_regime, defaults, seed=3, device="cpu")
    ref = JaxDataRegime(ref_model.data_regime, defaults, seed=3)
    sizes, rebuilt = [], []
    for epoch in range(epochs):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        before = ours._loader
        lo, lr = ours.get_loader(), ref.get_loader()
        assert lo.transform.input_size == lr.transform.input_size
        sizes.append(lo.transform.input_size)
        rebuilt.append(before is not lo)
        x, _ = next(iter(lo))
        jx, _ = next(iter(lr))
        assert tuple(x.shape) == tuple(jx.shape)
    assert sizes == [128] * 3 + [160] * 3 + [192] * 2 + [224] * 2
    assert rebuilt == [True, False, False, True, False, False, True, False,
                       True, False]
