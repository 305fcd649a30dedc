"""The port's threaded ``DataLoader`` against the JAX package's, on the CPU.

Host batches (``device_transform=False``: numpy uint8 images and int32
labels) must be bit-equal to the JAX ``DataLoader``'s on an ImageFolder and
an indexed tar written here, over two epochs, for the PIL path
(``CONVNET_TPU_NATIVE_DECODE=0``) and both native paths, with 0 and 4
workers and with duplicates. The host draws are seeded by
``hash((seed, epoch, i, d))``, the same in every Python process; the native
decoders are the same C++ source, the port's built by ``g++`` into
``convnet_tpu_torch/_build/``. The native eval decode is held within 1 LSB
of the PIL eval transform (``tests/test_native_jpeg.py``'s criterion), and
the device-transformed batches on the CPU against the JAX ones.
"""

import io
import random
import tarfile

import numpy as np
import pytest
import torch

from convnet_tpu.data import datasets as jax_datasets
from convnet_tpu.data import loader as jax_loader
from convnet_tpu.data import native as jax_native
from convnet_tpu.data import preprocess as jax_pre
from convnet_tpu_torch.data import datasets, loader, native, preprocess

CLASSES = 3
PER_CLASS = 6
SIZE = 24


def _jpeg(rng, h, w):
    from PIL import Image
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    """An ImageFolder (one png among the JPEGs) and an indexed tar of the
    same JPEGs, of varied sizes."""
    root = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(0)
    folder = root / "folder"
    tar_path = str(root / "imagenet_train.tar")
    with tarfile.open(tar_path, "w") as tf:
        for c in range(CLASSES):
            (folder / f"c{c}").mkdir(parents=True)
            for i in range(PER_CLASS):
                blob = _jpeg(rng, 30 + 6 * (i % 3), 34 + 4 * c)
                (folder / f"c{c}" / f"im{i}.jpg").write_bytes(blob)
                info = tarfile.TarInfo(name=f"c{c}/im{i}.jpg")
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
    from PIL import Image
    Image.fromarray((rng.random((40, 36, 3)) * 255).astype(np.uint8)).save(
        folder / "c1" / "z.png")
    return str(folder), tar_path


def _datasets(kind, dirs):
    folder, tar = dirs
    if kind == "folder":
        return datasets.ImageFolder(folder), jax_datasets.ImageFolder(folder)
    return (datasets.IndexedTarDataset(tar),
            jax_datasets.IndexedTarDataset(tar))


def _epochs(dl, n=2):
    out = []
    for epoch in range(n):
        dl.set_epoch(epoch)
        out.append(list(dl))
    return out


@pytest.mark.parametrize("kind", ["folder", "tar"])
@pytest.mark.parametrize("decode", ["pil", "native"])
@pytest.mark.parametrize("augment,workers,dup", [(True, 0, 1), (True, 4, 2),
                                                 (False, 4, 1)])
def test_host_batches_bit_equal_to_jax(data_dirs, monkeypatch, kind, decode,
                                       augment, workers, dup):
    if decode == "native":
        assert native.jpeg_available(), native.jpeg_status()
        if not jax_native.jpeg_available():
            pytest.skip("the JAX package's native decoder is unavailable")
    else:
        monkeypatch.setenv("CONVNET_TPU_NATIVE_DECODE", "0")
    ours_ds, ref_ds = _datasets(kind, data_dirs)
    assert len(ours_ds) == len(ref_ds)
    kw = dict(batch_size=5, shuffle=augment, drop_last=augment,
              num_workers=workers, seed=11, device_transform=False)
    ours = loader.DataLoader(ours_ds, preprocess.get_transform(
        "imagenet", input_size=SIZE, augment=augment, duplicates=dup), **kw)
    ref = jax_loader.DataLoader(ref_ds, jax_pre.get_transform(
        "imagenet", input_size=SIZE, augment=augment, duplicates=dup), **kw)
    got, want = _epochs(ours), _epochs(ref)
    want_native = decode == "native" and (augment or dup == 1)
    assert ours.decoder.startswith("native" if want_native else "PIL")
    assert [len(e) for e in got] == [len(e) for e in want] == [len(ours)] * 2
    for e_got, e_want in zip(got, want):
        for (x, y), (jx, jy) in zip(e_got, e_want):
            assert x.dtype == np.uint8 and y.dtype == np.int32
            assert x.shape == (len(y), SIZE, SIZE, 3)
            np.testing.assert_array_equal(y, np.asarray(jy))
            np.testing.assert_array_equal(x, np.asarray(jx))
    if augment:   # the epochs differ
        assert not np.array_equal(got[0][0][0], got[1][0][0])


def test_native_eval_decode_within_1lsb_of_pil(data_dirs):
    ds, _ = _datasets("tar", data_dirs)
    assert native.jpeg_available(), native.jpeg_status()
    idx = np.arange(len(ds))
    out, fail = native.decode_batch(ds.tar_path, ds.offsets[idx],
                                    ds.sizes[idx], train=False,
                                    out_size=SIZE, threads=2)
    assert not fail.any()
    ref = np.stack([preprocess.scale_crop_host(ds[i][0], random.Random(0),
                                               out_size=SIZE)
                    for i in range(len(ds))])
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.8
    blobs = ds.read_blobs(idx)
    mem, fail = native.decode_blobs(blobs, train=False, out_size=SIZE,
                                    threads=2)
    assert not fail.any()
    np.testing.assert_array_equal(mem, out)


def test_tar_index_matches_jax(data_dirs):
    _, tar = data_dirs
    ours = native.tar_index(tar)
    ref = jax_native.tar_index(tar)
    assert ours is not None
    if ref is None:
        pytest.skip("the JAX package's native dataio is unavailable")
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[2] == ref[2]


def test_device_batches_match_jax(data_dirs):
    """The device transform on the CPU: eval batches (deterministic) within
    1e-6 of the JAX loader's; train batches from the epoch's generator, the
    same for two loaders of one seed."""
    folder, _ = data_dirs
    ours = loader.DataLoader(datasets.ImageFolder(folder),
                             preprocess.get_transform(
                                 "imagenet", input_size=SIZE, augment=False),
                             batch_size=4, shuffle=False, drop_last=False,
                             num_workers=2, seed=3, device="cpu")
    ref = jax_loader.DataLoader(jax_datasets.ImageFolder(folder),
                                jax_pre.get_transform(
                                    "imagenet", input_size=SIZE,
                                    augment=False),
                                batch_size=4, shuffle=False, drop_last=False,
                                num_workers=2, seed=3)
    pairs = list(zip(ours, ref))
    assert len(pairs) == len(ours) == 5
    for (x, y), (jx, jy) in pairs:
        assert x.dtype == torch.float32 and x.device.type == "cpu"
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6)
    train = [loader.DataLoader(datasets.ImageFolder(folder),
                               preprocess.get_transform(
                                   "imagenet", input_size=SIZE),
                               batch_size=4, num_workers=2, seed=3,
                               device="cpu") for _ in range(2)]
    for (a, ya), (b, yb) in zip(*train):
        assert torch.equal(a, b) and torch.equal(ya, yb)


def test_loader_raises_without_a_card_unless_asked_for_the_cpu(data_dirs):
    folder, _ = data_dirs
    tf = preprocess.get_transform("imagenet", input_size=SIZE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            loader.DataLoader(datasets.ImageFolder(folder), tf, 4)
    # host batches touch no device
    dl = loader.DataLoader(datasets.ImageFolder(folder), tf, 4,
                           device_transform=False)
    assert dl.device is None


def test_a_corrupt_native_library_is_refused_not_raised(tmp_path,
                                                        monkeypatch):
    """The reference's fault (ROADMAP.md §3, fault 2): its ``ctypes.CDLL``
    of the data-IO library sits outside any try, so a corrupt library
    raises. The port refuses it, says why, and takes the Python path."""
    from convnet_tpu_torch.ops.kernels import _build
    bad = tmp_path / "libbroken.so"
    bad.write_bytes(b"not an ELF file")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_refusals", {})
    monkeypatch.setattr(_build, "build_host", lambda name: (bad, ""))
    assert not native.available() and not native.jpeg_available()
    assert native.jpeg_status().startswith("PIL: OSError")
    assert native.tar_index(str(bad)) is None
    assert native.decode_blobs([b"x"]) is None


@pytest.mark.parametrize("decode", ["native", "pil"])
def test_predict_jpeg_matches_call_on_the_decoded_batch(monkeypatch, decode):
    """``serve.predict_jpeg``: the eval decode (native, or PIL where the
    native decoder is unavailable) then ``Predictor.predict``; its top-1 is
    that of ``__call__`` on the same decoded uint8 batch."""
    from convnet_tpu_torch.serve import Predictor, predict_jpeg
    rng = np.random.default_rng(4)
    blobs = [_jpeg(rng, 36 + 4 * (i % 3), 44) for i in range(5)]
    pred = Predictor("resnet", {"dataset": "cifar10", "depth": 8},
                     dtype="float32", batch_size=4, device="cpu", seed=2)
    if decode == "pil":
        monkeypatch.setattr(native, "decode_blobs", lambda *a, **k: None)
        batch = np.stack([preprocess.scale_crop_host(
            _pil(b), None, out_size=pred.input_size) for b in blobs])
    else:
        batch, fail = native.decode_blobs(blobs, train=False,
                                          out_size=pred.input_size)
        assert not fail.any()
    top = predict_jpeg(pred, blobs)
    np.testing.assert_array_equal(top, pred(batch).argmax(-1))
    assert predict_jpeg(pred, blobs, topk=3).shape == (5, 3)


def _pil(blob):
    from PIL import Image
    return Image.open(io.BytesIO(blob))
