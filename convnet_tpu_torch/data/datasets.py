"""Dataset registry (counterpart of convnet_tpu/data/datasets.py, a copy:
numpy and ``tarfile``), so the port never imports the JAX package.

CIFAR-10/100, MNIST, SVHN and STL-10 from their standard on-disk formats
(no torchvision dependency), ImageNet through an ImageFolder-style directory
walk or a byte-offset-indexed tar archive (serving 1.3M JPEGs without
unpacking), and deterministic synthetic datasets for runs with no data on
disk.

A dataset is anything with ``__len__`` and ``__getitem__ -> (sample,
label)`` where sample is a uint8 HWC ndarray or a PIL image handled by the
transform's host stage. ``ArrayDataset`` additionally exposes
``.data``/``.labels`` so the loader can keep the whole set on the card
(``ArrayBatcher``).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Optional

import numpy as np

_DEFAULT_ROOT = os.environ.get("CONVNET_TPU_DATA", os.path.expanduser("~/datasets"))


class ArrayDataset:
    """In-memory (images, labels); images uint8 NHWC."""

    def __init__(self, data: np.ndarray, labels: np.ndarray, classes: int):
        self.data = data
        self.labels = labels.astype(np.int32)
        self.num_classes = classes

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i], int(self.labels[i])


class SyntheticDataset(ArrayDataset):
    """Deterministic random images — for tests and throughput benches."""

    def __init__(self, size=1024, image_size=32, channels=3, classes=10,
                 seed=0):
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 256, (size, image_size, image_size, channels),
                            dtype=np.uint8)
        labels = rng.integers(0, classes, (size,))
        super().__init__(data, labels, classes)


class StructuredSyntheticDataset(ArrayDataset):
    """Learnable synthetic data: each class owns a fixed smooth
    prototype (low-res random pattern, upsampled); samples are
    prototype + per-sample noise. Train and val share prototypes but
    draw different samples, so VALIDATION accuracy measures true
    generalization through the full pipeline (augmentation, BN
    statistics, eval path) — the strongest end-to-end signal available
    in containers with no datasets on disk."""

    def __init__(self, size=1024, image_size=32, channels=3, classes=10,
                 seed=0, noise=0.35):
        proto_rng = np.random.default_rng(1234)  # shared across splits
        cells = max(image_size // 8, 2)
        low = proto_rng.uniform(0.15, 0.85, (classes, cells, cells, channels))
        reps = -(-image_size // cells)
        protos = np.stack([
            np.kron(l, np.ones((reps, reps, 1)))[:image_size, :image_size]
            for l in low])
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, classes, (size,))
        imgs = protos[labels] + rng.normal(
            0, noise, (size, image_size, image_size, channels))
        data = np.clip(imgs * 255, 0, 255).astype(np.uint8)
        super().__init__(data, labels, classes)


def _load_cifar(root, name="cifar10", split="train"):
    """Parse the standard python-pickled CIFAR batches."""
    if name == "cifar10":
        base = os.path.join(root, "cifar-10-batches-py")
        files = ([f"data_batch_{i}" for i in range(1, 6)]
                 if split == "train" else ["test_batch"])
        label_key = b"labels"
        classes = 10
    else:
        base = os.path.join(root, "cifar-100-python")
        files = ["train"] if split == "train" else ["test"]
        label_key = b"fine_labels"
        classes = 100
    xs, ys = [], []
    for fn in files:
        with open(os.path.join(base, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.append(np.asarray(d[label_key]))
    data = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(data), np.concatenate(ys), classes)


def _load_mnist(root, split="train"):
    """Parse idx-format MNIST files (optionally gzipped)."""
    prefix = "train" if split == "train" else "t10k"

    def read(name):
        for candidate in (os.path.join(root, "MNIST", "raw", name),
                          os.path.join(root, name)):
            for path, opener in ((candidate, open),
                                 (candidate + ".gz", gzip.open)):
                if os.path.exists(path):
                    with opener(path, "rb") as f:
                        return f.read()
        raise FileNotFoundError(name)

    img = read(f"{prefix}-images-idx3-ubyte")
    lbl = read(f"{prefix}-labels-idx1-ubyte")
    _, n, h, w = struct.unpack(">IIII", img[:16])
    data = np.frombuffer(img, np.uint8, offset=16).reshape(n, h, w, 1)
    labels = np.frombuffer(lbl, np.uint8, offset=8)
    return ArrayDataset(data, labels, 10)


def _load_svhn(root, split="train"):
    """Parse the SVHN cropped-digits .mat files (train_32x32.mat)."""
    from scipy.io import loadmat
    name = {"train": "train_32x32.mat", "val": "test_32x32.mat",
            "test": "test_32x32.mat"}[split if split in ("train",) else "val"]
    for candidate in (os.path.join(root, "svhn", name),
                      os.path.join(root, name)):
        if os.path.exists(candidate):
            mat = loadmat(candidate)
            break
    else:
        raise FileNotFoundError(name)
    data = np.transpose(mat["X"], (3, 0, 1, 2))  # HWCN → NHWC
    labels = mat["y"].reshape(-1).astype(np.int32) % 10  # '10' means 0
    return ArrayDataset(np.ascontiguousarray(data), labels, 10)


def _load_stl10(root, split="train"):
    """Parse the STL-10 binary files (96×96×3, CHW column-major)."""
    prefix = "train" if split == "train" else "test"
    base = None
    for candidate in (os.path.join(root, "stl10_binary"), root):
        if os.path.exists(os.path.join(candidate, f"{prefix}_X.bin")):
            base = candidate
            break
    if base is None:
        raise FileNotFoundError(f"{prefix}_X.bin")
    with open(os.path.join(base, f"{prefix}_X.bin"), "rb") as f:
        x = np.frombuffer(f.read(), np.uint8)
    with open(os.path.join(base, f"{prefix}_y.bin"), "rb") as f:
        y = np.frombuffer(f.read(), np.uint8).astype(np.int32) - 1
    x = x.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)  # column-major HW
    return ArrayDataset(np.ascontiguousarray(x), y, 10)


class ImageFolder:
    """ImageNet-style class-per-directory layout; PIL decode on access."""

    def __init__(self, root):
        self.root = root
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        self.num_classes = len(self.classes)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image
        path, label = self.samples[i]
        with Image.open(path) as img:
            return img.convert("RGB"), label


class IndexedTarDataset:
    """Serve samples straight out of one tar archive via byte offsets
    (utils/dataset.py IndexedFileDataset equivalent). The index —
    (name, offset, size, label) — is built once by scanning the tar and
    cached next to it as .idx.npz. Class = first path component."""

    def __init__(self, tar_path: str, use_native: bool = True):
        self.tar_path = tar_path
        self.use_native = use_native
        idx_path = tar_path + ".idx.npz"
        if os.path.exists(idx_path):
            cached = np.load(idx_path, allow_pickle=False)
            self.offsets = cached["offsets"]
            self.sizes = cached["sizes"]
            self.labels = cached["labels"]
            self.classes = [str(c) for c in cached["classes"]]
        else:
            names = None
            if use_native:
                # GIL-free single-pass C++ scan (csrc/dataio.cpp)
                from convnet_tpu_torch.data import native
                indexed = native.tar_index(tar_path)
                if indexed is not None:
                    self.offsets, self.sizes, names = indexed
            if names is None:
                offsets, sizes, names = [], [], []
                with tarfile.open(tar_path) as tf:
                    for member in tf:
                        if member.isfile():
                            offsets.append(member.offset_data)
                            sizes.append(member.size)
                            names.append(member.name)
                self.offsets = np.asarray(offsets, np.int64)
                self.sizes = np.asarray(sizes, np.int64)
            cls = sorted({n.split("/")[0] for n in names})
            cls_idx = {c: i for i, c in enumerate(cls)}
            self.labels = np.asarray([cls_idx[n.split("/")[0]] for n in names],
                                     np.int32)
            self.classes = cls
            np.savez(idx_path, offsets=self.offsets, sizes=self.sizes,
                     labels=self.labels, classes=np.asarray(cls))
        self.num_classes = len(self.classes)
        self._fh = None

    def read_blobs(self, indices):
        """Batched raw reads for the given sample indices (thread-pooled
        pread in C++ when available; sequential python otherwise)."""
        indices = list(indices)
        if self.use_native:
            from convnet_tpu_torch.data import native
            blobs = native.batch_read(
                self.tar_path, self.offsets[indices], self.sizes[indices])
            if blobs is not None:
                return blobs
        if self._fh is None:
            self._fh = open(self.tar_path, "rb")
        out = []
        for i in indices:
            self._fh.seek(self.offsets[i])
            out.append(self._fh.read(self.sizes[i]))
        return out

    def decode(self, blob):
        import io
        from PIL import Image
        return Image.open(io.BytesIO(blob)).convert("RGB")

    def __len__(self):
        return len(self.offsets)

    def __getitem__(self, i):
        import io
        from PIL import Image
        if self._fh is None:  # one fh per worker thread via TLS would be
            self._fh = open(self.tar_path, "rb")  # ideal; seek+read is GIL-short
        self._fh.seek(self.offsets[i])
        blob = self._fh.read(self.sizes[i])
        img = Image.open(io.BytesIO(blob)).convert("RGB")
        return img, int(self.labels[i])

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_fh"] = None
        return d


def get_dataset(name: str, split: str = "train", data_dir: Optional[str] = None,
                **kwargs):
    """data.py get_dataset equivalent."""
    root = data_dir or _DEFAULT_ROOT
    name = name.lower()
    if name in ("cifar10", "cifar100"):
        return _load_cifar(root, name, split)
    if name == "mnist":
        return _load_mnist(root, split)
    if name == "svhn":
        return _load_svhn(root, split)
    if name == "stl10":
        return _load_stl10(root, split)
    if name in ("imagenet", "imagefolder"):
        sub = {"train": "train", "val": "val", "eval": "val"}.get(split, split)
        return ImageFolder(os.path.join(root, sub))
    if name in ("imagenet_tar", "indexed_tar"):
        tar = kwargs.get("tar_path") or os.path.join(
            root, f"imagenet_{split}.tar")
        return IndexedTarDataset(tar)
    if name.startswith("synthetic"):
        defaults = dict(size=1024, image_size=32, channels=3, classes=10)
        if "imagenet" in name:
            defaults = dict(size=2048, image_size=224, channels=3, classes=1000)
        keys = ("size", "image_size", "channels", "classes", "seed")
        if "structured" in name:
            keys = keys + ("noise",)
        defaults.update({k: v for k, v in kwargs.items() if k in keys})
        if split != "train":
            defaults["seed"] = defaults.get("seed", 0) + 1
        if "structured" in name:
            return StructuredSyntheticDataset(**defaults)
        return SyntheticDataset(**defaults)
    raise ValueError(f"unknown dataset {name!r}")
