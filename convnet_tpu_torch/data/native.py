"""ctypes bindings for the native host libraries of the input pipeline
(counterpart of convnet_tpu/data/native.py).

``csrc/dataio.cpp``: tar indexing and thread-pooled batched ``pread`` outside
the GIL. ``csrc/jpegdec.cpp``: pread + libjpeg decode + RandomResizedCrop or
scale + center crop, a batch at a time in a C++ thread pool. Both are host
code (no device kernel); each is built with ``g++`` into
``convnet_tpu_torch/_build/`` on first use (``ops/kernels/_build.py``
``build_host``), never by ``make``. A library that cannot be built, loaded
or that answers the wrong ABI version is refused once, with the reason
logged, and every caller takes its pure-Python or PIL path, as the
reference does.

Each library exports ``ctpu_*_abi_version()``; one whose version differs
from the constants below is never called, because a binary whose argument
list has drifted from the ctypes signatures here does not fail loudly: it
reads pointers as ints and corrupts the heap.
"""

from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np

log = logging.getLogger(__name__)

_DATAIO_ABI = 1
_JPEGDEC_ABI = 2

_lock = threading.Lock()
_libs = {}          # name -> loaded CDLL, or None once refused
_refusals = {}      # name -> why it was refused


def _open(name: str, abi_symbol: str, expected: int):
    """Builds and loads ``csrc/<name>.cpp``; None (the reason logged and
    kept in ``_refusals``) when any step fails or the ABI differs."""
    from convnet_tpu_torch.ops.kernels import _build
    try:
        path, _ = _build.build_host(name)
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, abi_symbol)
    except Exception as e:   # no g++, no libjpeg, a bad binary: host fallback
        _refusals[name] = f"{type(e).__name__}: {e}"
        log.warning("native %s unavailable, taking the Python path: %s",
                    name, _refusals[name])
        return None
    fn.restype = ctypes.c_int64
    fn.argtypes = []
    got = int(fn())
    if got != expected:
        _refusals[name] = f"ABI v{got} != expected v{expected}"
        log.warning("native %s at %s: %s; refusing to call it", name, path,
                    _refusals[name])
        return None
    return lib


def _load():
    with _lock:
        if "dataio" not in _libs:
            lib = _open("dataio", "ctpu_dataio_abi_version", _DATAIO_ABI)
            if lib is not None:
                lib.ctpu_tar_index.restype = ctypes.c_int64
                lib.ctpu_tar_index.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.c_char_p, ctypes.c_int64]
                lib.ctpu_batch_read.restype = ctypes.c_int
                lib.ctpu_batch_read.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
            _libs["dataio"] = lib
        return _libs["dataio"]


def available() -> bool:
    return _load() is not None


def tar_index(tar_path: str):
    """Returns (offsets int64[n], sizes int64[n], names list[str]) or
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    path = tar_path.encode()
    n = lib.ctpu_tar_index(path, None, None, 0, None, 0)
    if n < 0:
        return None
    offsets = np.zeros(n, np.int64)
    sizes = np.zeros(n, np.int64)
    name_cap = int(n) * 264 + 16
    names_buf = ctypes.create_string_buffer(name_cap)
    got = lib.ctpu_tar_index(
        path,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, names_buf, name_cap)
    if got != n:
        return None
    names = bytes(names_buf.raw).split(b"\0")[:n]
    return offsets, sizes, [s.decode("utf-8", "replace") for s in names]


def batch_read(path: str, offsets, sizes, threads: int = 8):
    """Read many (offset, size) spans concurrently; returns a list of
    bytes objects (or None if unavailable)."""
    lib = _load()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    dst_offsets = np.zeros(len(sizes), np.int64)
    np.cumsum(sizes[:-1], out=dst_offsets[1:])
    total = int(sizes.sum())
    dst = np.empty(total, np.uint8)
    rc = lib.ctpu_batch_read(
        path.encode(),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(sizes),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        threads)
    if rc != 0:
        return None
    return [dst[o:o + s].tobytes() for o, s in zip(dst_offsets, sizes)]


# ------------------------------------------------------------ jpegdec


def _load_jpeg():
    with _lock:
        if "jpegdec" not in _libs:
            lib = _open("jpegdec", "ctpu_jpegdec_abi_version", _JPEGDEC_ABI)
            if lib is not None:
                # one shared tail signature for both entry points; it MUST
                # stay in lockstep with csrc/jpegdec.cpp and _JPEGDEC_ABI
                tail = [
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_uint64,
                    ctypes.c_double, ctypes.c_double, ctypes.c_double,
                    ctypes.c_double, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
                lib.ctpu_decode_batch.restype = ctypes.c_int64
                lib.ctpu_decode_batch.argtypes = [ctypes.c_char_p] + tail
                lib.ctpu_decode_batch_mem.restype = ctypes.c_int64
                lib.ctpu_decode_batch_mem.argtypes = (
                    [ctypes.POINTER(ctypes.c_ubyte)] + tail)
            _libs["jpegdec"] = lib
        return _libs["jpegdec"]


def jpeg_available() -> bool:
    return _load_jpeg() is not None


def jpeg_status() -> str:
    """Which decoder the JPEG paths take, and why: ``"native"``, or
    ``"PIL: <reason>"`` (the build's or load's error)."""
    if jpeg_available():
        return "native"
    return f"PIL: {_refusals.get('jpegdec', 'native decoder unavailable')}"


def _decode_call(entry, first_arg, offsets, sizes, *, train, out_size,
                 scale_size, seed, scale, ratio, duplicates, fast_dct,
                 threads):
    """Shared ctypes tail for both decode entry points: the 16 positional
    arguments after the source argument (offsets, sizes, n, mode, out_size,
    scale_size, seed, scale lo/hi, ratio lo/hi, dup, fast_dct, out,
    fail_mask, nthreads) of ABI v2, marshalled in exactly one place."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    n = len(offsets)
    dup = max(int(duplicates), 1)
    out = np.empty((n * dup, out_size, out_size, 3), np.uint8)
    fail = np.empty(n, np.uint8)
    got = entry(
        first_arg,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, 0 if train else 1, out_size, scale_size,
        ctypes.c_uint64(seed & (2 ** 64 - 1)),
        float(scale[0]), float(scale[1]), float(ratio[0]), float(ratio[1]),
        dup, 1 if fast_dct else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        fail.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        threads)
    if got < 0:
        return None
    return out, fail.astype(bool)


def decode_batch(tar_path: str, offsets, sizes, *, train: bool,
                 out_size: int = 224, scale_size: int = 0,
                 seed: int = 0, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 duplicates: int = 1, fast_dct: bool = False,
                 threads: int = 8):
    """Decode + transform a batch of JPEG members straight out of the
    tar: RandomResizedCrop (train) or shorter-side scale + center crop
    (eval). Returns (uint8 [n, out, out, 3], fail_mask bool[n]) or None
    when the native path is unavailable. Failed decodes are zero-filled
    with fail_mask set; the caller re-decodes those through PIL.

    fast_dct (train path only) decodes at a reduced M/8 libjpeg DCT scale
    chosen per sample so the drawn crop still covers out_size: the same
    crop boxes, slightly different resampling taps. The eval path ignores
    it (it keeps its 1-LSB agreement with PIL)."""
    lib = _load_jpeg()
    if lib is None:
        return None
    return _decode_call(
        lib.ctpu_decode_batch, tar_path.encode(), offsets, sizes,
        train=train, out_size=out_size, scale_size=scale_size, seed=seed,
        scale=scale, ratio=ratio, duplicates=duplicates,
        fast_dct=fast_dct, threads=threads)


def decode_blobs(blobs, *, train: bool = False, out_size: int = 224,
                 scale_size: int = 0, seed: int = 0,
                 scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 duplicates: int = 1, fast_dct: bool = False,
                 threads: int = 8):
    """In-memory variant of :func:`decode_batch` for loose JPEG bytes
    (ImageFolder batches, serving). Returns (uint8 [n, out, out, 3],
    fail_mask) or None when the native library is unavailable."""
    lib = _load_jpeg()
    if lib is None:
        return None
    sizes = np.asarray([len(b) for b in blobs], np.int64)
    offsets = np.zeros(len(blobs), np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    base = np.frombuffer(b"".join(blobs), np.uint8)
    return _decode_call(
        lib.ctpu_decode_batch_mem,
        base.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        offsets, sizes,
        train=train, out_size=out_size, scale_size=scale_size, seed=seed,
        scale=scale, ratio=ratio, duplicates=duplicates,
        fast_dct=fast_dct, threads=threads)
