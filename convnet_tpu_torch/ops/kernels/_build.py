"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and includes no PyTorch
header, so one ``nvcc`` call builds it in seconds. The library goes into
``convnet_tpu_torch/_build/`` under a name that hashes the source and the
flags, so an edited source is rebuilt and an unchanged one is reused. The
compiler writes to a temporary name that is renamed into place only when it
succeeds: a killed build leaves neither a half-written library nor a lock.

Building happens on the first call, never at import, so the CPU tests can
import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 300


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = SOURCE_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns the library's path and the compiler's output ("" when reused)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out, proc.stdout + proc.stderr


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
