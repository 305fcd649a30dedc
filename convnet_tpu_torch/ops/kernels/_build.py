"""Build the package's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and includes no PyTorch
header, so one ``nvcc`` call builds it in seconds. The host libraries of the
input pipeline, ``csrc/dataio.cpp`` and ``csrc/jpegdec.cpp`` (libjpeg), are
built the same way with ``g++`` (:func:`build_host`). A library goes into
``convnet_tpu_torch/_build/`` under a name that hashes the source and the
flags, so an edited source is rebuilt and an unchanged one is reused; the
hash also covers the headers of ``csrc/`` that the source includes
(``#include "name"``, followed through the headers' own includes), such as
``csrc/hopper.cuh``, so an edited header rebuilds every library that uses
it. The compiler writes to a temporary name that is renamed into place only
when it succeeds: a killed build leaves neither a half-written library nor a
lock. Nothing is written anywhere else.

Building happens on the first call, never at import, so the CPU tests can
import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 300
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
# the libraries each host source links against
HOST_LINK = {"dataio": (), "jpegdec": ("-ljpeg",)}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src: Path) -> list[Path]:
    """``src`` and the files of its directory that it includes with quotes,
    directly or through one another, each once, in the order found."""
    found, todo = [src], [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_bytes()):
            dep = src.parent / name.decode()
            if dep.is_file() and dep not in found:
                found.append(dep)
                todo.append(dep)
    return found


def _output(name: str, src: Path, flags) -> Path:
    digest = hashlib.sha256()
    for path in _sources(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    return _output(name, SOURCE_DIR / f"{name}.cu", NVCC_FLAGS)


def _compile(compiler: str, src: Path, out: Path, flags, link=()) -> str:
    """Runs ``compiler flags -o <tmp> src link`` and renames the result to
    ``out``; raises with the compiler's output when it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [compiler, *flags, "-o", str(tmp), str(src), *link]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed "
                               f"({proc.returncode}) for {src.name}:"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return proc.stdout + proc.stderr


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns the library's path and the compiler's output ("" when reused)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    return out, _compile(_nvcc(), SOURCE_DIR / f"{name}.cu", out, NVCC_FLAGS)


def build_host(name: str) -> tuple[Path, str]:
    """Compile the host library ``csrc/<name>.cpp`` (``dataio`` or
    ``jpegdec``) with ``g++`` unless an up-to-date one exists. Returns its
    path and the compiler's output; raises when the compiler is missing or
    fails (for ``jpegdec``, also when libjpeg's headers are)."""
    link = HOST_LINK[name]
    out = _output(name, SOURCE_DIR / f"{name}.cpp", CXX_FLAGS + link)
    if out.exists():
        return out, ""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the host library "
                           f"{name} cannot be built")
    return out, _compile(cxx, SOURCE_DIR / f"{name}.cpp", out, CXX_FLAGS,
                         link)


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
