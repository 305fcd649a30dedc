"""The kernel build cache (``convnet_tpu_torch/ops/kernels/_build.py``): a
library's name hashes its source, the headers of ``csrc/`` that the source
includes (directly or through another header) and the compiler flags, so an
edited header rebuilds every library that uses it and nothing else. No
compiler runs here: the names are computed from the bytes."""

import pytest

from convnet_tpu_torch.ops.kernels import _build


@pytest.fixture
def sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n'
                              'int f() { return 0; }\n')
    (src / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (src / "b.cuh").write_text("// b\n")
    (src / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return src


@pytest.mark.parametrize("header", ["a.cuh", "b.cuh"])
def test_library_path_changes_with_an_included_headers_bytes(sources,
                                                             header):
    before = _build.library_path("k")
    assert before.parent == _build.BUILD_DIR
    original = (sources / header).read_bytes()
    (sources / header).write_bytes(original + b"// edited\n")
    assert _build.library_path("k") != before
    (sources / header).write_bytes(original)
    assert _build.library_path("k") == before


def test_library_path_ignores_headers_it_does_not_include(sources):
    before = _build.library_path("k")
    (sources / "other.cuh").write_text("// edited\n")
    assert _build.library_path("k") == before


def test_library_path_changes_with_the_source_and_the_flags(sources,
                                                           monkeypatch):
    before = _build.library_path("k")
    flags = _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags + ("-DX",))
    assert _build.library_path("k") != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags)
    assert _build.library_path("k") == before
    (sources / "k.cu").write_text("int f() { return 1; }\n")
    assert _build.library_path("k") != before


@pytest.mark.parametrize("name", ["matmul_fused", "matmul_int8"])
def test_the_hopper_kernels_are_keyed_on_the_shared_header(name):
    """Both TMA + wgmma sources include csrc/hopper.cuh, so their builds are
    keyed on it."""
    found = _build._sources(_build.SOURCE_DIR / f"{name}.cu")
    assert _build.SOURCE_DIR / "hopper.cuh" in found
