"""The port stands alone: it never imports JAX or the JAX package, nor
``ml_dtypes``, which the card's machine does not have."""

import ast
import os
import pathlib
import subprocess
import sys

import convnet_tpu_torch

PACKAGE = pathlib.Path(convnet_tpu_torch.__file__).parent
REPO = PACKAGE.parent
# the package's sources; _build/ holds build output only
SOURCES = sorted(p for p in PACKAGE.rglob("*.py")
                 if "_build" not in p.relative_to(PACKAGE).parts)


FORBIDDEN = ("jax", "jaxlib", "convnet_tpu", "ml_dtypes")


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    modules = [p.relative_to(REPO).with_suffix("").as_posix().replace("/", ".")
               for p in SOURCES]
    modules = [m.removesuffix(".__init__") for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_imports_jax():
    files = SOURCES + [REPO / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names
                          if _is_forbidden(n)]
    assert len(files) > 20 and not offenders, offenders


# the modules of the input pipeline and the CLI are among the checked ones
PIPELINE = ("data/datasets.py", "data/native.py", "data/autoaugment.py",
            "data/transforms.py", "data/preprocess.py", "data/loader.py",
            "data/data_regime.py", "cli/main.py", "utils/torch_import.py")


def test_the_pipeline_and_cli_modules_are_checked():
    checked = {p.relative_to(PACKAGE).as_posix() for p in SOURCES}
    assert set(PIPELINE) <= checked


def _code_lines(path):
    """A C++ source's lines without its comments and blank lines."""
    out = []
    for line in path.read_text().splitlines():
        code = line.split("//", 1)[0].rstrip()
        if code:
            out.append(code)
    return out


def test_native_sources_are_the_ports_own_copies():
    """The host libraries are built from the port's own copies under
    convnet_tpu_torch/csrc/, whose code is the JAX package's native/*.cpp
    line for line (the same C ABI), never from native/ or by make."""
    from convnet_tpu_torch.ops.kernels import _build
    for name in _build.HOST_LINK:
        src = _build.SOURCE_DIR / f"{name}.cpp"
        assert src.is_file() and PACKAGE in src.parents
        assert _code_lines(src) == _code_lines(REPO / "native" / f"{name}.cpp")
    text = (PACKAGE / "data" / "native.py").read_text()
    assert "build_host" in text
    imported = {a.name for node in ast.walk(ast.parse(text))
                if isinstance(node, ast.Import) for a in node.names}
    assert "subprocess" not in imported
    for word in ('"make"', "Makefile", "_NATIVE_DIR"):
        assert word not in text, word


def test_builds_write_only_into_the_build_dir(tmp_path, monkeypatch):
    """Every compiler call of ops/kernels/_build.py writes its library into
    BUILD_DIR and nothing else: the host libraries built afresh into a
    temporary BUILD_DIR leave only that directory behind, and the CUDA
    libraries' paths lie inside it."""
    import shutil
    from convnet_tpu_torch.ops.kernels import _build
    if shutil.which("g++") is None:
        import pytest
        pytest.skip("no g++: the host libraries cannot be built here")
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    calls = []
    real_run = subprocess.run

    def spy(cmd, *a, **kw):
        calls.append(list(cmd))
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(_build.subprocess, "run", spy)
    native_dir = REPO / "native"
    before = {p.name: p.stat().st_mtime_ns for p in native_dir.iterdir()}
    for name in _build.HOST_LINK:
        try:
            path, _ = _build.build_host(name)
        except RuntimeError:      # libjpeg's headers may be missing
            continue
        assert path.parent == build_dir and path.exists()
    assert calls and all(os.path.basename(c[0]) == "g++" for c in calls)
    for cmd in calls:
        out = pathlib.Path(cmd[cmd.index("-o") + 1])
        assert out.parent == build_dir, cmd
    assert [p.name for p in tmp_path.iterdir()] == ["_build"]
    assert all(".tmp" not in p.name for p in build_dir.iterdir())
    after = {p.name: p.stat().st_mtime_ns for p in native_dir.iterdir()}
    assert before == after
    for src in _build.SOURCE_DIR.glob("*.cu"):
        assert _build.library_path(src.stem).parent == build_dir
