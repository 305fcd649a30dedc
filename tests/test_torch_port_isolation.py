"""The port stands alone: it never imports JAX or the JAX package, nor
``ml_dtypes``, which the card's machine does not have."""

import ast
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
