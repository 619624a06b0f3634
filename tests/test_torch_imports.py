"""repro_torch and chip_smoke.py import neither JAX nor the JAX package."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
# The training slice's modules: each must exist and import alone, in a
# fresh interpreter, without JAX or the JAX package.
TRAINING_MODULES = (
    "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
    "repro_torch.runtime", "repro_torch.runtime.straggler",
    "repro_torch.runtime.trainer", "repro_torch.parallel.updates",
    "repro_torch.engine.training", "repro_torch.launch.train")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_import_leaves_jax_and_repro_out():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len(names), bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 28, proc.stdout


def test_training_modules_import_without_jax_or_repro():
    code = textwrap.dedent("""
        import importlib, sys
        for name in sys.argv[1:]:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    for name in TRAINING_MODULES:
        rel = Path(*name.split(".")[1:])
        assert ((PORT / rel).with_suffix(".py").exists()
                or (PORT / rel / "__init__.py").exists()), name
        assert any(p == (PORT / rel).with_suffix(".py")
                   or p == PORT / rel / "__init__.py" for p in SOURCES), name
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code, *TRAINING_MODULES],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        bad = [m for m in mods if _forbidden(m)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
