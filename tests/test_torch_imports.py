"""repro_torch, the port's benchmarks and examples (benchmarks_torch,
examples_torch) and chip_smoke.py import neither JAX, nor the JAX package,
nor the reference's benchmarks or examples."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
BENCH_DIRS = (REPO / "benchmarks_torch", REPO / "examples_torch")
BENCH_SOURCES = sorted(p for d in BENCH_DIRS for p in d.glob("*.py"))
SOURCES = (sorted(PORT.rglob("*.py")) + BENCH_SOURCES
           + [REPO / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks", "examples")
# the fleet, host-tier and online benches and the last three examples:
# each must be among the sources the checks below walk
FLEET_MODULES = (
    "benchmarks_torch._fleet", "benchmarks_torch.bench_cluster",
    "benchmarks_torch.bench_fabric", "benchmarks_torch.bench_elastic",
    "benchmarks_torch.bench_hoststore", "benchmarks_torch.bench_online",
    "examples_torch.cluster_sla", "examples_torch.fabric_sharding",
    "examples_torch.lm_mini")
# The training slice's modules: each must exist and import alone, in a
# fresh interpreter, without JAX or the JAX package.
TRAINING_MODULES = (
    "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
    "repro_torch.runtime", "repro_torch.runtime.straggler",
    "repro_torch.runtime.trainer", "repro_torch.parallel.updates",
    "repro_torch.engine.training", "repro_torch.launch.train")
# The k-rank slice's modules (ROADMAP A6b-i), held the same way.
RANK_MODULES = (
    "repro_torch.launch.mesh", "repro_torch.parallel.primitives",
    "repro_torch.optim.compression", "repro_torch.core.sharding")
# The LM over k ranks (ROADMAP A6b-ii, first item), held the same way.
LM_RANK_MODULES = ("repro_torch.models.moe_dist",)
# Fleet boards of k ranks and checkpoints over k ranks (ROADMAP A6b-ii),
# held the same way.
BOARD_MODULES = (
    "repro_torch.runtime.elastic", "repro_torch.cluster.replica",
    "repro_torch.cluster.cluster", "repro_torch.fabric.fleet",
    "repro_torch.checkpoint.manager", "repro_torch.parallel.build",
    "repro_torch.convert", "repro_torch.launch.serve")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


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
    for name in (TRAINING_MODULES + RANK_MODULES + LM_RANK_MODULES
                 + BOARD_MODULES):
        rel = Path(*name.split(".")[1:])
        assert ((PORT / rel).with_suffix(".py").exists()
                or (PORT / rel / "__init__.py").exists()), name
        assert any(p == (PORT / rel).with_suffix(".py")
                   or p == PORT / rel / "__init__.py" for p in SOURCES), name
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code, *TRAINING_MODULES,
                           *RANK_MODULES, *LM_RANK_MODULES,
                           *BOARD_MODULES],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_bench_and_example_modules_import_without_jax_or_repro():
    code = textwrap.dedent("""
        import importlib, sys
        for name in sys.argv[1:]:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "repro", "benchmarks", "examples"))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    names = [f"{p.parent.name}.{p.stem}" if p.stem != "__init__"
             else p.parent.name for p in BENCH_SOURCES]
    assert len(names) >= 16, names
    assert set(FLEET_MODULES) <= set(names), sorted(
        set(FLEET_MODULES) - set(names))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    proc = subprocess.run([sys.executable, "-c", code, *names],
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
