"""Benchmark artifacts: ``BENCH_torch_<name>.json`` under ``--out-dir``.

Every section that supports ``--emit-json`` funnels through
``write_bench_json``: the claims it judged (name / ok / detail), the
scalar measurements behind them, the git revision, and the device the
numbers were taken on. The schema is the reference's
(``benchmarks/_artifacts.py``) plus the ``device`` block; the file never
replaces a reference ``BENCH_<name>.json``. A ``"platform": "cpu"`` block
marks a run whose times are CPU wall-clocks, not device numbers.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
from typing import Any, Dict, List, Optional, Tuple

import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT_DIR = os.path.join(REPO_ROOT, "build", "bench")

# (name, ok, detail): detail is the WIN / FAILED CLAIM line's substance
Claim = Tuple[str, bool, str]


def git_rev() -> str:
    """The current commit hash, or "unknown" outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=REPO_ROOT,
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def device_block(device: torch.device) -> Dict[str, Any]:
    """What the artifact's numbers were measured on."""
    if device.type == "cuda":
        name, _, limit = card_line().rpartition(",")
        name = name.strip()
        try:
            watts = float(limit.split()[0])
        except (IndexError, ValueError):
            watts = None
        return {"platform": "gpu", "name": name, "power_limit_w": watts,
                "count": torch.cuda.device_count()}
    return {"platform": device.type,
            "name": platform.processor() or platform.machine(),
            "power_limit_w": None, "count": 1}


def device_label(block: Dict[str, Any]) -> str:
    """``"<card name>, <limit> W"``, or the CPU run's label."""
    if block["platform"] == "gpu":
        watts = block["power_limit_w"]
        return (f"{block['name']}, "
                f"{'unknown' if watts is None else f'{watts:.2f}'} W")
    return f"{block['platform']} ({block['name']}): not a device number"


def print_claims(section: str, claims: List[Claim],
                 block: Dict[str, Any]) -> None:
    """One ``[bench] <section>: <claim> WIN|FAILED CLAIM <detail>
    (<card>)`` line a claim."""
    label = device_label(block)
    for name, ok, detail in claims:
        print(f"[bench] {section}: {name} "
              f"{'WIN' if ok else 'FAILED CLAIM'} {detail} ({label})")


def write_bench_json(name: str, claims: List[Claim],
                     scalars: Dict[str, Any], device: torch.device,
                     out_dir: Optional[str] = None,
                     metrics: Optional[Dict[str, Any]] = None) -> str:
    """Write ``BENCH_torch_<name>.json`` under ``out_dir`` (default
    ``build/bench/``) and return its path. ``metrics`` is a
    ``MetricsRegistry.snapshot()`` of a representative run, kept as the
    reference keeps it."""
    payload = {
        "bench": name,
        "git_rev": git_rev(),
        "ok": all(ok for _, ok, _ in claims),
        "claims": [{"name": n, "ok": ok, "detail": d}
                   for n, ok, d in claims],
        "scalars": scalars,
        "device": device_block(device),
    }
    if metrics is not None:
        payload["metrics"] = metrics
    out_dir = out_dir or DEFAULT_OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"BENCH_torch_{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"[{name}] wrote {path}")
    return path
