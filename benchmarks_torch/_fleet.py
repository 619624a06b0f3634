"""What the port's fleet, fabric, host-tier and online benches share.

* ``recorded``: the reference's record -> reload -> verify discipline: a
  run consumes the JSONL trace file, never the generator;
* ``trace_dir``: ``--trace-dir``, else ``<out-dir>/traces`` (never a
  system tmp dir);
* ``Cuts``: what one card forces a bench to cut, printed as it is made
  and kept in the artifact's ``scalars.cuts`` as ``{what: [full, used,
  why]}``;
* ``draw_params``: one draw of a config's weights, the tables in host
  memory, for every fleet of a bench to share through ``params=`` (a
  fleet built without them draws its own host copy);
* ``release`` and ``memory_line``: free a fleet's device memory before
  the next is built, and print the device peak and the host's RSS.
"""
from __future__ import annotations

import gc
import os
import resource
from typing import Any, Dict, List

import torch

from benchmarks_torch._artifacts import DEFAULT_OUT_DIR
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.hoststore.exchange import draw_host_tables
from repro_torch.traffic import load_trace, record_trace

GB = 1e9


def recorded(scenario, n: int, qps: float, seed: int, path: str) -> List:
    """Generate -> record -> reload -> verify: the run consumes the FILE."""
    events = scenario.events(n, qps=qps, seed=seed)
    record_trace(path, events, scenario, qps=qps, seed=seed)
    _, loaded = load_trace(path)
    assert loaded == events, f"trace replay diverged for {path}"
    return loaded


def trace_dir(args) -> str:
    """``--trace-dir``, else ``traces/`` under ``--out-dir`` (default
    ``build/bench/``); made if missing."""
    path = args.trace_dir or os.path.join(args.out_dir or DEFAULT_OUT_DIR,
                                          "traces")
    os.makedirs(path, exist_ok=True)
    return path


def draw_params(cfg, seed: int, device: torch.device) -> dict:
    """The weights a ``ShardedFleet`` built without ``params=`` draws:
    the MLPs on ``device`` and the (T, R, d) tables in host memory."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return dict(dlrm_lib.init_mlps(cfg, gen),
                tables=draw_host_tables(cfg, seed, device))


def fp32_table_bytes(cfg) -> List[int]:
    """Each table's bytes as the port stores it (fp32), the currency its
    fleets budget boards in."""
    return [cfg.rows_per_table * cfg.embed_dim * 4] * cfg.num_tables


class Cuts:
    """The cuts a bench makes to fit one card, each printed when made."""

    def __init__(self) -> None:
        self.cuts: Dict[str, List[Any]] = {}

    def add(self, what: str, full: Any, used: Any, why: str) -> Any:
        self.cuts[what] = [full, used, why]
        print(f"# cut {what}: {full} -> {used} ({why})")
        return used


def release(device: torch.device) -> None:
    """Collect dropped fleets and hand their device memory back."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_line(label: str, device: torch.device) -> None:
    """Print ``# memory <label>: peak device <x> GB, host RSS <y> GB
    (peak <z> GB)``: the device's peak allocation since its last reset
    (not read on the CPU) and the process's host resident set."""
    dev = "not read (cpu)"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        dev = f"{torch.cuda.max_memory_allocated(device) / GB:.2f} GB"
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"# memory {label}: peak device {dev}, host RSS {rss / GB:.2f} "
          f"GB (peak {peak / GB:.2f} GB)")
