"""RecSpeed planner — the paper's analysis operationalized as a feature.

The paper's conclusion is not just "build different HW"; it is that the
OPTIMAL DISTRIBUTION of a recommender model is a function of measurable HW
parameters (CC latency/bandwidth, random-access memory rate) and model
parameters (batch, embedding size, lookups, table sizes). This module makes
that decision automatically:

  plan = plan_dlrm(cfg, system)          # -> ShardingPlan

chooses, per the generalized-roofline perf model (core/perf_model.py):
  * sharding mode   : table_wise vs row_wise (the paper's two extremes),
  * exchange mode   : paper-faithful "unpooled" vs beyond-paper
                      "partial_pool" reduce-scatter,
  * table placement : hot tables -> fast memory tier ("HBM-like": replicated
                      or table-wise near compute), cold -> bulk tier
                      (row-sharded across the mesh) — the paper's hybrid
                      HBM+DDR4 memory (Sec. VII-A).

The hot/cold split takes per-table access frequencies (from data stats or a
profile pass) and greedily fills the fast tier by access-per-byte density —
the same static-allocation policy the paper argues for over caching
(Sec. VII-A, Knights-Landing lesson).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.perf_model import SystemConfig, breakdown


@dataclass(frozen=True)
class TablePlacement:
    table_id: int
    tier: str              # "fast" | "bulk"
    mode: str              # "table_wise" | "row_wise"
    owner: Optional[int]   # processor id for table_wise; None for row_wise


@dataclass(frozen=True)
class ShardingPlan:
    config: str
    mode: str                        # chosen global mode
    exchange: str                    # "unpooled" | "partial_pool"
    qps_table_wise: float
    qps_row_wise_unpooled: float
    qps_row_wise_partial: float
    placements: Tuple[TablePlacement, ...] = ()
    fast_bytes_used: int = 0
    bulk_bytes_used: int = 0
    # Fraction of embedding lookups serviced by the fast tier under this
    # placement (tables placed "fast" count in full; consumed by the
    # perf model's cache-hit term and by the tiered runtime).
    hit_ratio: float = 0.0

    @property
    def predicted_qps(self) -> float:
        return {
            ("table_wise", "unpooled"): self.qps_table_wise,
            ("table_wise", "partial_pool"): self.qps_table_wise,
            ("row_wise", "unpooled"): self.qps_row_wise_unpooled,
            ("row_wise", "partial_pool"): self.qps_row_wise_partial,
        }[(self.mode, self.exchange)]


def plan_dlrm(cfg: DLRMConfig, system: SystemConfig, mode: str = "inference",
              allow_partial_pool: bool = True) -> ShardingPlan:
    """Pick the sharding/exchange combination the perf model says is fastest.

    The paper's two extremes are evaluated faithfully; the beyond-paper
    partial-pool exchange is considered only when `allow_partial_pool`.
    """
    tw = breakdown(replace(cfg, sharding="table_wise"), system, mode)
    rw_u = breakdown(replace(cfg, sharding="row_wise"), system, mode,
                     row_wise_exchange="unpooled")
    rw_p = breakdown(replace(cfg, sharding="row_wise"), system, mode,
                     row_wise_exchange="partial_pool")

    candidates = {("table_wise", "unpooled"): tw.qps,
                  ("row_wise", "unpooled"): rw_u.qps}
    if allow_partial_pool:
        candidates[("row_wise", "partial_pool")] = rw_p.qps
    (best_mode, best_ex), _ = max(candidates.items(), key=lambda kv: kv[1])
    return ShardingPlan(
        config=cfg.name, mode=best_mode, exchange=best_ex,
        qps_table_wise=tw.qps, qps_row_wise_unpooled=rw_u.qps,
        qps_row_wise_partial=rw_p.qps)


def default_table_bytes(cfg: DLRMConfig) -> List[int]:
    """Per-table embedding bytes at the model's stored precision (fp16) —
    the capacity-accounting unit every placement decision budgets in."""
    return [cfg.rows_per_table * cfg.embed_dim * 2] * cfg.num_tables


def access_density_order(access_freq: Sequence[float],
                         table_bytes: Sequence[int]) -> np.ndarray:
    """Table ids sorted by access density (accesses per byte), hottest
    first — the shared greedy currency of the hot/cold tier placement
    below AND the cross-board partitioner (`repro.fabric.partition`):
    whatever is being filled (a chip's fast tier, a board's memory), the
    highest-value bytes go in first."""
    density = (np.asarray(access_freq, dtype=np.float64)
               / np.maximum(table_bytes, 1))
    return np.argsort(-density, kind="stable")


def split_table_shards(
    n_rows: int,
    row_freq: Optional[Sequence[float]],
    free_rows: Sequence[int],
    board_load: Sequence[float],
    min_shard_rows: int = 1,
) -> List[Tuple[int, int, int]]:
    """Split ONE table's row space across boards when no board holds it
    whole: contiguous row ranges, handed out head-first (under the Zipf
    streams the profiled row frequencies describe, low row ids carry the
    mass, so the head range is the densest) to the least-loaded board
    with room — the same greedy currency as `access_density_order`, one
    granularity down.

    `row_freq` (length `n_rows`) prices each range's access mass; None
    means uniform. `free_rows` is each board's remaining capacity in THIS
    table's rows. Returns [(board, row_lo, row_hi)] covering [0, n_rows)
    exactly; raises ValueError — the loud-failure contract of
    `place_tables` — only when a range of `min_shard_rows` (or the whole
    remainder, if smaller) fits on no board.
    """
    if n_rows < 1:
        raise ValueError(f"n_rows must be >= 1, got {n_rows}")
    if min_shard_rows < 1:
        raise ValueError(f"min_shard_rows must be >= 1, got {min_shard_rows}")
    freq = (np.ones(n_rows, np.float64) if row_freq is None
            else np.asarray(row_freq, np.float64))
    if len(freq) != n_rows:
        raise ValueError(f"row_freq must have {n_rows} entries, "
                        f"got {len(freq)}")
    free = [int(f) for f in free_rows]
    load = [float(l) for l in board_load]
    cum = np.concatenate([[0.0], np.cumsum(freq)])
    out: List[Tuple[int, int, int]] = []
    lo = 0
    while lo < n_rows:
        rem = n_rows - lo
        need = min(min_shard_rows, rem)
        fits = [b for b in range(len(free)) if free[b] >= need]
        if not fits:
            raise ValueError(
                f"no board fits a row range of {need} rows "
                f"({sum(free)} rows free across {len(free)} boards)")
        # hottest remaining range to the least accumulated access mass;
        # free space then board id break ties -> deterministic in inputs
        b = min(fits, key=lambda i: (load[i], -free[i], i))
        take = min(rem, free[b])
        out.append((b, lo, lo + take))
        load[b] += float(cum[lo + take] - cum[lo])
        free[b] -= take
        lo += take
    return out


def place_tables(
    cfg: DLRMConfig,
    access_freq: Sequence[float],
    fast_capacity_bytes: int,
    bulk_capacity_bytes: int,
    n_chips: int,
    table_bytes: Optional[Sequence[int]] = None,
) -> Tuple[List[TablePlacement], int, int]:
    """Greedy hot/cold placement by access density (accesses per byte).

    Hot tables go to the fast tier table-wise (whole table near one
    processor's fast memory, pooled-row exchange only); cold tables are
    row-sharded across the bulk tier. Mirrors the paper's static
    HBM-vs-DDR4 allocation argument.
    """
    t_bytes = (list(table_bytes) if table_bytes is not None
               else default_table_bytes(cfg))
    assert len(access_freq) == cfg.num_tables == len(t_bytes)

    order = access_density_order(access_freq, t_bytes)

    placements: List[Optional[TablePlacement]] = [None] * cfg.num_tables
    fast_used = bulk_used = 0
    bulk_capacity_total = bulk_capacity_bytes * n_chips
    # fast tier budget is per-chip; a table_wise table occupies one chip's fast mem
    fast_left = [fast_capacity_bytes] * n_chips
    for t in order:
        t = int(t)
        # try fast tier: least-loaded chip that fits
        chip = int(np.argmax(fast_left))
        if fast_left[chip] >= t_bytes[t]:
            fast_left[chip] -= t_bytes[t]
            fast_used += t_bytes[t]
            placements[t] = TablePlacement(t, "fast", "table_wise", chip)
            continue
        if bulk_used + t_bytes[t] > bulk_capacity_total:
            raise ValueError(
                f"model does not fit: table {t} ({t_bytes[t]} B) overflows the "
                f"bulk tier ({bulk_used} B of {bulk_capacity_total} B already "
                f"used across {n_chips} chips)")
        bulk_used += t_bytes[t]
        placements[t] = TablePlacement(t, "bulk", "row_wise", None)
    return [p for p in placements if p is not None], fast_used, bulk_used


def plan_with_placement(cfg: DLRMConfig, system: SystemConfig,
                        access_freq: Sequence[float],
                        fast_capacity_bytes: int, bulk_capacity_bytes: int,
                        mode: str = "inference") -> ShardingPlan:
    base = plan_dlrm(cfg, system, mode)
    placements, fast_used, bulk_used = place_tables(
        cfg, access_freq, fast_capacity_bytes, bulk_capacity_bytes,
        system.n_chips)
    freq = np.asarray(access_freq, dtype=np.float64)
    total = float(freq.sum())
    fast_mass = float(sum(freq[p.table_id] for p in placements
                          if p.tier == "fast"))
    hit = fast_mass / total if total > 0 else 0.0
    return replace(base, placements=tuple(placements),
                   fast_bytes_used=fast_used, bulk_bytes_used=bulk_used,
                   hit_ratio=hit)
