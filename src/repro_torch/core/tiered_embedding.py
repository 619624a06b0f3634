"""Tiered freq-aware embedding runtime — EXECUTES the planner's placements.

The planner (`core/planner.py`) decides which tables live in the fast
memory tier and which in the bulk tier (the paper's static HBM-vs-DDR4
allocation, Sec. VII-A). This module turns that analysis into a runnable
store, following the freq-aware cached-bag design of
hpcaitech/CacheEmbedding (index translation against a reordered hot set):

  fast (T, S+1, d) : per-table compact arrays holding each table's hottest
                     rows (slot S is a zeros "miss" row). A table the plan
                     places in the FAST tier gets all R rows here; a BULK
                     table gets a freq-aware cache of `hot_per_table` rows.
  bulk (T, R+1, d) : the canonical full tables (row R is a zeros "hit"
                     row). Cold lookups are serviced here.
  row_map (T, R)   : global row id -> fast slot, or -1 for cold rows — the
                     index translation table, built from access statistics
                     (`measure_row_freq` over the `data/recsys.py` stream,
                     or live counts via `accumulate_row_freq`).

Lookups translate the index stream once (`translate_indices`) and then run
the two-tier cached bag (`kernels.ops.cached_embedding_bag`): each lookup
sums one row from each tier, exactly one of which is the zero pad, so the
pooled output equals `embedding_bag_ref` on the tables the store holds.

Everything runs on the tables' device. `accumulate_row_freq` adds into its
counts in place; the other functions return new tensors, as the
reference's do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.planner import TablePlacement
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.kernels import ops


class TieredTables(NamedTuple):
    """The two-tier embedding store (see module docstring)."""

    fast: torch.Tensor      # (T, S+1, d) hot rows per table + zeros miss slot
    bulk: torch.Tensor      # (T, R+1, d) canonical tables + zeros hit slot
    row_map: torch.Tensor   # (T, R) int32: global row -> fast slot, -1 = cold
    hot_rows: torch.Tensor  # (T, S) int32: global row backing each slot, -1 = unused

    @property
    def num_tables(self) -> int:
        return self.fast.shape[0]

    @property
    def rows_per_table(self) -> int:
        return self.bulk.shape[1] - 1

    @property
    def hot_slots(self) -> int:
        return self.fast.shape[1] - 1


# ---------------------------------------------------------------------------
# Access statistics (the planner's and the cache's shared currency)
# ---------------------------------------------------------------------------
def measure_row_freq(cfg: DLRMConfig, alpha: float = 0.0, seed: int = 0,
                     n_batches: int = 8, batch_size: Optional[int] = None,
                     device: DeviceArg = None) -> torch.Tensor:
    """Per-row access counts (T, R) int32 measured over the synthetic stream,
    counted on ``device`` (None: the card).

    Deterministic in (cfg, alpha, seed): the stream is step-indexed, so a
    profile pass sees exactly the batches training/serving will see.
    """
    from repro_torch.data.recsys import make_recsys_batch

    dev = resolve_device(device)
    counts = torch.zeros((cfg.num_tables, cfg.rows_per_table),
                         dtype=torch.int32, device=dev)
    for step in range(n_batches):
        idx = make_recsys_batch(cfg, step, seed, alpha, batch_size,
                                device=dev)["indices"]
        accumulate_row_freq(counts, idx)
    return counts


def accumulate_row_freq(counts: torch.Tensor,
                        indices: torch.Tensor) -> torch.Tensor:
    """Online LFU counter update: counts (T, R) += bincount of indices
    (B, T, L), duplicates counted, in place; returns ``counts``."""
    T = counts.shape[0]
    idx = indices.to(counts.device).long()
    t_ix = torch.arange(T, device=counts.device)[None, :, None].expand_as(idx)
    counts.index_put_((t_ix, idx), torch.ones((), dtype=counts.dtype,
                                              device=counts.device),
                      accumulate=True)
    return counts


# ---------------------------------------------------------------------------
# Build / translate / lookup
# ---------------------------------------------------------------------------
def build_tiered_tables(
    tables: torch.Tensor,
    row_freq: torch.Tensor,
    hot_per_table: int,
    placements: Optional[Sequence[TablePlacement]] = None,
) -> TieredTables:
    """Construct the two-tier store from stacked tables (T, R, d), on the
    tables' device.

    `row_freq` (T, R) ranks rows within each table (LFU order), ties broken
    by row id as ``np.argsort(-freq, kind="stable")`` breaks them. Tables
    whose placement tier is "fast" are fully resident in the fast tier; all
    other tables get a `hot_per_table`-row freq-aware cache. Setup step
    (runs once per plan / refresh, not per lookup).

    The stacked layout sizes every table's fast slab to the LARGEST slot
    count: mixing a fully-fast-placed table (slots = R) with row-cached
    bulk tables allocates (T, R+1, d) of fast storage.
    """
    T, R, d = tables.shape
    dev = tables.device
    freq = torch.as_tensor(row_freq, device=dev)
    assert tuple(freq.shape) == (T, R), (tuple(freq.shape), (T, R, d))
    freq = freq.double() if freq.is_floating_point() else freq.long()

    slots = np.full(T, min(int(hot_per_table), R), dtype=np.int64)
    if placements:
        for p in placements:
            if p.tier == "fast":
                slots[p.table_id] = R
    S = int(slots.max()) if T else 0

    row_map = torch.full((T, R), -1, dtype=torch.int32, device=dev)
    hot_rows = torch.full((T, S), -1, dtype=torch.int32, device=dev)
    fast = torch.zeros((T, S + 1, d), dtype=tables.dtype, device=dev)
    for t in range(T):
        k = int(slots[t])
        if k <= 0:
            continue
        # stable sort => deterministic tie-break by row id (uniform streams)
        top = torch.sort(-freq[t], stable=True).indices[:k]
        hot_rows[t, :k] = top.int()
        row_map[t, top] = torch.arange(k, dtype=torch.int32, device=dev)
        fast[t, :k] = tables[t].index_select(0, top)

    bulk = torch.zeros((T, R + 1, d), dtype=tables.dtype, device=dev)
    bulk[:, :R] = tables
    return TieredTables(fast, bulk, row_map, hot_rows)


def _slots(tiered: TieredTables, indices: torch.Tensor) -> torch.Tensor:
    """Gather each lookup's fast slot from the translation table:
    (B, T, L) global row ids -> (B, T, L) slot ids (-1 = cold). As in
    the reference's gather, a negative id counts from the end and an id
    past the table reads the last row's slot."""
    T, R = tiered.row_map.shape
    idx = indices.long()
    idx = torch.where(idx < 0, idx + R, idx).clamp(0, R - 1)
    t_ix = torch.arange(T, device=idx.device)[None, :, None]
    return tiered.row_map[t_ix, idx]


def translate_indices(tiered: TieredTables, indices: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index translation (CacheEmbedding `prepare_ids`): global row ids
    (B, T, L) -> (fast_idx, bulk_idx), each (B, T, L) int32. Hot lookups get
    their fast slot + the bulk zeros row; cold lookups the reverse."""
    S = tiered.hot_slots
    R = tiered.rows_per_table
    slot = _slots(tiered, indices)                        # (B, T, L)
    hot = slot >= 0
    fast_idx = torch.where(hot, slot, S).int()
    bulk_idx = torch.where(hot, R, indices.long()).int()
    return fast_idx, bulk_idx


def tiered_embedding_bag(tiered: TieredTables,
                         indices: torch.Tensor) -> torch.Tensor:
    """Tiered lookup + sum-pool: (B, T, L) global ids -> (B, T, d) fp32.

    Equals `embedding_bag_ref(tables, indices)` for the tables the store was
    built from."""
    fast_idx, bulk_idx = translate_indices(tiered, indices)
    return ops.cached_embedding_bag(tiered.fast, tiered.bulk,
                                    fast_idx, bulk_idx)


def packed_tables(tiered: TieredTables) -> torch.Tensor:
    """Single-array two-tier layout (T, (S+1)+(R+1), d): the compact fast
    slab (hot rows) directly followed by the canonical bulk slab. With
    `translate_indices_packed` one gather through the embedding-bag kernel
    serves it: one row per lookup, most landing in the hot prefix."""
    return torch.cat([tiered.fast, tiered.bulk], dim=1)


def translate_indices_packed(tiered: TieredTables,
                             indices: torch.Tensor) -> torch.Tensor:
    """Global row ids (B, T, L) -> physical slots in `packed_tables` output:
    hot rows map to their fast slot, cold rows to S+1+row in the bulk slab."""
    S = tiered.hot_slots
    slot = _slots(tiered, indices)
    return torch.where(slot >= 0, slot, S + 1 + indices.long()).int()


def tiered_embedding_bag_packed(packed: torch.Tensor, tiered: TieredTables,
                                indices: torch.Tensor) -> torch.Tensor:
    """Packed-layout tiered lookup: translate once, then a single gather +
    sum-pool through the embedding-bag op. `packed` must be
    `packed_tables(tiered)` (built once, off the hot path)."""
    return ops.embedding_bag(packed, translate_indices_packed(tiered, indices))


def hit_mask(tiered: TieredTables, indices: torch.Tensor) -> torch.Tensor:
    """Boolean (B, T, L): which lookups the fast tier services."""
    return _slots(tiered, indices) >= 0


def expected_hit_ratio(row_freq: torch.Tensor, tiered: TieredTables) -> float:
    """Fraction of accesses the fast tier will serve under `row_freq` —
    the perf model's cache-hit-ratio term (predicted vs measured QPS)."""
    freq = torch.as_tensor(row_freq, device=tiered.row_map.device).double()
    total = float(freq.sum())
    if total <= 0:
        return 0.0
    return float((freq * (tiered.row_map >= 0)).sum()) / total


# ---------------------------------------------------------------------------
# Training integration: sparse updates + LFU refresh (plain row scatters)
# ---------------------------------------------------------------------------
def tiered_row_update(tiered: TieredTables, indices: torch.Tensor,
                      g_rows: torch.Tensor, lr: float) -> TieredTables:
    """SGD scatter-add routed per tier: hot rows update IN THE FAST TIER
    (their bulk copy goes stale until the next refresh, like a dirty cache
    line), cold rows update in bulk. indices (B, T, L) global ids, g_rows
    (B, T, L, d) per-row grads. Duplicate ids accumulate. Returns a new
    store; the given one is left as it was."""
    B, T, L = indices.shape
    d = g_rows.shape[-1]
    fast_idx, bulk_idx = translate_indices(tiered, indices)
    fi = fast_idx.permute(1, 0, 2).reshape(T, B * L).long()
    bi = bulk_idx.permute(1, 0, 2).reshape(T, B * L).long()
    g = g_rows.permute(1, 0, 2, 3).reshape(T, B * L, d)
    fast, bulk = tiered.fast.clone(), tiered.bulk.clone()
    for t in range(T):
        step = (-lr * g[t]).to(fast.dtype)
        fast[t].index_add_(0, fi[t], step)
        bulk[t].index_add_(0, bi[t], step)
    # cold lookups target the fast miss slot / hot ones the bulk hit slot;
    # those pad rows absorb the off-tier halves — zero them back after.
    fast[:, -1] = 0
    bulk[:, -1] = 0
    return tiered._replace(fast=fast, bulk=bulk)


def flush_to_bulk(tiered: TieredTables) -> torch.Tensor:
    """Write live fast-tier rows back into the canonical tables; returns
    a new dense (T, R, d). Unused slots (-1) are skipped."""
    S = tiered.hot_slots
    R = tiered.rows_per_table
    T = tiered.num_tables
    dense = tiered.bulk[:, :R].clone()
    live = tiered.hot_rows >= 0                                  # (T, S)
    t_ix = torch.arange(T, device=dense.device)[:, None].expand(T, S)
    dense[t_ix[live], tiered.hot_rows[live].long()] = tiered.fast[:, :S][live]
    return dense


def lfu_refresh(
    tiered: TieredTables,
    row_freq: torch.Tensor,
    hot_per_table: Optional[int] = None,
    placements: Optional[Sequence[TablePlacement]] = None,
) -> TieredTables:
    """LFU-style refresh hook for training: flush the fast tier back to
    bulk, then re-elect the hot set from the (updated) frequency counts.
    Call between training phases / on access-distribution drift.

    Defaults reproduce the CURRENT store's shape: the per-table cache size
    is the smallest live hot count across tables (the bulk tables' cache),
    and fully-resident tables are re-derived as fast placements — so a
    mixed-placement store refreshes to a mixed-placement store."""
    dense = flush_to_bulk(tiered)
    if hot_per_table is None or placements is None:
        R = tiered.rows_per_table
        counts = (tiered.row_map >= 0).sum(dim=1).cpu().numpy()
        full = counts == R
        if hot_per_table is None:
            hot_per_table = int(counts[~full].min()) if (~full).any() else R
        if placements is None and full.any():
            placements = [TablePlacement(int(t), "fast", "table_wise", None)
                          for t in np.flatnonzero(full)]
    return build_tiered_tables(dense, row_freq, hot_per_table, placements)
