"""Update -> cache coherence: keep every copy of a row honest.

The port's counterpart of ``repro.online.coherence``. With frozen
serving every cache in the stack could lean on its copy being exact
forever: a `RemoteRowCache` copy, a tiered fast slab, a host-tier device
chunk. An online delta push breaks all three at once. This module is the
protocol that repairs them, in two modes:

  invalidate  -- the owner drops every other copy of the updated rows
                 (cheap on the wire: row ids only). The next access pays
                 the fabric / the bulk tier / a chunk fault, which re-reads
                 the owner's NEW value.
  propagate   -- the owner piggybacks the new payloads onto the push, and
                 caches holding (or electing) the row install the fresh
                 value in place. Costs payload bytes but keeps the hit
                 ratio through the update.

Either way a copy is bit-equal to the owner's CURRENT row or it does not
exist. The adapters are plain functions over the existing cache surfaces
(`fabric.cache.RemoteRowCache`, `core.tiered_embedding.TieredTables`,
`hoststore.chunks.ChunkParamMgr`).

Device copies are written in place where a kernel reads them live:
`write_through_host` rewrites the resident rows of the manager's own
``device_cache`` tensor, the one a host-tier session's params hold
(``params["hs_cache"]``) and row 6 reads in its ``cached_bag`` pool mode;
the reference rebinds the manager's cache to a new array instead.
`refresh_tiered` keeps the reference's contract: it returns a new store
and leaves its input unchanged.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.tiered_embedding import TieredTables
from repro_torch.fabric.cache import RemoteRowCache
from repro_torch.hoststore.chunks import ChunkParamMgr
from repro_torch.online.delta import DeltaBatch

MODES = ("invalidate", "propagate")


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown coherence mode {mode!r}; one of {MODES}")
    return mode


def apply_to_remote_cache(cache: RemoteRowCache, batch: DeltaBatch, *,
                          now: float, mode: str = "invalidate"
                          ) -> Tuple[int, int]:
    """Reconcile one board's remote-row cache with an update batch.

    Returns (invalidated, admitted): rows whose cached copy was dropped,
    and rows the propagate path installed/refreshed. Only rows REMOTE to
    this board are touched -- the board's own resident rows are the
    owner's problem (`ShardedFleet._apply_delta` rewrites them)."""
    check_mode(mode)
    invalidated = admitted = 0
    for d in batch.deltas:
        if mode == "invalidate":
            invalidated += cache.invalidate_rows(d.table, d.rows)
        else:
            admitted += cache.admit_rows(d.table, d.rows, now)
    return invalidated, admitted


def refresh_tiered(tiered: TieredTables, batch: DeltaBatch
                   ) -> Tuple[TieredTables, int]:
    """Write an update batch through a two-tier embedding store: bulk
    rows always take the new payload; rows with a fast slot get their hot
    copy refreshed too (no re-election -- hotness didn't change, values
    did). Returns (new store, fast rows refreshed); ``tiered`` is left as
    it was."""
    bulk, fast = tiered.bulk, tiered.fast
    refreshed = 0
    for d in batch.deltas:
        if bulk is tiered.bulk:
            bulk, fast = bulk.clone(), fast.clone()
        rows = torch.from_numpy(d.rows).to(bulk.device)
        vals = torch.from_numpy(d.values).to(bulk.device, bulk.dtype)
        bulk[d.table, rows] = vals
        slots = tiered.row_map[d.table].index_select(0, rows)
        hot = slots >= 0
        n_hot = int(hot.sum())
        if n_hot:
            fast[d.table, slots[hot].long()] = vals[hot]
            refreshed += n_hot
    return TieredTables(fast, bulk, tiered.row_map, tiered.hot_rows), refreshed


def write_through_host(mgr: ChunkParamMgr, batch: DeltaBatch) -> int:
    """Write an update batch through the host chunk store: the host copy
    is canonical and takes every row; rows whose chunk is RESIDENT in the
    device cache get that copy rewritten in place (the indirection map
    keeps pointing at the same position, so the next step reads the new
    value). The rows are NOT marked dirty -- the update originated
    outside, host is already truth. Rows of the host tier's hot slab are
    not this store's: the caller keeps them. Returns the number of
    device-resident rows refreshed."""
    refreshed = 0
    cache = mgr.device_cache
    for d in batch.deltas:
        vals = torch.from_numpy(d.values)
        mgr.host[d.table, torch.from_numpy(d.rows)] = vals.to(mgr.host.dtype)
        pos = mgr.host_pos[d.table, d.rows]
        res = pos < mgr.pad_pos               # resident rows only
        if res.any():
            at = torch.from_numpy(pos[res].astype(np.int64)).to(cache.device)
            cache[at] = vals[torch.from_numpy(res)].to(cache.device,
                                                       cache.dtype)
            refreshed += int(res.sum())
    return refreshed
