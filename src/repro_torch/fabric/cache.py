"""Per-board LFU cache of REMOTE hot rows -- locality recovery for the
sharded fleet.

The port's copy of ``repro.fabric.cache`` (pure Python and numpy).

Partitioning a table set across boards destroys the locality a single
board enjoys: every lookup whose owner is another board pays the fabric.
hpcaitech/CacheEmbedding's observation is that a small software-managed
cache of the hot rows recovers most of it, because recommendation
streams are Zipfian -- a few percent of rows take most of the accesses.

`RemoteRowCache` is that cache for one board, over the rows the board
does NOT own, keyed by global ``(table, row)``: whether the board misses
a whole table or only the tail of a split one, the cache sees the same
currency, a boolean (T, R) remote mask. A live re-partition calls
`update_ownership(new_remote_mask)` and only rows whose remote-status
changed are invalidated.

Election is LFU by count over all remote rows (a very hot table may take
more slots than a cool one), and the hit-ratio monitor's drift
discipline (`cluster/monitor.py`) decides when to re-elect: a sliding
window of per-query remote-hit ratios, a two-phase trigger that resets
the counts when the windowed ratio erodes below `refresh_threshold x
baseline`, and a cooldown before the re-election fires.

A cached row is an exact copy of the owner's CURRENT row: the cache
changes which lookups pay fabric bytes and latency, never the served
values. Under online serving (`repro_torch.online`) the update -> cache
coherence protocol keeps it so: an owner's row update either drops every
other board's copy (`invalidate_rows`) or piggybacks the fresh payload
into it (`admit_rows`, which evicts the least recently accessed copies
when admission would overflow), so a copy is bit-equal to the owner's
latest version or does not exist.

At full width (RM2-small: 40 x 4,194,304 rows) the reference's
bookkeeping takes seconds a query, so the port keeps its results and
changes how they are computed:

  * lookups read the masks on a flat ``t * R + row`` index (ids in
    [0, R), as the stream draws them), and only in the tables that need
    it: a table wholly local or wholly remote is answered per table,
    and a wholly local one has no cached rows;
  * `observe` folds a query's remote accesses with ``np.unique`` and one
    add on that flat index, where the reference runs ``np.add.at`` on a
    (table, row) tuple;
  * `_elect` picks the same rows as the reference's stable argsort over
    every (T, R) count (descending count, ties by the lowest flat id,
    never a zero count) from the non-zero counts alone, with a partition
    at the boundary count;
  * the cached-row count is kept as a counter, not recounted over the
    (T, R) mask;
  * `admit_rows` picks its LRU victims from the flat ids of the cached
    rows, in the order the reference's ``np.nonzero`` gives them.

The last-use times are a (T, R) float64 array, as in the reference: 1.34
GB a board at full width.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import DLRMConfig


class RemoteRowCache:
    """LFU cache over one board's REMOTE rows; see module docstring.

    `remote` is the board's remote-row space: a (T, R) bool mask, or a
    sequence of remote table ids.
    """

    def __init__(self, cfg: DLRMConfig, remote, *,
                 capacity_rows: int, window: int = 24,
                 refresh_threshold: float = 0.6,
                 cooldown_queries: int = 24, enabled: bool = True):
        self.cfg = cfg
        self.capacity_rows = max(0, int(capacity_rows))
        self.enabled = bool(enabled) and self.capacity_rows > 0
        self.refresh_threshold = float(refresh_threshold)
        self.cooldown_queries = int(cooldown_queries)
        self._set_remote(self._as_mask(remote))
        # stats are keyed by global (table, row): granularity-agnostic, so
        # whole-table and row-range-split ownership look identical here
        self._counts = np.zeros((cfg.num_tables, cfg.rows_per_table),
                                np.int64)
        self._cached = np.zeros((cfg.num_tables, cfg.rows_per_table), bool)
        self._n_cached = 0
        # last access time per row (LRU axis of the propagate-admission
        # eviction); -inf = never accessed
        self._last_used = np.full((cfg.num_tables, cfg.rows_per_table),
                                  -np.inf)
        self.baseline = 0.0
        self._window: Deque[float] = deque(maxlen=int(window))
        self._seen = 0
        self._degraded_at: Optional[int] = None
        self.refreshes: List[float] = []
        self.history: List[Tuple[float, float]] = []   # (t, per-query hit)

    def _as_mask(self, remote) -> np.ndarray:
        arr = np.asarray(remote)
        shape = (self.cfg.num_tables, self.cfg.rows_per_table)
        if arr.dtype == bool and arr.shape == shape:
            return arr.copy()
        mask = np.zeros(shape, bool)
        mask[np.asarray(sorted(int(t) for t in remote), np.int64)] = True
        return mask

    def _set_remote(self, mask: np.ndarray) -> None:
        """Take ``mask`` as the remote-row space, and note which tables
        are wholly remote and which partly."""
        self._remote = mask
        per_table = np.count_nonzero(mask, axis=1)
        self._n_remote = int(per_table.sum())
        self._any_remote = np.flatnonzero(per_table > 0)
        self._all_remote = per_table == mask.shape[1]
        self._mixed = np.flatnonzero((per_table > 0) & ~self._all_remote)

    def _remote_at(self, flat: np.ndarray) -> np.ndarray:
        """(B, T, L) bool: which of these flat positions are remote."""
        out = np.broadcast_to(self._all_remote[None, :, None],
                              flat.shape).copy()
        if self._mixed.size:
            out[:, self._mixed, :] = np.take(self._remote.reshape(-1),
                                             flat[:, self._mixed, :])
        return out

    def _flat(self, indices) -> np.ndarray:
        """(B, T, L) ids -> their flat ``t * R + row`` positions, int32
        while they fit (RM2's 40 x 4,194,304 rows do): the sorts in
        `observe` run on half the bytes."""
        T, R = self.cfg.num_tables, self.cfg.rows_per_table
        dt = np.int32 if T * R < 2 ** 31 else np.int64
        t_off = (np.arange(T, dtype=dt) * R)[None, :, None]
        return np.asarray(indices).astype(dt, copy=False) + t_off

    @property
    def remote_tables(self) -> Tuple[int, ...]:
        """Tables with at least one remote row (fully or partially)."""
        return tuple(self._any_remote.tolist())

    @property
    def cached_rows(self) -> int:
        return self._n_cached

    # -- election ------------------------------------------------------------
    def _elect(self, ids: np.ndarray, vals: np.ndarray) -> None:
        """Install the `capacity_rows` most-accessed remote rows, given
        the candidates' flat ids (ascending) and their counts: global LFU,
        ties by the lowest flat id, never a row of count <= 0 -- the rows
        the reference's stable argsort of every negated count elects."""
        self._cached[:] = False
        self._n_cached = 0
        if not self.enabled or self._n_remote == 0:
            return
        keep = vals > 0
        ids, vals = ids[keep], vals[keep]
        k = min(self.capacity_rows, self._n_remote)
        if ids.size > k:
            kth = np.partition(vals, ids.size - k)[ids.size - k]
            above = np.flatnonzero(vals > kth)
            ties = np.flatnonzero(vals == kth)[:k - above.size]
            ids = ids[np.concatenate([above, ties])]
        self._cached.reshape(-1)[ids] = True
        self._n_cached = int(ids.size)

    def _remote_nonzero(self, values: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Flat ids (ascending) and values of the non-zero entries of a
        (T, R) array at remote rows."""
        flat = values.reshape(-1)
        ids = np.flatnonzero(flat)
        ids = ids[self._remote.reshape(-1)[ids]]
        return ids, flat[ids]

    def warm(self, row_freq) -> float:
        """Elect from a profiled frequency snapshot (the same (T, R)
        profile the partition used) and set the expected-hit baseline the
        drift trigger judges against. Returns the baseline: the cached
        share of the profile's remote mass, summed over its non-zero
        entries (exactly the reference's for an integer profile)."""
        ids, vals = self._remote_nonzero(np.asarray(row_freq))
        vals = vals.astype(np.float64)
        self._elect(ids, vals)
        mass = float(vals.sum())
        hot = self._cached.reshape(-1)[ids]
        self.baseline = float(vals[hot].sum()) / mass if mass > 0 else 0.0
        return self.baseline

    # -- elastic ownership ----------------------------------------------------
    def update_ownership(self, remote) -> int:
        """Swap in a new remote mask after a live re-partition. Only rows
        whose remote-status CHANGED are invalidated (counts zeroed, cached
        copy dropped); every untouched row keeps its stats and its cached
        copy. Returns the number of invalidated rows."""
        new = self._as_mask(remote)
        changed = np.flatnonzero(new != self._remote)
        self._counts.reshape(-1)[changed] = 0
        self._n_cached -= int(np.count_nonzero(
            self._cached.reshape(-1)[changed]))
        self._cached.reshape(-1)[changed] = False
        self._last_used.reshape(-1)[changed] = -np.inf
        self._set_remote(new)
        return int(changed.size)

    # -- online-update coherence (repro_torch.online) -------------------------
    def invalidate_rows(self, table: int, rows) -> int:
        """Drop cached copies of specific rows an owner just updated
        (coherence mode "invalidate"). Counts survive -- the rows are as
        hot as ever, only the bytes went stale. Returns the number of
        copies actually dropped."""
        rows = np.asarray(rows, np.int64)
        hit = rows[self._cached[table, rows]]
        self._cached[table, hit] = False
        self._n_cached -= int(hit.size)
        return int(hit.size)

    def admit_rows(self, table: int, rows, now: float) -> int:
        """Install fresh copies of updated rows (coherence mode
        "propagate"): the owner piggybacked the new payloads, so copies
        this board already holds are refreshed in place for free, and the
        rest are ADMITTED -- evicting least-recently-accessed cached rows
        (ties by the lowest flat id) when over capacity. Only rows remote
        to this board are admitted. Returns rows admitted or refreshed."""
        rows = np.asarray(rows, np.int64)
        rows = rows[self._remote[table, rows]]
        if not self.enabled or rows.size == 0:
            return 0
        held = self._cached[table, rows]
        refreshed, fresh = rows[held], rows[~held]
        space = self.capacity_rows - self._n_cached
        if fresh.size > space:
            # evict least-recently-accessed cached rows that are not
            # themselves being refreshed
            R = self.cfg.rows_per_table
            cand = np.flatnonzero(self._cached)
            cand = cand[~np.isin(cand, table * R + refreshed,
                                 assume_unique=True)]
            if cand.size:
                order = np.argsort(self._last_used.reshape(-1)[cand],
                                   kind="stable")
                drop = cand[order[:min(fresh.size - space, cand.size)]]
                self._cached.reshape(-1)[drop] = False
                self._n_cached -= int(drop.size)
                space += int(drop.size)
        if fresh.size > space:         # nothing left to evict: admit what fits
            fresh = fresh[:max(space, 0)]
        self._cached[table, fresh] = True
        self._n_cached += int(fresh.size)
        touched = np.concatenate([refreshed, fresh])
        self._last_used[table, touched] = np.maximum(
            self._last_used[table, touched], now)
        return int(touched.size)

    # -- lookup-path queries --------------------------------------------------
    def hit_mask(self, indices) -> np.ndarray:
        """(B, T, L) bool: remote lookups this cache serves locally. Local
        rows are False -- they never needed the cache: only remote rows
        are ever elected, and a row that turns local is dropped
        (`update_ownership`), so the cached mask alone answers."""
        flat = self._flat(indices)
        hit = np.zeros(flat.shape, bool)
        tabs = self._any_remote
        hit[:, tabs, :] = np.take(self._cached.reshape(-1),
                                  flat[:, tabs, :])
        return hit

    def observe(self, indices, now: float,
                hit: Optional[np.ndarray] = None) -> float:
        """Fold one query's REMOTE accesses into the LFU counts; score its
        remote lookups against the cache into the drift window. Returns
        the query's remote-hit ratio (1.0 when nothing was remote). `hit`
        short-circuits the mask when the caller already computed
        `hit_mask(indices)`."""
        flat = self._flat(indices)
        remote = self._remote_at(flat)
        n_remote = int(np.count_nonzero(remote))
        if n_remote == 0:
            return 1.0
        rows, n = np.unique(flat[remote], return_counts=True)
        self._counts.reshape(-1)[rows] += n
        self._last_used.reshape(-1)[rows] = now
        if hit is None:
            hit = self.hit_mask(indices)
        h = float(np.count_nonzero(hit)) / n_remote
        self._window.append(h)
        self._seen += 1
        self.history.append((now, h))
        if (self.enabled and self._degraded_at is None
                and len(self._window) == self._window.maxlen
                and self.windowed_hit_ratio()
                < self.refresh_threshold * self.baseline):
            # drift detected: restart the stats so the coming re-election
            # sees the NEW regime's counts only (cluster/monitor.py's
            # two-phase discipline)
            self._degraded_at = self._seen
            self._counts[:] = 0
        return h

    def windowed_hit_ratio(self) -> float:
        if not self._window:
            return self.baseline
        return float(np.mean(self._window))

    # -- refresh policy -------------------------------------------------------
    def should_refresh(self) -> bool:
        return (self.enabled
                and self._degraded_at is not None
                and self._seen - self._degraded_at >= self.cooldown_queries)

    def maybe_refresh(self, now: float) -> bool:
        if not self.should_refresh():
            return False
        self._elect(*self._remote_nonzero(self._counts))
        self._counts[:] = 0
        self._window.clear()
        self._degraded_at = None
        self.refreshes.append(now)
        return True
