"""Per-board LFU cache of REMOTE hot rows -- locality recovery for the
sharded fleet.

The port's copy of ``repro.fabric.cache``, its (T, R) state in torch
tensors on the board's device.

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
  * `observe` folds a query's remote accesses with ``torch.unique`` and
    one add on that flat index, where the reference runs ``np.add.at`` on a
    (table, row) tuple;
  * `_elect` picks the same rows as the reference's stable argsort over
    every (T, R) count (descending count, ties by the lowest flat id,
    never a zero count) from the non-zero counts alone, cut at the
    boundary count;
  * the cached-row count is kept as a counter, not recounted over the
    (T, R) mask;
  * `admit_rows` picks its LRU victims from the flat ids of the cached
    rows, in the order the reference's ``np.nonzero`` gives them.

The (T, R) state -- access counts, the cached and remote masks, the
last-use times (float64, as in the reference) -- lives on ``device``, the
board's card in a fleet: ~2.9 GB a board at full width, which host
memory would have to fault in and numpy would walk on one thread, for
every query's scatter and every whole-array pass. Queries arrive as
numpy ids; `hit_mask` answers in numpy; the values are the reference's
on any device. `_counts`, `_cached`, `_remote` and `_last_used` read
the state back as numpy arrays (views on the CPU).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.device import DeviceArg, resolve_device


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array: a view on the CPU, a copy from a card."""
    return t.detach().cpu().numpy()


class RemoteRowCache:
    """LFU cache over one board's REMOTE rows; see module docstring.

    `remote` is the board's remote-row space: a (T, R) bool mask, or a
    sequence of remote table ids. ``device`` holds the (T, R) state.
    """

    def __init__(self, cfg: DLRMConfig, remote, *,
                 capacity_rows: int, window: int = 24,
                 refresh_threshold: float = 0.6,
                 cooldown_queries: int = 24, enabled: bool = True,
                 device: DeviceArg = "cpu"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capacity_rows = max(0, int(capacity_rows))
        self.enabled = bool(enabled) and self.capacity_rows > 0
        self.refresh_threshold = float(refresh_threshold)
        self.cooldown_queries = int(cooldown_queries)
        self._set_remote(self._as_mask(remote))
        # stats are keyed by global (table, row): granularity-agnostic, so
        # whole-table and row-range-split ownership look identical here
        shape = (cfg.num_tables, cfg.rows_per_table)
        self._counts_t = torch.zeros(shape, dtype=torch.int64,
                                     device=self.device)
        self._cached_t = torch.zeros(shape, dtype=torch.bool,
                                     device=self.device)
        self._n_cached = 0
        # last access time per row (LRU axis of the propagate-admission
        # eviction); -inf = never accessed
        self._last_used_t = torch.full(shape, -math.inf,
                                       dtype=torch.float64,
                                       device=self.device)
        self.baseline = 0.0
        self._window: Deque[float] = deque(maxlen=int(window))
        self._seen = 0
        self._degraded_at: Optional[int] = None
        self.refreshes: List[float] = []
        self.history: List[Tuple[float, float]] = []   # (t, per-query hit)

    # -- the (T, R) state, read back as numpy --------------------------------
    @property
    def _counts(self) -> np.ndarray:
        return _host(self._counts_t)

    @property
    def _cached(self) -> np.ndarray:
        return _host(self._cached_t)

    @property
    def _remote(self) -> np.ndarray:
        return _host(self._remote_t)

    @property
    def _last_used(self) -> np.ndarray:
        return _host(self._last_used_t)

    @property
    def nbytes(self) -> int:
        """Bytes of the (T, R) state on ``device``."""
        return sum(t.nbytes for t in (self._counts_t, self._cached_t,
                                      self._remote_t, self._last_used_t))

    def _as_mask(self, remote) -> torch.Tensor:
        shape = (self.cfg.num_tables, self.cfg.rows_per_table)
        if (torch.is_tensor(remote) and remote.dtype == torch.bool
                and tuple(remote.shape) == shape):
            return remote.to(self.device, copy=True)
        arr = np.asarray(remote)
        if arr.dtype == bool and arr.shape == shape:
            return torch.from_numpy(np.array(arr)).to(self.device)
        mask = torch.zeros(shape, dtype=torch.bool, device=self.device)
        tids = torch.tensor(sorted(int(t) for t in remote),
                            dtype=torch.int64)
        mask[tids.to(self.device)] = True
        return mask

    def _set_remote(self, mask: torch.Tensor) -> None:
        """Take ``mask`` as the remote-row space, and note which tables
        are wholly remote and which partly."""
        self._remote_t = mask
        per_table = _host(mask.sum(1))
        self._n_remote = int(per_table.sum())
        self._any_remote = np.flatnonzero(per_table > 0)
        self._all_remote = per_table == mask.shape[1]
        self._mixed = np.flatnonzero((per_table > 0) & ~self._all_remote)
        self._any_remote_t = torch.from_numpy(self._any_remote).to(
            self.device)
        self._all_remote_t = torch.from_numpy(self._all_remote).to(
            self.device)
        self._mixed_t = torch.from_numpy(self._mixed).to(self.device)

    def _remote_at(self, flat: torch.Tensor) -> torch.Tensor:
        """(B, T, L) bool: which of these flat positions are remote."""
        out = self._all_remote_t[None, :, None].expand(flat.shape).clone()
        if self._mixed.size:
            out[:, self._mixed_t, :] = self._remote_t.view(-1)[
                flat[:, self._mixed_t, :]]
        return out

    def _flat(self, indices) -> torch.Tensor:
        """(B, T, L) ids -> their flat ``t * R + row`` positions (int64)
        on ``device``."""
        T, R = self.cfg.num_tables, self.cfg.rows_per_table
        idx = (indices if torch.is_tensor(indices)
               else torch.from_numpy(np.ascontiguousarray(indices)))
        idx = idx.to(self.device).long()
        t_off = torch.arange(T, dtype=torch.int64, device=self.device) * R
        return idx + t_off[None, :, None]

    @property
    def remote_tables(self) -> Tuple[int, ...]:
        """Tables with at least one remote row (fully or partially)."""
        return tuple(self._any_remote.tolist())

    @property
    def cached_rows(self) -> int:
        return self._n_cached

    # -- election ------------------------------------------------------------
    def _elect(self, ids: torch.Tensor, vals: torch.Tensor) -> None:
        """Install the `capacity_rows` most-accessed remote rows, given
        the candidates' flat ids (ascending) and their counts: global LFU,
        ties by the lowest flat id, never a row of count <= 0 -- the rows
        the reference's stable argsort of every negated count elects."""
        self._cached_t.zero_()
        self._n_cached = 0
        if not self.enabled or self._n_remote == 0:
            return
        keep = vals > 0
        ids, vals = ids[keep], vals[keep]
        k = min(self.capacity_rows, self._n_remote)
        if ids.numel() > k:
            # the boundary count: np.partition's element at size - k
            kth = torch.sort(vals).values[ids.numel() - k]
            above = (vals > kth).nonzero().view(-1)
            ties = (vals == kth).nonzero().view(-1)[:k - above.numel()]
            ids = ids[torch.cat([above, ties])]
        self._cached_t.view(-1)[ids] = True
        self._n_cached = int(ids.numel())

    def _remote_nonzero(self, values: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat ids (ascending) and values of the non-zero entries of a
        (T, R) tensor at remote rows."""
        flat = values.reshape(-1)
        ids = flat.nonzero().view(-1)
        ids = ids[self._remote_t.view(-1)[ids]]
        return ids, flat[ids]

    def warm(self, row_freq) -> float:
        """Elect from a profiled frequency snapshot (the same (T, R)
        profile the partition used; an array, or a tensor on any device)
        and set the expected-hit baseline the drift trigger judges
        against. Returns the baseline: the cached share of the profile's
        remote mass, summed over its non-zero entries (exactly the
        reference's for an integer profile)."""
        freq = (row_freq if torch.is_tensor(row_freq)
                else torch.from_numpy(np.array(row_freq)))
        ids, vals = self._remote_nonzero(freq.to(self.device))
        vals = vals.to(torch.float64)
        self._elect(ids, vals)
        mass = float(vals.sum())
        hot = self._cached_t.view(-1)[ids]
        self.baseline = float(vals[hot].sum()) / mass if mass > 0 else 0.0
        return self.baseline

    # -- elastic ownership ----------------------------------------------------
    def update_ownership(self, remote) -> int:
        """Swap in a new remote mask after a live re-partition. Only rows
        whose remote-status CHANGED are invalidated (counts zeroed, cached
        copy dropped); every untouched row keeps its stats and its cached
        copy. Returns the number of invalidated rows."""
        new = self._as_mask(remote)
        changed = (new != self._remote_t).view(-1).nonzero().view(-1)
        cached = self._cached_t.view(-1)
        self._n_cached -= int(cached[changed].sum())
        self._counts_t.view(-1)[changed] = 0
        cached[changed] = False
        self._last_used_t.view(-1)[changed] = -math.inf
        self._set_remote(new)
        return int(changed.numel())

    # -- online-update coherence (repro_torch.online) -------------------------
    def _table_rows(self, rows) -> torch.Tensor:
        return torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)

    def invalidate_rows(self, table: int, rows) -> int:
        """Drop cached copies of specific rows an owner just updated
        (coherence mode "invalidate"). Counts survive -- the rows are as
        hot as ever, only the bytes went stale. Returns the number of
        copies actually dropped."""
        rows = self._table_rows(rows)
        hit = rows[self._cached_t[table, rows]]
        self._cached_t[table, hit] = False
        self._n_cached -= int(hit.numel())
        return int(hit.numel())

    def admit_rows(self, table: int, rows, now: float) -> int:
        """Install fresh copies of updated rows (coherence mode
        "propagate"): the owner piggybacked the new payloads, so copies
        this board already holds are refreshed in place for free, and the
        rest are ADMITTED -- evicting least-recently-accessed cached rows
        (ties by the lowest flat id) when over capacity. Only rows remote
        to this board are admitted. Returns rows admitted or refreshed."""
        rows = self._table_rows(rows)
        rows = rows[self._remote_t[table, rows]]
        if not self.enabled or rows.numel() == 0:
            return 0
        held = self._cached_t[table, rows]
        refreshed, fresh = rows[held], rows[~held]
        space = self.capacity_rows - self._n_cached
        if fresh.numel() > space:
            # evict least-recently-accessed cached rows that are not
            # themselves being refreshed
            R = self.cfg.rows_per_table
            cand = self._cached_t.view(-1).nonzero().view(-1)
            cand = cand[~torch.isin(cand, table * R + refreshed,
                                    assume_unique=True)]
            if cand.numel():
                order = torch.argsort(self._last_used_t.view(-1)[cand],
                                      stable=True)
                drop = cand[order[:min(fresh.numel() - space,
                                       cand.numel())]]
                self._cached_t.view(-1)[drop] = False
                self._n_cached -= int(drop.numel())
                space += int(drop.numel())
        if fresh.numel() > space:      # nothing left to evict: admit what fits
            fresh = fresh[:max(space, 0)]
        self._cached_t[table, fresh] = True
        self._n_cached += int(fresh.numel())
        touched = torch.cat([refreshed, fresh])
        last = self._last_used_t[table]
        last[touched] = torch.clamp(last[touched], min=now)
        return int(touched.numel())

    # -- lookup-path queries --------------------------------------------------
    def _hit(self, flat: torch.Tensor) -> torch.Tensor:
        hit = torch.zeros(flat.shape, dtype=torch.bool, device=self.device)
        tabs = self._any_remote_t
        hit[:, tabs, :] = self._cached_t.view(-1)[flat[:, tabs, :]]
        return hit

    def hit_mask(self, indices) -> np.ndarray:
        """(B, T, L) bool: remote lookups this cache serves locally. Local
        rows are False -- they never needed the cache: only remote rows
        are ever elected, and a row that turns local is dropped
        (`update_ownership`), so the cached mask alone answers."""
        return _host(self._hit(self._flat(indices)))

    def observe(self, indices, now: float,
                hit: Optional[np.ndarray] = None) -> float:
        """Fold one query's REMOTE accesses into the LFU counts; score its
        remote lookups against the cache into the drift window. Returns
        the query's remote-hit ratio (1.0 when nothing was remote). `hit`
        short-circuits the mask when the caller already computed
        `hit_mask(indices)`."""
        flat = self._flat(indices)
        remote = self._remote_at(flat)
        seen = flat[remote]
        n_remote = int(seen.numel())
        if n_remote == 0:
            return 1.0
        rows, n = torch.unique(seen, sorted=True, return_counts=True)
        counts = self._counts_t.view(-1)
        counts[rows] += n
        self._last_used_t.view(-1)[rows] = now
        n_hit = (int(np.count_nonzero(hit)) if hit is not None
                 else int(self._hit(flat).sum()))
        h = float(n_hit) / n_remote
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
            self._counts_t.zero_()
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
        self._elect(*self._remote_nonzero(self._counts_t))
        self._counts_t.zero_()
        self._window.clear()
        self._degraded_at = None
        self.refreshes.append(now)
        return True
