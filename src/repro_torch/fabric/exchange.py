"""Inter-board embedding exchange: route lookups to owners, pool, return.

The port's copy of ``repro.fabric.exchange`` (pure Python and numpy). It
routes a whole table's lookups by the table's owner and a split table's
by its row cuts, where the reference reads a (T, R) owner grid (random
reads over 336 MB a batch at RM2-small's full width).

One flushed batch on a dense-owner board plays Alg. 1 across BOARDS:

  1. split the (B, T, L) index stream by the shard map's ROW-RANGE
     ownership (`owner_cuts`: row r of table t belongs to the board whose
     range covers it); for whole (single-shard) tables the owner's slice
     is one bag call on that board's stacked owned tables
     (`FabricBoard.lookup`: row 4, `kernels.ops.embedding_bag`, the
     hand-written bag kernel on the card),
     producing pooled (B, T_o, d) parts; a row-range SPLIT table is
     gathered per owner as masked raw rows and summed on the dense owner
     (pooling a row-sliced bag remotely would change fp summation order
     and break bit-identity);
  2. re-stitch the parts into original table order (the
     `parallel.exchange.planned_forward` inverse-permutation idiom),
     whole tables grouped by owner first, split tables after;
  3. account the wire traffic the remote slices imply — index bytes out
     for every remote lookup the dense owner's `RemoteRowCache` does NOT
     hold; coming back, one partially-pooled d-vector per (sample, table)
     bag with at least one miss for whole tables (the partial-pool wire
     format of `core/perf_model.py`: owners pool what they can before
     shipping), but one d-vector per miss ROW for split tables (a
     row-sliced bag cannot be pooled remotely without changing the sum
     order) — and price it with `perf_model.fabric_exchange_time`
     (latency + bandwidth + topology).

The VALUES never depend on the cache or the link (cached rows are exact
copies of frozen rows); the exchange's job is to make the pooled tensor
bit-identical to a single full board's while metering exactly what a
real fabric would carry.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.collectives import Interconnect
from repro_torch.core.perf_model import fabric_exchange_time
from repro_torch.fabric.cache import RemoteRowCache
from repro_torch.fabric.partition import ShardMap
from repro_torch.obs.metrics import MetricsRegistry

PartitionMap = ShardMap  # wire-level alias, same as fabric.partition


@dataclass(frozen=True)
class ExchangeTraffic:
    """Wire accounting for one flushed batch on one dense-owner board."""

    n_queries: int
    remote_lookups: int       # lookups owned by another board
    cache_hits: int           # of those, served by the remote-row cache
    miss_rows: int            # row fetches that actually cross the fabric
    miss_bags: int            # (sample, table) bags with >= 1 miss
    bytes_out: float          # index payload to the owner boards
    bytes_in: float           # vectors coming back (pooled or raw rows)
    t_link_s: float           # modeled fabric time for the round

    @property
    def bytes_total(self) -> float:
        return self.bytes_out + self.bytes_in

    @property
    def remote_hit_ratio(self) -> float:
        if self.remote_lookups == 0:
            return 1.0
        return self.cache_hits / self.remote_lookups


class FabricExchange:
    """Shard-map-aware routing + exchange accounting for a sharded fleet.

    index_bytes / elem_bytes follow the perf model's wire conventions
    (4 B indices, fp16 embeddings on the wire) so the fabric numbers
    compose with the chip-level CC model's.
    """

    def __init__(self, cfg: DLRMConfig, partition: ShardMap,
                 link: Interconnect, *, index_bytes: int = 4,
                 elem_bytes: int = 2,
                 metrics: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.partition = partition
        self.link = link
        self.metrics = metrics     # publish wire accounting here when set
        self.index_bytes = int(index_bytes)
        self.elem_bytes = int(elem_bytes)
        T = partition.num_tables
        self.split_tables = np.asarray(partition.split_tables, np.int32)
        self._split_mask = np.zeros(T, bool)
        self._split_mask[self.split_tables] = True
        # the two-level routing table: a whole table's owner, and each
        # split table's (row cuts, owners)
        whole_owner = {s.table: s.board for s in partition.shards
                       if not self._split_mask[s.table]}
        self._table_owner = np.zeros(T, np.int16)
        self._table_owner[list(whole_owner)] = list(whole_owner.values())
        self._cuts = {int(t): partition.owner_cuts(int(t))
                      for t in self.split_tables}
        # whole tables: per-board table-id slices + the inverse permutation
        # that restores original table order after concatenating [owners'
        # pooled parts in board order] + [split tables in id order]
        self.tables_by_board: Tuple[np.ndarray, ...] = tuple(
            np.asarray(sorted(t for t, b in whole_owner.items() if b == bd),
                       np.int32)
            for bd in range(partition.n_boards))
        concat_order = np.concatenate(
            [t for t in self.tables_by_board if t.size]
            + [self.split_tables]
            or [np.zeros(0, np.int32)])
        self.inv_perm = np.argsort(concat_order).astype(np.int32)

    def lookup_owners(self, indices) -> np.ndarray:
        """(B, T, L) owning board id per lookup — routing by row offset."""
        idx = np.asarray(indices)
        owners = np.broadcast_to(self._table_owner[None, :, None],
                                 idx.shape).copy()
        for t, (cuts, own) in self._cuts.items():
            owners[:, t, :] = own[np.searchsorted(cuts, idx[:, t, :],
                                                  "right") - 1]
        return owners

    def account(self, board_id: int, indices,
                cache: Optional[RemoteRowCache] = None,
                hit: Optional[np.ndarray] = None) -> ExchangeTraffic:
        """Meter one batch's cross-board traffic as seen from the dense
        owner `board_id`; `cache` filters remote lookups it holds. `hit`
        reuses a mask the caller already computed for this batch."""
        idx = np.asarray(indices)
        B, T, L = idx.shape
        remote = self.lookup_owners(idx) != board_id        # (B, T, L)
        remote_lookups = int(remote.sum())
        if remote_lookups == 0:
            return ExchangeTraffic(B, 0, 0, 0, 0, 0.0, 0.0, 0.0)
        if hit is None:
            hit = (cache.hit_mask(idx) if cache is not None
                   else np.zeros_like(idx, bool))
        miss = remote & ~hit
        miss_rows = int(miss.sum())
        miss_bags = int(miss.any(axis=2).sum())
        cache_hits = remote_lookups - miss_rows
        bytes_out = miss_rows * self.index_bytes
        # whole tables ship one partially-pooled vector per missing bag;
        # split tables ship raw rows (one vector per miss) — remote pooling
        # of a row slice would break the bit-identity invariant
        split = self._split_mask[None, :, None]
        pooled_bags = int((miss & ~split).any(axis=2).sum())
        raw_rows = int((miss & split).sum())
        bytes_in = (pooled_bags + raw_rows) * self.cfg.embed_dim \
            * self.elem_bytes
        t_link = fabric_exchange_time(bytes_out, bytes_in,
                                      self.partition.n_boards, self.link)
        if self.metrics is not None:
            self.metrics.counter("wire_bytes", board=board_id).inc(
                bytes_out + bytes_in)
            self.metrics.counter("remote_lookups").inc(remote_lookups)
            self.metrics.counter("cache_hit", tier="remote").inc(cache_hits)
            self.metrics.counter("cache_miss", tier="remote").inc(miss_rows)
        return ExchangeTraffic(B, remote_lookups, cache_hits, miss_rows,
                               miss_bags, float(bytes_out), float(bytes_in),
                               t_link)
