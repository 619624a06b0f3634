"""ShardedFleet: N boards that TOGETHER hold one model too big for any
single board.

The port's counterpart of ``repro.fabric.fleet``. `repro_torch.cluster.
Cluster` replicates -- every board a full copy, so the fleet's servable
model is capped by ONE board's memory. `ShardedFleet` partitions: each
board owns a slice of the ROW SPACE (whole tables, plus row ranges of
tables too big for any board, per the `ShardMap`) and a copy of the small
dense MLPs. A query is served by two-level routing on the cluster's
virtual-clock discipline:

  query  -> dense-owner board   (the Router policies: round_robin / jsq /
                                 p2c)
  lookup -> row-owner boards    (the ShardMap: whole-table owners run row
                                 4, the bag kernel, on their stacked
                                 tables and ship pooled vectors; owners of
                                 a SPLIT table ship masked raw rows --
                                 pooling a row slice remotely would change
                                 the fp sum order -- which the dense owner
                                 sums and pools with the SAME bag kernel)

One flushed batch's timeline on the virtual clock:

  start       = max(trigger, dense_owner.free)
  parts ready = max over owners of (max(start, owner.free) + t_owner)
  done        = parts_ready + t_link (modeled: latency + bytes/bw +
                topology, misses only) + t_pool (split tables only)
                + t_dense (measured on the owner)

Lookup, gather, pool and dense SERVICE times are real device executions
on each board's device, each timed alone; only the fabric term is
modeled. On one card every board is ``cuda:0``. Served values are
bit-identical to one full board regardless of partition, split
granularity, cache state or link: every flush is padded to the capacity
shape, and the split-table path pools a (T_s, B*L, d) "fake table" of
gathered rows with the bag kernel, whose per-(sample, table) summation
order depends only on L and d.

An optional `SLAAutoscaler` makes the fleet ELASTIC: on sustained p99
violation/slack it grows/shrinks the board count mid-trace via
`fabric/elastic.expand_map` / `shrink_map`, executing the
`MigrationPlan` (the virtual clock stalls `perf_model.repartition_time`;
each surviving cache invalidates ONLY migrated rows).

Memory, where the reference's choices would not fit the card at full
width (RM2-small: 21.47 GB of tables):

  * the canonical tables live ONCE, in host memory (drawn a table at a
    time by ``hoststore.draw_host_tables``, or the CPU tensor of
    ``params=``, shared without a copy); no fleet holds a device copy of
    all tables beside the boards' slices;
  * capacity is budgeted at the bytes the tables are stored in (fp32:
    4 bytes an element), not at the config's nominal fp16 as the
    reference budgets them, so a board's budget is what it holds;
  * a board's residency is installed from host memory a table or row
    range at a time, through the host tier's pinned staging ring, and
    a re-partition releases every changed board's old residency before
    it installs the new ones; a retired board releases its tensors and
    keeps its stats;
  * a served query's content is dropped from its future (the reference
    keeps it); its probs stay;
  * an online run (``run(online=...)``) writes each batch's rows in
    place: into the fleet's host tables, which it copies on its first
    write (fleets built from one ``params`` share them), and into each
    owner's resident slices on the device. The reference re-installs
    every owner's residency from the host tables instead; an installed
    residency is kept as it is here, and a re-install would move the
    whole slice through the staging ring for each update.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (Callable, ClassVar, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.cluster.autoscale import ScaleEvent, SLAAutoscaler
from repro_torch.cluster.cluster import FleetReport
from repro_torch.cluster.replica import slice_devices, submesh
from repro_torch.cluster.router import Router, make_router
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.core import perf_model
from repro_torch.core import tiered_embedding as te
from repro_torch.core.collectives import Interconnect
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.engine.batching import MicroBatcher, QueryFuture
from repro_torch.fabric.cache import RemoteRowCache
from repro_torch.fabric.elastic import expand_map, plan_migration, shrink_map
from repro_torch.fabric.exchange import FabricExchange
from repro_torch.fabric.partition import ShardMap, partition_rows
from repro_torch.hoststore import StagingRing, draw_host_tables
from repro_torch.kernels import ops
from repro_torch.obs.attribution import AttributionLog, interval_overlap_s
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.online.delta import ELEM_BYTES, INDEX_BYTES, DeltaBatch
from repro_torch.online.report import OnlineReport
from repro_torch.traffic.scenarios import QueryEvent, materialize_query

RowRanges = Dict[int, List[Tuple[int, int]]]   # table -> [(row_lo, row_hi)]


@dataclass(frozen=True)
class FabricReport(FleetReport):
    """FleetReport + the sharded fleet's telemetry."""

    n_boards: int = 0
    board_capacity_bytes: int = 0
    model_bytes: int = 0
    fits_one_board: bool = True
    cache_rows: int = 0
    bytes_per_query: float = 0.0        # cross-board wire bytes / query
    remote_lookup_fraction: float = 0.0
    remote_hit_first: Optional[float] = None
    remote_hit_last: Optional[float] = None
    link_stall_share: float = 0.0       # fabric seconds / service seconds
    cache_refreshes: int = 0
    # elastic ledger: live re-partitions executed during the run
    scale_events: Tuple[ScaleEvent, ...] = ()
    migrations: int = 0
    migrated_bytes: int = 0
    migration_s: float = 0.0            # virtual seconds stalled migrating
    cache_invalidated_rows: int = 0

    tag: ClassVar[str] = "fabric"

    def summary(self) -> str:
        lines = [super().summary()]
        lines.append(
            f"[fabric] {self.model_bytes / 2**20:.2f} MiB tables over "
            f"{self.n_boards} boards @ "
            f"{self.board_capacity_bytes / 2**20:.2f} MiB "
            f"({'fits' if self.fits_one_board else 'does NOT fit'} one "
            f"board); {self.remote_lookup_fraction:.0%} of lookups remote")
        hit = ("" if self.remote_hit_first is None else
               f" remote-cache hit {self.remote_hit_first:.3f} -> "
               f"{self.remote_hit_last:.3f}"
               + (f" ({self.cache_refreshes} refresh)"
                  if self.cache_refreshes else ""))
        lines.append(
            f"[fabric] {self.bytes_per_query:.0f} B/query on the wire, "
            f"link-stall {self.link_stall_share:.1%} of service;{hit}")
        if self.migrations:
            lines.append(
                f"[fabric] elastic: {self.migrations} re-partitions, "
                f"{self.migrated_bytes / 2**20:.2f} MiB migrated in "
                f"{self.migration_s * 1e3:.2f}ms stall, "
                f"{self.cache_invalidated_rows} cached rows invalidated")
        for e in self.scale_events:
            lines.append(
                f"[fabric] scale {e.action} at t={e.t_s:.3f}s -> "
                f"{e.n_replicas} boards (window p99 "
                f"{e.window_p99_ms:.2f}ms, moved {e.remesh})")
        return "\n".join(lines)


def _residency_key(whole_tids: Sequence[int], split_ranges: RowRanges):
    return (tuple(sorted(int(t) for t in whole_tids)),
            {int(t): sorted(r) for t, r in split_ranges.items()})


def _on(tree, device: torch.device):
    """A tree of dicts and lists of tensors, each on ``device`` (a tensor
    already there is kept, not copied)."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


class FabricBoard:
    """One board of a sharded fleet: its slice of the row space + a copy
    of the dense MLPs, on its own device. Speaks the queue-state protocol
    routers see on `cluster.Replica` (rid / expected_wait_s / backlog /
    enqueue / deadline). Residency is re-settable (`set_residency`) so a
    live re-partition can move row ranges without rebuilding the board.
    Rows come from host memory through ``staging``, the pinned ring its
    device shares with the fleet's other boards there. The port's board
    is one device; more raises naming ROADMAP A6b."""

    def __init__(self, rid: int, cfg: DLRMConfig, devices: Sequence,
                 whole_tids: Sequence[int], split_ranges: RowRanges,
                 params, tables_host: torch.Tensor, *,
                 model_axis: int = 1, max_batch_queries: int = 4,
                 max_wait_ms: float = 2.0, staging: StagingRing,
                 service_scale: float = 1.0):
        self.rid = rid
        self.cfg = cfg
        self.devices = list(devices)
        self.mesh = submesh(self.devices, model_axis)
        self.device = self.mesh[0]
        # fixed per-board slowdown (a straggler board): scales every
        # measured device time
        self.service_scale = float(service_scale)
        self.dense_params = _on({"bot_mlp": params["bot_mlp"],
                                 "top_mlp": params["top_mlp"]}, self.device)
        self.batcher = MicroBatcher(int(max_batch_queries), max_wait_ms / 1e3)
        self.free = 0.0              # virtual clock: busy until this time
        self.busy_s = 0.0            # occupied window (incl. link stalls)
        self.lookup_busy_s = 0.0     # time spent serving OTHERS' lookups
        self.served = 0
        self.spawned_at = 0.0        # virtual time this board came up
        self.retired_at: Optional[float] = None
        self.batch_sizes: List[int] = []
        self._svc_ewma = 0.0
        # (role, shape) keys that ran their untimed warm-up execution
        self.warmed: set = set()
        self._staging = staging
        self.table_ids = np.zeros(0, np.int32)
        self.tables: Optional[torch.Tensor] = None
        self.split_rows: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.residency: Tuple[Tuple[int, ...], RowRanges] = ((), {})
        self.set_residency(whole_tids, split_ranges, tables_host)

    # -- residency (re-settable: live re-partition moves row ranges) ---------
    def release(self) -> None:
        """Drop this board's resident rows from its device."""
        self.tables = None
        self.split_rows = {}
        self.table_ids = np.zeros(0, np.int32)
        self.residency = ((), {})

    def _install(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """dst (n, d) on the device <- src (n, d) in host memory, through
        the pinned staging ring."""
        d = src.shape[-1]
        self._staging.to_device(
            src.shape[0], (d,),
            lambda a, b, piece: piece.copy_(src[a:b]),
            lambda a, b, piece: dst[a:b].copy_(piece, non_blocking=True))

    def set_residency(self, whole_tids: Sequence[int],
                      split_ranges: RowRanges,
                      tables_host: torch.Tensor) -> None:
        """Install this board's owned slice of the row space: whole tables
        stacked (T_own, R, d) for the pooled bag path, split-table row
        ranges as compact (n_owned, d) slices + their sorted global row
        ids for the masked-gather path. Only OWNED rows live on the board.
        The old residency is released first; an unchanged one stays."""
        if self.holds(whole_tids, split_ranges):
            return
        residency = _residency_key(whole_tids, split_ranges)
        self.release()
        _, R, d = tables_host.shape
        tids, ranges = residency
        self.table_ids = np.asarray(tids, np.int32)
        self.tables = torch.empty((len(tids), R, d), dtype=tables_host.dtype,
                                  device=self.device)
        for j, t in enumerate(tids):
            self._install(self.tables[j], tables_host[t])
        for t, rr in sorted(ranges.items()):
            rows = torch.empty((sum(hi - lo for lo, hi in rr), d),
                               dtype=tables_host.dtype, device=self.device)
            off = 0
            for lo, hi in rr:
                self._install(rows[off:off + hi - lo], tables_host[t, lo:hi])
                off += hi - lo
            row_ids = torch.cat([torch.arange(lo, hi) for lo, hi in rr])
            self.split_rows[t] = (row_ids.to(self.device), rows)
        self.residency = residency

    def holds(self, whole_tids: Sequence[int],
              split_ranges: RowRanges) -> bool:
        """Whether this residency is the one installed."""
        return _residency_key(whole_tids, split_ranges) == self.residency

    @property
    def resident_rows(self) -> int:
        return (int(self.table_ids.size) * self.cfg.rows_per_table
                + sum(len(ids) for ids, _ in self.split_rows.values()))

    def resident_bytes(self, row_bytes: int) -> int:
        """Embedding bytes on this board at the accounting precision."""
        return self.resident_rows * row_bytes

    # -- queue state (what routers see) -------------------------------------
    def backlog(self, now: float) -> int:
        return len(self.batcher.queue)

    def expected_wait_s(self, now: float) -> float:
        return (max(self.free - now, 0.0)
                + len(self.batcher.queue) * self._svc_ewma)

    def enqueue(self, fut: QueryFuture) -> bool:
        return self.batcher.add(fut)

    def deadline(self) -> float:
        return self.batcher.deadline()

    # -- real device executions ---------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, key: tuple, fn: Callable[[], torch.Tensor]
               ) -> Tuple[torch.Tensor, float]:
        """(fn(), seconds of its device work alone x ``service_scale``).
        The first call of a (role, shape) key runs once untimed first (the
        reference's compile-once warm-up)."""
        if key not in self.warmed:
            fn()
            self.warmed.add(key)
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        return out, (time.perf_counter() - t0) * self.service_scale

    def lookup(self, indices_local: torch.Tensor
               ) -> Tuple[torch.Tensor, float]:
        """Bag-reduce this board's whole owned tables for a batch slice
        with row 4: (B, T_own, L) ids in owned-table order -> ((B, T_own,
        d) pooled part, measured seconds x service_scale)."""
        idx = indices_local.to(self.device, torch.int32).contiguous()
        return self._timed(("lookup", tuple(idx.shape)),
                           lambda: ops.embedding_bag(self.tables, idx))

    def gather_rows(self, table: int, idx_bl: torch.Tensor
                    ) -> Tuple[torch.Tensor, float]:
        """Masked gather of this board's resident rows of a SPLIT table:
        (B, L) global row ids -> ((B, L, d) rows, seconds). Rows this
        board does not own come back as exact zeros (value x 0.0) so the
        dense owner's cross-owner sum reconstructs every row bit-exactly
        (x + 0.0 == x); pooling happens there, in kernel order."""
        row_ids, rows = self.split_rows[int(table)]
        ids = idx_bl.to(self.device, torch.int64)

        def gather() -> torch.Tensor:
            pos = torch.searchsorted(row_ids, ids).clamp_(
                max=row_ids.numel() - 1)
            mask = row_ids[pos] == ids
            return rows[pos] * mask[..., None].to(rows.dtype)

        return self._timed(("gather", int(table), tuple(ids.shape),
                            row_ids.numel()), gather)

    def pool_rows(self, fake_tables: torch.Tensor, fake_idx: torch.Tensor
                  ) -> Tuple[torch.Tensor, float]:
        """Pool reassembled split-table rows with the SAME bag kernel the
        whole tables run: fake_tables (T_s, B*L, d) are the summed
        gathered rows, fake_idx[b, s, l] = b*L + l, so the per-(b, t)
        accumulation order (l = 0..L-1) is a single full board's."""
        tables = fake_tables.to(self.device).contiguous()
        idx = fake_idx.to(self.device, torch.int32).contiguous()
        return self._timed(("pool", tuple(tables.shape), tuple(idx.shape)),
                           lambda: ops.embedding_bag(tables, idx))

    def dense_forward(self, dense: torch.Tensor, pooled: torch.Tensor
                      ) -> Tuple[np.ndarray, float]:
        """Bottom MLP + interactions + top MLP + sigmoid on this board's
        device, plain torch; returns (probs (B,), measured seconds x
        service_scale)."""
        dense = dense.to(self.device)
        pooled = pooled.to(self.device)
        probs, t = self._timed(
            ("dense", tuple(dense.shape)),
            lambda: torch.sigmoid(dlrm_lib.dlrm_forward_from_pooled(
                self.dense_params, dense, pooled)))
        return probs.cpu().numpy(), t

    def pull(self, x: torch.Tensor) -> torch.Tensor:
        """Land a tensor on THIS board's device -- the executable face of
        the fabric transfer (remote owners' parts must live on the dense
        owner's device before it can reassemble and compute)."""
        return x.to(self.device)

    def note_service(self, window_s: float, n_queries: int) -> None:
        per_query = window_s / max(n_queries, 1)
        self._svc_ewma = (per_query if self._svc_ewma == 0.0
                          else 0.3 * per_query + 0.7 * self._svc_ewma)

    def retire(self, at: float) -> None:
        """Leave the fleet at virtual time ``at``: the device tensors go,
        the stats stay."""
        self.retired_at = at
        self.release()
        self.dense_params = None

    def stats(self, makespan_s: float) -> Dict[str, float]:
        active = max(makespan_s, 1e-12)
        return {
            "rid": self.rid,
            "served": self.served,
            "batches": len(self.batch_sizes),
            "mean_batch": (float(np.mean(self.batch_sizes))
                           if self.batch_sizes else 0.0),
            "busy_s": self.busy_s,
            "lookup_busy_s": self.lookup_busy_s,
            # occupancy = own flush windows + lookups served for OTHER
            # boards' batches -- without the second term a board that
            # mostly answers remote lookups reads as idle
            "util": min((self.busy_s + self.lookup_busy_s) / active, 1.0),
        }


class ShardedFleet:
    """N boards collectively owning one row-range-partitioned table set;
    peer of `cluster.Cluster` (same event loop, router policies, and
    report surface) for the sharded axis of scale-in. Optionally elastic
    via an `SLAAutoscaler`. See module docstring.

    ``params`` serve given weights: ``{"bot_mlp", "top_mlp", "tables"}``
    with the (T, R, d) tables in host memory (a CPU tensor or numpy
    array, used without a copy). None draws them from ``seed`` as the
    port's stacked session would. ``devices`` is the pool the boards are
    sliced from; None is ``[device]``, and ``device=None`` is the card.
    """

    def __init__(self, cfg: DLRMConfig, *, n_boards: int = 2,
                 devices: Optional[Sequence] = None,
                 devices_per_board: Optional[int] = None,
                 model_axis: int = 1,
                 board_capacity_bytes: Optional[int] = None,
                 link: Optional[Interconnect] = None,
                 cache_rows: Optional[int] = None,
                 cache_enabled: bool = True,
                 cache_window: int = 24,
                 cache_refresh_threshold: float = 0.6,
                 cache_cooldown: int = 24,
                 alpha: float = 0.0, seed: int = 0,
                 profile_batches: int = 4,
                 max_batch_queries: int = 4, max_wait_ms: float = 2.0,
                 query_size: Optional[int] = None,
                 router: Union[str, Router] = "round_robin",
                 autoscaler: Optional[SLAAutoscaler] = None,
                 min_shard_rows: int = 1,
                 service_scales: Optional[Sequence[float]] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 params: Optional[dict] = None,
                 verbose: bool = False, device: DeviceArg = None):
        if n_boards < 1:
            raise ValueError(f"n_boards must be >= 1, got {n_boards}")
        if service_scales is not None and len(service_scales) != n_boards:
            raise ValueError(
                f"service_scales must have one entry per board "
                f"({n_boards}), got {len(service_scales)}")
        self.cfg = cfg
        self.query_size = int(query_size or cfg.batch_size)
        self.verbose = verbose
        self.alpha = float(alpha)
        self.seed = int(seed)
        self.link = link if link is not None else perf_model.fabric_link()
        self.min_shard_rows = int(min_shard_rows)
        self._pool = ([resolve_device(d) for d in devices]
                      if devices is not None else [resolve_device(device)])
        self.device = self._pool[0]
        self._dpb = devices_per_board or max(
            model_axis,
            model_axis * (len(self._pool) // (model_axis * n_boards)))
        # observability: the per-instance registry IS the fleet's tally
        # store (wire bytes, link/service seconds, migration ledger) --
        # FabricReport reads it back after the run; tracer is opt-in
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.attribution = AttributionLog()
        # remesh quiesce windows, for carving remesh_barrier time out of
        # queued queries' waits
        self._barrier_ivals: List[Tuple[float, float]] = []
        # online delta pushes per owner board (update_stall carve) and
        # the online run's tallies
        self._update_ivals: Dict[int, List[Tuple[float, float]]] = {}
        self._online: Optional[Dict[str, object]] = None

        # -- weights: the canonical tables once, in host memory ---------------
        # Fleets built from one `params` share them; an online run's first
        # row update copies them (`_own_tables`), so another fleet's never
        # change.
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params = dict(dlrm_lib.init_mlps(cfg, gen),
                          tables=draw_host_tables(cfg, self.seed,
                                                  self.device))
        tables = torch.as_tensor(params["tables"])
        if tables.device.type != "cpu":
            tables = tables.cpu()
        self._tables_host = tables
        self._params = dict(params, tables=tables)
        self._tables_owned = False
        self.host_copy_s = 0.0       # wall seconds of that copy

        # -- partition: profiled access stats -> row-range ownership ---------
        # the profile on the device warms each board's cache there
        self._row_freq_dev = te.measure_row_freq(
            cfg, alpha, seed, n_batches=profile_batches, device=self.device)
        self.row_freq = self._row_freq_dev.cpu().numpy()
        row_bytes = cfg.embed_dim * tables.element_size()
        table_bytes = [cfg.rows_per_table * row_bytes] * cfg.num_tables
        if board_capacity_bytes is None:
            # tightest sensible default: the fair share + 25% headroom for
            # imbalance (callers proving the too-big-for-one-board claim
            # pass an explicit budget)
            board_capacity_bytes = int(np.ceil(
                1.25 * sum(table_bytes) / n_boards))
        self.partition: ShardMap = partition_rows(
            cfg, self.row_freq, n_boards, board_capacity_bytes, table_bytes,
            min_shard_rows=self.min_shard_rows)
        if verbose:
            print(self.partition.summary())
        self.exchange = FabricExchange(cfg, self.partition, self.link,
                                       metrics=self.metrics)

        # -- boards: the shared params, sliced by ownership -------------------
        self._staging: Dict[torch.device, StagingRing] = {}
        self._board_kw = dict(model_axis=model_axis,
                              max_batch_queries=max_batch_queries,
                              max_wait_ms=max_wait_ms)
        self.boards: List[FabricBoard] = [
            self._new_board(b, *self._residency_of(self.partition, b),
                            service_scale=(service_scales[b]
                                           if service_scales is not None
                                           else 1.0))
            for b in range(n_boards)]

        # -- per-board LFU caches of remote hot rows -------------------------
        self._cache_kw = dict(window=cache_window,
                              refresh_threshold=cache_refresh_threshold,
                              cooldown_queries=cache_cooldown)
        self._cache_rows = cache_rows
        self._cache_enabled_arg = bool(cache_enabled)
        self.caches: List[RemoteRowCache] = [
            self._make_cache(b, self.partition) for b in range(n_boards)]
        self.cache_enabled = bool(cache_enabled) and any(
            c.enabled for c in self.caches)

        self.router: Router = (router if isinstance(router, Router)
                               else make_router(router, seed))
        self.autoscaler = autoscaler
        self.completed: Dict[int, QueryFuture] = {}
        self.scale_events: List[ScaleEvent] = []
        self._retired: List[FabricBoard] = []

    @property
    def n_boards(self) -> int:
        return len(self.boards)

    # -- residency + cache plumbing ------------------------------------------
    def _new_board(self, rid: int, whole: List[int], ranges: RowRanges,
                   service_scale: float = 1.0) -> FabricBoard:
        devs = slice_devices(self._pool, rid, self._dpb)
        dev = resolve_device(devs[0])
        if dev not in self._staging:
            self._staging[dev] = StagingRing(dev, self._tables_host.dtype)
        return FabricBoard(rid, self.cfg, devs, whole, ranges, self._params,
                           self._tables_host, staging=self._staging[dev],
                           service_scale=service_scale, **self._board_kw)

    @staticmethod
    def _residency_of(pm: ShardMap, rid: int
                      ) -> Tuple[List[int], RowRanges]:
        """(whole table ids, split-table row ranges) board `rid` owns."""
        split = set(pm.split_tables)
        whole = [t for t in pm.tables_of(rid) if t not in split]
        ranges: RowRanges = {}
        for t in split:
            rr = [(s.row_lo, s.row_hi) for s in pm.table_shards(t)
                  if s.board == rid]
            if rr:
                ranges[t] = sorted(rr)
        return whole, ranges

    def _make_cache(self, rid: int, pm: ShardMap) -> RemoteRowCache:
        remote = ~pm.owned_mask(rid)
        # default budget: ~10% of the row space the board does NOT own --
        # small next to its owned slice, large next to the Zipf head
        cap = (self._cache_rows if self._cache_rows is not None
               else int(np.ceil(0.1 * int(np.count_nonzero(remote)))))
        cache = RemoteRowCache(self.cfg, remote, capacity_rows=cap,
                               enabled=self._cache_enabled_arg,
                               device=self.boards[rid].device,
                               **self._cache_kw)
        cache.warm(self._row_freq_dev)
        return cache

    # -- elastic re-partitioning ---------------------------------------------
    def _board_seconds(self, now: float) -> float:
        """Boards x live time so far (live boards since spawn + retired
        boards' full spawn->retirement windows) -- the cost axis the
        elastic bench trades against SLA."""
        live = sum(max(now - b.spawned_at, 0.0) for b in self.boards)
        gone = sum(max((b.retired_at or now) - b.spawned_at, 0.0)
                   for b in self._retired)
        return live + gone

    def _apply_map(self, new_map: ShardMap, now: float, action: str,
                   window_p99: float) -> float:
        """Execute the migration from self.partition to new_map on the
        virtual clock: all boards quiesce, rows stream for
        `repartition_time`, residency and caches update (invalidating
        only migrated rows). Returns the migration end time."""
        plan = plan_migration(self.partition, new_map)
        stall = plan.time_s(self.link)
        start = max([now] + [b.free for b in self.boards])
        end = start + stall
        invalidated = 0
        for b in self.boards:
            b.free = max(b.free, end)
            b.busy_s += stall
            if self.tracer is not None and stall > 0:
                self.tracer.span("remesh_barrier", "autoscaler", start, end,
                                 pid=b.rid + 1, tid=0,
                                 args={"action": action,
                                       "bytes_moved": plan.bytes_moved})
        self._barrier_ivals.append((start, end))
        self.partition = new_map
        self.exchange = FabricExchange(self.cfg, new_map, self.link,
                                       metrics=self.metrics)
        # every changed board lets go of its rows before any installs, so
        # the device never holds more than the table set
        moves = [(b, self._residency_of(new_map, b.rid)) for b in self.boards]
        for b, (whole, ranges) in moves:
            if not b.holds(whole, ranges):
                b.release()
        for b, (whole, ranges) in moves:
            b.set_residency(whole, ranges, self._tables_host)
            invalidated += self.caches[b.rid].update_ownership(
                ~new_map.owned_mask(b.rid))
        cost = self._board_seconds(end)
        if self.autoscaler is not None:
            self.autoscaler.record_cost(end, cost)
            self.autoscaler.record_migration(end, plan.bytes_moved, stall)
        self.scale_events.append(ScaleEvent(
            t_s=now, action=action, n_replicas=new_map.n_boards,
            window_p99_ms=window_p99,
            remesh={"moves": len(plan.moves),
                    "rows_moved": plan.rows_moved,
                    "bytes_moved": plan.bytes_moved,
                    "cache_invalidated_rows": invalidated},
            board_seconds=cost))
        self.metrics.counter("migrations", action=action).inc()
        self.metrics.counter("migrated_bytes").inc(plan.bytes_moved)
        self.metrics.counter("migration_s").inc(stall)
        self.metrics.counter("cache_invalidated_rows").inc(invalidated)
        self.metrics.gauge("n_boards").set(new_map.n_boards)
        if self.tracer is not None:
            self.tracer.track(0, 0, process="control", thread="autoscaler")
            self.tracer.instant(f"scale:{action}", "autoscaler", now,
                                args={"n_boards": new_map.n_boards,
                                      "window_p99_ms": window_p99,
                                      "stall_ms": stall * 1e3})
            self.tracer.counter("n_boards", now, {"fleet": new_map.n_boards})
        if self.verbose:
            print(f"[fabric] t={now:.3f}s scale {action.upper()} -> "
                  f"{new_map.n_boards} boards: {plan.summary()[10:]} "
                  f"stall {stall * 1e3:.2f}ms")
        return end

    def _scale_up(self, now: float, window_p99: float) -> None:
        new_map = expand_map(self.partition, self.row_freq,
                             min_shard_rows=self.min_shard_rows)
        rid = len(self.boards)
        board = self._new_board(rid, [], {})
        board.free = board.spawned_at = now
        self.boards.append(board)
        self.caches.append(self._make_cache(rid, new_map))
        self._apply_map(new_map, now, "up", window_p99)

    def _scale_down(self, now: float, window_p99: float) -> None:
        # the victim is ALWAYS the last board (shrink_map retires the
        # highest id so survivors keep their ids and resident rows);
        # drain its queue before its rows leave
        victim = self.boards[-1]
        self._flush(victim, now, reason="drain")
        try:
            new_map = shrink_map(self.partition, self.row_freq,
                                 min_shard_rows=self.min_shard_rows)
        except ValueError:
            return          # survivors can't absorb the rows; stay put
        end = self._apply_map(new_map, max(now, victim.free), "down",
                              window_p99)
        victim.retire(end)
        self.boards.pop()
        self.caches.pop()
        self.router.replica_removed(self.boards)
        self._retired.append(victim)

    def measure_service_time(self, n_queries: int = 1, repeats: int = 3,
                             ) -> float:
        """Median seconds of one capacity-shaped service round on board 0
        (parallel owner lookups/gathers + split pooling + dense forward;
        no link/cache terms) -- the per-batch service floor the launcher
        calibrates offered load from."""
        from repro_torch.data.recsys import make_recsys_batch
        cap = self.boards[0].batcher.capacity
        qs = [make_recsys_batch(self.cfg, s, self.seed, self.alpha,
                                batch_size=self.query_size,
                                device=self.device)
              for s in range(max(1, min(n_queries, cap)))]
        while len(qs) < cap:
            qs.append(qs[0])
        dense = torch.cat([q["dense"] for q in qs], dim=0)
        idx = torch.cat([q["indices"] for q in qs], dim=0)
        times = []
        for _ in range(repeats):
            pooled, owner_s, pool_s = self._owner_parts(self.boards[0], idx)
            _, t_dense = self.boards[0].dense_forward(dense, pooled)
            times.append(max(owner_s.values()) + pool_s + t_dense)
        return float(np.median(times))

    # -- one flushed batch ---------------------------------------------------
    def _owner_parts(self, board: FabricBoard, idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[int, float], float]:
        """Run every owner's share of one capacity-shaped (B, T, L) batch
        and reassemble the (B, T, d) pooled tensor on `board`. Returns
        (pooled, {owner rid: measured seconds}, split-pool seconds on
        `board`). Virtual-clock composition is the caller's job."""
        B, T, L = idx.shape
        d = self.cfg.embed_dim
        owner_s: Dict[int, float] = {}
        parts: List[torch.Tensor] = []
        for o, tids in enumerate(self.exchange.tables_by_board):
            if tids.size == 0:
                continue
            sel = torch.from_numpy(tids.astype(np.int64)).to(idx.device)
            pooled_o, t_o = self.boards[o].lookup(idx.index_select(1, sel))
            parts.append(board.pull(pooled_o))
            owner_s[o] = owner_s.get(o, 0.0) + t_o
        pool_s = 0.0
        split_tids = self.exchange.split_tables
        if split_tids.size:
            fake_rows = []
            for t in split_tids:
                t = int(t)
                # each owner contributes its resident rows, exact zeros
                # elsewhere; x + 0.0 reconstructs every row bit-exactly
                acc: Optional[torch.Tensor] = None
                owners = sorted({s.board for s in
                                 self.partition.table_shards(t)})
                for o in owners:
                    part, t_g = self.boards[o].gather_rows(t, idx[:, t, :])
                    owner_s[o] = owner_s.get(o, 0.0) + t_g
                    part = board.pull(part)
                    acc = part if acc is None else acc + part
                fake_rows.append(acc.reshape(B * L, d))
            fake_tables = torch.stack(fake_rows)         # (T_s, B*L, d)
            fake_idx = (torch.arange(B, dtype=torch.int32)[:, None, None] * L
                        + torch.arange(L, dtype=torch.int32)[None, None, :]
                        ).expand(B, len(split_tids), L)
            pooled_split, pool_s = board.pool_rows(fake_tables, fake_idx)
            parts.append(pooled_split)
        inv = torch.from_numpy(self.exchange.inv_perm.astype(np.int64))
        pooled = torch.cat(parts, dim=1).index_select(1, inv.to(board.device))
        return pooled, owner_s, pool_s

    def _flush(self, board: FabricBoard, trigger: float,
               reason: str = "full") -> List[QueryFuture]:
        futs = board.batcher.drain()
        if not futs:
            return []
        # pad every flush to the CAPACITY shape (replicating query 0, padded
        # outputs discarded): identical executed shapes for every fleet
        # size, so per-row results are bitwise equal to the single-board
        # reference no matter how routing composed the batch
        parts_q = [f.query for f in futs]
        while len(parts_q) < board.batcher.capacity:
            parts_q.append(parts_q[0])
        dense = torch.cat([q["dense"] for q in parts_q], dim=0)
        idx = torch.cat([q["indices"] for q in parts_q], dim=0)
        qs = self.query_size
        idx_np = idx[:len(futs) * qs].cpu().numpy()

        # one hit mask per query, shared between LFU scoring and wire
        # accounting (the election cannot change between the two -- refresh
        # only fires below); padding never reaches the cache or the meter
        cache = self.caches[board.rid]
        idx_per_q = [idx_np[i * qs:(i + 1) * qs] for i in range(len(futs))]
        hits = [cache.hit_mask(q) for q in idx_per_q]
        for q, hm in zip(idx_per_q, hits):   # LFU stats + drift window
            cache.observe(q, trigger, hit=hm)
        traffic = self.exchange.account(board.rid, idx_np, cache,
                                        hit=np.concatenate(hits, axis=0))
        cache.maybe_refresh(trigger)

        # owners bag-reduce / gather their slices (board.rid's own share
        # included); a busy owner queues the request behind its horizon
        start = max(trigger, board.free)
        pooled, owner_s, pool_s = self._owner_parts(board, idx)
        parts_ready = start
        owner_windows: List[Tuple[int, float, float]] = []
        for o, t_o in owner_s.items():
            owner = self.boards[o]
            begin = start if o == board.rid else max(start, owner.free)
            done_o = begin + t_o
            parts_ready = max(parts_ready, done_o)
            owner_windows.append((o, begin, done_o))
            if o != board.rid:
                owner.free = max(owner.free, done_o)
                owner.lookup_busy_s += t_o

        probs, t_dense = board.dense_forward(dense, pooled)
        done = parts_ready + traffic.t_link_s + pool_s + t_dense
        window = done - start
        board.free = done
        board.busy_s += window
        board.served += len(futs)
        board.batch_sizes.append(len(futs))
        board.note_service(window, len(futs))
        self._batch_sizes.append(len(futs))
        self._last_done = max(self._last_done, done)

        # -- observability: attribution + registry tallies + spans ----------
        # compute = parallel owner service (their max) + split pooling +
        # dense forward; the rest of [start, done] is owner-queue coupling
        # (busy owners delayed their slice) and the modeled fabric round
        compute_s = max(owner_s.values()) + pool_s + t_dense
        queue_extra = (parts_ready - start) - max(owner_s.values())
        # the share of the owner-queue coupling caused by a remote owner's
        # online delta push: overlap of the critical owner's queue window
        # [start, begin] with that owner's update_push intervals, capped at
        # queue_extra so the carve keeps the closure exact
        update_extra = 0.0
        if queue_extra > 0 and self._update_ivals and owner_windows:
            crit_o, crit_begin, _ = max(owner_windows, key=lambda w: w[2])
            update_extra = min(
                interval_overlap_s(start, crit_begin,
                                   self._update_ivals.get(crit_o, ())),
                queue_extra)
        self.attribution.record_batch(
            [(f.qid, f.arrival) for f in futs], rid=board.rid,
            trigger=trigger, start=start, done=done, compute_s=compute_s,
            link_stall_s=traffic.t_link_s, queue_extra_s=queue_extra,
            barriers=self._barrier_ivals,
            update_ivals=self._update_ivals.get(board.rid, ()),
            update_extra_s=update_extra)
        self.metrics.counter("service_s").inc(window)
        self.metrics.counter("link_stall_s").inc(traffic.t_link_s)
        self.metrics.counter("queries_served", rid=board.rid).inc(len(futs))
        self.metrics.histogram("flush_service_ms").observe(window * 1e3)
        if self.tracer is not None:
            pid = board.rid + 1
            self.tracer.track(pid, 0, process=f"board{board.rid}",
                              thread="serve")
            self.tracer.track(pid, 1, thread="batching")
            self.tracer.span("batch_fill", "batching", futs[0].arrival,
                             trigger, pid=pid, tid=1,
                             args={"queries": len(futs), "reason": reason})
            self.tracer.instant(f"flush:{reason}", "batching", trigger,
                                pid=pid, tid=1, args={"queries": len(futs)})
            self.tracer.span("serve_batch", "service", start, done,
                             pid=pid, tid=0,
                             args={"queries": len(futs),
                                   "compute_ms": compute_s * 1e3,
                                   "link_ms": traffic.t_link_s * 1e3})
            for o, begin, done_o in owner_windows:
                self.tracer.track(o + 1, 2, thread="fabric")
                self.tracer.span("owner_lookup", "fabric", begin, done_o,
                                 pid=o + 1, tid=2,
                                 args={"for_board": board.rid})
            if traffic.t_link_s > 0:
                self.tracer.track(pid, 2, thread="fabric")
                self.tracer.span(
                    "fabric_link", "fabric", parts_ready,
                    parts_ready + traffic.t_link_s, pid=pid, tid=2,
                    args={"bytes": traffic.bytes_total,
                          "remote_lookups": traffic.remote_lookups,
                          "cache_hits": traffic.cache_hits})

        out = probs.reshape(len(parts_q), qs)[:len(futs)]
        for f, p in zip(futs, out):
            f.complete(p, done)
            # a served query's content is not read again: drop it, so a
            # run holds only its queued queries (the reference keeps it)
            f.query = None
            self.completed[f.qid] = f
            self._lat_ms.append(f.latency_ms)

        if self.autoscaler is not None:
            decision = self.autoscaler.observe(
                [f.latency_ms for f in futs], now=done,
                n_replicas=len(self.boards))
            if decision is not None:
                action, p99 = decision
                if action == "up":
                    self._scale_up(done, p99)
                else:
                    self._scale_down(done, p99)
        return futs

    # -- online delta application (repro_torch.online) -----------------------
    def _own_tables(self) -> None:
        """Copy the host tables on the first write: until then they may be
        shared with the fleets built from the same ``params``."""
        if self._tables_owned:
            return
        t0 = time.perf_counter()
        self._tables_host = self._tables_host.clone()
        self._tables_owned = True
        self.host_copy_s = time.perf_counter() - t0

    def _write_owned_rows(self, d) -> Dict[int, int]:
        """Write one ``RowDelta`` into each owner's resident copy, in place
        on its device: a whole table's rows in the board's stacked tables,
        a split table's in its compact slice, found by a search of the
        slice's sorted row ids. Returns {owner rid: rows written}."""
        vals = torch.from_numpy(d.values).to(self._tables_host.dtype)
        split = set(self.partition.split_tables)
        written: Dict[int, int] = {}
        for s in self.partition.table_shards(d.table):
            lo, hi = np.searchsorted(d.rows, [s.row_lo, s.row_hi])
            if hi <= lo:
                continue
            b = self.boards[s.board]
            rows = torch.from_numpy(d.rows[lo:hi]).to(b.device)
            v = vals[lo:hi].to(b.device)
            if d.table in split:
                row_ids, resident = b.split_rows[d.table]
                resident[torch.searchsorted(row_ids, rows)] = v
            else:
                j = int(np.searchsorted(b.table_ids, d.table))
                b.tables[j, rows] = v
            written[s.board] = written.get(s.board, 0) + int(hi - lo)
        return written

    def _apply_delta(self, batch: DeltaBatch, now: float, mode: str) -> None:
        """Make one ``DeltaBatch`` visible fleet-wide, ATOMICALLY at ``now``
        on the virtual clock: the host tables and every owner's resident
        copy take the rows, and every board's remote-row cache is
        reconciled per the coherence mode -- so after this returns, every
        copy anywhere is bit-equal to the new version or gone. The wire
        cost of the push (payloads in from the trainer + propagation /
        invalidation out to the other boards) then occupies each owner's
        fabric lane, advancing its busy horizon -- queries queued behind
        it read as update_stall in the attribution."""
        from repro_torch.online.coherence import apply_to_remote_cache

        self._own_tables()
        owner_rows: Dict[int, int] = {}
        for d in batch.deltas:
            self._tables_host[d.table, torch.from_numpy(d.rows)] = \
                torch.from_numpy(d.values).to(self._tables_host.dtype)
            for rid, n in self._write_owned_rows(d).items():
                owner_rows[rid] = owner_rows.get(rid, 0) + n

        invalidated = admitted = 0
        for b in self.boards:
            inv, adm = apply_to_remote_cache(self.caches[b.rid], batch,
                                             now=now, mode=mode)
            invalidated += inv
            admitted += adm

        # virtual-clock push pricing per owner: payload in from the
        # training tier, per-peer payloads (propagate) or row ids
        # (invalidate) out to the other boards' caches
        row_bytes = INDEX_BYTES + self.cfg.embed_dim * ELEM_BYTES
        per_peer = row_bytes if mode == "propagate" else INDEX_BYTES
        n_b = len(self.boards)
        total_bytes = 0
        stall_s = 0.0
        visible = now
        for rid, n_rows in sorted(owner_rows.items()):
            owner = self.boards[rid]
            bytes_in = n_rows * row_bytes
            bytes_out = n_rows * per_peer * max(n_b - 1, 0)
            t_push = perf_model.fabric_exchange_time(
                bytes_out, bytes_in, n_b, self.link)
            self.metrics.counter("rows_pushed", rid=rid).inc(n_rows)
            total_bytes += bytes_in + bytes_out
            if t_push <= 0.0:
                # free push (single board: the trainer writes the host
                # copy in place) -- nothing occupies the fabric lane
                continue
            start = max(now, owner.free)
            end = start + t_push
            owner.free = end
            owner.busy_s += t_push
            stall_s += t_push
            visible = max(visible, end)
            self._update_ivals.setdefault(rid, []).append((start, end))
            if self.tracer is not None:
                self.tracer.track(rid + 1, 2, thread="fabric")
                self.tracer.span("update_push", "fabric", start, end,
                                 pid=rid + 1, tid=2,
                                 args={"version": batch.version,
                                       "rows": n_rows, "mode": mode,
                                       "bytes": bytes_in + bytes_out})
        staleness = visible - batch.t_emit_s
        self.metrics.counter("update_batches").inc()
        self.metrics.counter("update_push_bytes").inc(total_bytes)
        self.metrics.counter("update_push_s").inc(stall_s)
        self.metrics.counter("cache_invalidated_rows",
                             cause="update").inc(invalidated)
        self.metrics.counter("rows_propagated").inc(admitted)
        self.metrics.histogram("update_staleness_s").observe(staleness)
        o = self._online
        if o is not None:
            o["n_updates"] += 1
            o["last_version"] = max(o["last_version"], batch.version)
            o["rows_pushed"] += sum(owner_rows.values())
            o["rows_propagated"] += admitted
            o["invalidated"] += invalidated
            o["push_bytes"] += total_bytes
            o["push_stall_s"] += stall_s
            o["staleness_s"].append(staleness)
            if batch.train_loss == batch.train_loss:   # not NaN
                o["losses"].append(batch.train_loss)

    def _online_report(self) -> Optional[OnlineReport]:
        o = self._online
        if o is None:
            return None
        st = np.asarray(o["staleness_s"] or [0.0], np.float64)
        losses = o["losses"]
        return OnlineReport(
            mode=str(o["mode"]), n_updates=int(o["n_updates"]),
            last_version=int(o["last_version"]),
            rows_pushed=int(o["rows_pushed"]),
            rows_propagated=int(o["rows_propagated"]),
            cache_invalidated_rows=int(o["invalidated"]),
            push_bytes=int(o["push_bytes"]),
            push_stall_s=float(o["push_stall_s"]),
            staleness_p50_s=float(np.percentile(st, 50)),
            staleness_max_s=float(st.max()),
            mean_train_loss=(float(np.mean(losses)) if losses
                             else float("nan")))

    # -- event loop ----------------------------------------------------------
    def run(self, events: Sequence[QueryEvent], *, sla_ms: float = 50.0,
            percentile: float = 99.0, scenario: str = "trace",
            online=None, coherence: str = "propagate") -> FabricReport:
        """Serve one event stream to completion on the merged virtual
        clock -- the cluster event loop with two-level routing (and, when
        an autoscaler is wired, live re-partitioning).

        ``online`` streams a delta channel into the run: anything speaking
        ``next_time()`` / ``poll(now)`` (an ``online.OnlineSource``, a
        recorded ``online.DeltaChannel``). Updates are applied at UPDATE
        BARRIERS: when the clock reaches an emit time, every queued query
        (which arrived strictly before it) is flushed against the
        pre-update tables, then the batch lands atomically -- so the table
        version a query sees is a pure function of its arrival time,
        independent of fleet size, routing, and batching. ``coherence``
        picks what other boards' caches do with an updated row
        ("invalidate" drops the copy; "propagate" piggybacks the fresh
        payload)."""
        if not events:
            raise ValueError("fleet run needs at least one event")
        self._lat_ms: List[float] = []
        self._batch_sizes: List[int] = []
        self._last_done = 0.0
        self.completed = {}
        self.scale_events = []
        self._retired = []
        self._barrier_ivals = []
        self._update_ivals = {}
        self._online = None
        if online is not None:
            from repro_torch.online.coherence import check_mode
            check_mode(coherence)
            self._online = dict(mode=coherence, n_updates=0, last_version=0,
                                rows_pushed=0, rows_propagated=0,
                                invalidated=0, push_bytes=0,
                                push_stall_s=0.0, staleness_s=[], losses=[])
        self.metrics.reset()
        self.attribution = AttributionLog()
        self.metrics.gauge("n_boards").set(len(self.boards))
        n_start = len(self.boards)
        i = 0
        while i < len(events) or any(b.batcher.queue for b in self.boards):
            next_arr = events[i].arrival_s if i < len(events) else float("inf")
            due = min(self.boards, key=lambda b: b.deadline())
            t_upd = online.next_time() if online is not None else None
            if t_upd is not None and t_upd <= min(next_arr, due.deadline()):
                # UPDATE BARRIER (updates win ties): every queued query
                # arrived before this emit time and serves the pre-update
                # tables; flush them all, then apply atomically
                for b in list(self.boards):
                    if b.batcher.queue:
                        self._flush(b, t_upd, reason="update")
                for batch in online.poll(t_upd):
                    self._apply_delta(batch, t_upd, coherence)
                continue
            # deadline wins ties, matching MicroBatcher.due (now >= deadline)
            if next_arr < due.deadline():
                ev = events[i]
                i += 1
                query = materialize_query(self.cfg, ev, self.query_size,
                                          device=self.device)
                fut = QueryFuture(ev.qid, ev.arrival_s, query)
                board = self.router.pick(self.boards, ev.arrival_s)
                full = board.enqueue(fut)
                self.metrics.gauge("queue_depth", rid=board.rid).set(
                    len(board.batcher.queue))
                if full:
                    self._flush(board, ev.arrival_s, reason="full")
            else:
                self._flush(due, due.deadline(), reason="deadline")

        lat = np.asarray(self._lat_ms, np.float64)
        p50, p90, p99 = (float(np.percentile(lat, p)) for p in (50, 90, 99))
        ppf = float(np.percentile(lat, percentile))
        makespan = max(self._last_done, 1e-12)
        offered = len(events) / max(events[-1].arrival_s, 1e-12)
        # the run's tallies live in the metrics registry (the exchange and
        # _flush published them there); the report reads them back
        remote_lookups = int(self.metrics.total("remote_lookups"))
        service_s = self.metrics.value("service_s")
        link_s = self.metrics.value("link_stall_s")
        total_lookups = (len(events) * self.query_size
                         * self.cfg.num_tables * self.cfg.lookups_per_table)
        # only ENABLED caches report a hit trajectory: a cache-off run must
        # show None, not a 0.0 indistinguishable from a stone-cold cache
        hist = sorted((h for c in self.caches if c.enabled
                       for h in c.history), key=lambda th: th[0])
        hit_first = hit_last = None
        if hist:
            hs = [h for _, h in hist]
            k = min(len(hs), 16)
            hit_first = float(np.mean(hs[:k]))
            hit_last = float(np.mean(hs[-k:]))
        return FabricReport(
            scenario=scenario, router=self.router.name,
            n_queries=len(events), n_replicas_start=n_start,
            n_replicas_end=len(self.boards), offered_qps=offered,
            achieved_qps=len(events) / makespan,
            p50_ms=p50, p90_ms=p90, p99_ms=p99, percentile=percentile,
            ppf_ms=ppf, sla_ms=sla_ms, ok=ppf <= sla_ms,
            mean_batch_queries=(float(np.mean(self._batch_sizes))
                                if self._batch_sizes else 0.0),
            makespan_s=makespan,
            replicas=tuple(b.stats(makespan)
                           for b in self.boards + self._retired),
            predicted_qps=None,
            board_seconds=self._board_seconds(makespan),
            sla_violations=int((lat > sla_ms).sum()),
            n_boards=len(self.boards),
            board_capacity_bytes=self.partition.board_capacity_bytes,
            model_bytes=self.partition.total_bytes,
            fits_one_board=(self.partition.total_bytes
                            <= self.partition.board_capacity_bytes),
            cache_rows=max((c.capacity_rows for c in self.caches
                            if c.enabled), default=0),
            bytes_per_query=self.metrics.total("wire_bytes") / len(events),
            remote_lookup_fraction=remote_lookups / max(total_lookups, 1),
            remote_hit_first=hit_first, remote_hit_last=hit_last,
            link_stall_share=(link_s / service_s if service_s > 0 else 0.0),
            cache_refreshes=sum(len(c.refreshes) for c in self.caches),
            scale_events=tuple(self.scale_events),
            migrations=len(self.scale_events),
            migrated_bytes=int(self.metrics.value("migrated_bytes")),
            migration_s=self.metrics.value("migration_s"),
            cache_invalidated_rows=int(
                self.metrics.value("cache_invalidated_rows")),
            blame=self.attribution.blame(percentile),
            online=self._online_report())
