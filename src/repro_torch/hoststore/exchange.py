"""HostTieredExchange: the three-tier memory hierarchy behind the
standard ``EmbeddingExchange`` interface, as the reference's
``repro.hoststore.exchange``.

  HBM hot slab   params["hs_hot"]   (T, S+1, d)  -- top-S freq-elected rows
                                                    per table + a zeros
                                                    miss slot.
  device cache   params["hs_cache"] (C*K + 1, d) -- ChunkParamMgr's chunk
                                                    cache + a zeros pad row.
  host chunks    mgr.host           (T, R, d)    -- the CANONICAL weights,
                                                    a CPU tensor.

Lookup maps     params["hs_hot_map"] (T, R) row -> hot slot or -1
                params["hs_pos"]     (T, R) row -> flat cache pos or pad

Every lookup resolves to exactly one real row: hot rows gather their slab
slot (the cache side reads the zeros pad), cold rows their cache position
(the slab side reads the zeros miss slot), and the two gathers sum.
Structured like ``dlrm.embedding_bag``'s gather-then-``sum(dim=2)``, the
pooled output is BIT-IDENTICAL to the all-in-device path on the same
device (``pool_mode="paired"``, plain torch). ``pool_mode="cached_bag"``
pools through the cached-bag kernel (``ops.cached_embedding_bag``, one
launch a micro-batch on the card) and agrees to fp32 tolerance.

The slab, cache and maps live on the session's device and are updated IN
PLACE (the reference returns new arrays): the sparse update scatters into
them, and ``end_batch`` only keeps the bookkeeping. The session hooks
(``begin_batch``/``end_batch``, no-ops on every other exchange) fault
chunks in ahead of the step.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.core import perf_model
from repro_torch.core.tiered_embedding import measure_row_freq
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.kernels import ops
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.parallel.exchange import EmbeddingExchange, Tables

from .chunks import ChunkParamMgr, StagingRing, copy_to_host
from .swap import SwapPlan, overlap_stall, plan_swaps


class HostTieredExchange(EmbeddingExchange):
    """Embedding exchange whose cold tier pages in from host memory.

    Single-board only (n == 1). The slab, cache and maps live on the
    manager's device."""

    table_keys = ("hs_hot", "hs_cache", "hs_hot_map", "hs_pos")
    holds_tables = True

    def __init__(self, cfg: DLRMConfig, n: int = 1, *,
                 mgr: ChunkParamMgr, hot_rows: np.ndarray,
                 link: Optional["perf_model.Interconnect"] = None,
                 pool_mode: str = "paired",
                 metrics: Optional[MetricsRegistry] = None):
        if n != 1:
            raise ValueError(
                f"HostTieredExchange is single-board (n=1), got n={n}; "
                f"scale out by sharding boards, each with its own host tier")
        super().__init__(cfg, n)
        if pool_mode not in ("paired", "cached_bag"):
            raise ValueError(f"unknown pool_mode {pool_mode!r}")
        if mgr.T != cfg.num_tables or mgr.R != cfg.rows_per_table \
                or mgr.d != cfg.embed_dim:
            raise ValueError(
                f"ChunkParamMgr shape ({mgr.T}, {mgr.R}, {mgr.d}) != cfg "
                f"({cfg.num_tables}, {cfg.rows_per_table}, {cfg.embed_dim})")
        self.mgr = mgr
        self.device = mgr.device
        self.link = link if link is not None else perf_model.host_link()
        self.pool_mode = pool_mode
        # the exchange lives inside an Engine, not a fleet -- it publishes
        # to the process-wide registry unless a caller scopes it
        self.metrics = metrics if metrics is not None else default_registry()

        hot_rows = np.asarray(hot_rows, np.int64)
        if hot_rows.ndim != 2 or hot_rows.shape[0] != cfg.num_tables:
            raise ValueError(f"hot_rows must be (T, S), got {hot_rows.shape}")
        self.hot_slots = int(hot_rows.shape[1])
        self._hot_rows = hot_rows                      # (T, S) global row ids
        hot_map = np.full((mgr.T, mgr.R), -1, np.int32)
        hot_map[np.arange(mgr.T)[:, None], hot_rows] = np.arange(
            self.hot_slots, dtype=np.int32)
        self._hot_map_np = hot_map
        # the hot slab: elected rows + a zeros miss slot at index S, built
        # on the device from the host store (the live slab: training
        # updates it in place)
        self.hot_slab = torch.zeros((mgr.T, self.hot_slots + 1, mgr.d),
                                    dtype=mgr.host.dtype, device=self.device)
        for t in range(mgr.T):
            mgr.rows_to_device(t * mgr.R + hot_rows[t],
                               self.hot_slab[t, :self.hot_slots])
        self._hot_map = torch.from_numpy(hot_map).to(self.device)
        self._last_plan: Optional[SwapPlan] = None

    def summary(self) -> str:
        """One line of the tier's sizing and the link that prices it."""
        return (f"host tier: {self.hot_slots} hot rows a table, "
                f"chunk_rows {self.mgr.chunk_rows}, {self.mgr.cache_slots} "
                f"cache slots, pool_mode {self.pool_mode}, link "
                f"{self.link.bandwidth / 1e9:.2f} GB/s + "
                f"{self.link.latency * 1e6:.2f} us a transfer")

    # -- layout --------------------------------------------------------------
    def expand_grads(self, tables, ctx, g_pooled):
        raise NotImplementedError(
            "HostTieredExchange applies updates in place (sparse_apply); "
            "flat grad expansion is only needed by stateful optimizers, "
            "which the host tier does not support (host-tier training is "
            "SGD-only)")

    # -- session hooks -------------------------------------------------------
    def init_session_params(self, params: Tables) -> Tables:
        """Replace the dense (T, R, d) "tables" param with the three-tier
        layout. The full weights stay in the manager's host store; only
        the hot slab, chunk cache and int maps are on the device."""
        return {"bot_mlp": params["bot_mlp"], "top_mlp": params["top_mlp"],
                "hs_hot": self.hot_slab, "hs_cache": self.mgr.device_cache,
                "hs_hot_map": self._hot_map, "hs_pos": self.mgr.device_pos}

    def begin_batch(self, params: Tables, indices, depth: int,
                    train: bool = False) -> Tuple[Tables, SwapPlan]:
        """Fault the step's cold rows in, micro-batch by micro-batch, into
        the cache and indirection tensors the params hold."""
        idx = (indices.cpu().numpy() if torch.is_tensor(indices)
               else np.asarray(indices))
        t_of = np.broadcast_to(
            np.arange(idx.shape[1])[None, :, None], idx.shape)
        cold = self._hot_map_np[t_of, idx] < 0
        plan = plan_swaps(self.mgr, idx, depth, self.link, cold_mask=cold)
        if train and cold.any():
            # the step's scatter-add will touch every cold row's cached
            # chunk -- mark them dirty so eviction/flush writes them back
            self.mgr.mark_dirty(t_of[cold], idx[cold])
        self._last_plan = plan
        self.metrics.counter("swap_faults", policy=self.mgr.policy).inc(
            plan.faulted_chunks)
        self.metrics.counter("swap_bytes").inc(plan.bytes_moved)
        return params, plan

    def stall_seconds(self, plan: Optional[SwapPlan],
                      service_s: float) -> float:
        if plan is None:
            return 0.0
        stall = overlap_stall(plan.swap_s, service_s, plan.depth)
        self.metrics.counter("swap_stall_s").inc(stall)
        return stall

    def end_batch(self, params: Tables) -> Tables:
        """Keep the bookkeeping on the step's tensors (the port's step
        updates them in place, so they are the manager's own)."""
        self.mgr.attach_cache(params["hs_cache"])
        self.mgr.device_pos = params["hs_pos"]
        self.hot_slab = params["hs_hot"]
        return params

    # -- Alg. 1 / Alg. 2 -----------------------------------------------------
    def forward(self, tables: Tables, indices: torch.Tensor):
        fast = tables["hs_hot"]                       # (T, S+1, d)
        cache = tables["hs_cache"]                    # (C*K+1, d)
        S = fast.shape[1] - 1
        pad = cache.shape[0] - 1
        idx = indices.long()
        t = torch.arange(idx.shape[1], device=idx.device)[None, :, None]
        slot = tables["hs_hot_map"][t, idx]           # (B, T, L)
        hot = slot >= 0
        fast_idx = torch.where(hot, slot, S).to(torch.int32)
        pos = torch.where(hot, pad, tables["hs_pos"][t, idx]).to(torch.int32)
        if self.pool_mode == "cached_bag":
            pooled = self._cached_bag_pool(fast, cache, fast_idx, pos)
        else:
            # per-table paired gather + sum, the structure of
            # dlrm.embedding_bag (each side of the add reads a zeros row
            # when the other tier owns the lookup): bit-identical to the
            # all-in-device path
            rows = fast[t, fast_idx.long()] + cache[pos.long()]
            pooled = rows.sum(dim=2)                  # (B, T, d)
        return pooled, (fast_idx, pos)

    def _cached_bag_pool(self, fast, cache, fast_idx, pos):
        """Pool through the cached-bag kernel, its bulk tier the flat
        chunk cache read in place at ``pos``: the sum the reference takes
        over its fake (T, B*L, d) slab of ``cache[pos]``, without building
        it. Accumulation order differs from the paired path, so this mode
        is allclose-equal, not bit-equal."""
        return ops.cached_embedding_bag(fast, cache, fast_idx, pos)

    def sparse_apply(self, tables: Tables, ctx, g_pooled, update_fn):
        """Split SGD scatter-add, in place: hot rows into the slab, cold
        rows into the flat chunk cache. Each side's "other tier" rows land
        on its zeros pad, which is re-zeroed after the update -- the
        combined effect is bit-identical to the per-table scatter (each
        real row receives exactly its batch's grads, in the same b-major
        order as ``table_wise_expand_grads``)."""
        fast_idx, pos = ctx                           # (B, T, L) each
        b, t, l = fast_idx.shape
        d = g_pooled.shape[-1]
        fi = fast_idx.transpose(0, 1).reshape(t, b * l)
        g_t = g_pooled.transpose(0, 1)[:, :, None, :].expand(
            t, b, l, d).reshape(t, b * l, d)
        with torch.no_grad():
            update_fn(tables["hs_hot"], fi, g_t)
            tables["hs_hot"][:, -1] = 0.0             # re-zero the miss slot
            update_fn(tables["hs_cache"][None],
                      pos.transpose(0, 1).reshape(1, t * b * l),
                      g_t.reshape(1, t * b * l, d))
            tables["hs_cache"][-1] = 0.0              # re-zero the pad row
        return tables

    # -- host round-trip -----------------------------------------------------
    def flush_host_weights(self) -> torch.Tensor:
        """Full (T, R, d) weights with every training update folded in, a
        copy on the host: dirty chunks written back first, then the hot
        slab overwrites its rows (the slab is canonical for hot rows --
        their chunk copies are stale by design, since forward/backward
        never touch them)."""
        host = self.mgr.flush()
        if self.hot_slots:
            slab = self.hot_slab[:, :self.hot_slots].cpu()
            for tt in range(self.mgr.T):
                host[tt, torch.from_numpy(self._hot_rows[tt])] = slab[tt]
        return host


def draw_host_tables(cfg: DLRMConfig, seed: int = 0,
                     device: DeviceArg = None) -> torch.Tensor:
    """The tables ``dlrm.init_dlrm`` draws from ``seed`` on ``device``
    (None: the card), as one (T, R, d) CPU tensor: each table is drawn on
    the device in turn and copied to host memory, so no (T, R, d) tensor
    is ever built on the device. Bitwise the stacked session's tables."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dlrm_lib.init_mlps(cfg, gen)          # the MLPs come first in the stream
    host = torch.empty((cfg.num_tables, cfg.rows_per_table, cfg.embed_dim))
    if dev.type == "cpu":
        for t in range(cfg.num_tables):
            dlrm_lib.draw_table(host[t], cfg, gen)
        return host
    table = torch.empty((cfg.rows_per_table, cfg.embed_dim), device=dev)
    ring = StagingRing(dev, host.dtype)
    for t in range(cfg.num_tables):
        copy_to_host(host[t], dlrm_lib.draw_table(table, cfg, gen), ring)
    return host


def build_host_exchange(
    cfg: DLRMConfig, *,
    device_capacity_bytes: int,
    alpha: float = 0.0,
    seed: int = 0,
    tables: Optional[Any] = None,
    chunk_rows: Optional[int] = None,
    cache_slots: Optional[int] = None,
    hot_fraction: float = 0.5,
    link: Optional["perf_model.Interconnect"] = None,
    policy: str = "clock",
    pool_mode: str = "paired",
    profile_batches: int = 8,
    metrics: Optional[MetricsRegistry] = None,
    device: DeviceArg = None,
) -> HostTieredExchange:
    """Size + build the host tier for a device-memory budget, on
    ``device`` (None: the card).

    The budget splits ``hot_fraction`` to the HBM hot slab (top rows per
    table by measured frequency -- deterministic in (cfg, alpha, seed),
    the same profile serving will see) and the rest to the device chunk
    cache. ``chunk_rows`` defaults to the perf model's pick
    (``perf_model.choose_hoststore_config``) over the ``link``.

    ``tables`` None draws the seed's tables into host memory
    (``draw_host_tables``) and hands them to the manager without a copy;
    given tables are copied, as the reference copies them.
    """
    if device_capacity_bytes <= 0:
        raise ValueError(
            f"device_capacity_bytes must be > 0, got {device_capacity_bytes}")
    if not 0.0 <= hot_fraction < 1.0:
        raise ValueError(f"hot_fraction must be in [0, 1), got {hot_fraction}")
    dev = resolve_device(device)
    copy = tables is not None
    if tables is None:
        tables = draw_host_tables(cfg, seed, dev)
    t_n, r_n, d = tables.shape
    row_bytes = d * (tables.element_size() if torch.is_tensor(tables)
                     else np.asarray(tables).dtype.itemsize)
    link = link if link is not None else perf_model.host_link()

    hot_budget = int(hot_fraction * device_capacity_bytes)
    hot_per_table = min(r_n, hot_budget // max(1, t_n * row_bytes))
    freq = measure_row_freq(cfg, alpha=alpha, seed=seed,
                            n_batches=profile_batches, device=dev)
    # each table's rows by descending count, ties by row id: the
    # reference's stable argsort on -freq, sorted where the counts lie
    hot_rows = torch.sort(-freq.long(), dim=1, stable=True).indices[
        :, :hot_per_table].cpu().numpy()
    del freq

    cache_budget = device_capacity_bytes - hot_per_table * t_n * row_bytes
    if chunk_rows is None:
        chunk_rows, _ = perf_model.choose_hoststore_config(
            cfg, link, cache_budget)
    chunk_rows = max(1, min(int(chunk_rows), r_n))
    if cache_slots is None:
        cache_slots = max(1, cache_budget // (chunk_rows * row_bytes))
    mgr = ChunkParamMgr(tables, chunk_rows, int(cache_slots), policy=policy,
                        device=dev, copy=copy)
    return HostTieredExchange(cfg, 1, mgr=mgr, hot_rows=hot_rows, link=link,
                              pool_mode=pool_mode, metrics=metrics)
