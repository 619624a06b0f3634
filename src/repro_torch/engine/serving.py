"""ServeSession: the engine's request path for batched DLRM inference.

Wraps the serve step (``repro_torch.parallel.build_step``) behind a
dynamic micro-batcher: callers ``submit()`` fixed-size queries, and
micro-batches flush when full or when the oldest query hits its deadline.
Two drivers measure the latency distribution D_Q against the paper's SLA
model (Eq. 1, PPF(D_Q, P) <= C_SLA):

  * ``run_serial(n)``: closed loop, one query at a time; isolates the
    per-query service time.
  * ``run_open_loop(n, qps)``: Poisson arrivals at a target QPS on a
    virtual clock. Service times are real device executions, timed to
    the end of the device's work; queueing and batching delays are
    simulated event by event, without sleeping.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.core.planner import ShardingPlan
from repro_torch.data.recsys import make_recsys_batch
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.engine.batching import (MicroBatcher, QueryFuture, now_s,
                                         poisson_arrivals)
from repro_torch.obs.attribution import AttributionLog, BlameReport
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.serialize import report_asdict, report_to_json
from repro_torch.obs.trace import Tracer
from repro_torch.parallel import primitives as prim
from repro_torch.parallel.build import (AXIS, build_step, init_local_dlrm,
                                        shard_dlrm_params)
from repro_torch.parallel.exchange import EmbeddingExchange, make_exchange
from repro_torch.parallel.plan import plan_table_groups

Query = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class SLAReport:
    """Latency distribution + SLA verdict for one serving run."""

    n_queries: int
    mode: str                  # "serial" | "open_loop"
    offered_qps: Optional[float]
    achieved_qps: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    percentile: float
    ppf_ms: float              # PPF(D_Q, percentile)
    sla_ms: float              # C_SLA
    ok: bool
    mean_batch_queries: float  # avg queries per flushed micro-batch
    blame: Optional[BlameReport] = None  # tail-latency attribution

    def summary(self) -> str:
        offered = ("" if self.offered_qps is None
                   else f" offered={self.offered_qps:.1f}qps")
        text = (
            f"[serve] {self.mode}: {self.n_queries} queries,{offered} "
            f"QPS={self.achieved_qps:.1f} mean_batch="
            f"{self.mean_batch_queries:.2f} p50={self.p50_ms:.2f}ms "
            f"p90={self.p90_ms:.2f}ms p99={self.p99_ms:.2f}ms\n"
            f"[serve] SLA check PPF(D_Q, {self.percentile:.0f}) = "
            f"{self.ppf_ms:.2f}ms {'<=' if self.ok else '>'} "
            f"C_SLA={self.sla_ms}ms -> {'PASS' if self.ok else 'FAIL'}")
        if self.blame is not None:
            text += "\n" + self.blame.summary()
        return text

    def asdict(self) -> dict:
        return report_asdict(self)

    def to_json(self, path: Optional[str] = None) -> str:
        return report_to_json(self, path)


def _report(lat_ms: Sequence[float], batch_sizes: Sequence[int], mode: str,
            offered_qps: Optional[float], achieved_qps: float,
            sla_ms: float, percentile: float,
            blame: Optional[BlameReport] = None) -> SLAReport:
    lat = np.asarray(lat_ms, np.float64)
    p50, p90, p99 = (float(np.percentile(lat, p)) for p in (50, 90, 99))
    ppf = float(np.percentile(lat, percentile))
    return SLAReport(
        n_queries=len(lat), mode=mode, offered_qps=offered_qps,
        achieved_qps=achieved_qps, p50_ms=p50, p90_ms=p90, p99_ms=p99,
        percentile=percentile, ppf_ms=ppf, sla_ms=sla_ms, ok=ppf <= sla_ms,
        mean_batch_queries=float(np.mean(batch_sizes)) if batch_sizes else 0.0,
        blame=blame)


class ServeSession:
    """One served model instance: params + step + batcher, on one rank or
    on every rank of ``mesh``.

    Built by ``Engine.serve_session()``. Queries are fixed-size
    (``query_size`` samples each, the paper's "query of size B", Sec.
    III-B); the micro-batcher packs up to ``max_batch_queries`` of them
    into one device execution. ``params`` must lie on the session's
    device; the default is a fresh init from ``seed`` drawn on that
    device. Under a placed ``plan`` stacked params are split into the
    plan's table groups (a copy of the tables); plan-split params are used
    as given when their groups match the plan's. Other params are used
    without a copy.

    ``pipeline_depth``: an int pins every batch shape to that depth; None
    resolves the depth PER BATCH SHAPE through ``depth_resolver`` (the
    planner's executed-schedule sweep at the flushed sample count, which
    ``Engine`` wires), falling back to 1.

    ``exchange``: an ``EmbeddingExchange`` instance to serve through (the
    ``Engine`` passes its host tier); None makes the plan's tiered
    exchange or the config's own layout, a row-wise one in the wire mode
    ``row_wise_exchange`` names ("partial_pool" or "unpooled"), through
    ``make_exchange``. Its session hooks bracket every
    execution: ``begin_batch`` faults the batch's cold chunks in before
    the step, and its modeled swap stall is added to the measured service
    time. An exchange that holds the tables itself takes only the MLPs of
    ``params`` (a fresh init draws no tables).

    ``mesh`` (``launch.mesh.Mesh``; None: one device), ``axis`` and
    ``dp_axes``: every rank of the mesh builds the same session and runs
    the same loop over the same queries; the step serves each rank's
    slice of a flush and gathers the probs. A rank draws only its shards
    of the init (``init_local_dlrm``) and takes its shards of given
    stacked params. A flush's service time is the slowest rank's.
    """

    def __init__(self, cfg: DLRMConfig, *, device: DeviceArg = None,
                 plan: Optional[ShardingPlan] = None,
                 max_batch_queries: int = 8,
                 max_wait_ms: float = 2.0,
                 query_size: Optional[int] = None,
                 params=None, seed: int = 0, alpha: float = 0.0,
                 warmup: bool = False,
                 pipeline_depth: Optional[int] = 1,
                 depth_resolver: Optional[Callable[[int], int]] = None,
                 fused: bool = True,
                 exchange: Optional[EmbeddingExchange] = None,
                 row_wise_exchange: str = "partial_pool",
                 mesh=None, axis=AXIS, dp_axes: Tuple[str, ...] = ()):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = plan
        self.seed = seed
        self.alpha = alpha
        self.query_size = int(query_size or cfg.batch_size)
        self.max_batch_queries = int(max_batch_queries)
        self.pipeline_depth = (None if pipeline_depth is None
                               else int(pipeline_depth))
        self._depth_resolver = depth_resolver
        if self.pipeline_depth is not None and self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got "
                             f"{pipeline_depth}")
        if self.max_batch_queries < 1:
            raise ValueError("max_batch_queries must be >= 1")
        self.mesh = mesh
        self._axis, self.dp_axes = axis, tuple(dp_axes)
        full = self.dp_axes + ((axis,) if isinstance(axis, str)
                               else tuple(axis))
        self._n = 1 if mesh is None else mesh.size(full)
        n_embed = 1 if mesh is None else mesh.size(axis)
        self._world_group = None if mesh is None else mesh.group(
            mesh.axis_names)
        fixed = self.pipeline_depth or 1
        if (self.max_batch_queries * self.query_size) % (self._n * fixed):
            raise ValueError(
                f"capacity batch {self.max_batch_queries}x{self.query_size} "
                f"samples must divide into {self._n} ranks x "
                f"pipeline_depth={fixed} micro-batches")
        self._exch = (exchange if exchange is not None else
                      make_exchange(cfg, n_embed, plan=plan,
                                    row_wise_exchange=row_wise_exchange,
                                    device=self.device,
                                    group=None if mesh is None
                                    else mesh.group(axis)))
        self._fused = bool(fused)
        self.serve_kernel = ("fused" if self._fused
                             and self._exch.supports_fused_forward()
                             else "composed")
        self._steps: Dict[int, Callable] = {}
        self._depth_by_samples: Dict[int, int] = {}
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = (dlrm_lib.init_mlps(cfg, gen) if self._exch.holds_tables
                      else init_local_dlrm(cfg, gen, self._exch))
        elif not self._exch.holds_tables:
            self._check_params(params)
        prepared = self._exch.init_session_params(params)
        self.params = (prepared if prepared is not None
                       else shard_dlrm_params(params, plan, self._exch))
        self.batcher = MicroBatcher(self.max_batch_queries, max_wait_ms / 1e3)
        self._qid = 0
        self._warm = False
        # The first execution builds and loads the kernel and initialises
        # the device libraries. The measurement drivers pay it untimed on
        # first use; warmup=True pays it here, for the real-time submit path.
        if warmup:
            self._ensure_warm()

    @property
    def exchange(self) -> EmbeddingExchange:
        """The exchange the session serves through."""
        return self._exch

    def _check_params(self, params) -> None:
        keys = ("tables",) if "tables" in params else ("tables_fast",
                                                       "tables_bulk")
        for k in keys:
            if params[k].device != self.device:
                raise ValueError(f"params lie on {params[k].device}, the "
                                 f"session on {self.device}")
        if "tables" in params or self._exch.n > 1:
            return
        # plan-split params: only accepted when the split matches THIS
        # session's plan groups, otherwise tables would land in the wrong
        # tier.
        if self.plan is None or not self.plan.placements:
            raise ValueError(
                "params have no 'tables' (plan-split) but this session "
                "has no placed plan; pass stacked params")
        groups = plan_table_groups(self.plan, 1)
        got = (params["tables_fast"].shape[0], params["tables_bulk"].shape[0])
        want = (len(groups.fast_ids), len(groups.bulk_ids))
        if got != want:
            raise ValueError(
                f"plan-split params (fast,bulk)={got} do not match this "
                f"session's plan groups {want}; re-stack them with "
                f"merge_dlrm_params_by_plan under their own plan first")

    # -- shapes ------------------------------------------------------------
    def _padded_count(self, n_queries: int) -> int:
        """Smallest query count >= n_queries whose sample total divides
        into the ranks x a pinned pipeline depth (exists because the
        capacity batch does). A planner-resolved depth is clamped to the
        per-rank batch instead."""
        if n_queries > self.max_batch_queries:
            raise ValueError(
                f"{n_queries} queries exceed the micro-batch capacity "
                f"({self.max_batch_queries})")
        k = n_queries
        while (k * self.query_size) % (self._n * (self.pipeline_depth or 1)):
            k += 1
        return k

    def depth_for_samples(self, batch_samples: int) -> int:
        """The pipeline depth the step for this batch shape executes: the
        fixed session depth, or (pipeline_depth=None) the per-shape planner
        choice via ``depth_resolver``, clamped to the largest feasible
        depth dividing the per-rank batch. Cached per shape, off the hot
        path."""
        if self.pipeline_depth is not None:
            return self.pipeline_depth
        b = int(batch_samples)
        if b not in self._depth_by_samples:
            local = max(1, b // self._n)
            depth = (self._depth_resolver(b)
                     if self._depth_resolver is not None else 1)
            depth = max(1, min(int(depth), local))
            while depth > 1 and local % depth:
                depth -= 1
            self._depth_by_samples[b] = depth
        return self._depth_by_samples[b]

    def _step_for(self, batch_samples: int) -> Callable:
        depth = self.depth_for_samples(batch_samples)
        if depth not in self._steps:
            self._steps[depth] = build_step(
                self.cfg, self.mesh, mode="serve", axis=self._axis,
                dp_axes=self.dp_axes, exchange=self._exch,
                pipeline_depth=depth, fused=self._fused)
        return self._steps[depth]

    def _ensure_warm(self) -> None:
        if self._warm:
            return
        b = self.query_size * self.max_batch_queries
        dense = torch.zeros((b, self.cfg.num_dense), device=self.device)
        idx = torch.zeros((b, self.cfg.num_tables,
                           self.cfg.lookups_per_table), dtype=torch.int32,
                          device=self.device)
        self._step_for(b)(self.params, dense, idx)
        self._sync()
        self._warm = True

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- execution ---------------------------------------------------------
    def serve_direct(self, dense: torch.Tensor,
                     indices: torch.Tensor) -> np.ndarray:
        """Run the serve step on one exact batch (no batching or padding),
        after the exchange's ``begin_batch`` (the host tier faults the
        batch's chunks in)."""
        b = dense.shape[0]
        idx = indices.to(self.device, torch.int32)
        self.params, _ = self._exch.begin_batch(self.params, idx,
                                                self.depth_for_samples(b))
        probs = self._step_for(b)(
            self.params, dense.to(self.device, torch.float32), idx)
        return probs.cpu().numpy()

    def _execute(self, queries: List[Query]
                 ) -> Tuple[np.ndarray, float, float]:
        """Concatenate + pad queries, run the step, split results back.

        Returns (probs (n_queries, query_size), service_seconds,
        swap_stall_seconds). The service time runs from the step's launch
        to the end of the device's work, plus the exchange's modeled swap
        stall (the batch's full occupancy of the executor); the stall is
        also returned on its own, so attribution can split compute from
        exposed host-tier swap time. The exchange's ``begin_batch`` faults
        the batch's chunks in before the clock starts. Padding replicates
        query 0; padded outputs are discarded."""
        k = self._padded_count(len(queries))
        self._ensure_warm()
        parts = list(queries) + [queries[0]] * (k - len(queries))
        dense = torch.cat([p["dense"] for p in parts]).to(self.device,
                                                         torch.float32)
        idx = torch.cat([p["indices"] for p in parts]).to(self.device,
                                                         torch.int32)
        step = self._step_for(k * self.query_size)
        self.params, plan = self._exch.begin_batch(
            self.params, idx, self.depth_for_samples(k * self.query_size))
        self._sync()
        t0 = time.perf_counter()
        probs = step(self.params, dense, idx)
        self._sync()
        service = time.perf_counter() - t0
        if self._world_group is not None:
            # the flush ends when its slowest rank does
            service = float(prim.pmax(torch.tensor(
                [service], dtype=torch.float64), self._world_group))
        # the modeled swap stall composes with the MEASURED compute time
        stall = self._exch.stall_seconds(plan, service)
        out = probs.cpu().numpy().reshape(k, self.query_size)
        return out[:len(queries)], service + stall, stall

    # -- request path ------------------------------------------------------
    def validate_query(self, query: Query) -> None:
        """Shape/dtype-check a query against the session's config before
        it reaches the device, so a malformed query fails with a clear
        ValueError at submit time. Metadata only: no device sync."""
        for field in ("dense", "indices"):
            if field not in query:
                raise ValueError(f"query is missing the {field!r} field")
            if not torch.is_tensor(query[field]):
                raise ValueError(f"query {field!r} must be a torch.Tensor, "
                                 f"got {type(query[field]).__name__}")
        dense, idx = query["dense"], query["indices"]
        q = self.query_size
        want_dense = (q, self.cfg.num_dense)
        if tuple(dense.shape) != want_dense:
            raise ValueError(
                f"query 'dense' must have shape {want_dense} "
                f"(query_size x cfg.num_dense), got {tuple(dense.shape)}")
        want_idx = (q, self.cfg.num_tables, self.cfg.lookups_per_table)
        if tuple(idx.shape) != want_idx:
            raise ValueError(
                f"query 'indices' must have shape {want_idx} (query_size x "
                f"cfg.num_tables x cfg.lookups_per_table), got "
                f"{tuple(idx.shape)}")
        if not dense.is_floating_point():
            raise ValueError(
                f"query 'dense' must be floating point, got {dense.dtype}")
        if (idx.is_floating_point() or idx.is_complex()
                or idx.dtype == torch.bool):
            raise ValueError(
                f"query 'indices' must be an integer dtype (row ids), got "
                f"{idx.dtype}")

    def submit(self, query: Query, now: Optional[float] = None) -> QueryFuture:
        """Enqueue one query; flushes the micro-batch if it became full or
        the oldest query's deadline has already passed. ``now`` (seconds)
        is injectable for deterministic tests; defaults to the wall clock."""
        self.validate_query(query)
        t = now_s() if now is None else now
        fut = QueryFuture(self._qid, t, {"dense": query["dense"],
                                         "indices": query["indices"]})
        self._qid += 1
        full = self.batcher.add(fut)
        if full or self.batcher.due(t):
            self.flush(now=t if now is not None else None)
        return fut

    def poll(self, now: Optional[float] = None) -> bool:
        """Flush if the oldest queued query has exceeded its deadline.
        Returns True if a flush happened."""
        t = now_s() if now is None else now
        if self.batcher.due(t):
            self.flush(now=now)
            return True
        return False

    def flush(self, now: Optional[float] = None) -> List[QueryFuture]:
        """Force the queued micro-batch through the device."""
        futs = self.batcher.drain()
        if not futs:
            return []
        probs, _, _ = self._execute([f.query for f in futs])
        t = now_s() if now is None else now
        for f, p in zip(futs, probs):
            f.complete(p, t)
        return futs

    @property
    def pending(self) -> int:
        return len(self.batcher.queue)

    # -- measurement drivers ----------------------------------------------
    def measure_service_time(self, n_queries: int = 1, repeats: int = 5,
                             seed: Optional[int] = None,
                             alpha: Optional[float] = None) -> float:
        """Median wall-clock seconds to serve one ``n_queries``-query batch
        (``n_queries`` must be <= the session's micro-batch capacity)."""
        qs = [self._make_query(s, seed, alpha) for s in range(n_queries)]
        self._ensure_warm()
        return float(np.median([self._execute(qs)[1]
                                for _ in range(repeats)]))

    def _make_query(self, step: int, seed: Optional[int] = None,
                    alpha: Optional[float] = None) -> Query:
        """Synthetic query from the session's stream, drawn on its device
        (seed/alpha default to the engine's)."""
        b = make_recsys_batch(self.cfg, step,
                              self.seed if seed is None else seed,
                              self.alpha if alpha is None else alpha,
                              batch_size=self.query_size, device=self.device)
        return {"dense": b["dense"], "indices": b["indices"]}

    def run_serial(self, n_queries: int, *, sla_ms: float = 50.0,
                   percentile: float = 99.0, seed: Optional[int] = None,
                   alpha: Optional[float] = None,
                   tracer: Optional[Tracer] = None,
                   metrics=None) -> SLAReport:
        """Closed loop: one query per micro-batch, back to back.

        ``metrics`` scopes the run's meters to a caller-owned
        ``MetricsRegistry``; the default is the process-wide
        ``default_registry()``."""
        self._ensure_warm()
        if tracer is not None:
            tracer.track(1, 0, process="board0", thread="serve")
            tracer.track(1, 3, thread="host-swap")
        log = AttributionLog()
        metrics = metrics if metrics is not None else default_registry()
        lat_ms: List[float] = []
        clock = 0.0            # back-to-back virtual timeline
        for q in range(n_queries):
            _, service, stall = self._execute(
                [self._make_query(q, seed, alpha)])
            done = clock + service
            metrics.counter("queries_served", rid=0).inc()
            metrics.histogram("flush_service_ms").observe(service * 1e3)
            # closed loop: arrival == dispatch, so latency is pure service
            log.record_batch([(q, clock)], rid=0, trigger=clock, start=clock,
                             done=done, compute_s=service - stall,
                             swap_stall_s=stall)
            if tracer is not None:
                tracer.span("serve_batch", "service", clock, done,
                            pid=1, tid=0, args={"queries": 1, "qid": q})
                if stall > 0:
                    tracer.span("swap_stall", "hoststore", done - stall,
                                done, pid=1, tid=3)
            clock = done
            lat_ms.append(service * 1e3)
        busy_s = sum(lat_ms) / 1e3
        return _report(lat_ms, [1] * n_queries, "serial", None,
                       n_queries / max(busy_s, 1e-12), sla_ms, percentile,
                       blame=log.blame(percentile))

    def run_open_loop(self, n_queries: int, qps: float, *,
                      sla_ms: float = 50.0, percentile: float = 99.0,
                      seed: Optional[int] = None,
                      alpha: Optional[float] = None,
                      max_wait_ms: Optional[float] = None,
                      tracer: Optional[Tracer] = None,
                      metrics=None) -> SLAReport:
        """Open-loop load: Poisson arrivals at ``qps``, dynamic batching.

        An event-driven virtual clock over the same ``MicroBatcher``
        policy the real-time submit path uses: arrival times are drawn up
        front; each flush's service time is a real, measured device
        execution; queueing (server busy) and batching (deadline) delays
        compose with it as on a single-executor server. Per-query latency
        is completion - arrival; ``report.blame`` decomposes the tail."""
        arrivals = poisson_arrivals(n_queries, qps,
                                    self.seed if seed is None else seed)
        batcher = MicroBatcher(
            self.max_batch_queries,
            self.batcher.max_wait_s if max_wait_ms is None
            else max_wait_ms / 1e3)
        if tracer is not None:
            tracer.track(1, 0, process="board0", thread="serve")
            tracer.track(1, 1, thread="batching")
            tracer.track(1, 3, thread="host-swap")
        log = AttributionLog()
        metrics = metrics if metrics is not None else default_registry()
        lat_ms: List[float] = []
        batch_sizes: List[int] = []
        free = 0.0            # server busy until this time
        last_done = 0.0
        i = 0
        while i < n_queries or batcher.queue:
            next_arr = arrivals[i] if i < n_queries else float("inf")
            # deadline wins ties, matching MicroBatcher.due (now >= deadline)
            if next_arr < batcher.deadline():
                fut = QueryFuture(i, arrivals[i],
                                  self._make_query(i, seed, alpha))
                i += 1
                if not batcher.add(fut):
                    continue
                trigger = fut.arrival          # the batch just filled
                reason = "full"
            else:
                trigger = batcher.deadline()   # oldest query timed out
                reason = "deadline"
            futs = batcher.drain()
            probs, service, stall = self._execute([f.query for f in futs])
            start = max(trigger, free)
            done = start + service
            free = done
            last_done = done
            metrics.counter("queries_served", rid=0).inc(len(futs))
            metrics.counter("flushes", reason=reason).inc()
            metrics.histogram("flush_service_ms").observe(service * 1e3)
            log.record_batch([(f.qid, f.arrival) for f in futs], rid=0,
                             trigger=trigger, start=start, done=done,
                             compute_s=service - stall, swap_stall_s=stall)
            if tracer is not None:
                tracer.span("batch_fill", "batching", futs[0].arrival,
                            trigger, pid=1, tid=1,
                            args={"queries": len(futs), "reason": reason})
                tracer.instant(f"flush:{reason}", "batching", trigger,
                               pid=1, tid=1, args={"queries": len(futs)})
                tracer.counter("queue_depth", trigger, {"board0": len(futs)},
                               pid=1)
                tracer.counter("queue_depth", done, {"board0": 0}, pid=1)
                tracer.span("serve_batch", "service", start, done,
                            pid=1, tid=0,
                            args={"queries": len(futs),
                                  "service_ms": service * 1e3})
                if stall > 0:
                    tracer.span("swap_stall", "hoststore", done - stall,
                                done, pid=1, tid=3)
            for f, p in zip(futs, probs):
                f.complete(p, done)
                lat_ms.append(f.latency_ms)
            batch_sizes.append(len(futs))
        achieved = n_queries / max(last_done, 1e-12)
        return _report(lat_ms, batch_sizes, "open_loop", qps, achieved,
                       sla_ms, percentile, blame=log.blame(percentile))
