"""Cluster: N scale-in boards behind a router, on one merged virtual clock.

The port's counterpart of ``repro.cluster.cluster``: the fleet-level
claim of the paper made runnable. Each ``Replica`` is an
Engine+ServeSession on its own board, a ``Router`` spreads a
``TrafficScenario``'s timestamped queries over them, and the event loop
merges per-replica flush deadlines with the arrival stream -- the same
event-by-event discipline as the single-board ``ServeSession.
run_open_loop``, generalized to N servers:

    next event = min(next arrival, min over replicas of batch deadline)
      arrival  -> monitor.observe -> router.pick -> enqueue
                  (flush that replica if its batch filled)
      deadline -> flush the replica whose oldest query timed out

Flush SERVICE times are real device executions on the replica's device
(optionally retimed by the hit-ratio monitor's hybrid-memory model);
queueing and batching delays compose on the virtual clock, so a run is
deterministic given (trace, fleet, policy) up to hardware timing noise --
and a RECORDED trace reproduces the whole workload. On one card every
replica shares ``cuda:0`` and the flushes run one at a time, each timed
on its own replica's busy horizon, as the reference times them.

Two controllers ride the loop: an ``SLAAutoscaler`` that grows/shrinks
the fleet on sustained p99 violation/slack (scale-up copies live params
onto the new board via ``runtime/elastic.remesh_tree``), and a
``HitRatioMonitor`` that fires ``tiered_embedding.lfu_refresh`` when a
``zipf_drift`` stream erodes the frequency-elected fast tier.

The run folds into one ``ClusterReport``: aggregate p50/p90/p99 + Eq. 1
verdict, achieved vs offered QPS, per-replica utilization, measured vs
``replicas x PlanReport.predicted_qps``, scale events, refresh events,
and, for a run that consumed a delta channel (``run(online=...)``), its
``OnlineReport``: each batch is broadcast to every replica at an update
barrier on the virtual clock.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.cluster.autoscale import ScaleEvent, SLAAutoscaler
from repro_torch.cluster.monitor import HitRatioMonitor
from repro_torch.cluster.replica import (MULTI_DEVICE, Replica,
                                         slice_devices, submesh)
from repro_torch.cluster.router import Router, make_router
from repro_torch.configs.base import DLRMConfig
from repro_torch.core.planner import ShardingPlan
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.engine.batching import QueryFuture
from repro_torch.engine.planning import PlanReport, build_auto_plan
from repro_torch.obs.attribution import AttributionLog, BlameReport
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.serialize import report_asdict, report_to_json
from repro_torch.obs.trace import Tracer
from repro_torch.traffic.scenarios import QueryEvent, materialize_query


@dataclass(frozen=True)
class FleetReport:
    """The serving-report surface EVERY fleet flavor shares: one run's
    latency distribution judged against the paper's Eq. 1 SLA
    (PPF(D_Q, p) <= C_SLA), achieved vs offered throughput, per-board
    utilization, and the autoscaler-economics cost axes (board_seconds,
    per-query SLA violations). ``ClusterReport`` (replicated fleet)
    extends it with its flavor's telemetry."""

    scenario: str
    router: str
    n_queries: int
    n_replicas_start: int
    n_replicas_end: int
    offered_qps: float
    achieved_qps: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    percentile: float
    ppf_ms: float
    sla_ms: float
    ok: bool
    mean_batch_queries: float
    makespan_s: float
    replicas: Tuple[Dict[str, float], ...]
    predicted_qps: Optional[float]        # n_replicas_start x plan prediction
    # cost accounting (autoscaler economics): boards x live time, and how
    # many individual queries exceeded C_SLA
    board_seconds: float = 0.0
    sla_violations: int = 0
    blame: Optional[BlameReport] = None   # per-query tail attribution
    # online-update ledger when the run consumed a delta channel
    # (annotated as a string to avoid a cluster <-> online import cycle;
    # the value is a repro_torch.online.report.OnlineReport)
    online: Optional["OnlineReport"] = None

    # subclass hook: the bracket tag each summary line carries
    tag: ClassVar[str] = "fleet"

    def summary(self) -> str:
        lines = [
            f"[{self.tag}] {self.scenario} x {self.router}: "
            f"{self.n_queries} queries over "
            f"{self.n_replicas_start}->{self.n_replicas_end} replicas, "
            f"offered={self.offered_qps:.1f}qps "
            f"achieved={self.achieved_qps:.1f}qps "
            f"mean_batch={self.mean_batch_queries:.2f}",
            f"[{self.tag}] p50={self.p50_ms:.2f}ms p90={self.p90_ms:.2f}ms "
            f"p99={self.p99_ms:.2f}ms | SLA PPF(D_Q, "
            f"{self.percentile:.0f}) = {self.ppf_ms:.2f}ms "
            f"{'<=' if self.ok else '>'} C_SLA={self.sla_ms:.1f}ms -> "
            f"{'PASS' if self.ok else 'FAIL'}",
            f"[{self.tag}] util: " + " ".join(
                f"r{int(s['rid'])}={s['util']:.2f}" for s in self.replicas),
            f"[{self.tag}] cost: {self.board_seconds:.3f} board-seconds, "
            f"{self.sla_violations} queries over C_SLA",
        ]
        if self.predicted_qps:
            lines.append(
                f"[{self.tag}] measured/predicted QPS = "
                f"{self.achieved_qps:.1f}/{self.predicted_qps:.1f} "
                f"({self.achieved_qps / self.predicted_qps:.2f}x of "
                f"{self.n_replicas_start} x PlanReport)")
        if self.online is not None:
            lines.append(self.online.summary())
        if self.blame is not None:
            lines.append(self.blame.summary())
        return "\n".join(lines)

    def asdict(self) -> dict:
        return report_asdict(self)

    def to_json(self, path: Optional[str] = None) -> str:
        return report_to_json(self, path)


@dataclass(frozen=True)
class ClusterReport(FleetReport):
    """FleetReport + the replicated fleet's telemetry: scale events, tier
    hit-ratio health, lfu refreshes."""

    scale_events: Tuple[ScaleEvent, ...] = ()
    refreshes: Tuple[float, ...] = ()
    hit_ratio_first: Optional[float] = None
    hit_ratio_last: Optional[float] = None

    tag: ClassVar[str] = "cluster"

    def summary(self) -> str:
        lines = [super().summary()]
        for e in self.scale_events:
            lines.append(
                f"[cluster] scale {e.action} at t={e.t_s:.3f}s -> "
                f"{e.n_replicas} replicas (window p99 "
                f"{e.window_p99_ms:.2f}ms, remesh {e.remesh})")
        if self.hit_ratio_first is not None:
            lines.append(
                f"[cluster] tier hit ratio {self.hit_ratio_first:.3f} -> "
                f"{self.hit_ratio_last:.3f}"
                + (f", {len(self.refreshes)} lfu_refresh at "
                   + ",".join(f"{t:.2f}s" for t in self.refreshes)
                   if self.refreshes else ", no refresh"))
        return "\n".join(lines)


class Cluster:
    """N replicas + router (+ optional autoscaler / hit-ratio monitor).

    The placement plan is resolved ONCE (profile + plan for one board)
    and every replica executes the same concrete plan -- boards of a
    fleet are interchangeable. All replicas init params from the shared
    seed, so they serve bit-identical results regardless of routing.

    ``devices`` is the device pool the boards are sliced from; None is
    ``[device]``, and ``device=None`` is the card. Queries are
    materialized on the pool's first device.
    """

    def __init__(self, cfg: DLRMConfig, *, n_replicas: int = 2,
                 devices: Optional[Sequence] = None,
                 devices_per_replica: Optional[int] = None,
                 model_axis: int = 1,
                 plan: Union[None, str, ShardingPlan] = "none",
                 exchange: str = "partial_pool",
                 alpha: float = 0.0, seed: int = 0,
                 fast_mb: Optional[float] = None,
                 max_batch_queries: int = 4, max_wait_ms: float = 2.0,
                 query_size: Optional[int] = None,
                 router: Union[str, Router] = "round_robin",
                 autoscaler: Optional[SLAAutoscaler] = None,
                 monitor: Optional[HitRatioMonitor] = None,
                 pipeline_depth: Optional[int] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 verbose: bool = False, device: DeviceArg = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.cfg = cfg
        self.query_size = int(query_size or cfg.batch_size)
        self.verbose = verbose
        pool = ([resolve_device(d) for d in devices] if devices is not None
                else [resolve_device(device)])
        dpr = devices_per_replica or max(
            model_axis, model_axis * (len(pool) // (model_axis * n_replicas)))
        if dpr > 1 or model_axis > 1:
            raise NotImplementedError(
                f"boards of {dpr} devices (model_axis={model_axis}) are not "
                f"ported yet ({MULTI_DEVICE})")
        self.device = pool[0]
        self._pool = pool
        self._dpr = dpr
        self._model_axis = model_axis
        self.plan_report: Optional[PlanReport] = None
        if isinstance(plan, str) and plan == "auto":
            self.plan_report = build_auto_plan(
                cfg, dpr, alpha=alpha, seed=seed, fast_mb=fast_mb,
                mode="inference", device=self.device)
            if verbose:
                print(self.plan_report.summary())
            plan = self.plan_report.plan
        elif isinstance(plan, str) and plan == "none":
            plan = None
        self._replica_kw = dict(
            model_axis=model_axis, plan=plan, exchange=exchange, alpha=alpha,
            seed=seed, max_batch_queries=max_batch_queries,
            max_wait_ms=max_wait_ms, query_size=self.query_size,
            pipeline_depth=pipeline_depth)
        self.replicas: List[Replica] = [
            Replica(rid, cfg, slice_devices(pool, rid, dpr),
                    **self._replica_kw)
            for rid in range(n_replicas)]
        self._next_rid = n_replicas
        self.router: Router = (router if isinstance(router, Router)
                               else make_router(router, seed))
        self.autoscaler = autoscaler
        self.monitor = monitor
        self.completed: Dict[int, QueryFuture] = {}
        self.scale_events: List[ScaleEvent] = []
        # observability: per-instance metrics registry (reset each run) so
        # reports read their tallies back without cross-run bleed; tracer
        # is opt-in (--trace-out)
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.attribution = AttributionLog()

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    # -- fleet changes -------------------------------------------------------
    def _board_seconds(self, now: float) -> float:
        """Boards x live time so far: the autoscaler-economics cost axis
        (every live replica since its spawn + every retired one's full
        spawn->retirement window)."""
        live = sum(max(now - r.spawned_at, 0.0) for r in self.replicas)
        gone = sum(max((r.retired_at or now) - r.spawned_at, 0.0)
                   for r in self._retired)
        return live + gone

    def _scale_up(self, now: float, window_p99: float) -> None:
        rid = self._next_rid
        self._next_rid += 1
        devs = slice_devices(self._pool, rid, self._dpr)
        new_mesh = submesh(devs, self._model_axis)
        # copy a live replica's params onto the new board
        params, remesh_report = self.replicas[0].clone_params_onto(new_mesh)
        rep = Replica(rid, self.cfg, devs, params=params, **self._replica_kw)
        rep.free = rep.spawned_at = now
        self.replicas.append(rep)
        cost = self._board_seconds(now)
        if self.autoscaler is not None:
            self.autoscaler.record_cost(now, cost)
        self.scale_events.append(ScaleEvent(
            t_s=now, action="up", n_replicas=len(self.replicas),
            window_p99_ms=window_p99, remesh=remesh_report,
            board_seconds=cost))
        self._observe_scale("up", now, window_p99)
        if self.verbose:
            print(f"[cluster] t={now:.3f}s scale UP -> "
                  f"{len(self.replicas)} replicas (p99 {window_p99:.2f}ms, "
                  f"{cost:.3f} board-s spent)")

    def _scale_down(self, now: float, window_p99: float) -> None:
        # retire the emptiest board; drain its queue before it goes
        victim = min(self.replicas, key=lambda r: (r.backlog(now), -r.rid))
        self._flush(victim, now, reason="drain")
        victim.retired_at = max(now, victim.free)   # serves out its queue
        victim.release()
        self.replicas.remove(victim)
        self.router.replica_removed(self.replicas)
        self._retired.append(victim)
        cost = self._board_seconds(now)
        if self.autoscaler is not None:
            self.autoscaler.record_cost(now, cost)
        self.scale_events.append(ScaleEvent(
            t_s=now, action="down", n_replicas=len(self.replicas),
            window_p99_ms=window_p99, board_seconds=cost))
        self._observe_scale("down", now, window_p99)
        if self.verbose:
            print(f"[cluster] t={now:.3f}s scale DOWN -> "
                  f"{len(self.replicas)} replicas (r{victim.rid} retired, "
                  f"p99 {window_p99:.2f}ms, {cost:.3f} board-s spent)")

    # -- observability hooks -------------------------------------------------
    def _observe_scale(self, action: str, now: float, p99: float) -> None:
        self.metrics.counter("scale_events", action=action).inc()
        self.metrics.gauge("n_replicas").set(len(self.replicas))
        if self.tracer is not None:
            self.tracer.track(0, 0, process="control", thread="autoscaler")
            self.tracer.instant(f"scale:{action}", "autoscaler", now,
                                args={"n_replicas": len(self.replicas),
                                      "window_p99_ms": p99})
            self.tracer.counter("n_replicas", now,
                                {"fleet": len(self.replicas)})

    def _observe_flush(self, replica: Replica, trigger: float,
                       reason: str, futs: List[QueryFuture]) -> None:
        lf = replica.last_flush
        self.attribution.record_batch(
            [(f.qid, f.arrival) for f in futs], rid=replica.rid,
            trigger=trigger, start=lf["start"], done=lf["done"],
            compute_s=lf["service_s"] - lf["swap_stall_s"],
            swap_stall_s=lf["swap_stall_s"])
        self.metrics.counter("queries_served", rid=replica.rid).inc(len(futs))
        self.metrics.gauge("queue_depth", rid=replica.rid).set(0)
        self.metrics.histogram("flush_service_ms").observe(
            lf["service_s"] * 1e3)
        if self.tracer is None:
            return
        pid = replica.rid + 1
        self.tracer.track(pid, 0, process=f"replica{replica.rid}",
                          thread="serve")
        self.tracer.track(pid, 1, thread="batching")
        self.tracer.span("batch_fill", "batching", lf["oldest_arrival"],
                         trigger, pid=pid, tid=1,
                         args={"queries": len(futs), "reason": reason})
        self.tracer.instant(f"flush:{reason}", "batching", trigger,
                            pid=pid, tid=1, args={"queries": len(futs)})
        self.tracer.span("serve_batch", "service", lf["start"], lf["done"],
                         pid=pid, tid=0,
                         args={"queries": len(futs),
                               "service_ms": lf["service_s"] * 1e3})
        if lf["swap_stall_s"] > 0:
            self.tracer.track(pid, 3, thread="host-swap")
            self.tracer.span("swap_stall", "hoststore",
                             lf["done"] - lf["swap_stall_s"], lf["done"],
                             pid=pid, tid=3)

    # -- online updates (repro_torch.online) ---------------------------------
    def _apply_update(self, batch, now: float) -> None:
        """Broadcast one ``DeltaBatch`` to every replica. The replicated
        fleet has no ownership -- each board holds all tables -- and no
        inter-board fabric is modeled here, so the batch becomes visible
        instantly at ``now`` on every board; staleness is only the
        emit->barrier gap."""
        rows = 0
        for r in self.replicas:
            rows = r.apply_row_updates(batch)
        stale = max(now - batch.t_emit_s, 0.0)
        o = self._online
        o["n_updates"] += 1
        o["last_version"] = max(o["last_version"], batch.version)
        o["rows_pushed"] += rows
        o["rows_propagated"] += rows * (len(self.replicas) - 1)
        o["push_bytes"] += batch.payload_bytes() * len(self.replicas)
        o["staleness_s"].append(stale)
        if batch.train_loss == batch.train_loss:     # not NaN
            o["losses"].append(float(batch.train_loss))
        self.metrics.counter("update_batches").inc()
        self.metrics.counter("rows_pushed").inc(rows)
        self.metrics.counter("rows_propagated").inc(
            rows * (len(self.replicas) - 1))
        self.metrics.histogram("update_staleness_s").observe(stale)
        if self.tracer is not None:
            self.tracer.track(0, 1, process="control", thread="online")
            self.tracer.instant("update_apply", "online", now,
                                args={"version": batch.version, "rows": rows,
                                      "replicas": len(self.replicas)})

    def _online_report(self):
        if self._online is None:
            return None
        # local import: repro_torch.online reaches this module through
        # coherence -> fabric.cache -> fabric.fleet
        from repro_torch.online.report import OnlineReport
        o = self._online
        st = o["staleness_s"] or [0.0]
        return OnlineReport(
            mode=o["mode"], n_updates=o["n_updates"],
            last_version=o["last_version"], rows_pushed=o["rows_pushed"],
            rows_propagated=o["rows_propagated"], cache_invalidated_rows=0,
            push_bytes=o["push_bytes"], push_stall_s=0.0,
            staleness_p50_s=float(np.percentile(st, 50)),
            staleness_max_s=float(np.max(st)),
            mean_train_loss=(float(np.mean(o["losses"])) if o["losses"]
                             else float("nan")))

    # -- event loop ----------------------------------------------------------
    def _flush(self, replica: Replica, trigger: float,
               reason: str = "full") -> List[QueryFuture]:
        scale = 1.0
        if self.monitor is not None:
            qids = [f.qid for f in replica.batcher.queue]
            scale = self.monitor.service_multiplier(
                self.monitor.batch_hit_ratio(qids))
        futs = replica.flush(trigger, service_scale=scale)
        if not futs:
            return futs
        self._batch_sizes.append(len(futs))
        for f in futs:
            self.completed[f.qid] = f
            self._lat_ms.append(f.latency_ms)
        self._last_done = max(self._last_done, futs[0].completed_at)
        self._observe_flush(replica, trigger, reason, futs)
        if self.autoscaler is not None:
            decision = self.autoscaler.observe(
                [f.latency_ms for f in futs], now=trigger,
                n_replicas=len(self.replicas))
            if decision is not None:
                action, p99 = decision
                if action == "up":
                    self._scale_up(trigger, p99)
                else:
                    self._scale_down(trigger, p99)
        return futs

    def run(self, events: Sequence[QueryEvent], *, sla_ms: float = 50.0,
            percentile: float = 99.0, scenario: str = "trace",
            online=None) -> ClusterReport:
        """Serve one event stream to completion; see module docstring.

        ``online`` is an optional delta source (``repro_torch.online``'s
        ``DeltaChannel`` / ``OnlineSource``: anything with
        ``next_time()`` / ``poll(now)``). Its batches are applied at
        UPDATE BARRIERS on the virtual clock -- every board with queued
        queries flushes at the emit time, then the batch is broadcast to
        all replicas -- so a query's served values depend only on its
        arrival time, never on routing or fleet size."""
        if not events:
            raise ValueError("cluster run needs at least one event")
        self._lat_ms: List[float] = []
        self._batch_sizes: List[int] = []
        self._last_done = 0.0
        self._retired: List[Replica] = []
        self.completed = {}
        self.scale_events = []
        self.metrics.reset()
        self.attribution = AttributionLog()
        self.metrics.gauge("n_replicas").set(len(self.replicas))
        self._online = None
        if online is not None:
            self._online = dict(mode="replicate", n_updates=0,
                                last_version=0, rows_pushed=0,
                                rows_propagated=0, push_bytes=0,
                                staleness_s=[], losses=[])
        n_start = len(self.replicas)
        i = 0
        while i < len(events) or any(r.batcher.queue for r in self.replicas):
            next_arr = events[i].arrival_s if i < len(events) else float("inf")
            due = min(self.replicas, key=lambda r: r.deadline())
            # update barrier: an emitted delta batch wins ties against
            # both arrivals and deadlines, so visibility is a pure
            # function of arrival time (V(q) = #batches emitted <=
            # arrival_q) -- the bit-identity invariant across fleet sizes
            t_upd = online.next_time() if online is not None else None
            if t_upd is not None and t_upd <= min(next_arr, due.deadline()):
                # (over a copy: a flush may scale the fleet)
                for r in list(self.replicas):
                    if r.batcher.queue:
                        self._flush(r, t_upd, reason="update")
                for batch in online.poll(t_upd):
                    self._apply_update(batch, t_upd)
                continue
            # deadline wins ties, matching MicroBatcher.due (now >= deadline)
            if next_arr < due.deadline():
                ev = events[i]
                i += 1
                query = materialize_query(self.cfg, ev, self.query_size,
                                          device=self.device)
                if self.monitor is not None:
                    self.monitor.observe(ev.qid, query["indices"],
                                         ev.arrival_s)
                    self.monitor.maybe_refresh(ev.arrival_s)
                fut = QueryFuture(ev.qid, ev.arrival_s, query)
                replica = self.router.pick(self.replicas, ev.arrival_s)
                full = replica.enqueue(fut)
                self.metrics.gauge("queue_depth", rid=replica.rid).set(
                    len(replica.batcher.queue))
                if full:
                    self._flush(replica, ev.arrival_s, reason="full")
            else:
                self._flush(due, due.deadline(), reason="deadline")

        lat = np.asarray(self._lat_ms, np.float64)
        p50, p90, p99 = (float(np.percentile(lat, p)) for p in (50, 90, 99))
        ppf = float(np.percentile(lat, percentile))
        makespan = max(self._last_done, 1e-12)
        offered = len(events) / max(events[-1].arrival_s, 1e-12)
        predicted = (self.plan_report.predicted_qps * n_start
                     if self.plan_report is not None else None)
        hit_first = hit_last = None
        if self.monitor is not None and self.monitor.history:
            hs = [h for _, h in self.monitor.history]
            k = min(len(hs), 16)
            hit_first = float(np.mean(hs[:k]))
            hit_last = float(np.mean(hs[-k:]))
        return ClusterReport(
            scenario=scenario, router=self.router.name,
            n_queries=len(events), n_replicas_start=n_start,
            n_replicas_end=len(self.replicas), offered_qps=offered,
            achieved_qps=len(events) / makespan,
            p50_ms=p50, p90_ms=p90, p99_ms=p99, percentile=percentile,
            ppf_ms=ppf, sla_ms=sla_ms, ok=ppf <= sla_ms,
            mean_batch_queries=(float(np.mean(self._batch_sizes))
                                if self._batch_sizes else 0.0),
            makespan_s=makespan,
            replicas=tuple(r.stats(makespan)
                           for r in self.replicas + self._retired),
            predicted_qps=predicted,
            scale_events=tuple(self.scale_events),
            refreshes=(tuple(self.monitor.refreshes)
                       if self.monitor is not None else ()),
            hit_ratio_first=hit_first, hit_ratio_last=hit_last,
            board_seconds=self._board_seconds(makespan),
            sla_violations=int((lat > sla_ms).sum()),
            blame=self.attribution.blame(percentile),
            online=self._online_report())
