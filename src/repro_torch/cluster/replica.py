"""Replica: one served board -- an Engine + ServeSession on its own ranks.

The port's counterpart of ``repro.cluster.replica``. The paper's
deployment unit is a board ("scale-in" node); a fleet is N of them behind
a router. Each ``Replica`` owns

  * a board's ranks (``submesh``), sliced from the world's ranks as the
    reference slices its device pool: a ("data", "model") mesh of
    ``launch.mesh``, on which the replica's Engine/ServeSession shard
    their tables over every rank of the board (``axis=("data",
    "model")``), independent of every other replica. On one rank without
    a world the board is a mesh of rank 0;
  * a ``MicroBatcher`` + a virtual-clock busy horizon (``free``): the
    cluster event loop (``repro_torch.cluster.cluster``) drives flushes
    with explicit trigger times, exactly like ``ServeSession.
    run_open_loop`` does for one board, so queueing/batching delays
    compose event-by-event while SERVICE times stay real device
    executions.

Over k ranks every rank of the world builds every Replica and runs the
same event loop; only the board's own ranks hold its session. A flush's
service time is its slowest rank's (the session's pmax over the board),
and the board's lead rank then shares the service time and the probs
with every rank outside the board (one broadcast a flush), so that every
rank decides the same routing, scaling and reports.

Replicas are spawned two ways: fresh (param init from the shared seed --
all replicas of a cluster start bit-identical) or by RE-PLACING a live
replica's params onto a new board via ``runtime/elastic.remesh_tree``
(``clone_params_onto``) -- the autoscaler's scale-up path, which must not
change served results. On one card every rank shares ``cuda:0``; boards
past the pool wrap onto its first ranks, as the reference's
oversubscription does, and each serializes on its own virtual busy
horizon.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.engine.batching import MicroBatcher, QueryFuture
from repro_torch.engine.engine import Engine
from repro_torch.launch.mesh import Mesh, group_of, sub_mesh, world_size
from repro_torch.parallel import primitives as prim
from repro_torch.parallel.build import AXIS, param_specs
from repro_torch.parallel.plan import plan_table_groups
from repro_torch.runtime.elastic import remesh_tree

MULTI_RANK_UPDATES = (
    "online row updates into a board of more than one rank are not "
    "ported yet (ROADMAP A6b-ii)")


def submesh(devices: Sequence[int], model_axis: int = 1) -> Mesh:
    """A board's ranks of the world as a ("data", "model")
    ``launch.mesh.Mesh`` of shape (len // model_axis, model_axis), the
    reference's ``submesh(devices, model_axis)``, built on every rank of
    the world. A board needs a rank each of its devices; this rank's
    device is the caller's ``device=``."""
    ranks = list(devices)
    if not all(isinstance(r, (int, np.integer)) for r in ranks):
        raise ValueError(
            f"a board needs a rank each of its devices: pass ranks of the "
            f"world (ints; torch.distributed, launch.mesh) and this rank's "
            f"device as device=, got {ranks!r}")
    return sub_mesh(ranks, model_axis)


def slice_devices(pool: Sequence, rid: int, per_replica: int) -> List:
    """Rank slice for replica ``rid``: disjoint while the pool
    lasts, then wrapped (oversubscribed). Oversubscription is exact on the
    virtual clock -- each replica serializes on its own busy horizon --
    and mirrors bring-up on fewer boards than the target fleet."""
    if per_replica > len(pool):
        raise ValueError(f"replica needs {per_replica} devices; pool has "
                         f"{len(pool)}")
    start = (rid * per_replica) % len(pool)
    return [pool[(start + i) % len(pool)] for i in range(per_replica)]


def share(mesh: Mesh, values: torch.Tensor) -> torch.Tensor:
    """``values`` (a float64 CPU tensor) as the board's lead rank holds
    it, on every rank of the world: one broadcast, skipped where the
    board is the whole world (its ranks agree already)."""
    if mesh.size() == world_size():
        return values
    return prim.broadcast(values, mesh.lead, group_of(range(world_size())))


class Replica:
    """One board of the fleet. See module docstring."""

    def __init__(self, rid: int, cfg: DLRMConfig, devices: Sequence, *,
                 model_axis: int = 1, plan=None, exchange: str = "partial_pool",
                 alpha: float = 0.0, seed: int = 0,
                 max_batch_queries: int = 4, max_wait_ms: float = 2.0,
                 query_size: Optional[int] = None, params=None,
                 pipeline_depth: Optional[int] = None,
                 service_scale: float = 1.0, device: DeviceArg = None):
        self.rid = rid
        self.cfg = cfg
        self.devices = list(devices)
        # fixed per-board slowdown (straggler/degraded board, the serving
        # analogue of runtime/straggler.py): scales every service time
        self.service_scale = float(service_scale)
        self.mesh = submesh(self.devices, model_axis)
        # this rank's device; a rank outside the board holds nothing of it
        self.device = resolve_device(device)
        self.member = self.mesh.member
        self.query_size = int(query_size or cfg.batch_size)
        self._plan = plan
        self.engine = self.session = None
        if self.member:
            # the plan is resolved ONCE at cluster level and passed
            # concrete (or None): replicas must not re-profile
            # independently
            self.engine = Engine(
                cfg, plan=plan if plan is not None else "none",
                exchange=exchange, alpha=alpha, seed=seed,
                pipeline_depth=pipeline_depth, device=self.device,
                mesh=self.mesh, axis=AXIS)
            self.session = self.engine.serve_session(
                max_batch_queries=max_batch_queries, max_wait_ms=max_wait_ms,
                query_size=query_size, params=params)
        self.batcher = MicroBatcher(int(max_batch_queries), max_wait_ms / 1e3)
        self.free = 0.0          # virtual clock: busy until this time
        self.spawned_at = 0.0
        self.retired_at: Optional[float] = None   # set on scale-down
        self.busy_s = 0.0
        self.served = 0
        self.batch_sizes: List[int] = []
        # dispatched-but-unfinished batches as (done_time, n_queries):
        # batches run serially on the board, so EVERY batch whose done
        # time is still ahead of `now` is unfinished work the router must
        # see -- tracking only the last one makes a backlogged replica
        # look idle and join-shortest-queue dogpiles it
        self._dispatched: Deque[Tuple[float, int]] = deque()
        self._svc_ewma = 0.0     # per-query service estimate (seconds)
        self.last_flush: Optional[Dict[str, float]] = None

    # -- queue state (what routers see) ------------------------------------
    def backlog(self, now: float) -> int:
        """Queued queries + all dispatched-but-unfinished ones at ``now``."""
        while self._dispatched and self._dispatched[0][0] <= now:
            self._dispatched.popleft()
        return len(self.batcher.queue) + sum(
            sz for _, sz in self._dispatched)

    def expected_wait_s(self, now: float) -> float:
        """Expected seconds until this board would finish the queued work:
        remaining busy horizon + queued queries x EWMA per-query service.
        The queue-state routing signal (jsq / p2c): unlike a raw query
        count, it weighs a slow (straggler) board's queue by its actual
        drain rate."""
        return (max(self.free - now, 0.0)
                + len(self.batcher.queue) * self._svc_ewma)

    def enqueue(self, fut: QueryFuture) -> bool:
        """Queue one arrival; True if the micro-batch is now full."""
        return self.batcher.add(fut)

    def deadline(self) -> float:
        return self.batcher.deadline()

    # -- execution ----------------------------------------------------------
    def flush(self, trigger: float, service_scale: float = 1.0
              ) -> List[QueryFuture]:
        """Drain + execute the queued micro-batch on the virtual clock.

        ``trigger`` is the event that caused the flush (batch-full arrival
        or oldest-query deadline); the batch starts when the replica is
        free. Service time is a REAL device execution on this replica's
        device (``ServeSession._execute``, timed to the end of the device's
        work), scaled by ``service_scale`` (the hit-ratio monitor's
        memory-tier retiming; 1.0 = measured time as-is) and by the
        board's own ``service_scale``.
        """
        futs = self.batcher.drain()
        if not futs:
            return []
        n = len(futs)
        values = torch.empty(2 + n * self.query_size, dtype=torch.float64)
        if self.member:
            probs, service, stall = self.session._execute(
                [f.query for f in futs])
            values[0], values[1] = service, stall
            values[2:] = torch.from_numpy(probs.reshape(-1).astype(
                np.float64))
        values = share(self.mesh, values)
        service, stall = float(values[0]), float(values[1])
        probs = values[2:].numpy().astype(np.float32).reshape(
            n, self.query_size)
        scale = float(service_scale) * self.service_scale
        service *= scale
        stall *= scale
        start = max(trigger, self.free)
        done = start + service
        self.free = done
        self.busy_s += service
        # flush-window timeline for the cluster's tracer/attribution:
        # the replica owns the busy horizon, the cluster owns the obs
        self.last_flush = {
            "trigger": trigger, "start": start, "done": done,
            "service_s": service, "swap_stall_s": stall,
            "n_queries": len(futs), "oldest_arrival": futs[0].arrival}
        self.served += len(futs)
        self.batch_sizes.append(len(futs))
        self._dispatched.append((done, len(futs)))
        per_query = service / len(futs)
        self._svc_ewma = (per_query if self._svc_ewma == 0.0
                          else 0.3 * per_query + 0.7 * self._svc_ewma)
        for f, p in zip(futs, probs):
            f.complete(p, done)
            # a served query's content is not read again: drop it, so a
            # run holds only its queued queries (an RM2-small query is
            # 2.8 MB on the device; the reference keeps every one)
            f.query = None
        return futs

    @property
    def serve_kernel(self) -> Optional[str]:
        """The session's serve kernel (None on a rank outside the
        board)."""
        return None if self.session is None else self.session.serve_kernel

    def measure_service_time(self, n_queries: int = 1) -> float:
        """``ServeSession.measure_service_time`` of this board, the same
        on every rank of the world (the lead rank's, after the board's
        pmax)."""
        t = torch.zeros(1, dtype=torch.float64)
        if self.member:
            t[0] = self.session.measure_service_time(n_queries)
        return float(share(self.mesh, t)[0])

    def release(self) -> None:
        """Let go of the board's device tensors (its session and the
        params it serves) when the board retires; the stats stay. The
        reference keeps a retired replica's params: at full width a
        scale-down then a scale-up would hold one more table set than the
        fleet serves."""
        self.session = None
        self.engine = None

    # -- online updates ------------------------------------------------------
    def apply_row_updates(self, batch) -> int:
        """Scatter one ``repro_torch.online.DeltaBatch`` into the live
        served params, in place on the board's device. The replicated
        fleet has no ownership: every replica holds every table, so the
        cluster loop broadcasts each batch to all replicas -- after this
        call the board serves the batch's row values bit-exactly. A
        replica spawned by ``clone_params_onto`` holds its own copy and
        takes the rows there. Returns rows written (the batch's rows on
        every rank; only the board's own ranks write). A board of more
        than one rank raises (ROADMAP A6b-ii)."""
        mesh = getattr(self, "mesh", None)
        if mesh is not None and mesh.size() > 1:
            raise NotImplementedError(MULTI_RANK_UPDATES)
        if not getattr(self, "member", True):
            return sum(d.n_rows for d in batch.deltas)
        params = self.session.params
        if not isinstance(params, dict) or "tables" not in params:
            raise ValueError(
                "online row updates need stacked params with a 'tables' "
                "leaf; plan-split sessions are not updatable in place "
                "(re-spawn the replica from refreshed params instead)")
        tables = params["tables"]
        n = 0
        for d in batch.deltas:
            rows = torch.from_numpy(d.rows).to(tables.device)
            tables[d.table, rows] = torch.from_numpy(d.values).to(
                tables.device, tables.dtype)
            n += d.n_rows
        return n

    # -- elastic re-placement ------------------------------------------------
    def param_specs(self) -> Any:
        """The ``Spec`` tree of this replica's (possibly plan-split) param
        tree -- what ``remesh_tree`` re-places against: the reference's
        ``parallel.param_specs`` over the board's ("data", "model") axis
        (known on every rank)."""
        groups = None
        if self._plan is not None and self._plan.placements:
            groups = plan_table_groups(self._plan, self.mesh.size(AXIS))
        return param_specs(self.cfg, AXIS, groups)

    def clone_params_onto(self, new_mesh) -> Tuple[Any, Dict[str, int]]:
        """Re-place this replica's live params onto another board via
        ``runtime/elastic.remesh_tree`` -- the autoscaler's scale-up path:
        every rank of the world calls, and each rank of ``new_mesh`` gets
        its shards (a copy, also where it is one of this board's ranks).
        Returns (params on the new board, None on a rank outside it;
        remesh report)."""
        return remesh_tree(
            self.session.params if self.member else None,
            self.param_specs(), new_mesh, src_mesh=self.mesh,
            device=self.device)

    def stats(self, makespan_s: float) -> Dict[str, float]:
        """Utilization is busy time over the board's LIVE window -- spawn to
        retirement (or end of run), not the whole run."""
        end = makespan_s if self.retired_at is None else self.retired_at
        active = max(end - self.spawned_at, 1e-12)
        return {
            "rid": self.rid,
            "served": self.served,
            "batches": len(self.batch_sizes),
            "mean_batch": (float(np.mean(self.batch_sizes))
                           if self.batch_sizes else 0.0),
            "busy_s": self.busy_s,
            "util": min(self.busy_s / active, 1.0),
        }
