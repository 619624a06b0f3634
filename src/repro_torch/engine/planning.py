"""Engine planning stage: profile stream -> placement plan -> mesh reconcile.

This is the one place the profile->plan->reconcile pipeline lives; every
entry point reaches it through `repro_torch.engine.Engine`.

`PlanReport.predicted_qps` and the depth sweep are the paper's performance
model evaluated for its RecSpeed hybrid HBM+DDR4 system (Table XIV, Sec.
VII-A), exactly as the reference computes them. They rank placements and
pipeline depths; they are not a prediction for the card the port runs on.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.planner import ShardingPlan
from repro_torch.device import DeviceArg
from repro_torch.obs.serialize import report_asdict, report_to_json


@dataclass(frozen=True)
class PlanReport:
    """A reconciled plan plus the perf model's prediction for it."""

    plan: ShardingPlan
    mode: str                 # "inference" | "training"
    predicted_qps: float
    # Planner-chosen micro-batch pipeline depth (executed-schedule model:
    # perf_model.optimal_pipeline_depth) + the swept step times behind it.
    pipeline_depth: int = 1
    depth_sweep: Dict[int, float] = field(default_factory=dict)
    # The serve-path kernel selection the engine's sessions execute:
    # "fused" (one gather->pool->interaction launch, local exchanges only)
    # or "composed" (separate bag + interaction kernels). Recorded by
    # Engine.serve_session once the session resolves it against the actual
    # exchange; plans built for training keep the default.
    serve_kernel: str = "composed"

    def summary(self) -> str:
        plan = self.plan
        n_fast = sum(1 for p in plan.placements if p.tier == "fast")
        n_tables = len(plan.placements)
        return (f"[plan] mode={plan.mode} exchange={plan.exchange} "
                f"fast_tables={n_fast}/{n_tables} "
                f"hit_ratio={plan.hit_ratio:.3f} "
                f"predicted_qps={self.predicted_qps:.0f} "
                f"pipeline_depth={self.pipeline_depth} "
                f"serve_kernel={self.serve_kernel} "
                f"(hybrid HBM+DDR4 model)")

    def asdict(self) -> dict:
        return report_asdict(self)

    def to_json(self, path: Optional[str] = None) -> str:
        return report_to_json(self, path)


def build_auto_plan(cfg: DLRMConfig, n: int, *, alpha: float = 0.0,
                    seed: int = 0, fast_mb: Optional[float] = None,
                    mode: str = "inference",
                    profile_batches: int = 4,
                    device: DeviceArg = None) -> PlanReport:
    """Profile the step-indexed stream, run the planner, reconcile with the
    mesh size, and report the hit-ratio-aware QPS prediction.

    The profile pass counts row accesses on ``device`` (None: the card).
    Default fast capacity fits ~half the tables across the mesh so smoke
    runs exercise a MIXED placement.
    """
    from repro_torch.core import perf_model, planner
    from repro_torch.core import tiered_embedding as te
    from repro_torch.parallel.plan import reconcile_plan_with_mesh

    counts = te.measure_row_freq(cfg, alpha, seed, n_batches=profile_batches,
                                 device=device)
    table_freq = counts.sum(dim=1).cpu().numpy().astype(np.float64)
    del counts
    tbytes = cfg.rows_per_table * cfg.embed_dim * 2
    if fast_mb is not None:
        fast_bytes = int(fast_mb * 2 ** 20)
    else:
        fast_bytes = -(-(cfg.num_tables // 2) // n) * tbytes
    system = dataclasses.replace(perf_model.recspeed_system(), n_chips=n)
    plan = planner.plan_with_placement(
        cfg, system, table_freq, fast_bytes,
        bulk_capacity_bytes=cfg.num_tables * tbytes, mode=mode)
    # fold the mesh-divisibility demotion into the plan so the reported
    # placement + hit ratio match what the step factories execute
    plan = reconcile_plan_with_mesh(plan, n, table_freq)
    hybrid = dataclasses.replace(perf_model.recspeed_hybrid_system(),
                                 n_chips=n)
    # predict for the sharding mode the plan actually chose (breakdown
    # routes on cfg.sharding)
    mode_cfg = dataclasses.replace(cfg, sharding=plan.mode)
    pred = perf_model.breakdown(mode_cfg, hybrid, mode, plan.exchange,
                                hit_ratio=plan.hit_ratio)
    # executed-schedule pipelining: pick the micro-batch depth that hides
    # the most exchange time behind compute on this system
    best_depth, sweep = perf_model.optimal_pipeline_depth(
        mode_cfg, hybrid, mode, row_wise_exchange=plan.exchange,
        hit_ratio=plan.hit_ratio)
    return PlanReport(plan=plan, mode=mode, predicted_qps=pred.qps,
                      pipeline_depth=best_depth, depth_sweep=sweep)


def resolve_depth_for_batch(cfg: DLRMConfig, n: int, batch_samples: int, *,
                            mode: str = "inference",
                            sharding: Optional[str] = None,
                            exchange: str = "partial_pool",
                            hit_ratio: float = 0.0,
                            compress_grads: bool = False
                            ) -> Tuple[int, Dict[int, float]]:
    """Planner-depth for ONE compiled batch shape.

    The planner picks `PlanReport.pipeline_depth` once from
    `cfg.batch_size`, but a ServeSession's flushed batches vary with load
    — a deadline flush can be a fraction of the capacity batch, where the
    latency-replay cost of deep pipelining dominates. This re-runs the
    executed-schedule sweep (`perf_model.optimal_pipeline_depth`) at the
    ACTUAL flushed sample count so each compiled shape executes the depth
    that wins for it. Returns (best_depth, {depth: t_step_s}).
    """
    from repro_torch.core import perf_model

    shape_cfg = dataclasses.replace(
        cfg, batch_size=int(batch_samples),
        sharding=sharding if sharding is not None else cfg.sharding)
    hybrid = dataclasses.replace(perf_model.recspeed_hybrid_system(),
                                 n_chips=n)
    return perf_model.optimal_pipeline_depth(
        shape_cfg, hybrid, mode, row_wise_exchange=exchange,
        hit_ratio=hit_ratio, compress_grads=compress_grads)
