"""Plan execution: the planner's per-table tier decisions -> runnable groups.

The placement planner (`core/planner.py`) decides WHERE each table lives
(fast tier near compute, or row-sharded bulk tier); this module turns those
decisions into the executable table grouping the tiered exchange consumes,
plus the param split/merge helpers that move between the stacked
({"tables": (T,R,d)}) and plan-grouped ({"tables_fast","tables_bulk"})
layouts.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.planner import ShardingPlan, TablePlacement

Params = Dict[str, Any]


@dataclass(frozen=True)
class PlanGroups:
    """Executable partition of the tables under a ShardingPlan.

    Fast-tier tables run table_wise (whole table near one processor's fast
    memory, pooled-row exchange only); bulk-tier tables run row_wise across
    the mesh — the paper's two extremes, MIXED per the planner's placement.
    """

    fast_ids: Tuple[int, ...]    # table_wise group (fast tier)
    bulk_ids: Tuple[int, ...]    # row_wise group (bulk tier)

    @property
    def inv_perm(self) -> Tuple[int, ...]:
        """Position of each original table in concat(fast, bulk) order."""
        perm = self.fast_ids + self.bulk_ids
        inv = [0] * len(perm)
        for pos, t in enumerate(perm):
            inv[t] = pos
        return tuple(inv)


def plan_table_groups(plan: ShardingPlan, n: int) -> PlanGroups:
    """Partition table ids by placement tier, honoring the hardware
    constraint that the fast group's table all-to-all divides the axis:
    the trailing `len(fast) % n` fast tables (highest table ids — a
    deterministic choice so every caller derives identical groups) are
    demoted to the bulk tier."""
    if not plan.placements:
        raise ValueError("plan has no placements; use plan_with_placement")
    fast = sorted(p.table_id for p in plan.placements if p.tier == "fast")
    bulk = sorted(p.table_id for p in plan.placements if p.tier != "fast")
    spill = len(fast) % n
    if spill:
        fast, demoted = fast[:-spill], fast[-spill:]
        bulk = sorted(bulk + demoted)
    return PlanGroups(tuple(fast), tuple(bulk))


def reconcile_plan_with_mesh(plan: ShardingPlan, n: int,
                             access_freq=None) -> ShardingPlan:
    """Fold the mesh-divisibility demotion into the plan itself, so its
    placements AND hit_ratio describe what the step factories will actually
    execute. With `access_freq` (per-table) the `len(fast) % n` spill is
    demoted COLDEST-first and the hit ratio recomputed exactly; without it
    the demotion falls back to `plan_table_groups`' id-order rule and the
    hit ratio is scaled by fast-table count. Running the step factories on
    the reconciled plan is a no-spill round trip either way."""
    fast = sorted(p.table_id for p in plan.placements if p.tier == "fast")
    spill = len(fast) % n
    if spill and access_freq is not None:
        freq = np.asarray(access_freq, np.float64)
        keep = sorted(sorted(fast, key=lambda t: freq[t])[spill:])
        fast_set = set(keep)
    else:
        fast_set = set(plan_table_groups(plan, n).fast_ids)
    placements = tuple(
        p if (p.table_id in fast_set) == (p.tier == "fast")
        else TablePlacement(p.table_id, "bulk", "row_wise", None)
        for p in plan.placements)
    n_fast_planned = len(fast)
    if access_freq is not None:
        freq = np.asarray(access_freq, np.float64)
        total = float(freq.sum())
        hit = (float(sum(freq[t] for t in fast_set)) / total
               if total > 0 else 0.0)
    elif n_fast_planned:
        hit = plan.hit_ratio * len(fast_set) / n_fast_planned
    else:
        hit = plan.hit_ratio
    return replace(plan, placements=placements, hit_ratio=hit)


def split_dlrm_params_by_plan(params: Params, groups: PlanGroups) -> Params:
    """Stacked-table params {"tables": (T, R, d)} -> plan-grouped params
    {"tables_fast": (Tf, R, d), "tables_bulk": (Tb, R, d)}: each group a
    new contiguous tensor on the tables' device (a copy, as in the
    reference); the MLP layers are shared, not copied."""
    tables = params["tables"]

    def take(ids: Tuple[int, ...]) -> torch.Tensor:
        return tables.index_select(
            0, torch.as_tensor(ids, dtype=torch.long, device=tables.device))

    return {
        "bot_mlp": params["bot_mlp"], "top_mlp": params["top_mlp"],
        "tables_fast": take(groups.fast_ids),
        "tables_bulk": take(groups.bulk_ids),
    }


def split_dlrm_params_in_place(params: Params, groups: PlanGroups) -> Params:
    """``split_dlrm_params_by_plan`` without a second copy of the tables:
    the stacked (T, R, d) tables are permuted IN PLACE into concat(fast,
    bulk) order, one table at a time through a one-table buffer, and the
    two groups are views of them. For params the caller owns and gives
    up (a fresh init): at full width the copy would be another 21.5 GB."""
    tables = params["tables"]
    perm = groups.fast_ids + groups.bulk_ids        # new slot i <- perm[i]
    done = [False] * len(perm)
    for start in range(len(perm)):
        if done[start] or perm[start] == start:
            continue
        held = tables[start].clone()
        i = start
        while True:
            done[i] = True
            src = perm[i]
            if src == start:
                tables[i].copy_(held)
                break
            tables[i].copy_(tables[src])
            i = src
    n_fast = len(groups.fast_ids)
    return {
        "bot_mlp": params["bot_mlp"], "top_mlp": params["top_mlp"],
        "tables_fast": tables[:n_fast], "tables_bulk": tables[n_fast:],
    }


def merge_dlrm_params_by_plan(params: Params, groups: PlanGroups) -> Params:
    """Inverse of `split_dlrm_params_by_plan` (checkpoint / equivalence)."""
    both = torch.cat([params["tables_fast"], params["tables_bulk"]], 0)
    inv = torch.as_tensor(groups.inv_perm, dtype=torch.long,
                          device=both.device)
    return {
        "bot_mlp": params["bot_mlp"], "top_mlp": params["top_mlp"],
        "tables": both.index_select(0, inv),
    }
