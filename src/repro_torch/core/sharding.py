"""Distributed DLRM: the legacy namespace over ``repro_torch.parallel``
(the reference's ``src/repro/core/sharding.py``).

  repro_torch.parallel.primitives - the collectives of Alg. 1/2
                                    (table_wise_*, row_wise_*)
  repro_torch.parallel.plan       - PlanGroups, reconcile, param split/merge
  repro_torch.parallel.updates    - sgd_row_update / adagrad_row_update
  repro_torch.parallel.exchange   - the EmbeddingExchange strategies
  repro_torch.parallel.build      - build_step, the one composition of
                                    exchange, dense compute, grad
                                    all-reduce and sparse update

This module keeps the historical import names and the two legacy
factories as thin wrappers over ``build_step``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.planner import ShardingPlan
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import (  # noqa: F401
    EmbeddingExchange, PlanGroups, PlannedTieredExchange, RowWiseExchange,
    TableWiseExchange, adagrad_row_update, build_step, init_dlrm_opt_state,
    init_error_feedback, make_exchange, merge_dlrm_params_by_plan,
    plan_table_groups, planned_forward, reconcile_plan_with_mesh,
    row_wise_backward_update, row_wise_expand_grads, row_wise_forward,
    sgd_row_update, shard_dlrm_params, split_dlrm_params_by_plan,
    table_wise_backward_update, table_wise_expand_grads, table_wise_forward)
from repro_torch.parallel.primitives import (  # noqa: F401
    _divisor_chunk, _masked_partial_pool, _masked_rows)

# Historical private aliases (pre-refactor helper names).
_table_wise_expand_grads = table_wise_expand_grads
_row_wise_expand_grads = row_wise_expand_grads

Axis = Union[str, Tuple[str, ...]]


def make_dlrm_train_step(
    cfg: DLRMConfig,
    mesh: Optional[Mesh] = None,
    axis: Axis = ("data", "model"),
    lr: float = 0.01,
    row_wise_exchange: str = "partial_pool",
    optimizer: str = "sgd",
    dp_axes: Tuple[str, ...] = (),
    plan: Optional[ShardingPlan] = None,
    pipeline_depth: int = 1,
    compress_grads: bool = False,
    device=None,
) -> Callable:
    """Legacy name for ``build_step(mode="train")``: ``step(params,
    opt_state, dense, indices, labels) -> (params, opt_state, loss)``,
    Algorithms 1 + 2 end to end. With a placed ``plan``, the planner's
    per-table tiers are executed (the tiered exchange, built on
    ``device``)."""
    return build_step(cfg, mesh, mode="train", axis=axis, plan=plan,
                      row_wise_exchange=row_wise_exchange,
                      optimizer=optimizer, lr=lr, dp_axes=dp_axes,
                      pipeline_depth=pipeline_depth,
                      compress_grads=compress_grads, device=device)


def make_dlrm_serve_step(
    cfg: DLRMConfig,
    mesh: Optional[Mesh] = None,
    axis: Axis = ("data", "model"),
    row_wise_exchange: str = "partial_pool",
    dp_axes: Tuple[str, ...] = (),
    plan: Optional[ShardingPlan] = None,
    pipeline_depth: int = 1,
    device=None,
) -> Callable:
    """Legacy name for ``build_step(mode="serve")``: ``serve(params,
    dense, indices) -> probs (B,)``, Alg. 1 + sigmoid, the paper's
    inference query (Sec. III-B), through the fused kernel where the
    exchange allows it (one rank)."""
    return build_step(cfg, mesh, mode="serve", axis=axis, plan=plan,
                      row_wise_exchange=row_wise_exchange, dp_axes=dp_axes,
                      pipeline_depth=pipeline_depth, device=device)
