"""build_step: the one composition of exchange + dense compute.

Serve mode returns ``step(params, dense, indices) -> probs (B,)`` over
``pipeline_depth`` micro-batches. With a fused-capable exchange (and
``fused=True``) each micro-batch runs bottom MLP -> fused gather -> pool
-> interaction kernel -> top MLP; otherwise the composed path pools
through ``exchange.forward`` and runs ``dlrm_forward_from_pooled``. The
micro-batches run in sequence on one device, so the result does not
depend on the depth. A placed plan selects the tiered exchange, whose
params are plan-split (``tables_fast``, ``tables_bulk``; see
``shard_dlrm_params``). Training steps come with a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.core.planner import ShardingPlan
from repro_torch.parallel.exchange import EmbeddingExchange, make_exchange
from repro_torch.parallel.plan import (plan_table_groups,
                                       split_dlrm_params_by_plan)

Params = Dict[str, object]


def shard_dlrm_params(params: Params,
                      plan: Optional[ShardingPlan] = None) -> Params:
    """Place DLRM params for the step on one device. With a placed
    ``plan``, stacked params ({"tables": ...}) are split into the plan's
    fast/bulk table groups (new tensors on the tables' device); params
    already split, or no placed plan, pass through unchanged."""
    if plan is not None and plan.placements and "tables" in params:
        params = split_dlrm_params_by_plan(params, plan_table_groups(plan, 1))
    return params


def _mb_slices(x: torch.Tensor, depth: int) -> List[torch.Tensor]:
    b = x.shape[0]
    if b % depth:
        raise ValueError(
            f"pipeline_depth={depth} must divide the batch ({b} samples); "
            f"pad the batch or lower the depth")
    return list(x.split(b // depth))


def build_step(cfg: DLRMConfig, *, mode: str = "serve",
               exchange: Optional[EmbeddingExchange] = None,
               pipeline_depth: int = 1, fused: bool = True) -> Callable:
    """Compose the exchange with the dense compute into one serve step.

    ``exchange`` defaults to ``make_exchange(cfg)``, the config's own
    layout; a planned session passes its tiered exchange. ``fused``: run the forward through the exchange's
    fused kernel when it supports one; ``fused=False`` forces the composed
    path. The returned step's ``serve_kernel`` attribute ("fused" or
    "composed") names the branch it runs."""
    if mode == "train":
        raise NotImplementedError(
            "training steps are not ported yet (ROADMAP A3, training)")
    if mode != "serve":
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    exch = exchange if exchange is not None else make_exchange(cfg)
    depth = int(pipeline_depth)
    if depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
    use_fused = bool(fused) and exch.supports_fused_forward()

    def serve(params: Params, dense: torch.Tensor,
              indices: torch.Tensor) -> torch.Tensor:
        tables = {k: params[k] for k in exch.table_keys}
        outs = []
        for den, idx in zip(_mb_slices(dense, depth),
                            _mb_slices(indices, depth)):
            if use_fused:
                bot = dlrm_lib.mlp_forward(params["bot_mlp"], den)
                z = exch.fused_forward(tables, bot, idx)
                logits = dlrm_lib.mlp_forward(params["top_mlp"], z)[:, 0]
            else:
                pooled, _ = exch.forward(tables, idx)
                logits = dlrm_lib.dlrm_forward_from_pooled(params, den,
                                                           pooled)
            outs.append(torch.sigmoid(logits))
        return outs[0] if depth == 1 else torch.cat(outs)

    serve.serve_kernel = "fused" if use_fused else "composed"
    return serve
