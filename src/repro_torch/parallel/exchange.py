"""EmbeddingExchange: where the tables live, and the forward that follows.

An exchange owns what depends on the tables' placement: which param keys
hold tables, the Alg. 1 forward (indices in, pooled embeddings out), and
whether the serve path may run as one fused gather -> pool -> interaction
kernel. The port carries two exchanges on one device: the table-wise one
(the paper's "unsharded" layout) and the planner's tiered one (fast and
bulk table groups, as placed by ``plan="auto"`` or a ``ShardingPlan``).
The distributed and row-wise exchanges are a later ROADMAP item (A6).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.core.planner import ShardingPlan
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.fused_serve import grouped_pos
from repro_torch.parallel.plan import plan_table_groups

Tables = Dict[str, torch.Tensor]


class EmbeddingExchange:
    """Base class; constructed against a concrete (cfg, n devices)."""

    table_keys: Tuple[str, ...] = ("tables",)

    def __init__(self, cfg: DLRMConfig, n: int):
        self.cfg = cfg
        self.n = n

    def forward(self, tables: Tables,
                indices: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """(B, T, L) indices -> ((B, T, d) pooled, backward context)."""
        raise NotImplementedError

    # A LOCAL exchange (every looked-up row on this device, no collectives
    # in the forward) can serve through the fused kernel, which never
    # writes the pooled (B, T, d) tensor to device memory.
    def supports_fused_forward(self) -> bool:
        return False

    def fused_forward(self, tables: Tables, bot_out: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
        """(B, d) bottom-MLP output + (B, T, L) indices -> the
        (B, top_mlp_in) interaction features, fused. Only valid when
        ``supports_fused_forward()`` is True."""
        raise NotImplementedError(
            f"{type(self).__name__} has no fused serve path")


class TableWiseExchange(EmbeddingExchange):
    """Paper "unsharded" on one device: every table whole and local."""

    def __init__(self, cfg: DLRMConfig, n: int = 1):
        if n != 1:
            raise NotImplementedError(
                f"table-wise exchange over {n} devices is not ported yet "
                f"(ROADMAP A6, distributed)")
        super().__init__(cfg, n)

    def forward(self, tables, indices):
        return dlrm_lib.embedding_bag(tables["tables"], indices), indices

    def supports_fused_forward(self) -> bool:
        return True

    def fused_forward(self, tables, bot_out, indices):
        return ops.fused_bag_interactions(tables["tables"], indices, bot_out)


class PlannedTieredExchange(EmbeddingExchange):
    """The planner's tier decisions executed on one device: the fast and
    the bulk table group each whole and local, under one exchange.

    At n=1 both groups are table-wise local (the reference runs the bulk
    group row-wise over the mesh, which on one device is the whole table),
    so the forward has no collectives and the fused kernel serves it. The
    table permutation and the kernel's slot map are device tensors built
    once here, on ``device`` (None = the card), not once per batch."""

    table_keys = ("tables_fast", "tables_bulk")

    def __init__(self, cfg: DLRMConfig, n: int, plan: ShardingPlan,
                 device: DeviceArg = None):
        if n != 1:
            raise NotImplementedError(
                f"the tiered exchange over {n} devices is not ported yet "
                f"(ROADMAP A6, distributed)")
        super().__init__(cfg, n)
        device = resolve_device(device)
        self.groups = plan_table_groups(plan, n)
        self.inv_perm = self.groups.inv_perm
        perm = self.groups.fast_ids + self.groups.bulk_ids
        self._perm = torch.as_tensor(perm, dtype=torch.long, device=device)
        self._inv = torch.as_tensor(self.inv_perm, dtype=torch.long,
                                    device=device)
        self._pos = grouped_pos(self.inv_perm, device)

    def forward(self, tables, indices):
        """Pool each group, concatenate, restore the original table order
        (``planned_forward`` of the reference at n=1)."""
        n_fast = len(self.groups.fast_ids)
        idx = indices.index_select(1, self._perm)
        parts = []
        if n_fast:
            parts.append(dlrm_lib.embedding_bag(tables["tables_fast"],
                                                idx[:, :n_fast]))
        if self.groups.bulk_ids:
            parts.append(dlrm_lib.embedding_bag(tables["tables_bulk"],
                                                idx[:, n_fast:]))
        return torch.cat(parts, dim=1).index_select(1, self._inv), indices

    def supports_fused_forward(self) -> bool:
        return True

    def fused_forward(self, tables, bot_out, indices):
        return ops.fused_grouped_bag_interactions(
            tables["tables_fast"], tables["tables_bulk"],
            indices.index_select(1, self._perm), bot_out,
            inv_perm=self.inv_perm, pos=self._pos)


def make_exchange(cfg: DLRMConfig, n: int = 1, *,
                  plan: Optional[ShardingPlan] = None,
                  device: DeviceArg = None) -> EmbeddingExchange:
    """The exchange for a config on ``n`` devices: a placed plan dictates
    the tiered exchange (built on ``device``, None = the card); otherwise
    ``cfg.sharding`` picks the layout. Resolves one device and raises for
    more."""
    if plan is not None and plan.placements:
        return PlannedTieredExchange(cfg, n, plan, device)
    if cfg.sharding != "table_wise":
        raise NotImplementedError(
            f"sharding={cfg.sharding!r} is not ported yet (ROADMAP A6, "
            f"distributed); this slice serves table_wise configs")
    return TableWiseExchange(cfg, n)
