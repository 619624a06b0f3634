"""EmbeddingExchange: where the tables live, and the forward that follows.

An exchange owns what depends on the tables' placement: which param keys
hold tables, the Alg. 1 forward (indices in, pooled embeddings out), and
whether the serve path may run as one fused gather -> pool -> interaction
kernel. This slice of the port carries the single-device table-wise
exchange (the paper's "unsharded" layout on one device); the distributed,
row-wise and planned-tier exchanges are later ROADMAP items.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.kernels import ops

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


def make_exchange(cfg: DLRMConfig, n: int = 1, *,
                  plan: Optional[Any] = None) -> EmbeddingExchange:
    """The exchange for a config on ``n`` devices. This slice resolves the
    table-wise layout on one device and raises for the rest."""
    if plan is not None:
        raise NotImplementedError(
            "placed (tiered) plans are not ported yet (ROADMAP A4, planner "
            "and tiered serving)")
    if cfg.sharding != "table_wise":
        raise NotImplementedError(
            f"sharding={cfg.sharding!r} is not ported yet (ROADMAP A6, "
            f"distributed); this slice serves table_wise configs")
    return TableWiseExchange(cfg, n)
