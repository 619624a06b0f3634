"""Plain PyTorch versions of the hand-written kernels (the correctness
contract).

Each ``*_ref`` mirrors ``repro.kernels.ref`` in signature and semantics:
tables may be fp32 or bf16, and every sum accumulates in fp32. The CPU
path of ``kernels.ops`` runs these, and the kernels are held against them
on the card.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(tables: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
    """tables (T, R, d), indices (B, T, L) -> pooled (B, T, d) fp32.

    Ids follow ``jnp.take``: a negative id counts from the end of the
    table, and an id outside [-R, R) gathers a row of NaN."""
    T, R, _ = tables.shape
    idx = indices.long()
    idx = torch.where(idx < 0, idx + R, idx)
    valid = (idx >= 0) & (idx < R)
    t = torch.arange(T, device=tables.device)[None, :, None]
    rows = tables[t, idx.clamp(0, R - 1)].float()          # (B, T, L, d)
    rows = rows.masked_fill(~valid[..., None], float("nan"))
    return rows.sum(dim=2)


def interactions_ref(bot_out: torch.Tensor,
                     pooled: torch.Tensor) -> torch.Tensor:
    """FM pairwise dot products (paper Sec. III-D), strict lower triangle
    in row-major order, concatenated after bot_out. bot_out (B, d),
    pooled (B, T, d) -> (B, d + (T+1)T/2) fp32."""
    T = pooled.shape[1]
    a = torch.cat([bot_out[:, None, :], pooled], dim=1).float()
    f = torch.bmm(a, a.transpose(1, 2))
    li, lj = torch.tril_indices(T + 1, T + 1, offset=-1, device=a.device)
    return torch.cat([bot_out.float(), f[:, li, lj]], dim=1)


def fused_bag_interactions_ref(tables: torch.Tensor, indices: torch.Tensor,
                               bot_out: torch.Tensor) -> torch.Tensor:
    """Composed gather -> pool -> interaction: exactly
    ``interactions_ref(bot_out, embedding_bag_ref(tables, indices))``."""
    return interactions_ref(bot_out, embedding_bag_ref(tables, indices))
