"""Public kernel entry points, dispatched by the tensors' device.

A CUDA tensor launches the hand-written kernel, and a failed build or
launch raises. A CPU tensor runs the plain version in ``kernels.ref``.
Nothing else selects the path: there is no environment switch and no
fallback from the kernel to the plain version.

``launch_counts`` counts, per kernel, the launches made through these
entry points, so a run can show that its main path went through the
kernel. Direct calls of a kernel's wrapper (as when it is held against
its plain version) are not counted.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import attention
from repro_torch.kernels import embedding_bags as bag_kernels
from repro_torch.kernels import feature_interactions, fused_serve, ref

launch_counts: Dict[str, int] = {
    "fused_bag_interactions": 0,
    "fused_cached_bag_interactions": 0,
    "fused_grouped_bag_interactions": 0,
    "embedding_bag": 0,
    "cached_embedding_bag": 0,
    "embedding_bag_blocked": 0,
    "interactions": 0,
    "flash_attention": 0,
    "flash_decode": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _no_path(op: str, t: torch.Tensor) -> ValueError:
    return ValueError(f"{op}: no path for tables on {t.device}")


def embedding_bag(tables: torch.Tensor,
                  indices: torch.Tensor) -> torch.Tensor:
    """(T, R, d) x (B, T, L) -> (B, T, d) pooled, fp32; one launch on the
    card."""
    if tables.device.type == "cuda":
        out = bag_kernels.embedding_bag(tables, indices)
        launch_counts["embedding_bag"] += 1
        return out
    if tables.device.type == "cpu":
        return ref.embedding_bag_ref(tables, indices)
    raise _no_path("embedding_bag", tables)


def embedding_bag_blocked(tables: torch.Tensor, indices: torch.Tensor, *,
                          lblk: int = 8) -> torch.Tensor:
    """(T, R, d) x (B, T, L) -> (B, T, d) pooled, fp32, read ``lblk``
    consecutive rows at a time when the stream is aligned; one launch on
    the card. L % lblk != 0 raises ValueError."""
    if tables.device.type == "cuda":
        out = bag_kernels.embedding_bag_blocked(tables, indices, lblk=lblk)
        launch_counts["embedding_bag_blocked"] += 1
        return out
    if tables.device.type == "cpu":
        return ref.embedding_bag_blocked_ref(tables, indices, lblk)
    raise _no_path("embedding_bag_blocked", tables)


def cached_embedding_bag(fast: torch.Tensor, bulk: torch.Tensor,
                         fast_idx: torch.Tensor,
                         bulk_idx: torch.Tensor) -> torch.Tensor:
    """Two-tier cached bag: (T, S+1, d) x (T, R+1, d) x 2 x (B, T, L)
    pre-translated slots -> (B, T, d) pooled, fp32; one launch on the
    card. A 2-D bulk (R+1, d) is one tier that every table reads, as the
    (T, R+1, d) tier ``bulk[None].expand(T, -1, -1)``. Shapes that
    disagree raise ValueError."""
    if fast.device.type == "cuda":
        out = bag_kernels.cached_embedding_bag(fast, bulk, fast_idx,
                                               bulk_idx)
        launch_counts["cached_embedding_bag"] += 1
        return out
    if fast.device.type == "cpu":
        bag_kernels.cached_shapes("cached_embedding_bag", fast, bulk,
                                  fast_idx, bulk_idx)
        if bulk.dim() == 2:
            bulk = bulk[None].expand(fast.shape[0], -1, -1)
        return ref.cached_embedding_bag_ref(fast, bulk, fast_idx, bulk_idx)
    raise _no_path("cached_embedding_bag", fast)


def interactions(bot_out: torch.Tensor,
                 pooled: torch.Tensor) -> torch.Tensor:
    """(B, d) x (B, T, d) -> (B, d + (T+1)T/2) fp32; one launch on the
    card."""
    if pooled.device.type == "cuda":
        out = feature_interactions.interactions(bot_out, pooled)
        launch_counts["interactions"] += 1
        return out
    if pooled.device.type == "cpu":
        return ref.interactions_ref(bot_out, pooled)
    raise _no_path("interactions", pooled)


def fused_bag_interactions(tables: torch.Tensor, indices: torch.Tensor,
                           bot_out: torch.Tensor) -> torch.Tensor:
    """(T, R, d) x (B, T, L) x (B, d) -> (B, d + (T+1)T/2) fp32 fused
    gather -> pool -> interaction features; one launch on the card."""
    if tables.device.type == "cuda":
        out = fused_serve.fused_bag_interactions(tables, indices, bot_out)
        launch_counts["fused_bag_interactions"] += 1
        return out
    if tables.device.type == "cpu":
        return ref.fused_bag_interactions_ref(tables, indices, bot_out)
    raise _no_path("fused_bag_interactions", tables)


def fused_cached_bag_interactions(fast: torch.Tensor, bulk: torch.Tensor,
                                  fast_idx: torch.Tensor,
                                  bulk_idx: torch.Tensor,
                                  bot_out: torch.Tensor) -> torch.Tensor:
    """Two-tier fused serve path: (T, S+1, d) x (T, R+1, d) x 2 x (B, T, L)
    x (B, d) -> (B, d + (T+1)T/2) fp32 interaction features; one launch on
    the card."""
    if fast.device.type == "cuda":
        out = fused_serve.fused_cached_bag_interactions(
            fast, bulk, fast_idx, bulk_idx, bot_out)
        launch_counts["fused_cached_bag_interactions"] += 1
        return out
    if fast.device.type == "cpu":
        return ref.fused_cached_bag_interactions_ref(fast, bulk, fast_idx,
                                                     bulk_idx, bot_out)
    raise _no_path("fused_cached_bag_interactions", fast)


def fused_grouped_bag_interactions(tables_fast: torch.Tensor,
                                   tables_bulk: torch.Tensor,
                                   indices_perm: torch.Tensor,
                                   bot_out: torch.Tensor, *, inv_perm,
                                   pos: torch.Tensor) -> torch.Tensor:
    """Tiered-plan fused serve path: (Tf, Rf, d) + (Tb, Rb, d) table groups,
    indices (B, Tf+Tb, L) pre-permuted to concat(fast, bulk) order, output
    (B, d + (T+1)T/2) in the original table order; one launch on the card.

    ``inv_perm`` is the plan's ``PlanGroups.inv_perm`` and ``pos`` its
    ``fused_serve.grouped_pos(inv_perm, device)``, built once by the
    caller (the tiered exchange); the card reads ``pos``, the plain
    version ``inv_perm``."""
    if bot_out.device.type == "cuda":
        out = fused_serve.fused_grouped_bag_interactions(
            tables_fast, tables_bulk, indices_perm, bot_out, pos)
        launch_counts["fused_grouped_bag_interactions"] += 1
        return out
    if bot_out.device.type == "cpu":
        return ref.fused_grouped_bag_interactions_ref(
            tables_fast, tables_bulk, indices_perm, bot_out, inv_perm)
    raise _no_path("fused_grouped_bag_interactions", bot_out)


def fused_grouped_bag_interactions_unpermuted(
        tables_fast: torch.Tensor, tables_bulk: torch.Tensor,
        indices: torch.Tensor, bot_out: torch.Tensor, *, inv_perm,
        src: torch.Tensor) -> torch.Tensor:
    """``fused_grouped_bag_interactions`` on indices (B, Tf+Tb, L) in the
    ORIGINAL table order: the kernel walks the tables in that order, so
    the ids are never permuted; counted as a launch of
    ``fused_grouped_bag_interactions``, the same kernel.

    ``src`` is ``fused_serve.grouped_src(inv_perm, device)``, built once by
    the caller (the tiered exchange); the card reads ``src``, the plain
    version ``inv_perm``."""
    if bot_out.device.type == "cuda":
        out = fused_serve.fused_grouped_bag_interactions_unpermuted(
            tables_fast, tables_bulk, indices, bot_out, src)
        launch_counts["fused_grouped_bag_interactions"] += 1
        return out
    if bot_out.device.type == "cpu":
        return ref.fused_grouped_bag_interactions_unpermuted_ref(
            tables_fast, tables_bulk, indices, bot_out, inv_perm)
    raise _no_path("fused_grouped_bag_interactions", bot_out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """(B, T, Hq, hd) x (B, S, Hkv, hd)^2 -> (B, T, Hq, hd) in q's dtype;
    one launch on the card, which picks its own tiles."""
    if q.device.type == "cuda":
        out = attention.flash_attention(q, k, v, causal=causal, window=window)
        launch_counts["flash_attention"] += 1
        return out
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    raise _no_path("flash_attention", q)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """(B, Hq, hd) x (B, S, Hkv, hd)^2 x (B,) -> (B, Hq, hd) in q's dtype;
    one launch on the card."""
    if q.device.type == "cuda":
        out = attention.flash_decode(q, k_cache, v_cache, lengths)
        launch_counts["flash_decode"] += 1
        return out
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k_cache, v_cache, lengths)
    raise _no_path("flash_decode", q)
