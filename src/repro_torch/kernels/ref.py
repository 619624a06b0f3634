"""Plain PyTorch versions of the hand-written kernels (the correctness
contract).

Each ``*_ref`` mirrors ``repro.kernels.ref`` in signature and semantics:
tables may be fp32 or bf16, and every sum accumulates in fp32. The CPU
path of ``kernels.ops`` runs these, and the kernels are held against them
on the card.
"""
from __future__ import annotations

import math
from typing import Optional

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


def blocked_stream_aligned(indices: torch.Tensor, lblk: int,
                           n_rows: Optional[int] = None) -> torch.Tensor:
    """0-dim bool tensor: every L-block of ``lblk`` lookups is exactly the
    consecutive rows [k*lblk, (k+1)*lblk) for some k (the reference's
    predicate, ``repro.kernels.embedding_bag.blocked_stream_aligned``).
    With ``n_rows`` every block must also lie inside [0, n_rows): a block
    past the table is not aligned."""
    B, T, L = indices.shape
    blocks = indices.reshape(B, T, L // lblk, lblk)
    base = blocks[..., :1]
    expect = base + torch.arange(lblk, dtype=indices.dtype,
                                 device=indices.device)
    ok = (base % lblk == 0).all() & (blocks == expect).all()
    if n_rows is not None:
        ok &= ((base >= 0) & (base + lblk <= n_rows)).all()
    return ok


def embedding_bag_blocked_ref(tables: torch.Tensor, indices: torch.Tensor,
                              lblk: int = 8) -> torch.Tensor:
    """The blocked bag: on a stream aligned inside the tables
    (``blocked_stream_aligned(indices, lblk, R)``), each L-block's rows
    summed in the tables' dtype, then the block sums in L order in fp32;
    on any other stream ``embedding_bag_ref``. tables (T, R, d), indices
    (B, T, L) with L % lblk == 0 -> (B, T, d) fp32."""
    T, R, _ = tables.shape
    B, _, L = indices.shape
    if lblk < 1 or L % lblk:
        raise ValueError(f"embedding_bag_blocked: lblk={lblk} must be >= 1 "
                         f"and divide the lookups a bag (L={L})")
    if not bool(blocked_stream_aligned(indices, lblk, R)):
        return embedding_bag_ref(tables, indices)
    base = indices.reshape(B, T, L // lblk, lblk)[..., 0].long()
    t = torch.arange(T, device=tables.device)[None, :, None, None]
    rows = base[..., None] + torch.arange(lblk, device=tables.device)
    # a block's sum is taken in the tables' dtype (one rounding for bf16,
    # as the reference's ``rows_ref[...].sum(axis=1)``), the blocks in fp32
    return tables[t, rows].sum(dim=3).float().sum(dim=2)


def cached_embedding_bag_ref(fast: torch.Tensor, bulk: torch.Tensor,
                             fast_idx: torch.Tensor,
                             bulk_idx: torch.Tensor) -> torch.Tensor:
    """Two-tier cached bag: fast (T, S+1, d) hot rows + zero miss slot,
    bulk (T, R+1, d) full tables + zero hit slot, pre-translated indices
    (B, T, L) -> pooled (B, T, d) fp32: the two pools added. Exactly one of
    the two rows a lookup reads is a zero pad, so this is the exact bag."""
    return embedding_bag_ref(fast, fast_idx) + embedding_bag_ref(bulk,
                                                                 bulk_idx)


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


def fused_cached_bag_interactions_ref(fast: torch.Tensor, bulk: torch.Tensor,
                                      fast_idx: torch.Tensor,
                                      bulk_idx: torch.Tensor,
                                      bot_out: torch.Tensor) -> torch.Tensor:
    """Two-tier composed version: the cached bag, then interactions."""
    return interactions_ref(
        bot_out, cached_embedding_bag_ref(fast, bulk, fast_idx, bulk_idx))


def fused_grouped_bag_interactions_ref(tables_fast: torch.Tensor,
                                       tables_bulk: torch.Tensor,
                                       indices_perm: torch.Tensor,
                                       bot_out: torch.Tensor,
                                       inv_perm) -> torch.Tensor:
    """Tiered-plan composed version: pool the fast (Tf, Rf, d) and bulk
    (Tb, Rb, d) table groups separately (indices (B, Tf+Tb, L) already in
    concat(fast, bulk) order), restore the original table order through
    ``inv_perm`` (a sequence of ints or an int tensor), then interactions —
    ``parallel.exchange.planned_forward`` at n=1."""
    Tf = tables_fast.shape[0]
    parts = []
    if Tf:
        parts.append(embedding_bag_ref(tables_fast, indices_perm[:, :Tf]))
    if tables_bulk.shape[0]:
        parts.append(embedding_bag_ref(tables_bulk, indices_perm[:, Tf:]))
    pooled = torch.cat(parts, dim=1)
    inv = torch.as_tensor(inv_perm, dtype=torch.long, device=pooled.device)
    return interactions_ref(bot_out, pooled.index_select(1, inv))


def fused_grouped_bag_interactions_unpermuted_ref(
        tables_fast: torch.Tensor, tables_bulk: torch.Tensor,
        indices: torch.Tensor, bot_out: torch.Tensor,
        inv_perm) -> torch.Tensor:
    """``fused_grouped_bag_interactions_ref`` on indices (B, Tf+Tb, L) in
    the ORIGINAL table order: permuted to concat(fast, bulk) order first
    (concat position k holds the table t with inv_perm[t] == k)."""
    inv = torch.as_tensor(inv_perm, dtype=torch.long).cpu()
    perm = torch.argsort(inv).to(indices.device)
    return fused_grouped_bag_interactions_ref(
        tables_fast, tables_bulk, indices.index_select(1, perm), bot_out,
        inv_perm)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Naive softmax attention with GQA. q (B, T, Hq, hd), k/v (B, S, Hkv,
    hd) -> (B, T, Hq, hd): fp32 scores and sums, cast back to q's dtype.

    Query head h reads KV head h // (Hq // Hkv). Causal is top-left
    (kpos <= qpos, also when T != S); the window keeps qpos - kpos <
    window, with or without ``causal``. Masked scores are -1e30, so a row
    whose every key is masked weighs all S keys equally."""
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, T, Hkv, G, hd).float()
    s = torch.einsum("bthgd,bshd->bhgts", qr, k.float())
    s.div_(math.sqrt(hd))
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= qpos - kpos < window
    s.masked_fill_(~ok, -1e30)
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return out.reshape(B, T, Hq, hd).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention over a KV cache. q (B, Hq, hd), caches
    (B, S, Hkv, hd), lengths (B,) valid-prefix lengths -> (B, Hq, hd) in
    q's dtype, fp32 inside.

    A length above S acts as S. A length of 0 masks every key at -1e30,
    so the answer is the mean of v over all S rows."""
    B, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.float())
    s.div_(math.sqrt(hd))
    ok = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s.masked_fill_(~ok[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)
