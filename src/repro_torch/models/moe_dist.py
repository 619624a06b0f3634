"""Distributed MoE dispatch over k ranks (the reference's
``src/repro/models/moe_dist.py``).

The reference runs each body under a ``shard_map`` manual over the batch
axes and "model"; here each rank runs it on its own part, through the
collectives of ``parallel.primitives`` under autograd. Outside the MoE a
rank holds its rows of the batch (B / |batch axes|, T, d), replicated
over "model", so each body enters through ``shard_in`` (the rank's slice
of T, the reference's ``P(batch_axes, "model", None)``: a rank's tokens
are its rows times its slice of T, in that order) and leaves through
``gather_out``. The router enters through ``replicate_in``; the expert
weights a body reads sharded are stored as this rank's shard
(``weight_layout``; ``models.transformer.init_model(sharder=)`` and
``convert.local_lm_params`` make them).

``moe_block_local_dispatch`` (the reference's FIX 1): the tokens
all-gathered over "model" along T, the dispatch and the experts on this
rank's 1/M of d_ff, the partial outputs combined first and
reduce-scattered back: ~2 n d elements of wire a layer, as a dense
Megatron TP layer.

``moe_block_ep_a2a`` (FIX 2): tokens hop to their expert's owner over
"model" by all-to-all, the experts run dense local einsums, results hop
back and combine with the gates at the source. Wire bytes a rank and
layer ~ 2 C_out |model| d (the collective the paper builds its analysis
on: pooled-embedding exchange = MoE token exchange).

Both size capacity per shard (a floor of 8, and the ep receive buffer at
a factor of 1.0), so they may drop other copies than the global
formulation. Their odd-shape fallback (``moe_block_global``) is the
global formulation over the whole batch, as the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.common import Sharder
from repro_torch.parallel import primitives as P

EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")
# the ep body's send buffer: copies a rank sends each owner, over the mean
SEND_CAPACITY_FACTOR = 2.0
# the dim of each expert weight (E, d, ff) / (E, ff, d) a layout splits
SHARD_DIMS = {"experts": {"w_gate": 0, "w_up": 0, "w_down": 0},
              "ff": {"w_gate": 2, "w_up": 2, "w_down": 1}}


def _capacity(n_tokens: int, k: int, e: int, factor: float) -> int:
    return max(8, int(math.ceil(factor * n_tokens * k / e / 8.0)) * 8)


def weight_layout(cfg: ModelConfig, sharder: Sharder) -> Optional[str]:
    """How a rank holds a MoE layer's expert weights under ``sharder``:
    "experts" (E over "model": the ep body), "ff" (d_ff over "model":
    local dispatch) or None (whole: no mesh, the global formulation, or a
    d_ff that does not split)."""
    body = sharder.moe_body(cfg.moe.num_experts)
    M = sharder.model_size
    if body == "ep" and cfg.moe.num_experts % M == 0 and M > 1:
        return "experts"
    if body is not None and cfg.d_ff % M == 0:
        return "ff"
    return None


def shard_spec(cfg: ModelConfig, sharder: Sharder
               ) -> Optional[Tuple[str, int, int]]:
    """(layout, this rank's place along "model", |model|) for
    ``layers.init_moe(shard=)``, or None where the weights are whole."""
    layout = weight_layout(cfg, sharder) if cfg.moe is not None else None
    if layout is None:
        return None
    return layout, sharder.model_rank, sharder.model_size


def sharded_leaves(tree, cfg: ModelConfig, sharder: Sharder) -> list:
    """The leaves of an LM tree (params or grads) that a rank holds as its
    shard over "model": each MoE layer's expert weights under a
    layout."""
    if cfg.moe is None or weight_layout(cfg, sharder) is None:
        return []
    return [unit["moe"][k] for unit in tree["units"] if "moe" in unit
            for k in EXPERT_WEIGHTS]


def whole_experts(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                  sharder: Sharder) -> Dict[str, torch.Tensor]:
    """``p`` with its expert weights whole, gathered over "model" by
    ``gather_out`` (each rank computes with them replicated, so a
    weight's grad is its slice of the whole cotangent)."""
    layout = weight_layout(cfg, sharder)
    if layout is None:
        return p
    group = sharder.model_group
    return {**p, **{k: P.gather_out(p[k], SHARD_DIMS[layout][k], group)
                    for k in EXPERT_WEIGHTS}}


def _odd(x: torch.Tensor, sharder: Sharder, d_ff: int = 0) -> bool:
    """The reference's fallback test on the global shapes: T, or (local
    dispatch) d_ff, does not split over "model". Its third condition, a
    global batch that does not split over the batch axes, cannot hold
    here: a rank holds B / |batch axes| rows (the session refuses a
    batch that does not divide)."""
    M = sharder.model_size
    return x.shape[1] % M != 0 or d_ff % M != 0


def moe_block_global(p: Dict[str, torch.Tensor], x: torch.Tensor,
                     cfg: ModelConfig, sharder: Sharder) -> torch.Tensor:
    """The global formulation over the whole batch (the reference's
    odd-shape fallback, and ``moe_impl="global"`` under a mesh: GSPMD's
    ``moe_block``, whose capacity counts every token): x all-gathered
    over the batch axes (backward: ``psum_scatter``), the expert weights
    gathered whole, ``layers.moe_global``, and this rank's rows kept
    (backward: zeros elsewhere)."""
    Bl = x.shape[0]
    x_all = P.ad_all_gather(x, 0, sharder.batch_group)
    y = L.moe_global(whole_experts(p, cfg, sharder), x_all, cfg)
    r = sharder.batch_rank
    return y[r * Bl:(r + 1) * Bl]


def moe_block_local_dispatch(p: Dict[str, torch.Tensor], x: torch.Tensor,
                             cfg: ModelConfig, sharder: Sharder
                             ) -> torch.Tensor:
    """FIX 1+2 of the reference: sequence-parallel TP MoE.

      x enters SEQUENCE-SHARDED over "model"  (B_l, T/M, d)
      -> all_gather over "model": the local token slab (n, d)
      -> dispatch + expert einsums on the LOCAL d_ff shard (E, C, ff/M)
      -> the down-projection's partial sums are LINEAR in the combine, so
         combine FIRST (y_partial (n, d)) and reduce-scatter back to
         sequence shards.

    x is this rank's rows (B_l, T, d), replicated over "model", and so is
    the result. Falls back to ``moe_block_global`` when T or d_ff does
    not split over "model"."""
    if _odd(x, sharder, cfg.d_ff):
        return moe_block_global(p, x, cfg, sharder)
    Bl, T, d = x.shape
    group = sharder.model_group
    x_loc = P.shard_in(x, 1, group)                       # (B_l, T/M, d)
    router = P.replicate_in(p["router"], group)
    xt = P.ad_all_gather(x_loc, 1, group).reshape(Bl * T, d)
    y_partial = L.moe_tokens(
        {**p, "router": router}, xt, cfg,
        _capacity(Bl * T, cfg.moe.top_k, cfg.moe.num_experts,
                  cfg.moe.capacity_factor), "local")
    # inverse of the entry all_gather: rank r keeps tokens [r Ts, (r+1) Ts)
    y = P.ad_psum_scatter(y_partial.reshape(Bl, T, d), 1, group)
    return P.gather_out(y, 1, group)


def moe_block_ep_a2a(p: Dict[str, torch.Tensor], x: torch.Tensor,
                     cfg: ModelConfig, sharder: Sharder) -> torch.Tensor:
    """Tokens hop to expert owners over "model" by all-to-all and back.

    Requirements: E % |model| == 0 (this rank holds experts [r E/M,
    (r+1) E/M)), |model| > 1, T divisible by |model|; falls back to
    ``moe_block_local_dispatch`` otherwise. Gates stay at the source;
    only token vectors and expert-local ids (int32) travel. Sends at most
    C_out = ``_capacity(n, K, M, SEND_CAPACITY_FACTOR)`` copies to each
    owner; each local expert takes at most C_in = ``_capacity(M C_out, 1,
    E_loc, 1.0)`` of what arrives."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    M = sharder.model_size
    if E % M != 0 or M == 1 or _odd(x, sharder):
        return moe_block_local_dispatch(p, x, cfg, sharder)
    E_loc = E // M
    group = sharder.model_group
    x_loc = P.shard_in(x, 1, group)                       # (B_l, T_l, d)
    Bl, Tl, d = x_loc.shape
    n = Bl * Tl
    dt, dev = x.dtype, x.device
    zero = torch.zeros((), dtype=dt, device=dev)
    xt = x_loc.reshape(n, d)
    gate, idx = L.route(xt, P.replicate_in(p["router"], group), K)
    dest = idx // E_loc                                   # owner (n, K)
    eloc = (idx % E_loc).to(torch.int32)

    # ---- pack per destination rank ----
    C_out = _capacity(n, K, M, SEND_CAPACITY_FACTOR)
    order, dest_s, pos, keep = L.pack_by_segment(dest.reshape(-1), M, C_out)
    L.count_dropped("ep_send", keep)
    tok_s = order // K
    send = torch.zeros((M, C_out, d), dtype=dt, device=dev).index_put(
        (dest_s, pos), torch.where(keep[:, None], xt[tok_s], zero),
        accumulate=True)
    minus = torch.full((), -1, dtype=torch.int32, device=dev)
    send_eid = torch.full((M * C_out,), -1, dtype=torch.int32,
                          device=dev).scatter_reduce(
        0, dest_s * C_out + pos,
        torch.where(keep, eloc.reshape(-1)[order], minus), "amax")

    # ---- the paper's collective: all-to-all over the model axis ----
    recv = P.ad_all_to_all(send, 0, 0, group).reshape(M * C_out, d)
    reid = P.all_to_all(send_eid.reshape(M, C_out), 0, 0,
                        group).reshape(M * C_out)

    # ---- local expert compute (capacity-pack by local expert id) ----
    C_in = _capacity(M * C_out, 1, E_loc, 1.0)
    valid = reid >= 0
    seg = torch.where(valid, reid, torch.full_like(reid, E_loc)).long()
    order2, seg_s, pos2, keep2 = L.pack_by_segment(seg, E_loc + 1, C_in)
    L.count_dropped("ep_recv", keep2 | (seg_s == E_loc))
    keep2 = keep2 & (seg_s < E_loc)
    seg_s = torch.where(keep2, seg_s, torch.zeros_like(seg_s))
    buf = torch.zeros((E_loc, C_in, d), dtype=dt, device=dev).index_put(
        (seg_s, pos2), torch.where(keep2[:, None], recv[order2], zero),
        accumulate=True)
    out_buf = L.expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"], cfg)

    # unpack to the received-slot order, send back
    y_recv = torch.zeros((M * C_out, d), dtype=dt, device=dev).index_put(
        (order2,), torch.where(keep2[:, None], out_buf[seg_s, pos2], zero),
        accumulate=True)
    y_back = P.ad_all_to_all(y_recv.reshape(M, C_out, d), 0, 0, group)

    # combine at the source with the gates
    contrib = torch.where(keep[:, None], y_back[dest_s, pos], zero)
    contrib = contrib * gate.reshape(-1)[order][:, None].to(dt)
    y = torch.zeros((n, d), dtype=dt, device=dev).index_add(0, tok_s,
                                                           contrib)
    return P.gather_out(y.reshape(Bl, Tl, d), 1, group)

