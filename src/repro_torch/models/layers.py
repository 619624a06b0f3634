"""Core transformer layers: norms, RoPE, GQA/SWA attention (prefill and
training through row 8, cached decode through row 9), SwiGLU MLP and
sort-based capacity MoE (its distributed bodies in ``models.moe_dist``).

As the reference (``repro.models.layers``): plain functions over dict
params made by the matching ``init_*`` functions, the reference's layouts
at every public function. The reference computes attention in jnp
(``blockwise_attention``, ``decode_attention``); the port sends it through
the hand-written kernels of ``kernels.ops``:

  * self-attention and cross-attention -> ``ops.flash_attention`` (row 8).
    The reference's blockwise masks come from positions ``arange(T)`` on
    these paths, which are the kernel's index masks;
  * cached decode -> ``ops.flash_decode`` (row 9) over each cache's valid
    prefix, ``lengths = (pos >= 0).sum(-1)``. Slots fill in order (prefill
    writes ``positions % S``, decode ``cache_pos % S``) and a ring is never
    longer than the window, so the valid slots are a prefix and all lie in
    the window: the reference's position mask keeps exactly them.

Training differentiates row 8 through ``FlashAttention``, whose backward is
plain torch (the TPU kernel has none; the reference differentiates jnp).

Decode writes the new K/V into the cache tensors in place (the reference
returns new arrays): at decode_32k a copy a step would double the cache.

The ``*_spmd`` sublayers are the spec-driven executor's
(``models.common.Sharder(specs=)``): the pre-norm of a residual stream
split along d (``rms_norm_spmd``), column- and row-parallel attention
(whole heads, or gathered where a rank's columns split a head), decode
over a cache split along S (row 9's log-sum-exp combines the ranks'
slices, ``combine_slices``), the MLP and the vocabulary-parallel
embedding.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (COMPUTE_DTYPE, NULL_SHARDER,
                                       Sharder, dense_init, init_leaf)
from repro_torch.op_stream import host_work
from repro_torch.parallel import primitives as P


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """fp32 variance, then the cast back to ``x.dtype`` before the weight."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def init_rms_norm(d: int, device=None, lead: Tuple[int, ...] = ()
                  ) -> torch.Tensor:
    return torch.ones(tuple(lead) + (d,), dtype=torch.float32,
                      device=device)


# -------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., T, H, hd); positions: (..., T). Rotates INTERLEAVED pairs
    (even, odd), not halves; none at ``theta <= 0``."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., :, None].float() * freqs        # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------- attention
def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    lead = tuple(lead)
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(cfg.n_heads * hd,), bk=(cfg.n_kv_heads * hd,),
                      bv=(cfg.n_kv_heads * hd,))
    return {n: init_leaf(generator, n, lead + s, cfg.n_layers)
            for n, s in shapes.items()}


# fp32 scores a temporary of the attention backward holds: 2^25 (128 MB)
# on the one-rank path; 2^29 (2 GB) on the spec-driven executor's, whose
# train cells spent most of their eager ops in 128 MB blocks (PERF.md
# section 6) and have room for the larger ones at their peaks.
BACKWARD_SCORES = 1 << 25
SPMD_BACKWARD_SCORES = 1 << 29


def _backward_block(B: int, Hq: int, T: int, S: int,
                    scores: int = BACKWARD_SCORES) -> int:
    """Query rows the backward takes at once: ~``scores`` fp32 scores a
    temporary."""
    return max(1, min(T, scores // max(1, B * Hq * S)))


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, causal: bool,
                       window: Optional[int],
                       scores: int = BACKWARD_SCORES
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``ops.flash_attention`` in plain torch: the softmax
    recomputed a query block of ~``scores`` fp32 scores at a time (no (B,
    H, T, S) tensor is held whole), dq, dk, dv summed over each GQA group,
    each in its input's dtype."""
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, T, Hq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, S, Hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kpos = torch.arange(S, device=q.device)[None, :]
    bq = _backward_block(B, Hq, T, S, scores)
    for t0 in range(0, T, bq):
        t1 = min(T, t0 + bq)
        qb = q[:, t0:t1].reshape(B, t1 - t0, Hkv, G, hd).float()
        do = dout[:, t0:t1].reshape(B, t1 - t0, Hkv, G, hd).float()
        s = torch.einsum("bthgd,bshd->bhgts", qb, kf) * scale
        qpos = torch.arange(t0, t1, device=q.device)[:, None]
        ok = torch.ones((t1 - t0, S), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= qpos - kpos < window
        s.masked_fill_(~ok, -1e30)
        p = torch.softmax(s, dim=-1)
        del s
        dv += torch.einsum("bhgts,bthgd->bshd", p, do)
        dp = torch.einsum("bthgd,bshd->bhgts", do, vf)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        del p, dp
        dq[:, t0:t1] = (torch.einsum("bhgts,bshd->bthgd", ds, kf)
                        * scale).reshape(B, t1 - t0, Hq, hd)
        dk += torch.einsum("bhgts,bthgd->bshd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Row 8 under autograd: the forward is ``ops.flash_attention`` (the
    kernel on the card, its plain version on the CPU), the backward
    ``attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scores):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.scores = causal, window, scores
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, dout.contiguous(), ctx.causal,
                                    ctx.window, ctx.scores), None, None,
                None)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, window: Optional[int] = None,
           scores: int = BACKWARD_SCORES) -> torch.Tensor:
    """q (B, T, Hq, hd), k, v (B, S, Hkv, hd) -> (B, T, Hq, hd) through
    row 8, differentiable when autograd asks for it (the backward's
    blocks of ~``scores`` fp32 scores)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, scores)
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def attention_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    positions: torch.Tensor, cfg: ModelConfig,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_pos=None,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    causal: bool = True, collect_kv: bool = False,
                    ) -> Tuple[torch.Tensor,
                               Optional[Dict[str, torch.Tensor]]]:
    """Full attention sublayer (no residual/norm).

    Modes:
      cache is None, kv_override None      -> self-attention over x (train /
                                              prefill), row 8; ``positions``
                                              are consecutive (the masks are
                                              the kernel's index masks)
      cache given (decode)                 -> write x's k/v at ``cache_pos``
                                              (in place), attend, row 9
      kv_override given (cross-attention)  -> attend to the (k, v) memory,
                                              non-causal, row 8
    Returns (out, new_cache); with collect_kv=True (prefill), new_cache is
    {"k": (B,T,Hkv,hd), "v": ...}, the post-RoPE K/V for cache seeding.
    """
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, T, cfg.n_heads, hd)

    if kv_override is None:
        k = x @ p["wk"].to(x.dtype)
        v = x @ p["wv"].to(x.dtype)
        if "bk" in p:
            k = k + p["bk"].to(x.dtype)
            v = v + p["bv"].to(x.dtype)
        k = k.reshape(B, T, cfg.n_kv_heads, hd)
        v = v.reshape(B, T, cfg.n_kv_heads, hd)
        pos = positions[None, :].expand(B, T)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    else:
        k, v = kv_override

    new_cache = None
    if cache is not None and kv_override is None:
        S = cache["k"].shape[1]
        cp = int(cache_pos)
        slot = cp % S if (cfg.sliding_window is not None
                          and S < 2**20) else cp
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][:, slot] = cp
        new_cache = cache
        lengths = (cache["pos"] >= 0).sum(dim=-1)
        out = ops.flash_decode(q[:, 0].contiguous(), cache["k"], cache["v"],
                               lengths)[:, None]
    elif kv_override is not None:
        out = attend(q, k, v, causal=False, window=None)
    else:
        out = attend(q, k, v, causal=causal, window=cfg.sliding_window)
        if collect_kv:
            new_cache = {"k": k, "v": v}

    out = out.reshape(B, T, cfg.n_heads * hd)
    return out @ p["wo"].to(x.dtype), new_cache


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         dtype=COMPUTE_DTYPE, device=None,
                         lead: Tuple[int, ...] = ()
                         ) -> Dict[str, torch.Tensor]:
    """Cache for ONE attention layer (or ``lead`` stacked ones). SWA uses a
    ring of ``min(max_len, window)`` slots."""
    S = max_len
    if cfg.sliding_window is not None:
        S = min(max_len, cfg.sliding_window)
    hd = cfg.resolved_head_dim
    shape = tuple(lead) + (batch, S, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(tuple(lead) + (batch, S), -1, dtype=torch.int32,
                          device=device),
    }


# -------------------------------------------------------------------- MLP
def _act(cfg: ModelConfig):
    """silu, or gelu as ``jax.nn.gelu`` computes it: the tanh
    approximation."""
    if cfg.act == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, lead: Tuple[int, ...] = ()
             ) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    shapes = {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    return {n: init_leaf(generator, n, tuple(lead) + s, cfg.n_layers)
            for n, s in shapes.items()}


def mlp_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    act = _act(cfg)
    h = act(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


# ------------------------------------------ tensor parallel (spec-driven)
# The sublayers of a spec-driven ``Sharder`` (``models.common``) take their
# input whole on every rank of "model" (``rms_norm_spmd``) and their
# params after the FSDP gather (whole but for their split over "model"),
# and return (result (..., d), partial): ``partial`` says the ranks'
# results sum to the sublayer's (``Sharder.leave`` reduce-scatters it),
# else every rank holds all of it.
def rms_norm_spmd(x: torch.Tensor, w: torch.Tensor, eps: float, d: int,
                  sharder: Sharder) -> torch.Tensor:
    """A sublayer's pre-norm of the residual stream, whole on every rank of
    "model": on a stream split along d, each rank normalizes its columns
    (the sum of squares psummed over "model") and the normalized columns
    are all-gathered, so no rank normalizes all of d; an unsplit stream
    is normalized whole on every rank (``replicate_in``: its backward
    sums the ranks' parts of the cotangent)."""
    if not sharder.residual_split(d):
        return rms_norm(P.replicate_in(x, sharder.model_group), w, eps)
    n = d // sharder.model_size
    w = w.narrow(-1, sharder.model_rank * n, n)
    dt = x.dtype
    xf = x.float()
    var = P.ad_all_reduce(xf.square().sum(dim=-1, keepdim=True),
                          sharder.model_group) / d
    h = (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)
    return P.ad_all_gather(h, h.dim() - 1, sharder.model_group)


def _project(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             full: int, sharder: Sharder) -> Tuple[torch.Tensor, int, int]:
    """``x @ w (+ b)``: the output columns [c0, c1) of ``full`` this rank
    holds (all of them when ``w`` is whole over "model")."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    c0, c1 = sharder.columns(w.shape[-1], full)
    return y, c0, c1


def _heads(y: torch.Tensor, c0: int, c1: int, full: int, hd: int,
           sharder: Sharder, every: bool = False
           ) -> Tuple[torch.Tensor, int]:
    """A projection's columns [c0, c1) -> (B, T, heads, hd) whole heads
    and the first head's index: columns that split a head (|model| above
    the heads), or with ``every`` any split, are all-gathered over
    "model" first."""
    if c0 % hd or c1 % hd or (every and c1 - c0 < full):
        y = P.ad_all_gather(y, y.dim() - 1, sharder.model_group)
        c0, c1 = 0, full
    return y.reshape(y.shape[:-1] + ((c1 - c0) // hd, hd)), c0 // hd


def _kv_for(q_heads: Tuple[int, int], k: torch.Tensor, v: torch.Tensor,
            k0: int, cfg: ModelConfig, sharder: Sharder
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KV heads the query heads [h0, h1) read, laid out for the
    kernels' GQA mapping (local query head i reads local KV head
    i // (local group)): k, v hold heads [k0, k0 + n) (all-gathered over
    "model" first if they lack some), and a range that does not map
    evenly is expanded to one KV head a query head."""
    h0, h1 = q_heads
    G = cfg.n_heads // cfg.n_kv_heads
    n0, n1 = h0 // G, (h1 - 1) // G + 1
    if n0 < k0 or n1 > k0 + k.shape[-2]:
        k = P.ad_all_gather(k, k.dim() - 2, sharder.model_group)
        v = P.ad_all_gather(v, v.dim() - 2, sharder.model_group)
        k0 = 0
    k, v = k[..., n0 - k0:n1 - k0, :], v[..., n0 - k0:n1 - k0, :]
    if not ((h0 % G == 0 and (h1 - h0) % G == 0) or n1 - n0 == 1):
        idx = torch.arange(h0, h1, device=k.device) // G - n0
        k, v = k[..., idx, :], v[..., idx, :]
    return k, v


def _out_proj(out: torch.Tensor, h0: int, wo: torch.Tensor,
              cfg: ModelConfig, sharder: Sharder
              ) -> Tuple[torch.Tensor, bool]:
    """Attention's (..., heads, hd) output of heads from ``h0`` times
    wo's rows this rank holds: a partial sum when wo is split over
    "model"."""
    hd = cfg.resolved_head_dim
    full = cfg.n_heads * hd
    out = out.reshape(out.shape[:-2] + (out.shape[-2] * hd,))
    a0 = h0 * hd
    r0, r1 = sharder.columns(wo.shape[0], full)
    if r0 < a0 or r1 > a0 + out.shape[-1]:
        out = P.ad_all_gather(out, out.dim() - 1, sharder.model_group)
        a0 = 0
    out = out[..., r0 - a0:r1 - a0]
    return out @ wo.to(out.dtype), r1 - r0 < full


def attention_spmd(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig,
                   sharder: Sharder, memory: Optional[torch.Tensor] = None,
                   causal: bool = True, collect_kv: bool = False):
    """``attention_block``'s train / prefill modes over "model": q, k, v
    column-parallel (whole heads, or gathered where a rank's columns
    split a head), row 8 on this rank's query heads, wo row-parallel.
    ``memory`` (the encoder's output, whole) makes it cross-attention.
    Returns (result, partial, seed): with ``collect_kv``, seed is the
    post-RoPE (k, v) for the caches (every KV head, or this rank's)."""
    B, T, _ = x.shape
    hd, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q, h0 = _heads(*_project(x, p["wq"], p.get("bq"), Hq * hd, sharder),
                   Hq * hd, hd, sharder)
    src = x if memory is None else memory
    k, k0 = _heads(*_project(src, p["wk"], p.get("bk"), Hkv * hd, sharder),
                   Hkv * hd, hd, sharder)
    v, _ = _heads(*_project(src, p["wv"], p.get("bv"), Hkv * hd, sharder),
                  Hkv * hd, hd, sharder)
    if memory is None:
        pos = positions[None, :].expand(B, T)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    ka, va = _kv_for((h0, h0 + q.shape[-2]), k, v, k0, cfg, sharder)
    if memory is None:
        out = attend(q, ka, va, causal=causal, window=cfg.sliding_window,
                     scores=SPMD_BACKWARD_SCORES)
    else:
        out = attend(q, ka, va, causal=False, window=None,
                     scores=SPMD_BACKWARD_SCORES)
    y, partial = _out_proj(out, h0, p["wo"], cfg, sharder)
    return y, partial, ((k, v) if collect_kv else None)


def combine_slices(out: torch.Tensor, lse: torch.Tensor, group
                   ) -> torch.Tensor:
    """Attention over a cache split along S into the ranks' slices: each
    rank's (B, H, hd) output and (B, H) log-sum-exp over its slice ->
    the whole cache's output, out = sum_r exp(lse_r - lse) out_r with
    lse = log sum_r exp(lse_r) (a pmax, then one psum of the weighted
    outputs and their weights)."""
    if P.group_size(group) == 1:
        return out
    m = P.pmax(lse, group)
    w = torch.exp(lse - m)[..., None]
    both = P.psum(torch.cat([out.float() * w, w], dim=-1), group)
    return (both[..., :-1] / both[..., -1:]).to(out.dtype)


def decode_attention_spmd(p: Dict[str, torch.Tensor], x: torch.Tensor,
                          cfg: ModelConfig, sharder: Sharder,
                          cache: Optional[Dict[str, torch.Tensor]] = None,
                          cache_pos=None, cache_split: bool = False,
                          memory=None, memory_split: bool = False
                          ) -> Tuple[torch.Tensor, bool]:
    """``attention_block``'s decode mode over "model", with a cache (or
    whisper's ``memory`` (k, v)) that may be split along S over "model":
    every rank takes every query head, writes the new token's k/v into
    the cache only where it owns the token's slot, runs row 9 on its
    slice with the lengths clipped to it (``return_lse``), and the slices
    combine (``combine_slices``); wo is row-parallel."""
    B = x.shape[0]
    hd, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q, _ = _heads(*_project(x, p["wq"], p.get("bq"), Hq * hd, sharder),
                  Hq * hd, hd, sharder, every=True)
    if memory is None:
        cp = int(cache_pos)
        with host_work():
            positions = torch.tensor([cp], device=x.device)
        k, _ = _heads(*_project(x, p["wk"], p.get("bk"), Hkv * hd,
                                sharder), Hkv * hd, hd, sharder, every=True)
        v, _ = _heads(*_project(x, p["wv"], p.get("bv"), Hkv * hd,
                                sharder), Hkv * hd, hd, sharder, every=True)
        q = apply_rope(q, positions[None, :].expand(B, 1), cfg.rope_theta)
        k = apply_rope(k, positions[None, :].expand(B, 1), cfg.rope_theta)
        S = cache["k"].shape[1]
        S_full = S * sharder.model_size if cache_split else S
        slot = cp % S_full if (cfg.sliding_window is not None
                               and S_full < 2**20) else cp
        owner = slot // S if cache_split else sharder.model_rank
        if owner == sharder.model_rank:
            s = slot % S
            cache["k"][:, s] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, s] = v[:, 0].to(cache["v"].dtype)
            cache["pos"][:, s] = cp
        kc, vc, split = cache["k"], cache["v"], cache_split
        lengths = (cache["pos"] >= 0).sum(dim=-1)
    else:
        kc, vc = memory
        split = memory_split
        lengths = torch.full((B,), kc.shape[1], dtype=torch.int32,
                             device=x.device)
    out, lse = ops.flash_decode(q[:, 0].contiguous(), kc, vc, lengths,
                                return_lse=True)
    if split:
        out = combine_slices(out, lse, sharder.model_group)
    return _out_proj(out[:, None], 0, p["wo"], cfg, sharder)


def mlp_spmd(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, bool]:
    """``mlp_block`` over "model": w_gate and w_up column-parallel, w_down
    row-parallel (a partial sum when split)."""
    act = _act(cfg)
    h = act(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype), p["w_down"].shape[0] < cfg.d_ff


def embed_spmd(table: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
               sharder: Sharder) -> Tuple[torch.Tensor, bool]:
    """The embedding lookup of a table whole along d (after the FSDP
    gather): vocab-parallel, a masked lookup of the rows this rank holds
    (a partial sum), when the table is split over "model"."""
    V = table.shape[0]
    if V == cfg.padded_vocab:
        return F.embedding(tokens, table), False
    local = tokens - sharder.model_rank * V
    mine = (local >= 0) & (local < V)
    x = F.embedding(local.clamp(0, V - 1), table)
    return x * mine[..., None].to(x.dtype), True


# -------------------------------------------------------------------- MoE
def _draw_experts(generator: torch.Generator, lead: Tuple[int, ...],
                  E: int, d_in: int, d_out: int, scale: float,
                  shard: Optional[Tuple[Optional[str], int, int]],
                  ff_dim: int) -> torch.Tensor:
    """(*lead, E, d_in, d_out) expert weights of N(0, (scale /
    sqrt(d_in))^2), each (d_in, d_out) matrix drawn on its own, unit by
    unit and expert by expert, so that a rank keeps its shard of each as
    it is drawn and never holds the whole stack. ``shard`` is (layout,
    rank, M) of ``moe_dist.weight_layout``: "experts" keeps experts
    [rank E / M, (rank + 1) E / M), "ff" the rank's 1/M of d_ff (dim
    ``ff_dim`` of a matrix), None all of it."""
    layout, rank, M = shard if shard is not None else (None, 0, 1)
    e0, e1 = (rank * E // M, (rank + 1) * E // M) if layout == "experts" \
        else (0, E)
    rows, cols = d_in, d_out
    if layout == "ff":
        rows, cols = ((d_in // M, d_out) if ff_dim == 0
                      else (d_in, d_out // M))
    std = scale / math.sqrt(d_in)
    out = torch.empty(tuple(lead) + (e1 - e0, rows, cols),
                      device=generator.device)
    flat = out.view(-1, e1 - e0, rows, cols)
    scratch = None
    for u in range(flat.shape[0]):
        for e in range(E):
            if layout is None or (layout == "experts" and e0 <= e < e1):
                flat[u, e - e0].normal_(0.0, std, generator=generator)
                continue
            if scratch is None:
                scratch = torch.empty((d_in, d_out), device=out.device)
            scratch.normal_(0.0, std, generator=generator)
            if layout == "ff":
                size = rows if ff_dim == 0 else cols
                flat[u, e].copy_(scratch.narrow(ff_dim, rank * size, size))
    return out


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             lead: Tuple[int, ...] = (),
             shard: Optional[Tuple[Optional[str], int, int]] = None
             ) -> Dict[str, torch.Tensor]:
    """The router (d, E), then each expert weight stacked (E, ...) behind
    ``lead``, drawn a matrix at a time (``_draw_experts``); with
    ``shard``, this rank's part of them, the same numbers."""
    assert cfg.moe is not None
    E = cfg.moe.num_experts
    d, ff = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    return {
        "router": dense_init(generator, d, E, lead=lead),
        "w_gate": _draw_experts(generator, lead, E, d, ff, 1.0, shard, 1),
        "w_up": _draw_experts(generator, lead, E, d, ff, 1.0, shard, 1),
        "w_down": _draw_experts(generator, lead, E, ff, d,
                                1.0 / math.sqrt(2 * cfg.n_layers), shard,
                                0),
    }


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert's buffer holds: ceil(cf * N * K / E / 8) * 8."""
    m = cfg.moe
    return max(1, int(math.ceil(m.capacity_factor * n_tokens * m.top_k
                                / m.num_experts / 8.0)) * 8)


# Routing statistics of the MoE bodies, for the k-rank checks; both off
# (None) unless a harness sets them. While ``DROPS`` is a dict, each body
# adds the copies it dropped under its name ("global", "local",
# "ep_send", "ep_recv"; device scalars, summed without a sync; a
# rematerialized layer counts twice); while ``ROUTES`` is a list, each
# routing appends its top-k expert ids (n, K).
DROPS: Optional[Dict[str, torch.Tensor]] = None
ROUTES: Optional[list] = None


def count_dropped(body: str, keep: torch.Tensor) -> None:
    if DROPS is not None:
        n = (~keep).sum()
        DROPS[body] = DROPS[body] + n if body in DROPS else n


def pack_by_segment(seg_ids: torch.Tensor, n_segments: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Sort-based capacity packing. seg_ids (N,) in [0, n_segments) ->
    (the stable sort's order, the sorted ids, each copy's slot in its
    segment (0 where dropped), keep), all in the sorted order."""
    order = torch.argsort(seg_ids, stable=True)
    seg_sorted = seg_ids[order]
    seg_start = torch.searchsorted(
        seg_sorted, torch.arange(n_segments, device=seg_ids.device,
                                 dtype=seg_sorted.dtype))
    pos = torch.arange(seg_ids.shape[0], device=seg_ids.device) \
        - seg_start[seg_sorted]
    keep = pos < capacity
    return order, seg_sorted, torch.where(keep, pos, torch.zeros_like(pos)), \
        keep


def route(xt: torch.Tensor, router: torch.Tensor, K: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of the tokens xt (n, d): (gates (n, K) fp32,
    renormalised over the k, expert ids (n, K))."""
    logits = xt @ router.to(xt.dtype)                        # (n, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idx = torch.topk(probs, K, dim=-1)                 # (n, K)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if ROUTES is not None:
        ROUTES.append(idx.detach())
    return gate, idx


def expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The experts' SwiGLU over their buffers: (E, C, d) -> (E, C, d)."""
    dt = buf.dtype
    act = _act(cfg)
    h = act(torch.einsum("ecd,edf->ecf", buf, w_gate.to(dt)))
    h = h * torch.einsum("ecd,edf->ecf", buf, w_up.to(dt))
    return torch.einsum("ecf,efd->ecd", h, w_down.to(dt))


def moe_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, sharder: Sharder = NULL_SHARDER
              ) -> torch.Tensor:
    """Sort-based capacity-dropping top-k MoE (tokens routed to expert
    buffers): x (B, T, d) -> (B, T, d).

    The body is the reference's choice (``Sharder.moe_body``): without a
    mesh, the global formulation (``moe_global``); over a mesh with a
    "model" axis, ``moe_dist.moe_block_ep_a2a`` or
    ``moe_block_local_dispatch``; under ``moe_impl="global"`` or with no
    "model" axis, the global formulation over the whole batch
    (``moe_dist.moe_block_global``). Over a mesh, x is this rank's rows of
    the batch, replicated over "model", and ``p`` holds this rank's shards
    of the expert weights (``moe_dist.weight_layout``)."""
    assert cfg.moe is not None
    if sharder.mesh is None:
        return moe_global(p, x, cfg)
    from repro_torch.models import moe_dist
    body = sharder.moe_body(cfg.moe.num_experts)
    if body == "ep":
        return moe_dist.moe_block_ep_a2a(p, x, cfg, sharder)
    if body == "local":
        return moe_dist.moe_block_local_dispatch(p, x, cfg, sharder)
    return moe_dist.moe_block_global(p, x, cfg, sharder)


def moe_global(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """The reference's global formulation: ``moe_tokens`` over every
    token of x at ``moe_capacity``."""
    B, T, d = x.shape
    N = B * T
    return moe_tokens(p, x.reshape(N, d), cfg, moe_capacity(cfg, N),
                      "global").reshape(B, T, d)


def moe_tokens(p: Dict[str, torch.Tensor], xt: torch.Tensor,
               cfg: ModelConfig, C: int, body: str) -> torch.Tensor:
    """The MoE on the tokens xt (n, d) at C slots an expert: copies of
    tokens are stably sorted by expert; a copy past its expert's capacity
    is dropped (counted under ``body``); the gates are renormalised over
    the top k. With a d_ff shard of the experts in ``p`` the result is
    this rank's partial sum."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    n, d = xt.shape
    dt = xt.dtype
    gate, idx = route(xt, p["router"], K)

    order, fe_s, pos, keep = pack_by_segment(idx.reshape(-1), E, C)
    count_dropped(body, keep)
    tok_s = order // K
    slot_gate = gate.reshape(-1)[order]
    zero = torch.zeros((), dtype=dt, device=xt.device)

    gathered = torch.where(keep[:, None], xt[tok_s], zero)
    buf = torch.zeros((E, C, d), dtype=dt, device=xt.device).index_put(
        (fe_s, pos), gathered, accumulate=True)
    out_buf = expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"], cfg)

    y_slot = torch.where(keep[:, None], out_buf[fe_s, pos], zero)
    y_slot = y_slot * slot_gate[:, None].to(dt)
    return torch.zeros((n, d), dtype=dt, device=xt.device).index_add(
        0, tok_s, y_slot)
