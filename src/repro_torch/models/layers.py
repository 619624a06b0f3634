"""Core transformer layers: norms, RoPE, GQA/SWA attention (prefill and
training through row 8, cached decode through row 9), SwiGLU MLP and
sort-based capacity MoE.

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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import COMPUTE_DTYPE, dense_init


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
    p = {
        "wq": dense_init(generator, d, cfg.n_heads * hd, lead=lead),
        "wk": dense_init(generator, d, cfg.n_kv_heads * hd, lead=lead),
        "wv": dense_init(generator, d, cfg.n_kv_heads * hd, lead=lead),
        "wo": dense_init(generator, cfg.n_heads * hd, d,
                         scale=1.0 / math.sqrt(2 * cfg.n_layers), lead=lead),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(tuple(lead) + (n * hd,),
                                  device=generator.device)
    return p


def _backward_block(B: int, Hq: int, T: int, S: int) -> int:
    """Query rows the backward takes at once: ~2^25 fp32 scores (128 MB) a
    temporary."""
    return max(1, min(T, (1 << 25) // max(1, B * Hq * S)))


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, causal: bool,
                       window: Optional[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``ops.flash_attention`` in plain torch: the softmax
    recomputed a query block at a time in fp32 (no (B, H, T, S) tensor is
    held whole), dq, dk, dv summed over each GQA group, each in its
    input's dtype."""
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, T, Hq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, S, Hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kpos = torch.arange(S, device=q.device)[None, :]
    bq = _backward_block(B, Hq, T, S)
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
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, dout.contiguous(), ctx.causal,
                                    ctx.window), None, None)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, window: Optional[int] = None
           ) -> torch.Tensor:
    """q (B, T, Hq, hd), k, v (B, S, Hkv, hd) -> (B, T, Hq, hd) through
    row 8, differentiable when autograd asks for it."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
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
    return {
        "w_gate": dense_init(generator, d, ff, lead=lead),
        "w_up": dense_init(generator, d, ff, lead=lead),
        "w_down": dense_init(generator, ff, d,
                             scale=1.0 / math.sqrt(2 * cfg.n_layers),
                             lead=lead),
    }


def mlp_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    act = _act(cfg)
    h = act(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


# -------------------------------------------------------------------- MoE
def init_moe(generator: torch.Generator, cfg: ModelConfig,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    assert cfg.moe is not None
    E = cfg.moe.num_experts
    d, ff = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    return {
        "router": dense_init(generator, d, E, lead=lead),
        "w_gate": dense_init(generator, d, ff, lead=lead + (E,)),
        "w_up": dense_init(generator, d, ff, lead=lead + (E,)),
        "w_down": dense_init(generator, ff, d,
                             scale=1.0 / math.sqrt(2 * cfg.n_layers),
                             lead=lead + (E,)),
    }


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert's buffer holds: ceil(cf * N * K / E / 8) * 8."""
    m = cfg.moe
    return max(1, int(math.ceil(m.capacity_factor * n_tokens * m.top_k
                                / m.num_experts / 8.0)) * 8)


def moe_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Sort-based capacity-dropping top-k MoE (tokens routed to expert
    buffers), the reference's global formulation: x (B, T, d) -> (B, T, d).

    Copies of tokens are stably sorted by expert; a copy past its expert's
    capacity C is dropped; the gates are renormalised over the top k."""
    assert cfg.moe is not None
    B, T, d = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    N = B * T
    dt = x.dtype
    xt = x.reshape(N, d)

    logits = xt @ p["router"].to(dt)                          # (N, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idx = torch.topk(probs, K, dim=-1)                  # (N, K)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    flat_e = idx.reshape(-1)                                  # (N*K,)
    order = torch.argsort(flat_e, stable=True)
    fe_s = flat_e[order]
    tok_s = order // K
    slot_gate = gate.reshape(-1)[order]

    # position of each routed copy within its expert's group
    seg_start = torch.searchsorted(
        fe_s, torch.arange(E, device=x.device, dtype=fe_s.dtype))
    pos = torch.arange(N * K, device=x.device) - seg_start[fe_s]

    C = moe_capacity(cfg, N)
    keep = pos < C
    safe_pos = torch.where(keep, pos, torch.zeros_like(pos))

    gathered = torch.where(keep[:, None], xt[tok_s],
                           torch.zeros((), dtype=dt, device=x.device))
    buf = torch.zeros((E, C, d), dtype=dt, device=x.device).index_put(
        (fe_s, safe_pos), gathered, accumulate=True)

    act = _act(cfg)
    h = act(torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(dt)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(dt))
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))

    y_slot = out_buf[fe_s, safe_pos]                          # (N*K, d)
    y_slot = torch.where(keep[:, None], y_slot,
                         torch.zeros((), dtype=dt, device=x.device))
    y_slot = y_slot * slot_gate[:, None].to(dt)
    y = torch.zeros((N, d), dtype=dt, device=x.device).index_add(
        0, tok_s, y_slot)
    return y.reshape(B, T, d)
