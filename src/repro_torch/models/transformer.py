"""Model stacks for the ten LM architectures.

As the reference (``repro.models.transformer``): one ``init_model`` /
``forward`` pair covers every family through the ModelConfig switches
(GQA/SWA attention, MoE every-k, Mamba/RWKV6 mixers, enc-dec,
modality-frontend stubs). Layers of one kind are STACKED (params with a
leading (n_units,) dim, per position of the repeating unit), so weights
carry across from the reference unchanged; a Python loop over units
replaces ``lax.scan``, all units of position 0 first, then position 1, and
so on, as the reference's grouped scan runs them.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe_dist
from repro_torch.models import ssm as S
from repro_torch.models.common import (COMPUTE_DTYPE, NULL_SHARDER, Params,
                                       Sharder, init_leaf, unstack)
from repro_torch.op_stream import host_work
from repro_torch.parallel import primitives as P


# ---------------------------------------------------------------------------
# Layer plan: which mixer/MLP each position in the repeating unit uses
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerPlan:
    period: int                   # repeating unit length
    mixers: Tuple[str, ...]       # per-position: "attn" | "mamba" | "rwkv6"
    mlps: Tuple[str, ...]         # per-position: "dense" | "moe" | "rwkv_cmix"


def plan_for(cfg: ModelConfig) -> LayerPlan:
    periods = [1]
    if cfg.attn_every > 1:
        periods.append(cfg.attn_every)
    if cfg.moe is not None and cfg.moe.every > 1:
        periods.append(cfg.moe.every)
    period = math.lcm(*periods)
    assert cfg.n_layers % period == 0, (cfg.name, cfg.n_layers, period)

    mixers, mlps = [], []
    for i in range(period):
        if cfg.family == "ssm":
            mixers.append("rwkv6")
            mlps.append("rwkv_cmix")
            continue
        if cfg.ssm is not None:  # hybrid: attention on the last slot of each unit
            is_attn = (i % cfg.attn_every) == (cfg.attn_every - 1)
            mixers.append("attn" if is_attn else "mamba")
        else:
            mixers.append("attn")
        if cfg.moe is not None and (i % cfg.moe.every) == cfg.moe.offset:
            mlps.append("moe")
        else:
            mlps.append("dense")
    return LayerPlan(period, tuple(mixers), tuple(mlps))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_layers(generator: torch.Generator, cfg: ModelConfig, mixer: str,
                 mlp: str, n: int, moe_shard=None) -> Dict[str, Any]:
    """``n`` layers of one kind, stacked over a leading (n,) dim; a MoE's
    expert weights are this rank's ``moe_shard`` of them."""
    dev, lead = generator.device, (n,)
    p: Dict[str, Any] = {"norm1": L.init_rms_norm(cfg.d_model, dev, lead),
                         "norm2": L.init_rms_norm(cfg.d_model, dev, lead)}
    if mixer == "attn":
        p["attn"] = L.init_attention(generator, cfg, lead)
    elif mixer == "mamba":
        p["mamba"] = S.init_mamba(generator, cfg, lead)
    elif mixer == "rwkv6":
        p["rwkv"] = S.init_rwkv6(generator, cfg, lead)
    else:
        raise ValueError(mixer)
    if mlp == "dense":
        p["mlp"] = L.init_mlp(generator, cfg, lead=lead)
    elif mlp == "moe":
        p["moe"] = L.init_moe(generator, cfg, lead, moe_shard)
    elif mlp == "rwkv_cmix":
        p["cmix"] = S.init_rwkv6_channel_mix(generator, cfg, lead)
    else:
        raise ValueError(mlp)
    return p


def init_model(cfg: ModelConfig, generator: torch.Generator,
               sharder: Sharder = NULL_SHARDER) -> Params:
    """Full parameter tree on ``generator.device``, fp32, with the
    reference's names and shapes: per-kind layer params stacked over
    units, the encoder's over its layers, the cross-attention's over the
    decoder's layers. Under a ``sharder`` whose MoE body reads its expert
    weights sharded (``moe_dist.weight_layout``), each MoE layer keeps
    this rank's shard of them, the numbers of the whole init: every rank
    draws the same stream in the same order, a matrix at a time, and
    never holds every layer's experts at full width."""
    plan = plan_for(cfg)
    n_units = cfg.n_layers // plan.period
    dev = generator.device
    moe_shard = moe_dist.shard_spec(cfg, sharder)
    params: Dict[str, Any] = {
        "embed": init_leaf(generator, "embed",
                           (cfg.padded_vocab, cfg.d_model), cfg.n_layers),
        "final_norm": L.init_rms_norm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_leaf(generator, "lm_head",
                                      (cfg.d_model, cfg.padded_vocab),
                                      cfg.n_layers)
    params["units"] = [
        _init_layers(generator, cfg, plan.mixers[pos], plan.mlps[pos],
                     n_units, moe_shard) for pos in range(plan.period)]
    if cfg.is_encoder_decoder:
        params["encoder"] = _init_layers(generator, cfg, "attn", "dense",
                                         cfg.n_encoder_layers)
        n_x = n_units * plan.period
        params["cross_attn"] = {
            "attn": L.init_attention(generator, cfg, (n_x,)),
            "norm": L.init_rms_norm(cfg.d_model, dev, (n_x,))}
        params["enc_final_norm"] = L.init_rms_norm(cfg.d_model, dev)
    if cfg.frontend is not None:
        # stub frontend: a single linear adapter applied to precomputed
        # patch/frame embeddings (the batch supplies them at d_model)
        params["frontend_proj"] = init_leaf(generator, "frontend_proj",
                                            (cfg.d_model, cfg.d_model),
                                            cfg.n_layers)
    return params


# ---------------------------------------------------------------------------
# Caches / recurrent state
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=COMPUTE_DTYPE, device=None) -> Params:
    """Decode state for the whole stack, shaped like ``units`` (stacked), a
    position of the unit each: attention {"k", "v", "pos"} (empty slots at
    pos -1), mamba {"conv", "ssm"}, rwkv6 {"wkv", "x_prev", "cmix_prev"}
    (the channel mix's token shift beside the time mix's state)."""
    plan = plan_for(cfg)
    lead = (cfg.n_layers // plan.period,)
    states = []
    for mixer in plan.mixers:
        if mixer == "attn":
            states.append(L.init_attention_cache(cfg, batch, max_len, dtype,
                                                 device, lead=lead))
        elif mixer == "mamba":
            states.append(S.init_mamba_state(cfg, batch, dtype, device,
                                             lead))
        else:
            st = S.init_rwkv6_state(cfg, batch, dtype, device, lead)
            st["cmix_prev"] = torch.zeros(lead + (batch, cfg.d_model),
                                          dtype=dtype, device=device)
            states.append(st)
    return states


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _unit_forward(layer_p, x, positions, cfg, mixer, mlp, state=None,
                  cache_pos=None, memory=None, xattn_p=None,
                  collect=False, sharder=NULL_SHARDER):
    """One layer: pre-norm mixer + pre-norm MLP (+ optional
    cross-attention). Returns (x, new_state). With collect=True
    (full-sequence prefill), new_state carries cache-seeding data: the
    post-RoPE K/V for attention, the final recurrent state for
    mamba / rwkv6. With a ``state`` (decode), attention writes its cache in
    place and returns it; mamba / rwkv6 return new state tensors."""
    h = L.rms_norm(x, layer_p["norm1"], cfg.norm_eps)
    new_state = state
    if mixer == "attn":
        out, new_state = L.attention_block(
            layer_p["attn"], h, positions, cfg, cache=state,
            cache_pos=cache_pos, collect_kv=collect)
    elif mixer == "mamba":
        if state is None:
            out, st = S.mamba_scan(layer_p["mamba"], h, cfg)
            new_state = st if collect else None
        else:
            out, new_state = S.mamba_step(layer_p["mamba"], h, cfg, state)
    else:  # rwkv6
        tm_state = None if state is None else {
            "wkv": state["wkv"], "x_prev": state["x_prev"]}
        out, tm_new = S.rwkv6_scan(layer_p["rwkv"], h, cfg, tm_state)
        if state is not None:
            new_state = {**state, **tm_new}
        elif collect:
            new_state = tm_new
    x = x + out

    if memory is not None and xattn_p is not None:
        hx = L.rms_norm(x, xattn_p["norm"], cfg.norm_eps)
        out, _ = L.attention_block(xattn_p["attn"], hx, positions, cfg,
                                   kv_override=memory, causal=False)
        x = x + out

    h = L.rms_norm(x, layer_p["norm2"], cfg.norm_eps)
    if mlp == "dense":
        x = x + L.mlp_block(layer_p["mlp"], h, cfg)
    elif mlp == "moe":
        x = x + L.moe_block(layer_p["moe"], h, cfg, sharder)
    else:  # rwkv channel mix
        prev = None if state is None else state["cmix_prev"]
        out, cmix_prev = S.rwkv6_channel_mix(layer_p["cmix"], h, prev)
        x = x + out
        if new_state is not None:
            new_state = {**new_state, "cmix_prev": cmix_prev}
    return x, new_state


def _project_kv_memory(cfg: ModelConfig, xattn_stacked,
                       enc_out: torch.Tensor):
    """(k, v) for cross-attention from the encoder output, per decoder
    layer: a stacked (n_layers, B, S, Hkv, hd) pair."""
    hd = cfg.resolved_head_dim
    B, Ssrc, _ = enc_out.shape
    a = xattn_stacked["attn"]
    ks, vs = [], []
    for wk, wv in zip(a["wk"].unbind(0), a["wv"].unbind(0)):
        ks.append((enc_out @ wk.to(enc_out.dtype)).reshape(
            B, Ssrc, cfg.n_kv_heads, hd))
        vs.append((enc_out @ wv.to(enc_out.dtype)).reshape(
            B, Ssrc, cfg.n_kv_heads, hd))
    return torch.stack(ks), torch.stack(vs)


def encode(params: Params, cfg: ModelConfig,
           src_embeds: torch.Tensor) -> torch.Tensor:
    """Encoder stack over precomputed frame/patch embeddings (stub
    frontend); non-causal self-attention through row 8."""
    assert cfg.is_encoder_decoder
    x = src_embeds.to(COMPUTE_DTYPE)
    if "frontend_proj" in params:
        x = x @ params["frontend_proj"].to(x.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for layer_p in unstack(params["encoder"], cfg.n_encoder_layers):
        h = L.rms_norm(x, layer_p["norm1"], cfg.norm_eps)
        out, _ = L.attention_block(layer_p["attn"], h, positions, cfg,
                                   causal=False)
        x = x + out
        h = L.rms_norm(x, layer_p["norm2"], cfg.norm_eps)
        x = x + L.mlp_block(layer_p["mlp"], h, cfg)
    return L.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _memory(params: Params, cfg: ModelConfig,
            encoder_embeds: Optional[torch.Tensor]):
    if not cfg.is_encoder_decoder:
        return None
    assert encoder_embeds is not None, "an enc-dec arch needs encoder_embeds"
    enc_out = encode(params, cfg, encoder_embeds)
    return _project_kv_memory(cfg, params["cross_attn"], enc_out)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            frontend_embeds: Optional[torch.Tensor] = None,
            encoder_embeds: Optional[torch.Tensor] = None,
            collect: bool = False, remat: bool = False,
            sharder: Sharder = NULL_SHARDER):
    """Full-sequence forward (train / prefill). Returns the final hidden
    (B, T, d) in bf16; with collect=True also the per-unit cache seeds a
    position of the unit, stacked over units: the post-RoPE K/V ({"k",
    "v"}: (n_units, B, T, Hkv, hd)) of attention, the final states of
    mamba / rwkv6 (``init_cache``'s layouts).

    positions       : consecutive (default ``arange(T)``): RoPE reads them,
                      and row 8's masks are index masks.
    frontend_embeds : (B, n_frontend_tokens, d_model) precomputed patch /
                      frame embeddings (VLM stub), prepended to the tokens.
    encoder_embeds  : (B, S_src, d_model) for enc-dec archs.
    remat           : rematerialize each layer in the backward (the
                      reference's train memory policy): its body runs
                      under ``torch.utils.checkpoint`` while autograd
                      records, so the backward runs its forward again (row
                      8 included).
    sharder         : the mesh of the LM over k ranks: ``tokens`` are this
                      rank's rows of the batch, and each MoE layer runs
                      the body the sharder picks (``layers.moe_block``);
                      everything else is computed replicated over "model".
                      A spec-driven sharder (``Sharder.spmd``) runs
                      ``forward_spmd`` instead: ``params`` are this rank's
                      shards, and the hidden comes back whole.
    """
    if sharder.spmd:
        return forward_spmd(params, cfg, tokens, sharder, frontend_embeds,
                            encoder_embeds, collect, remat)
    plan = plan_for(cfg)
    n_units = cfg.n_layers // plan.period
    # cast the table BEFORE the gather, as the reference does, so the
    # table's gradient accumulates where the reference's does
    x = F.embedding(tokens, params["embed"].to(COMPUTE_DTYPE))
    if frontend_embeds is not None and not cfg.is_encoder_decoder:
        fe = (frontend_embeds.to(COMPUTE_DTYPE)
              @ params["frontend_proj"].to(COMPUTE_DTYPE))
        x = torch.cat([fe, x], dim=1)
    T = x.shape[1]
    if positions is None:
        positions = torch.arange(T, device=x.device)

    memory_kv = _memory(params, cfg, encoder_embeds)
    xattn = (unstack(params["cross_attn"], n_units) if memory_kv is not None
             else None)
    run = _unit_forward
    if remat and torch.is_grad_enabled():
        run = functools.partial(checkpoint, _unit_forward,
                                use_reentrant=False, preserve_rng_state=False)
    extras = []
    for pos in range(plan.period):
        mixer, mlp = plan.mixers[pos], plan.mlps[pos]
        collected = []
        for u, layer_p in enumerate(unstack(params["units"][pos], n_units)):
            mem = ((memory_kv[0][u], memory_kv[1][u])
                   if memory_kv is not None else None)
            x, ex = run(layer_p, x, positions, cfg, mixer, mlp, memory=mem,
                        xattn_p=xattn[u] if xattn else None, collect=collect,
                        sharder=sharder)
            collected.append(ex)
        if collect:
            extras.append({n: torch.stack([ex[n] for ex in collected])
                           for n in collected[0]})
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if collect:
        return hidden, extras
    return hidden


# ---------------------------------------------------------------------------
# The spec-driven forward (FSDP and TP from the sharding rules)
# ---------------------------------------------------------------------------
SPMD_NOT_PORTED = ("the spec-driven executor (the dry-run's LM cells) runs "
                   "attention and dense-MLP layers; the MoE, Mamba and "
                   "RWKV6 layers over their expert-, d_ff- and "
                   "feature-parallel specs are ROADMAP A8c-ii-b, not "
                   "ported yet")


def _check_spmd(cfg: ModelConfig) -> LayerPlan:
    plan = plan_for(cfg)
    if set(plan.mixers) != {"attn"} or set(plan.mlps) != {"dense"}:
        raise NotImplementedError(f"{cfg.name}: {SPMD_NOT_PORTED}")
    return plan


def _stacked_spec(specs):
    """A stacked leaf's spec without its leading (n_units,) entry."""
    if isinstance(specs, dict):
        return {k: _stacked_spec(v) for k, v in specs.items()}
    return type(specs)(*tuple(specs)[1:])


def _unit_spmd(layer_p, x, positions, cfg, sharder, unit_spec,
               xattn_p=None, xattn_spec=None, memory=None, collect=False,
               causal=True):
    """One layer over the spec-driven sharder (train / prefill, or an
    encoder layer with ``causal`` False): the FSDP gather of its shards,
    then pre-norm attention and MLP (and the cross-attention over the
    encoder's output ``memory``), each entering and leaving the residual
    stream split over "model". Returns (x, the cache seed with
    ``collect``)."""
    d = cfg.d_model
    p = sharder.fsdp(layer_p, unit_spec, COMPUTE_DTYPE)
    h = L.rms_norm_spmd(x, p["norm1"], cfg.norm_eps, d, sharder)
    y, partial, seed = L.attention_spmd(p["attn"], h, positions, cfg,
                                        sharder, causal=causal,
                                        collect_kv=collect)
    x = x + sharder.leave(y, partial, d)
    if memory is not None:
        xp = sharder.fsdp(xattn_p, xattn_spec, COMPUTE_DTYPE)
        hx = L.rms_norm_spmd(x, xp["norm"], cfg.norm_eps, d, sharder)
        y, partial, _ = L.attention_spmd(xp["attn"], hx, positions, cfg,
                                         sharder, memory=memory)
        x = x + sharder.leave(y, partial, d)
    h = L.rms_norm_spmd(x, p["norm2"], cfg.norm_eps, d, sharder)
    y, partial = L.mlp_spmd(p["mlp"], h, cfg)
    return x + sharder.leave(y, partial, d), seed


def _embed_spmd(params, cfg, tokens, sharder, cast_first: bool):
    """The token embedding into the residual stream: the table cast to
    the compute dtype before the lookup (``cast_first``, the forward's
    order) or after it (decode's)."""
    table = sharder.fsdp(params["embed"], sharder.specs["embed"],
                         COMPUTE_DTYPE)
    if cast_first:
        table = table.to(COMPUTE_DTYPE)
    x, partial = L.embed_spmd(table, tokens, cfg, sharder)
    return sharder.leave(x.to(COMPUTE_DTYPE), partial, cfg.d_model)


def _frontend_spmd(params, cfg, embeds, sharder):
    """``embeds @ frontend_proj`` in the residual stream's layout: the
    projection's columns split over "model" are this rank's columns."""
    w = sharder.fsdp(params["frontend_proj"],
                     sharder.specs["frontend_proj"], COMPUTE_DTYPE)
    x = embeds.to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)
    if w.shape[-1] < cfg.d_model:
        return x
    return sharder.leave(x, False, cfg.d_model)


def encode_spmd(params, cfg: ModelConfig, src_embeds: torch.Tensor,
                sharder: Sharder) -> torch.Tensor:
    """``encode`` over the spec-driven sharder: the encoder's output whole
    on every rank of "model"."""
    sp = sharder.specs
    if "frontend_proj" in params:
        x = _frontend_spmd(params, cfg, src_embeds, sharder)
    else:
        x = sharder.leave(src_embeds.to(COMPUTE_DTYPE), False, cfg.d_model)
    positions = torch.arange(src_embeds.shape[1], device=x.device)
    enc_spec = _stacked_spec(sp["encoder"])
    for layer_p in unstack(params["encoder"], cfg.n_encoder_layers):
        x, _ = _unit_spmd(layer_p, x, positions, cfg, sharder, enc_spec,
                          causal=False)
    norm = sharder.fsdp(params["enc_final_norm"], sp["enc_final_norm"],
                        COMPUTE_DTYPE)
    return L.rms_norm_spmd(x, norm, cfg.norm_eps, cfg.d_model, sharder)


def forward_spmd(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 sharder: Sharder, frontend_embeds=None, encoder_embeds=None,
                 collect: bool = False, remat: bool = False):
    """``forward`` over a spec-driven sharder (see ``models.common``):
    ``params`` are this rank's shards, ``tokens`` (and the embeddings)
    its rows of the batch; each unit gathers its shards over "data"
    (again in the recompute under ``remat``). Returns the final hidden
    whole (B, T, d) on every rank of "model"; with collect=True also the
    cache seeds, a list of the post-RoPE (k, v) of each unit for each
    position of the unit."""
    plan = _check_spmd(cfg)
    n_units = cfg.n_layers // plan.period
    sp = sharder.specs
    x = _embed_spmd(params, cfg, tokens, sharder, cast_first=True)
    if frontend_embeds is not None and not cfg.is_encoder_decoder:
        x = torch.cat([_frontend_spmd(params, cfg, frontend_embeds, sharder),
                       x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    memory, xattn, x_spec = None, None, None
    if cfg.is_encoder_decoder:
        assert encoder_embeds is not None, \
            "an enc-dec arch needs encoder_embeds"
        memory = encode_spmd(params, cfg, encoder_embeds, sharder)
        xattn = unstack(params["cross_attn"], n_units)
        x_spec = _stacked_spec(sp["cross_attn"])
    run = _unit_spmd
    if remat and torch.is_grad_enabled():
        run = functools.partial(checkpoint, _unit_spmd, use_reentrant=False,
                                preserve_rng_state=False)
    extras = []
    for pos in range(plan.period):
        unit_spec = _stacked_spec(sp["units"][pos])
        seeds = []
        for u, layer_p in enumerate(unstack(params["units"][pos], n_units)):
            x, seed = run(layer_p, x, positions, cfg, sharder, unit_spec,
                          xattn[u] if xattn else None, x_spec, memory,
                          collect)
            seeds.append(seed)
        extras.append(seeds)
    norm = sharder.fsdp(params["final_norm"], sp["final_norm"],
                        COMPUTE_DTYPE)
    hidden = L.rms_norm_spmd(x, norm, cfg.norm_eps, cfg.d_model, sharder)
    if collect:
        return hidden, extras
    return hidden


def _seed_slice(k: torch.Tensor, T: int, S_full: int, split: bool,
                cfg: ModelConfig, sharder: Sharder,
                dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """A unit's post-RoPE (B, T, heads, hd) prompt K (or V), every KV
    head or this rank's block of them ->
    this rank's cache block (B, S, Hkv, hd): the last min(T, S_full)
    positions scattered to their (ring) slots, then the block of slots
    this rank holds when the cache is split along S over "model" (an
    all-to-all from a split over heads), every KV head."""
    B, _, nh, hd = k.shape
    Hkv, M = cfg.n_kv_heads, sharder.model_size
    n = min(T, S_full)
    S = S_full // M if (nh == Hkv and split) else S_full
    s0 = sharder.model_rank * S if (nh == Hkv and split) else 0
    with host_work():      # the token count alone decides the slots
        slots = torch.arange(T - n, T) % S_full
        mine = ((slots >= s0) & (slots < s0 + S)).nonzero()[:, 0]
        dst, src = (slots[mine] - s0).to(k.device), mine.to(k.device)
    out = torch.zeros((B, S, nh, hd), dtype=dtype, device=k.device)
    out[:, dst] = k[:, T - n:][:, src].to(dtype)
    if nh == Hkv:
        return out
    if split:
        return P.all_to_all(out, 1, 2, sharder.model_group)
    return P.all_gather(out.movedim(2, 0).contiguous(),
                        sharder.model_group).movedim(0, 2).contiguous()


def caches_from_prefill_spmd(cfg: ModelConfig, extras, max_len: int,
                             sharder: Sharder, dtype=COMPUTE_DTYPE
                             ) -> Params:
    """``caches_from_prefill`` over a spec-driven sharder: this rank's
    block of each attention cache, as ``Sharder.cache_specs`` split it
    (the batch over the data axes, S over "model")."""
    caches = []
    for pos, seeds in enumerate(extras):
        spec = sharder.cache_specs[pos]["k"]
        split = spec[2] == "model"
        T = seeds[0][0].shape[1]
        S_full = max_len if cfg.sliding_window is None else min(
            max_len, cfg.sliding_window)
        ks = [_seed_slice(k, T, S_full, split, cfg, sharder, dtype)
              for k, _ in seeds]
        vs = [_seed_slice(v, T, S_full, split, cfg, sharder, dtype)
              for _, v in seeds]
        S = ks[0].shape[1]
        s0 = sharder.model_rank * S if split else 0
        n = min(T, S_full)
        with host_work():
            full = torch.full((S_full,), -1, dtype=torch.int32)
            positions = torch.arange(T - n, T, dtype=torch.int32)
            full[positions.long() % S_full] = positions
            pos = full[s0:s0 + S].to(ks[0].device)
        B = ks[0].shape[0]
        caches.append({"k": torch.stack(ks), "v": torch.stack(vs),
                       "pos": pos.expand(len(ks), B, S).contiguous()})
    return caches


def forward_with_state_spmd(params: Params, cfg: ModelConfig,
                            tokens: torch.Tensor, caches: Params, cache_pos,
                            sharder: Sharder, memory_kv=None
                            ) -> Tuple[torch.Tensor, Params]:
    """``forward_with_state`` over a spec-driven sharder: ``caches`` (and
    ``memory_kv``) are this rank's blocks as the sharder's cache and
    memory specs split them; each attention layer runs
    ``layers.decode_attention_spmd``. Returns (hidden whole (B, 1, d),
    caches)."""
    plan = _check_spmd(cfg)
    n_units = cfg.n_layers // plan.period
    sp, d = sharder.specs, cfg.d_model
    x = _embed_spmd(params, cfg, tokens, sharder, cast_first=False)
    cp = int(cache_pos)
    xattn = (unstack(params["cross_attn"], n_units)
             if cfg.is_encoder_decoder and memory_kv is not None else None)
    x_spec = _stacked_spec(sp["cross_attn"]) if xattn else None
    mem_split = (sharder.memory_spec is not None
                 and sharder.memory_spec[2] == "model")
    for pos in range(plan.period):
        split = sharder.cache_specs[pos]["k"][2] == "model"
        unit_spec = _stacked_spec(sp["units"][pos])
        states = unstack(caches[pos], n_units)
        for u, layer_p in enumerate(unstack(params["units"][pos], n_units)):
            p = sharder.fsdp(layer_p, unit_spec, COMPUTE_DTYPE)
            h = L.rms_norm_spmd(x, p["norm1"], cfg.norm_eps, d, sharder)
            y, partial = L.decode_attention_spmd(
                p["attn"], h, cfg, sharder, cache=states[u], cache_pos=cp,
                cache_split=split)
            x = x + sharder.leave(y, partial, d)
            if xattn is not None:
                xp = sharder.fsdp(xattn[u], x_spec, COMPUTE_DTYPE)
                hx = L.rms_norm_spmd(x, xp["norm"], cfg.norm_eps, d,
                                     sharder)
                y, partial = L.decode_attention_spmd(
                    xp["attn"], hx, cfg, sharder,
                    memory=(memory_kv[0][u], memory_kv[1][u]),
                    memory_split=mem_split)
                x = x + sharder.leave(y, partial, d)
            h = L.rms_norm_spmd(x, p["norm2"], cfg.norm_eps, d, sharder)
            y, partial = L.mlp_spmd(p["mlp"], h, cfg)
            x = x + sharder.leave(y, partial, d)
    norm = sharder.fsdp(params["final_norm"], sp["final_norm"],
                        COMPUTE_DTYPE)
    return L.rms_norm_spmd(x, norm, cfg.norm_eps, d, sharder), caches


def caches_from_prefill(cfg: ModelConfig, extras, prompt_len: int,
                        max_len: int, dtype=COMPUTE_DTYPE) -> Params:
    """``forward(collect=True)`` extras -> decode caches. Attention: the
    post-RoPE prompt K/V scattered into (ring) cache buffers in one bulk
    write a position of the unit (the parallel-prefill path). Mamba /
    rwkv6: the final recurrent state IS the cache."""
    plan = plan_for(cfg)
    caches = []
    for pos in range(plan.period):
        if plan.mixers[pos] != "attn":
            caches.append(extras[pos])
            continue
        k, v = extras[pos]["k"], extras[pos]["v"]   # (U, B, T, Hkv, hd)
        U, B, T, Hkv, hd = k.shape
        S = max_len
        if cfg.sliding_window is not None:
            S = min(max_len, cfg.sliding_window)
        n = min(T, S)
        positions = torch.arange(T - n, T, device=k.device)
        slots = positions % S
        c = L.init_attention_cache(cfg, B, max_len, dtype, k.device,
                                   lead=(U,))
        c["k"][:, :, slots] = k[:, :, T - n:].to(dtype)
        c["v"][:, :, slots] = v[:, :, T - n:].to(dtype)
        c["pos"][:, :, slots] = positions.to(torch.int32)
        caches.append(c)
    return caches


def forward_with_state(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, caches: Params, cache_pos,
                       memory_kv=None, sharder: Sharder = NULL_SHARDER
                       ) -> Tuple[torch.Tensor, Params]:
    """Single-token decode step. tokens: (B, 1); ``cache_pos`` the token's
    position (an int). Updates ``caches`` in place (attention writes its
    K/V there; each mamba / rwkv6 layer's new state is copied over its
    old) and returns (hidden (B, 1, d), caches). A spec-driven sharder
    runs ``forward_with_state_spmd``."""
    if sharder.spmd:
        return forward_with_state_spmd(params, cfg, tokens, caches,
                                       cache_pos, sharder, memory_kv)
    plan = plan_for(cfg)
    n_units = cfg.n_layers // plan.period
    # gather, then cast: the reference's order on this path
    x = F.embedding(tokens, params["embed"]).to(COMPUTE_DTYPE)
    cp = int(cache_pos)
    positions = torch.tensor([cp], device=x.device)
    xattn = (unstack(params["cross_attn"], n_units)
             if cfg.is_encoder_decoder and memory_kv is not None else None)
    for pos in range(plan.period):
        mixer, mlp = plan.mixers[pos], plan.mlps[pos]
        states = unstack(caches[pos], n_units)     # views of the stacks
        for u, layer_p in enumerate(unstack(params["units"][pos], n_units)):
            mem = ((memory_kv[0][u], memory_kv[1][u])
                   if xattn is not None else None)
            x, new = _unit_forward(layer_p, x, positions, cfg, mixer, mlp,
                                   state=states[u], cache_pos=cp,
                                   memory=mem,
                                   xattn_p=xattn[u] if xattn else None)
            if mixer != "attn":
                for name, t in new.items():
                    states[u][name].copy_(t)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       hidden: torch.Tensor,
                       sharder: Sharder = NULL_SHARDER) -> torch.Tensor:
    """(B, T, d) -> (B, T, padded_vocab), in the hidden's dtype; the
    embedding transposed when the arch ties it. Over a spec-driven
    sharder (``hidden`` whole): this rank's columns of the vocabulary
    when the head is split over "model" (``head_spmd``)."""
    head = head_spmd(params, cfg, sharder) if sharder.spmd else (
        params["embed"].t() if cfg.tie_embeddings else params["lm_head"])
    return hidden @ head.to(hidden.dtype)


def head_spmd(params: Params, cfg: ModelConfig,
              sharder: Sharder) -> torch.Tensor:
    """The (d, V or V / |model|) output head, after the FSDP gather of
    this rank's shard."""
    if cfg.tie_embeddings:
        return sharder.fsdp(params["embed"], sharder.specs["embed"],
                            COMPUTE_DTYPE).t()
    return sharder.fsdp(params["lm_head"], sharder.specs["lm_head"],
                        COMPUTE_DTYPE)
