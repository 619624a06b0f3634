"""LM training and serving steps of the ten architectures.

As the reference (``repro.models.lm``):

  train_step(state, batch)        -> (state, metrics)
  prefill_step(params, batch)     -> (caches, first_token)
  decode_step(params, caches, …)  -> (caches, next_token)

Cross-entropy is CHUNKED: logits are made for ``CE_CHUNK`` tokens at a
time, so the (tokens x padded_vocab) logits tensor is never whole.
Prefill and decode run under ``torch.no_grad``; the train step
differentiates the forward (row 8 through ``layers.FlashAttention``) and
updates params and optimizer state in place.

Over k ranks (a ``Sharder`` with a mesh) the train step is the
reference's under ``Sharder(mesh)``: each rank holds its rows of the
batch (``shard_batch``), the MoE runs over "model" (``models.moe_dist``)
and the rest replicated over it; the loss is this rank's summed
cross-entropy over the GLOBAL count of valid labels (not a mean of the
ranks' means), the grads are summed over the batch axes, and the grad
norm counts each "model"-sharded leaf's shards once and each replicated
leaf once.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe_dist
from repro_torch.models import transformer as T
from repro_torch.models.common import (COMPUTE_DTYPE, NULL_SHARDER, Params,
                                       Sharder, tree_leaves, tree_map)
from repro_torch.parallel import primitives as P

CE_CHUNK = 512  # tokens per cross-entropy chunk


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------
def chunked_cross_entropy(params: Params, cfg: ModelConfig,
                          hidden: torch.Tensor, labels: torch.Tensor,
                          chunk: int = CE_CHUNK) -> torch.Tensor:
    """Mean CE over (B, T) labels without materializing (B, T, V) logits.

    hidden: (B, T, d). labels: (B, T) ints in [0, vocab). The logsumexp
    runs over the PADDED vocab; label positions >= vocab_size (padding
    ids) and < 0 are masked out."""
    loss_sum, count = cross_entropy_sums(params, cfg, hidden, labels, chunk)
    return loss_sum / count.clamp_min(1).float()


def cross_entropy_sums(params: Params, cfg: ModelConfig,
                       hidden: torch.Tensor, labels: torch.Tensor,
                       chunk: int = CE_CHUNK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``chunked_cross_entropy``'s (summed NLL fp32, count of valid
    labels int64), before the division."""
    B, Tlen, _ = hidden.shape
    chunk = min(chunk, Tlen)
    head = (params["embed"].t() if cfg.tie_embeddings
            else params["lm_head"]).to(COMPUTE_DTYPE)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, Tlen, chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk].long()
        logits = (h @ head).float()                           # (B, c, V)
        valid = (y >= 0) & (y < cfg.vocab_size)
        ysafe = y.clamp(0, cfg.padded_vocab - 1)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ysafe[..., None])[..., 0]
        loss_sum = loss_sum + ((logz - gold) * valid.float()).sum()
        count = count + valid.sum()
    return loss_sum, count


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def make_loss_fn(cfg: ModelConfig, sharder: Sharder = NULL_SHARDER):
    """loss_fn(params, batch): the mean CE of the batch. Under a sharder,
    ``batch`` is this rank's rows and the loss this rank's summed NLL over
    the global count of valid labels (psummed over the batch axes), so
    the ranks' losses and grads sum to the global batch's."""
    group = sharder.batch_group

    def loss_fn(params, batch):
        hidden = T.forward(params, cfg, batch["tokens"],
                           frontend_embeds=batch.get("frontend_embeds"),
                           encoder_embeds=batch.get("encoder_embeds"),
                           sharder=sharder)
        fe = (cfg.n_frontend_tokens
              if (cfg.frontend and not cfg.is_encoder_decoder) else 0)
        loss_sum, count = cross_entropy_sums(params, cfg, hidden[:, fe:, :],
                                             batch["labels"])
        count = P.psum(count, group)
        return loss_sum / count.clamp_min(1).float()
    return loss_fn


def shard_batch(batch: Dict[str, Any], sharder: Sharder) -> Dict[str, Any]:
    """This rank's rows of a global batch of B, B divisible by the n ranks
    of the batch axes (``LMTrainSession`` refuses another): every leading
    dim is the batch, and the rank at place r keeps rows
    [r B / n, (r + 1) B / n)."""
    n, r = sharder.batch_size, sharder.batch_rank
    if n == 1:
        return batch
    B = batch["tokens"].shape[0]
    return {k: v[r * B // n:(r + 1) * B // n] for k, v in batch.items()}


def value_and_grad(loss_fn, params: Params, batch) -> Tuple[torch.Tensor,
                                                             Params]:
    """(loss, grads) of ``loss_fn(params, batch)``, the grads a tree like
    ``params``; the params themselves are not marked for autograd."""
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not read gets zeros, as jax.grad gives it
    by_id = {id(x): torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda x: by_id[id(x)], live)


def loss_and_grads(loss_fn, params: Params, batch, sharder: Sharder
                   ) -> Tuple[torch.Tensor, Params]:
    """The global batch's (loss, grads) from this rank's part: each summed
    over the batch axes (a 1-rank group is skipped)."""
    loss, grads = value_and_grad(loss_fn, params, batch)
    group = sharder.batch_group
    if P.group_size(group) == 1:
        return loss, grads
    return P.psum(loss, group), tree_map(lambda g: P.psum(g, group), grads)


def make_train_step(cfg: ModelConfig, optimizer,
                    sharder: Sharder = NULL_SHARDER):
    """Returns step(train_state, batch) -> (train_state, metrics).

    ``optimizer`` follows ``repro_torch.optim``'s (init, update) protocol.
    The params and optimizer state are updated in place (``p += u``, the
    reference's ``p + u``) and the state dict is returned with the step
    advanced; metrics are the loss and the global grad norm (device
    scalars). Under a sharder, ``batch`` is this rank's rows, the params
    and optimizer state this rank's (its shards of the "model"-sharded
    expert weights), and the metrics the global batch's."""
    loss_fn = make_loss_fn(cfg, sharder)

    def step(state, batch):
        params = state["params"]
        loss, grads = loss_and_grads(loss_fn, params, batch, sharder)
        gnorm = global_norm(grads, moe_dist.sharded_leaves(grads, cfg,
                                                           sharder),
                            sharder.model_group)
        updates, new_opt = optimizer.update(grads, state["opt"], params)
        del grads
        with torch.no_grad():
            for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                p.add_(u)
        return ({"params": params, "opt": new_opt, "step": state["step"] + 1},
                {"loss": loss, "grad_norm": gnorm})
    return step


def global_norm(tree: Params, sharded=(), group=None) -> torch.Tensor:
    """The norm of every leaf as one vector. ``sharded`` leaves are this
    rank's shards over ``group``: their squares are summed over it, and
    every other leaf (replicated) counts once."""
    ids = {id(x) for x in sharded}
    total = sum(x.float().square().sum() for x in tree_leaves(tree)
                if id(x) not in ids)
    if ids:
        total = total + P.psum(sum(x.float().square().sum()
                                   for x in sharded), group)
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
def _greedy(cfg: ModelConfig, params: Params,
            hidden: torch.Tensor) -> torch.Tensor:
    """Argmax over the real vocab ([:vocab_size]) of the last position."""
    logits = T.logits_from_hidden(params, cfg, hidden[:, -1:, :])
    return torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1)


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """prefill(params, batch) -> (caches, next_token (B,)).

    PARALLEL prefill: one forward over the whole prompt (row 8 an
    attention layer; collect=True gathers each attention layer's post-RoPE
    K/V and each mamba / rwkv6 layer's final state), then one bulk scatter
    a position seeds the attention caches; the states are the SSM
    caches."""
    def prefill(params, batch):
        tokens = batch["tokens"]                               # (B, Tp)
        with torch.no_grad():
            hidden, extras = T.forward(
                params, cfg, tokens, collect=True,
                frontend_embeds=batch.get("frontend_embeds"),
                encoder_embeds=batch.get("encoder_embeds"))
            caches = T.caches_from_prefill(cfg, extras, hidden.shape[1],
                                           max_len)
            del extras
            return caches, _greedy(cfg, params, hidden)
    return prefill


def prefill_into_cache(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, caches: Params,
                       frontend_embeds=None, encoder_embeds=None,
                       ) -> Tuple[torch.Tensor, Params]:
    """The prompt through ``forward_with_state`` one token at a time (the
    serial prefill; row 9 a layer and token): returns (hidden (B, Tp, d),
    caches), the caches filled in place."""
    Tp = tokens.shape[1]
    with torch.no_grad():
        memory_kv = None
        if cfg.is_encoder_decoder and encoder_embeds is not None:
            enc_out = T.encode(params, cfg, encoder_embeds)
            memory_kv = T._project_kv_memory(cfg, params["cross_attn"],
                                             enc_out)
        hiddens = []
        for t in range(Tp):
            hid, caches = T.forward_with_state(
                params, cfg, tokens[:, t:t + 1], caches, t,
                memory_kv=memory_kv)
            hiddens.append(hid[:, 0])
    return torch.stack(hiddens, dim=1), caches


def make_decode_step(cfg: ModelConfig):
    """decode(params, caches, token (B,), pos) -> (caches, next_token (B,)):
    one new token against the caches (row 9 a self-attention layer; a
    mamba / rwkv6 layer steps its state)."""
    def decode(params, caches, token, pos, memory_kv=None):
        with torch.no_grad():
            hid, caches = T.forward_with_state(
                params, cfg, token[:, None], caches, pos,
                memory_kv=memory_kv)
            return caches, _greedy(cfg, params, hid)
    return decode


# ---------------------------------------------------------------------------
# Reduced-config smoke helpers (used by tests and the smoke script)
# ---------------------------------------------------------------------------
def smoke_batch(cfg: ModelConfig, batch: int = 2, seq: int = 16,
                seed: int = 0, device=None) -> Dict[str, Any]:
    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    dev = g.device
    out = {
        "tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                generator=g, device=dev),
        "labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                generator=g, device=dev),
    }
    if cfg.frontend is not None and not cfg.is_encoder_decoder:
        out["frontend_embeds"] = torch.zeros(
            (batch, cfg.n_frontend_tokens, cfg.d_model), device=dev)
    if cfg.is_encoder_decoder:
        out["encoder_embeds"] = torch.zeros(
            (batch, cfg.encoder_seq_len, cfg.d_model), device=dev)
    return out
