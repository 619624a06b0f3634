"""Synthetic LM token pipeline (the same stateless step-indexed contract as
the recsys pipeline).

As the reference (``repro.data.lm``): tokens follow a planted bigram chain
so cross-entropy has learnable structure: token t+1 = hash(token t) with
probability ``chain_prob``, else uniform. A model that learns the chain
drops below the uniform-entropy floor.

The draws come from a ``torch.Generator`` on the batch's device, so they
differ from ``jax.random``'s; ``chain_tokens`` is the deterministic core
that, fed the same draws, gives the reference's tokens.
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.recsys import _generator
from repro_torch.device import DeviceArg, resolve_device

_LCG_MULT, _LCG_ADD = 1103515245, 12345
_SALT = 0x2545F4914F6CDD1D     # apart from the recsys stream's seeds


def chain_step(tok: torch.Tensor, vocab: int) -> torch.Tensor:
    """The chain's successor ``uint32(tok * 1103515245 + 12345) % vocab``:
    the reference's uint32 arithmetic with its wrap, done in int64."""
    return ((tok.long() * _LCG_MULT + _LCG_ADD) & 0xFFFFFFFF) % vocab


def chain_tokens(first: torch.Tensor, use_chain: torch.Tensor,
                 uniform: torch.Tensor, vocab: int) -> torch.Tensor:
    """first (B,), use_chain (B, T) bool, uniform (B, T) -> tokens (B, T)
    int64: token t is the chain's successor of token t-1 (``first`` before
    token 0) where ``use_chain``, else the uniform draw."""
    tok = first.long()
    out = []
    for t in range(use_chain.shape[1]):
        tok = torch.where(use_chain[:, t], chain_step(tok, vocab),
                          uniform[:, t].long())
        out.append(tok)
    return torch.stack(out, dim=1)


def make_lm_batch(cfg: ModelConfig, step: int, seed: int = 0,
                  batch: int = 8, seq: int = 128, chain_prob: float = 0.8,
                  device: DeviceArg = None) -> Dict[str, torch.Tensor]:
    """Pure function (cfg, step, seed) -> {"tokens", "labels"} (B, seq-1)
    int64, the labels the tokens shifted by one, on ``device``; plus zero
    "frontend_embeds" (VLM stub) or N(0, 0.02^2) "encoder_embeds" (enc-dec)
    fp32, as the reference."""
    dev = resolve_device(device)
    g = _generator(dev, (seed ^ _SALT) * 0x9E3779B97F4A7C15 + step)
    V = cfg.vocab_size
    first = torch.randint(0, V, (batch,), generator=g, device=dev)
    use_chain = torch.rand((batch, seq), generator=g, device=dev) < chain_prob
    uniform = torch.randint(0, V, (batch, seq), generator=g, device=dev)
    tokens = chain_tokens(first, use_chain, uniform, V)
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.frontend is not None and not cfg.is_encoder_decoder:
        out["frontend_embeds"] = torch.zeros(
            (batch, cfg.n_frontend_tokens, cfg.d_model), device=dev)
    if cfg.is_encoder_decoder:
        out["encoder_embeds"] = torch.randn(
            (batch, cfg.encoder_seq_len, cfg.d_model), generator=g,
            device=dev) * 0.02
    return out


def lm_batch_iterator(cfg: ModelConfig, seed: int = 0, start_step: int = 0,
                      batch: int = 8, seq: int = 128,
                      device: DeviceArg = None
                      ) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield make_lm_batch(cfg, step, seed, batch, seq, device=device)
        step += 1
