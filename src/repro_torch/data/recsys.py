"""Synthetic Criteo-like click log for DLRM, drawn on the device.

As in the reference (``repro.data.recsys``):

  * a batch is a pure function of (seed, step), so a restarted job sees
    the same stream;
  * row ids follow a power law (Zipf, ``alpha``; 0 is uniform, the
    paper's zero-locality case), scattered over the table by a fixed
    multiplicative hash;
  * labels come from a planted logistic teacher.

The generator is a ``torch.Generator`` on the batch's device, so its
draws differ from ``jax.random``'s. ``zipf_from_uniform`` is the
deterministic core that turns uniform draws into row ids; fed the same
uniforms, it gives the reference's ids.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.device import DeviceArg, resolve_device

RecSysBatch = Dict[str, torch.Tensor]

# Weight of the table-borne (sparse) component of the teacher's logit,
# relative to the dense component's unit scale (the reference's value).
SPARSE_SIGNAL = 0.75

_HASH_MULT = 2654435761        # odd: a bijection on rows mod 2^k tables
_MASK64 = (1 << 64) - 1


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed & _MASK64)


def teacher_click_probs(cfg: DLRMConfig, dense: torch.Tensor,
                        indices: torch.Tensor, seed: int = 0
                        ) -> torch.Tensor:
    """The planted teacher's P(click): a dense logistic term (weights fixed
    by ``seed``, not by step) plus the sparse term of the reference,
    ``SPARSE_SIGNAL * mean_t((ids[:, t, 0] % 7) - 3)``."""
    g = _generator(dense.device, seed + 10_007)
    w = (torch.randn(cfg.num_dense, generator=g, device=dense.device)
         / math.sqrt(cfg.num_dense))
    sig = dense @ w + SPARSE_SIGNAL * (
        (indices[:, :, 0] % 7).float() - 3.0).mean(dim=1)
    return torch.sigmoid(2.0 * sig)


def row_hash(ranks: torch.Tensor, n_rows: int) -> torch.Tensor:
    """rank -> row id: ``uint32(rank * 2654435761) % n_rows``, the
    reference's uint32 arithmetic with wraparound, computed in int64."""
    return (((ranks.long() * _HASH_MULT) & 0xFFFFFFFF) % n_rows).to(
        torch.int32)


def zipf_from_uniform(u: torch.Tensor, n_rows: int,
                      alpha: float) -> torch.Tensor:
    """Uniform draws u in (0, 1) float32 -> int32 row ids with
    P(rank r) ~ (r+1)^-alpha (inverse-CDF sampling of a power law
    truncated to [1, n_rows]), then scattered by ``row_hash``."""
    if alpha == 0.0:
        ranks = (u * n_rows).to(torch.int32)
    else:
        a1 = 1.0 - alpha
        if abs(a1) < 1e-6:
            ranks = torch.exp(u * math.log(n_rows)).to(torch.int32) - 1
        else:
            hi = float(n_rows) ** a1
            ranks = (torch.pow(u * (hi - 1.0) + 1.0, 1.0 / a1)
                     - 1.0).to(torch.int32)
    return row_hash(ranks.clamp(0, n_rows - 1), n_rows)


def zipf_indices(generator: torch.Generator, shape: Tuple[int, ...],
                 n_rows: int, alpha: float) -> torch.Tensor:
    """Power-law row ids of ``shape`` drawn on the generator's device."""
    u = torch.rand(shape, generator=generator,
                   device=generator.device).clamp_(min=1e-9)
    return zipf_from_uniform(u, n_rows, alpha)


def make_recsys_batch(cfg: DLRMConfig, step: int, seed: int = 0,
                      alpha: float = 0.0, batch_size: Optional[int] = None,
                      device: DeviceArg = None) -> RecSysBatch:
    """Pure function (cfg, step, seed) -> {"dense" (b, D) fp32,
    "indices" (b, T, L) int32, "labels" (b,) fp32} on ``device``."""
    dev = resolve_device(device)
    b = batch_size or cfg.batch_size
    g = _generator(dev, seed * 0x9E3779B97F4A7C15 + step)
    dense = torch.randn((b, cfg.num_dense), generator=g, device=dev)
    indices = zipf_indices(
        g, (b, cfg.num_tables, cfg.lookups_per_table), cfg.rows_per_table,
        alpha)
    p = teacher_click_probs(cfg, dense, indices, seed)
    labels = torch.bernoulli(p, generator=g)
    return {"dense": dense, "indices": indices, "labels": labels}


def recsys_batch_iterator(cfg: DLRMConfig, seed: int = 0, alpha: float = 0.0,
                          start_step: int = 0,
                          batch_size: Optional[int] = None,
                          device: DeviceArg = None) -> Iterator[RecSysBatch]:
    """Infinite deterministic stream of ``make_recsys_batch`` from
    ``start_step`` on; a restart passes its checkpoint's step."""
    step = start_step
    while True:
        yield make_recsys_batch(cfg, step, seed, alpha, batch_size, device)
        step += 1
