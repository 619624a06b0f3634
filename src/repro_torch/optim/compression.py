"""Int8 block-quantized all-reduce with error feedback, for the dense
grads (the reference's ``src/repro/optim/compression.py``).

Each leaf is cut into blocks of ``BLOCK`` elements, each block scaled by
its absmax to int8 (round half to even, as ``jnp.round`` and
``torch.round`` both do). The residual ``x - dequant(quant(x))`` is kept
per rank and added to the next step's grads before they are quantized,
so the quantization noise cancels over the steps.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from repro_torch.parallel.primitives import Group, group_size, psum

BLOCK = 256


def int8_compress(x: torch.Tensor, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (q int8 (nblk, block), scales fp32 (nblk,)): the
    flattened x, zero-padded to whole blocks."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    flat = flat.reshape(-1, block)
    absmax = flat.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones((), dtype=absmax.dtype,
                                   device=absmax.device))
    q = torch.round(flat / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor,
                    shape: Tuple[int, ...],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The inverse up to rounding: (nblk, block) int8 and (nblk,) scales
    -> a tensor of ``shape`` in ``dtype``."""
    n = 1
    for s in shape:
        n *= s
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:n].reshape(shape).to(dtype)


def make_compressed_allreduce(group: Group, block: int = BLOCK) -> Callable:
    """``allreduce_fn(leaves, ef) -> (mean_leaves, new_ef)`` over the ranks
    of ``group``, on lists of tensors: each grad plus its residual is
    quantized, the dequantized values are summed over the ranks (one
    all-reduce of all leaves) and divided by the rank count; the new
    residual is the pre-wire error. The residuals start as fp32 zeros
    like the grads (``parallel.build.init_error_feedback`` for the
    DLRM's MLPs); the reference's ``init_ef`` has no counterpart here."""
    def allreduce(leaves: List[Any], ef: List[torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        n = group_size(group)
        deq, new_ef = [], []
        for g, e in zip(leaves, ef):
            g = g.float() + e
            q, scale = int8_compress(g, block)
            d = int8_decompress(q, scale, tuple(g.shape))
            deq.append(d)
            new_ef.append(g - d)
        summed = psum(torch.cat([d.reshape(-1) for d in deq]), group)
        out, at = [], 0
        for d in deq:
            out.append(summed[at:at + d.numel()].reshape(d.shape) / n)
            at += d.numel()
        return out, new_ef

    return allreduce
