"""Sparse optimizer row updates (paper Alg. 2's scatter-add phase).

They take expanded flat gradients, (T, N) row ids and (T, N, d) row grads
per table group, from an exchange's backward routing; the dense (T, R, d)
embedding gradient never exists. Both update the tables (and AdaGrad's
accumulators) IN PLACE with ``index_add_``, where the reference returns
new arrays: at full width a copy of the tables is 21.5 GB.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.dlrm import scatter_add_rows


def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX combines it with an array of ``dtype`` (a
    weak type takes the array's dtype): ``x`` rounded to ``dtype``."""
    return float(torch.tensor(x, dtype=dtype))


def sgd_row_update(lr: float) -> Callable:
    """fn(tables, flat_idx, flat_g) -> tables: ``tab.at[idx].add((-lr *
    g).astype(tab.dtype))`` per table, in place. ``-lr`` is rounded to the
    grads' dtype first, as JAX's weak-typed scalar is (bf16 grads: the
    tiered exchange's bulk group)."""
    def update(tables, flat_idx, flat_g):
        with torch.no_grad():
            scatter_add_rows(tables, flat_idx,
                             (_weak(-lr, flat_g.dtype) * flat_g).to(
                                 tables.dtype))
        return tables
    return update


def adagrad_row_update(lr: float, eps: float = 1e-8) -> Callable:
    """Row-wise AdaGrad (the DLRM repo's sparse optimizer). State: a (T, R)
    fp32 accumulator. fn(tables, acc, flat_idx, flat_g) -> (tables, acc),
    in place: the accumulator first takes the mean square of every row
    grad (repeated ids accumulate), then each row moves by -lr * g /
    sqrt(acc[row] + eps), read after the whole accumulate."""
    def update(tables, acc, flat_idx, flat_g):
        with torch.no_grad():
            g_sq = flat_g.square().mean(dim=-1)                  # (T, N)
            scatter_add_rows(acc, flat_idx, g_sq.to(acc.dtype))
            T, R = acc.shape
            idx = flat_idx.long()
            idx = torch.where(idx < 0, idx + R, idx).clamp(0, R - 1)
            scale = torch.rsqrt(torch.gather(acc, 1, idx) + eps)  # (T, N)
            scatter_add_rows(tables, flat_idx,
                             (-lr * scale[..., None] * flat_g).to(
                                 tables.dtype))
        return tables, acc
    return update
