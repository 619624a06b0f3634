"""Shared model utilities: param init, the dtype policy, param counting.

Params are plain trees (nested dicts and lists of tensors), as the
reference's pytrees, so weights carry across through
``repro_torch.convert`` unchanged. Master params are fp32; compute is
bf16, as in the reference. Init draws from an explicit
``torch.Generator`` on the params' device; its numbers are not
``jax.random``'s, so tests hand both packages the same numpy params.

The reference's ``Sharder`` is the identity without a mesh; the port runs
on one rank and leaves it out until the LM runs over k ranks (ROADMAP
A6b-ii).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

Params = Any  # nested dict / list tree of tensors

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# ----------------------------------------------------------------- param init
def _normal(shape: Tuple[int, ...], std: float,
            generator: torch.Generator, dtype=PARAM_DTYPE) -> torch.Tensor:
    x = torch.empty(shape, device=generator.device, dtype=torch.float32)
    return x.normal_(0.0, std, generator=generator).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: float = 1.0, dtype=PARAM_DTYPE,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """(*lead, d_in, d_out) of N(0, (scale / sqrt(d_in))^2): ``lead`` stacks
    that many independent weights (units of layers, experts)."""
    return _normal(tuple(lead) + (d_in, d_out), scale / math.sqrt(d_in),
                   generator, dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    return _normal((vocab, d), 0.02, generator, dtype)


def tree_map(fn, tree: Params, *rest: Params) -> Params:
    """``fn`` on every tensor leaf of a tree of dicts, lists and tuples, and
    on the leaves at the same paths of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unstack(tree: Params, n: int) -> list:
    """A tree stacked over a leading dim of ``n`` -> ``n`` trees of views.
    Under autograd each leaf's grad comes back stacked in one op (the
    backward of ``unbind``), not as ``n`` zero-padded slices."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def tree_leaves(tree: Params) -> list:
    """The tensor leaves in the reference's order (dict keys sorted, list
    items by position)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def count_params(tree: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))
