"""Shared model utilities: param init, the dtype policy, param counting.

Params are plain trees (nested dicts and lists of tensors), as the
reference's pytrees, so weights carry across through
``repro_torch.convert`` unchanged. Master params are fp32; compute is
bf16, as in the reference. Init draws from an explicit
``torch.Generator`` on the params' device; its numbers are not
``jax.random``'s, so tests hand both packages the same numpy params.

``Sharder`` is the reference's mesh context of the LM over k ranks
(``torch.distributed`` ranks laid out by ``launch.mesh.Mesh``): the batch
axes split the batch, "model" carries the MoE (``models.moe_dist``), and
everything else is computed replicated over "model". ``NULL_SHARDER`` has
no mesh: one rank. The reference's ``act`` and ``batch_act`` are
placement constraints (``with_sharding_constraint``), which change where
XLA keeps a value and not its numbers; eager torch has no counterpart,
so they are left out.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch

Params = Any  # nested dict / list tree of tensors

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32

MOE_IMPLS = ("auto", "global", "local", "ep")


class Sharder:
    """The mesh a model runs over, or none (one rank).

    ``mesh`` is a ``launch.mesh.Mesh``; ``batch_axes`` (the reference's
    default ("data",)) split the batch; the tensor- and expert-parallel
    axis is "model", as the reference's MoE bodies assume. ``moe_impl``
    picks the MoE body, in place of the reference's ``REPRO_MOE_IMPL``
    environment variable: "global" (the global formulation over the
    whole batch), "local" (``moe_block_local_dispatch``), "ep"
    (``moe_block_ep_a2a``) or "auto" (ep when E % |model| == 0 and
    |model| > 1, else local)."""

    def __init__(self, mesh=None, batch_axes: Sequence[str] = ("data",),
                 moe_impl: str = "auto"):
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got "
                             f"{moe_impl!r}")
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.moe_impl = moe_impl

    def axis_size(self, names: Sequence[str]) -> int:
        return 1 if self.mesh is None else self.mesh.size(tuple(names))

    @property
    def batch_size(self) -> int:
        """Ranks along the batch axes: the batch splits into this many."""
        return self.axis_size(self.batch_axes)

    @property
    def batch_group(self):
        return None if self.mesh is None else self.mesh.group(
            self.batch_axes)

    @property
    def batch_rank(self) -> int:
        """This rank's place along the batch axes: it holds rows
        [r B / n, (r + 1) B / n) of a global batch of B."""
        return 0 if self.mesh is None else self.mesh.rank_in(
            self.batch_axes)

    @property
    def has_model(self) -> bool:
        return self.mesh is not None and "model" in self.mesh.shape

    @property
    def model_size(self) -> int:
        return self.mesh.shape["model"] if self.has_model else 1

    @property
    def model_group(self):
        return self.mesh.group("model") if self.has_model else None

    @property
    def model_rank(self) -> int:
        return self.mesh.coords["model"] if self.has_model else 0

    def moe_body(self, num_experts: int) -> Optional[str]:
        """The body a MoE layer of ``num_experts`` experts calls:
        "ep", "local", or None for the global formulation (no mesh, no
        "model" axis, or ``moe_impl="global"``), as the reference's
        ``moe_block`` dispatches."""
        if not self.has_model or self.moe_impl == "global":
            return None
        M = self.model_size
        if self.moe_impl == "ep" or (self.moe_impl == "auto"
                                     and num_experts % M == 0 and M > 1):
            return "ep"
        return "local"


NULL_SHARDER = Sharder(None)


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
