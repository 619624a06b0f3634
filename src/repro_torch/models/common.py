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

With ``specs`` (the filtered ``models.sharding_rules`` specs of the
params) the sharder is spec-driven, the port's stand-in for XLA's SPMD
partitioner on the dry-run's cells: every rank holds its shard of each
leaf, and the model (``layers``, ``transformer``, ``lm``) issues the
collectives the specs imply.

  * FSDP: before each unit, every leaf split over "data" is all-gathered
    over "data" (``fsdp``, ``primitives.ad_all_gather``); its backward
    is the grads' reduce-scatter, and under ``forward(remat=)`` the
    recompute gathers again.
  * TP over "model": the residual stream is split over "model" along d
    between units, as the reference's ``batch_act`` constrains it (a
    sublayer's pre-norm normalizes each rank's columns and all-gathers
    them, ``layers.rms_norm_spmd``; ``leave`` brings a sublayer's result
    back: a partial sum is reduce-scattered, a result every rank
    computed whole is narrowed to the rank's columns).
    Column-parallel weights give their output split over "model";
    row-parallel ones take it so and give partial sums.

  Cotangents follow one convention. The residual stream carries whole
  cotangents; inside a sublayer a value every rank of "model" holds alike
  carries this rank's part of its cotangent, so the grad of a leaf whole
  over "model" is a part, summed over "model" after the backward
  (``sync_grads``), and the all-gather into a sublayer sums the parts of
  the stream's cotangent in its backward.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.models.sharding_rules import DATA, MODEL, _axes

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
                 moe_impl: str = "auto", specs=None, cache_specs=None,
                 memory_spec=None):
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got "
                             f"{moe_impl!r}")
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.moe_impl = moe_impl
        # the spec-driven mode (see the module doc): the params' filtered
        # specs, the caches' (a position of the unit each) and whisper's
        # memory_kv's, as ``models.sharding_rules`` gives them
        self.specs = specs
        self.cache_specs = cache_specs
        self.memory_spec = memory_spec

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


    # ----------------------------------------------- the spec-driven mode
    @property
    def spmd(self) -> bool:
        return self.specs is not None

    def group(self, axes: Sequence[str]):
        """The group over ``axes`` (those in the mesh, in its order); None
        for one rank."""
        names = tuple(a for a in self.mesh.axis_names if a in tuple(axes))
        return self.mesh.group(names) if self.axis_size(names) > 1 else None

    def fsdp(self, tree, specs, dtype=None):
        """``tree`` (this rank's shards) with every dim split over "data"
        all-gathered over "data" under autograd: each leaf whole but for
        its split over "model". A leaf it gathers is cast to ``dtype``
        (the compute dtype) first, so the gather moves, and the grads'
        reduce-scatter sums, that dtype."""
        if isinstance(tree, dict):
            return {k: self.fsdp(v, specs[k], dtype) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.fsdp(v, s, dtype)
                              for v, s in zip(tree, specs))
        from repro_torch.parallel.primitives import ad_all_gather
        for dim, entry in enumerate(specs):
            if _axes(entry) == (DATA,):
                if dtype is not None:
                    tree = tree.to(dtype)
                tree = ad_all_gather(tree, dim, self.group((DATA,)))
        return tree

    def residual_split(self, d: int) -> bool:
        """Whether the residual stream of width ``d`` is split over
        "model" (the reference's ``batch_act``: when |model| divides d)."""
        M = self.model_size
        return M > 1 and d % M == 0

    def leave(self, y: torch.Tensor, partial: bool, d: int) -> torch.Tensor:
        """A sublayer's (..., d) result -> the residual stream's layout:
        a partial sum over "model" reduce-scattered along d (or psummed,
        unsplit); a whole result narrowed to this rank's columns (or,
        unsplit, counted once in the backward)."""
        from repro_torch.parallel import primitives as P
        group = self.model_group
        if P.group_size(group) == 1:
            return y
        if self.residual_split(d):
            if partial:
                return P.ad_psum_scatter(y, y.dim() - 1, group)
            n = d // self.model_size
            return y.narrow(y.dim() - 1, self.model_rank * n, n)
        return P.ad_psum(y, group) if partial else P.first_rank_grad(
            y, group)

    def columns(self, local: int, full: int) -> Tuple[int, int]:
        """The range of a dim of ``full`` a rank holds ``local`` of: split
        over "model" (its block) or whole."""
        if local == full:
            return 0, full
        return self.model_rank * local, (self.model_rank + 1) * local

    def sync_grads(self, grads, specs):
        """Each leaf's grad summed over the batch axes it is not split
        over (an FSDP leaf's backward has reduce-scattered it over
        "data"), and over "model" when the leaf is whole over "model"
        (its grad there is this rank's part)."""
        if isinstance(grads, dict):
            return {k: self.sync_grads(v, specs[k]) for k, v in grads.items()}
        if isinstance(grads, (list, tuple)):
            return type(grads)(self.sync_grads(g, s)
                               for g, s in zip(grads, specs))
        from repro_torch.parallel import primitives as P
        held = {a for entry in specs for a in _axes(entry)}
        axes = [a for a in self.batch_axes + (MODEL,) if a not in held]
        group = self.group(axes)
        return grads if group is None else P.psum(grads, group)


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


# The init of the attention and dense-MLP archs' leaves by name: the one
# table ``layers.init_attention``, ``layers.init_mlp``,
# ``transformer.init_model`` and the dry-run's per-rank draw
# (``launch.steps.draw_params``) read.
EMBED_STD = 0.02
RESIDUAL_OUT = ("wo", "w_down")      # scaled by 1 / sqrt(2 n_layers)


def init_std(name: str, shape: Tuple[int, ...], n_layers: int
             ) -> Optional[float]:
    """The spread a leaf named ``name`` of (whole) ``shape`` is drawn
    with: N(0, (scale / sqrt(d_in))^2) for a (..., d_in, d_out) weight,
    0.02 for the embedding; 0.0 for the biases (zeros), None for the
    norms (ones)."""
    if "norm" in name:
        return None
    if name in ("bq", "bk", "bv"):
        return 0.0
    if name == "embed":
        return EMBED_STD
    scale = (1.0 / math.sqrt(2 * n_layers) if name in RESIDUAL_OUT
             else 1.0)
    return scale / math.sqrt(shape[-2])


def init_leaf(generator: torch.Generator, name: str,
              shape: Tuple[int, ...], n_layers: int) -> torch.Tensor:
    """A leaf of ``shape`` drawn as ``init_std`` says."""
    std = init_std(name, shape, n_layers)
    if std is None:
        return torch.ones(shape, dtype=PARAM_DTYPE, device=generator.device)
    if std == 0.0:
        return torch.zeros(shape, dtype=PARAM_DTYPE,
                           device=generator.device)
    return _normal(shape, std, generator)


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
