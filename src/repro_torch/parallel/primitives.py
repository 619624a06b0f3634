"""Collective primitives for distributed DLRM: paper Algorithms 1 and 2
(the reference's ``src/repro/parallel/primitives.py``).

Each rank runs these functions on its own shard, as each device runs the
reference's inside ``shard_map``; ``group`` is the process group of the
embedding axis (``launch.mesh.Mesh.group``), and a rank's place in it is
its shard's index. A group of one rank is None: every collective is then
skipped, not called, and what is left is the computation of one device.

  table-wise (the paper's "unsharded"): each rank owns T/n whole tables.
    Forward: an all-to-all of the ids (batch-major -> table-major), the
    owner's pool of its whole tables through row 4 (``ops.embedding_bag``),
    an all-to-all of the pooled rows back (table-major -> batch-major).

  row-wise (the paper's "full sharding"): every table's rows are
    range-sharded, rank r owning [r R/n, (r+1) R/n). Forward: an
    all_gather of the ids, the owned rows masked in, then a psum_scatter
    over the batch of the partial pools ("partial_pool") or of the
    unpooled rows, in chunks ("unpooled", the paper's wire).

Backward (Alg. 2): the pooled grads go back to the row owners (an
all-to-all table-wise, an all_gather row-wise), are expanded to every
looked-up row and applied by a sparse optimizer; the dense (T, R, d)
embedding gradient never exists.

Every collective goes through one small wrapper (``all_to_all``,
``all_gather``, ``psum_scatter``, ``psum``, ``pmax``, ``broadcast``,
which moves a tree's pieces between boards of a fleet and agrees a
board's results with the ranks outside it, and ``gather``, which brings
a checkpoint's blocks to one rank's host memory). gloo takes CUDA
tensors for the first six (measured on PyTorch 2.11's gloo, which copies them
through host memory itself), so no wrapper stages a tensor through the
host. ``call_counts`` counts every collective a wrapper ran, by the
tensor's device. No wrapper catches an error of a collective.

The LM over k ranks (``models.moe_dist``) differentiates through its
collectives: ``ad_all_gather``, ``ad_psum_scatter`` and ``ad_all_to_all``
are the wrappers under autograd along any dim, each backward the
forward's transpose (``psum_scatter``, ``all_gather``, the inverse
all-to-all), and ``shard_in``, ``replicate_in`` and ``gather_out`` are
the boundaries of the reference's ``shard_map``. The convention: a value
replicated over an axis has its whole cotangent on every rank of that
axis, so the grads of params replicated over "model" are never summed
over "model" (``replicate_in`` sums what a body computed from this
rank's part alone), while data shards are disjoint, so every grad is
summed over the batch axes (``models.lm.make_train_step``). The backward
passes go through the same counted wrappers.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import dlrm as dlrm_lib
from repro_torch.kernels import ops

Group = Optional[dist.ProcessGroup]
COLLECTIVES = ("all_to_all", "all_gather", "psum_scatter", "psum", "pmax",
               "broadcast", "gather")
call_counts: Dict[str, int] = {f"{c}_{where}": 0 for c in COLLECTIVES
                               for where in ("cuda", "cpu")}


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _run(name: str, fn: Callable, out: torch.Tensor,
         inp: torch.Tensor) -> torch.Tensor:
    """``fn(out, inp)``, the collective, counted by ``inp``'s device."""
    fn(out, inp)
    call_counts[f"{name}_{'cuda' if inp.is_cuda else 'cpu'}"] += 1
    return out


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               group: Group) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    x split along ``split_axis`` into n chunks, chunk j sent to rank j, the
    chunks received concatenated along ``concat_axis`` in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    shape = x.shape
    s, c = split_axis, concat_axis
    send = x.reshape(shape[:s] + (n, shape[s] // n) + shape[s + 1:]) \
        .movedim(s, 0).contiguous()
    recv = _run("all_to_all",
                lambda o, i: dist.all_to_all_single(o, i, group=group),
                torch.empty_like(send), send)
    chunk = send.shape[1:]
    return recv.movedim(0, c).reshape(
        chunk[:c] + (n * chunk[c],) + chunk[c + 1:])


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=0, tiled=True)``."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return _run("all_gather",
                lambda o, i: dist.all_gather_into_tensor(o, i, group=group),
                out, x)


def psum_scatter(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``:
    the sum over the ranks, rank r keeping rows [r B/n, (r+1) B/n)."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return _run("psum_scatter",
                lambda o, i: dist.reduce_scatter_tensor(o, i, group=group),
                out, x)


def _all_reduce(name: str, x: torch.Tensor, group: Group,
                op) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    out = x.contiguous().clone()

    def reduce(o, i):
        if o is not i:
            o.copy_(i)
        dist.all_reduce(o, op=op, group=group)

    return _run(name, reduce, out, out)


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``jax.lax.psum(x, axis)``, into a new tensor."""
    return _all_reduce("psum", x, group, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``jax.lax.pmax(x, axis)``, into a new tensor."""
    return _all_reduce("pmax", x, group, dist.ReduceOp.MAX)


def broadcast(x: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """``x`` as the global rank ``src`` holds it, written in place into
    ``x`` (contiguous) on every rank of ``group``."""
    if group_size(group) == 1:
        return x
    return _run("broadcast",
                lambda o, i: dist.broadcast(o, src=src, group=group), x, x)


def gather(x: torch.Tensor, dst: int, group: Group
           ) -> Optional[List[torch.Tensor]]:
    """The ``x`` of every rank of ``group``, in group order, on the global
    rank ``dst`` (None on the others). ``x`` lies in host memory: gloo
    gathers CPU tensors only."""
    if group_size(group) == 1:
        return [x]
    x = x.contiguous()
    parts = ([torch.empty_like(x) for _ in range(group_size(group))]
             if dist.get_rank() == dst else None)
    return _run("gather",
                lambda o, i: dist.gather(i, o, dst=dst, group=group),
                parts, x)


# ---------------------------------------------------------------------------
# Collectives under autograd
# ---------------------------------------------------------------------------
def _along(fn: Callable, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn`` (a dim-0 collective) applied along ``dim``."""
    if dim == 0:
        return fn(x)
    return fn(x.movedim(dim, 0)).movedim(0, dim)


def _rank_slice(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """This rank's 1/n of ``x`` along ``dim``, in a tensor of its own."""
    n = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * n, n).clone(
        memory_format=torch.contiguous_format)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _along(lambda t: all_gather(t, group), x, dim)

    @staticmethod
    def backward(ctx, g):
        return (_along(lambda t: psum_scatter(t, ctx.group), g, ctx.dim),
                None, None)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _along(lambda t: psum_scatter(t, group), x, dim)

    @staticmethod
    def backward(ctx, g):
        return (_along(lambda t: all_gather(t, ctx.group), g, ctx.dim),
                None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        s, c = ctx.axes
        return all_to_all(g.contiguous(), c, s, ctx.group), None, None, None


class _ShardIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _rank_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (_along(lambda t: all_gather(t, ctx.group), g, ctx.dim),
                None, None)


class _ReplicateIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _along(lambda t: all_gather(t, group), x, dim)

    @staticmethod
    def backward(ctx, g):
        return _rank_slice(g, ctx.dim, ctx.group), None, None


def ad_all_gather(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)`` under
    autograd; its backward is ``psum_scatter`` along ``dim``."""
    return x if group_size(group) == 1 else _AllGather.apply(x, dim, group)


def ad_psum_scatter(x: torch.Tensor, dim: int, group: Group
                    ) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``
    under autograd; its backward is ``all_gather`` along ``dim``."""
    return x if group_size(group) == 1 else _PsumScatter.apply(x, dim,
                                                               group)


def ad_all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
                  group: Group) -> torch.Tensor:
    """``all_to_all`` under autograd; its backward is the inverse
    all-to-all (split and concat axes swapped)."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, split_axis, concat_axis, group)


def shard_in(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """A value replicated over ``group`` entering a ``shard_map`` split
    along ``dim``: forward, this rank's slice; backward, the slices'
    cotangents all-gathered (the whole cotangent on every rank)."""
    return x if group_size(group) == 1 else _ShardIn.apply(x, dim, group)


def replicate_in(x: torch.Tensor, group: Group) -> torch.Tensor:
    """A ``P()`` input of a ``shard_map`` (the router): forward, the
    identity; backward, the cotangents psummed over ``group``, since each
    rank's body saw only its part of the tokens or of d_ff."""
    return x if group_size(group) == 1 else _ReplicateIn.apply(x, group)


def gather_out(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """A ``shard_map`` output split along ``dim`` leaving replicated over
    ``group``: forward, the slices all-gathered; backward, this rank's
    slice of the (replicated) cotangent."""
    return x if group_size(group) == 1 else _GatherOut.apply(x, dim, group)


# ---------------------------------------------------------------------------
# Table-wise (paper "unsharded") exchange
# ---------------------------------------------------------------------------
def table_wise_forward(tables_local: torch.Tensor,
                       indices_local: torch.Tensor, group: Group
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1, no-sharding branch. tables_local (T/n, R, d), this rank's
    whole tables; indices_local (B/n, T, L), this rank's batch slice ->
    (pooled (B/n, T, d), owner ids (B, T/n, L), the ids this rank looked
    up). At n=1 the pool is ``dlrm.embedding_bag`` on the ids as given;
    over more ranks the owner pools through row 4 (``ops.embedding_bag``,
    the reference's ``dlrm_lib.embedding_bag`` on the same tables)."""
    if group_size(group) == 1:
        return dlrm_lib.embedding_bag(tables_local, indices_local), \
            indices_local
    owner_idx = all_to_all(indices_local, 1, 0, group)     # (B, T/n, L)
    pooled_owner = ops.embedding_bag(tables_local, owner_idx)
    return all_to_all(pooled_owner, 0, 1, group), owner_idx


def table_wise_expand_grads(ctx: torch.Tensor, g_pooled: torch.Tensor,
                            group: Group = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 for whole tables: the (B/n, T, d) pooled grads routed to
    the owners (an all-to-all) and copied to every looked-up row. ctx
    (B, T/n, L) owner ids -> (flat_idx (T/n, B*L), flat_g (T/n, B*L, d))
    in the grads' dtype."""
    g_owner = all_to_all(g_pooled, 1, 0, group)
    B, T, L = ctx.shape
    d = g_owner.shape[-1]
    flat_idx = ctx.transpose(0, 1).reshape(T, B * L)
    flat_g = g_owner.transpose(0, 1)[:, :, None, :].expand(
        T, B, L, d).reshape(T, B * L, d)
    return flat_idx, flat_g


def table_wise_backward_update(tables_local: torch.Tensor,
                               owner_idx: torch.Tensor,
                               g_pooled_local: torch.Tensor, group: Group,
                               update_fn: Callable) -> torch.Tensor:
    """Alg. 2, no-sharding branch: route, expand and apply
    ``update_fn(tables, flat_idx, flat_g)`` (SGD)."""
    return update_fn(tables_local, *table_wise_expand_grads(
        owner_idx, g_pooled_local, group))


# ---------------------------------------------------------------------------
# Row-wise (paper "full sharding") exchange
# ---------------------------------------------------------------------------
def _divisor_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (>= 1)."""
    c = max(1, min(n, target))
    while n % c:
        c -= 1
    return c


def local_row_ids(idx: torch.Tensor, r_start: int, rows_local: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global ids -> (this rank's row of each id, 0 where another rank
    owns it, in the ids' dtype; the mask of the ids it owns)."""
    local = idx - r_start if r_start else idx
    mine = (local >= 0) & (local < rows_local)
    return torch.where(mine, local, torch.zeros((), dtype=local.dtype,
                                                device=local.device)), mine


def _masked_rows(tables: torch.Tensor, idx: torch.Tensor,
                 r_start: int = 0) -> torch.Tensor:
    """The rows this rank owns, zeros elsewhere. tables (T, R/n, d) hold
    global rows [r_start, r_start + R/n); idx (B', T, L) global ids ->
    (B', T, L, d) in the tables' dtype. An id owned elsewhere takes row 0
    times zero (a NaN there stays NaN, as in the reference)."""
    T = tables.shape[0]
    safe, mine = local_row_ids(idx.long(), r_start, tables.shape[1])
    t = torch.arange(T, device=tables.device)[None, :, None]
    rows = tables[t, safe]                                 # (B', T, L, d)
    return rows.mul_(mine[..., None].to(rows.dtype))


def _masked_partial_pool(tables: torch.Tensor, idx: torch.Tensor,
                         r_start: int = 0) -> torch.Tensor:
    """Partial sum-pool of the rows this rank owns: idx (B', T, L) ->
    (B', T, d)."""
    return _masked_rows(tables, idx, r_start).sum(dim=2)


def row_wise_forward(tables_local: torch.Tensor, indices_local: torch.Tensor,
                     mode: str = "partial_pool", lookup_chunk: int = 4096,
                     group: Group = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1, full-sharding branch. tables_local (T, R/n, d), a row range
    of every table; indices_local (B/n, T, L) global row ids -> (pooled
    (B/n, T, d), the gathered ids (B, T, L), the backward context).

    ``mode`` is the wire format: "partial_pool" pools the owned rows here
    and reduce-scatters the partial pools; "unpooled" (the paper's)
    reduce-scatters the unpooled (B, T, L, d) rows and pools at the home
    rank, chunked over each rank's output slots so that an (n C', T, L, d)
    row block at a time is alive. The partial pools' masked lookup runs in
    batch chunks of at most ``lookup_chunk`` samples."""
    n = group_size(group)
    r_start = group_rank(group) * tables_local.shape[1]
    idx_all = all_gather(indices_local, group)             # (B, T, L)
    B, T, L = idx_all.shape
    if mode == "unpooled":
        Bn = B // n
        Cp = _divisor_chunk(Bn, max(1, lookup_chunk // n))
        if Bn == Cp:
            rows = _masked_rows(tables_local, idx_all, r_start)
            return psum_scatter(rows, group).sum(dim=2), idx_all
        idx_r = idx_all.reshape(n, Bn, T, L)
        pooled = [psum_scatter(_masked_rows(
            tables_local, idx_r[:, k * Cp:(k + 1) * Cp].reshape(n * Cp, T, L),
            r_start), group).sum(dim=2) for k in range(Bn // Cp)]
        return torch.cat(pooled), idx_all
    if mode != "partial_pool":
        raise ValueError(f"unknown row_wise exchange mode {mode!r}")
    if B <= lookup_chunk:
        partial = _masked_partial_pool(tables_local, idx_all, r_start)
    else:
        chunk = _divisor_chunk(B, lookup_chunk)
        partial = torch.cat([_masked_partial_pool(tables_local, c, r_start)
                             for c in idx_all.split(chunk)])
    return psum_scatter(partial, group), idx_all


def _expand_owned(n_rows: int, ctx: torch.Tensor, g_all: torch.Tensor,
                  r_start: int, dtype: Optional[torch.dtype]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, d) grads of the whole batch -> the flat pairs of the rows
    [r_start, r_start + n_rows) this rank owns."""
    B, T, L = ctx.shape
    d = g_all.shape[-1]
    safe, mine = local_row_ids(ctx, r_start, n_rows)
    g_t = g_all.transpose(0, 1)
    if dtype is not None:
        g_t = g_t.to(dtype)
    g_rows = g_t[:, :, None, :].expand(T, B, L, d)
    g_rows = g_rows * mine.transpose(0, 1)[..., None].to(g_rows.dtype)
    return (safe.transpose(0, 1).reshape(T, B * L),
            g_rows.reshape(T, B * L, d))


def row_wise_expand_grads(n_rows: int, ctx: torch.Tensor,
                          g_pooled: torch.Tensor,
                          dtype: Optional[torch.dtype] = None,
                          group: Group = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 for row-sharded tables: the (B/n, T, d) pooled grads
    all-gathered, masked to the ``n_rows`` rows this rank owns (an id
    owned elsewhere goes to row 0 at zero). ctx (B, T, L) gathered ids ->
    (flat_idx (T, B*L) in ctx's dtype, flat_g (T, B*L, d)). ``dtype``
    casts the SMALL (T, B, d) grads before the L-fold expansion, as
    ``row_wise_backward_update`` does (the tables' dtype); None keeps
    theirs."""
    return _expand_owned(n_rows, ctx, all_gather(g_pooled, group),
                         group_rank(group) * n_rows, dtype)


def row_wise_backward_update(tables: torch.Tensor, idx_all: torch.Tensor,
                             g_pooled: torch.Tensor, update_fn: Callable,
                             lookup_chunk: int = 4096,
                             group: Group = None) -> torch.Tensor:
    """Alg. 2, full-sharding branch: the pooled grads all-gathered, then
    expanded to the owned rows and applied by ``update_fn(tables,
    flat_idx, flat_g)`` in batch chunks of at most ``lookup_chunk``
    samples, each chunk on the tables the one before it left. The small
    (T, chunk, d) grads are cast to the tables' dtype BEFORE the L-fold
    expansion, as the reference does."""
    g_all = all_gather(g_pooled, group)
    B = idx_all.shape[0]
    rows = tables.shape[1]
    r_start = group_rank(group) * rows
    chunk = B if B <= lookup_chunk else _divisor_chunk(B, lookup_chunk)
    for s in range(0, B, chunk):
        tables = update_fn(tables, *_expand_owned(
            rows, idx_all[s:s + chunk], g_all[s:s + chunk], r_start,
            tables.dtype))
    return tables
