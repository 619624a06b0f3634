"""EmbeddingExchange: where the tables live, and the forward that follows.

An exchange owns what depends on the tables' placement: which param keys
hold tables, the Alg. 1 forward (indices in, pooled embeddings and a
backward context out), the Alg. 2 backward (pooled-output grads expanded
to flat (row id, row grad) pairs per table group, and applied by a sparse
optimizer), and whether the serve path may run as one fused gather ->
pool -> interaction kernel. The port carries three exchanges on one
device: the table-wise one (the paper's "unsharded" layout), the
row-wise one (the paper's "full sharding", in both wire modes) and the
planner's tiered one (fast and bulk table groups, as placed by
``plan="auto"`` or a ``ShardingPlan``; its bulk group row-wise). The host
tier (``hoststore.HostTieredExchange``) is a fourth, built by the Engine.

The row-wise functions below are the reference's
(``src/repro/parallel/primitives.py:110-271``) at n=1: this device owns
every row [0, R) of every table, the masks keep their meaning (ids
outside the range pool to zero, their grads go to row 0 at zero), and the
collectives over the ranks (the indices' and grads' all_gather, the
pools' psum_scatter) are the identity. The exchanges over more devices
bring them (ROADMAP A6b).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.core.planner import ShardingPlan
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.fused_serve import grouped_src
from repro_torch.parallel.plan import plan_table_groups

Tables = Dict[str, torch.Tensor]
# table key -> (flat_idx (T, N), flat_g (T, N, d))
FlatGrads = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def acc_key(table_key: str) -> str:
    """Param key -> its AdaGrad accumulator's key ("tables" ->
    "table_acc", "tables_fast" -> "table_acc_fast", ...)."""
    return table_key.replace("tables", "table_acc", 1)


def _divisor_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (>= 1)."""
    c = max(1, min(n, target))
    while n % c:
        c -= 1
    return c


def _masked_rows(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows this device owns, zeros elsewhere. tables (T, R, d) hold
    global rows [0, R) at n=1 (the reference's r_start is 0); idx (B', T,
    L) global ids -> (B', T, L, d) in the tables' dtype. An id outside the
    range takes row 0 times zero (a NaN there stays NaN, as in the
    reference)."""
    T, R, _ = tables.shape
    local = idx.long()
    mine = (local >= 0) & (local < R)
    safe = torch.where(mine, local, torch.zeros((), dtype=local.dtype,
                                                device=local.device))
    t = torch.arange(T, device=tables.device)[None, :, None]
    rows = tables[t, safe]                                 # (B', T, L, d)
    return rows.mul_(mine[..., None].to(rows.dtype))


def _masked_partial_pool(tables: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Partial sum-pool of the rows this device owns: idx (B', T, L) ->
    (B', T, d)."""
    return _masked_rows(tables, idx).sum(dim=2)


def row_wise_forward(tables: torch.Tensor, indices: torch.Tensor,
                     mode: str = "partial_pool", lookup_chunk: int = 4096
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1, full-sharding branch, at n=1. tables (T, R, d), every row
    of every table; indices (B, T, L) global row ids -> (pooled (B, T, d),
    the gathered ids (B, T, L), the backward context).

    ``mode`` is the wire format: "partial_pool" pools the owned rows here
    and reduce-scatters the partial pools; "unpooled" (the paper's)
    reduce-scatters the unpooled (B, T, L, d) rows and pools at the home
    device. At n=1 both wires are the identity, so both modes compute the
    same sums. The masked lookup runs in batch chunks of at most
    ``lookup_chunk`` samples: the (chunk, T, L, d) row block is the only
    L-sized tensor alive."""
    n = 1
    # the index exchange: an all_gather over the ranks, the identity at
    # n=1 (ROADMAP A6b brings the collectives)
    idx_all = indices
    B, T, L = idx_all.shape
    if mode == "unpooled":
        # chunked over each rank's output slots: an (n C', T, L, d) row
        # block at a time; psum_scatter of the rows, the identity at n=1
        Bn = B // n
        Cp = _divisor_chunk(Bn, max(1, lookup_chunk // n))
        if Bn == Cp:
            return _masked_rows(tables, idx_all).sum(dim=2), idx_all
        pooled = [_masked_rows(tables, idx_all[k * Cp:(k + 1) * Cp]).sum(
            dim=2) for k in range(Bn // Cp)]
        return torch.cat(pooled), idx_all
    if mode != "partial_pool":
        raise ValueError(f"unknown row_wise exchange mode {mode!r}")
    if B <= lookup_chunk:
        partial = _masked_partial_pool(tables, idx_all)
    else:
        chunk = _divisor_chunk(B, lookup_chunk)
        partial = torch.cat([_masked_partial_pool(tables, c)
                             for c in idx_all.split(chunk)])
    # psum_scatter of the partial pools over the batch: the identity at n=1
    return partial, idx_all


def table_wise_expand_grads(ctx: torch.Tensor, g_pooled: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 for whole local tables: the (B, T, d) pooled grads copied to
    every looked-up row. ctx (B, T, L) ids -> (flat_idx (T, B*L),
    flat_g (T, B*L, d)) in the grads' dtype."""
    B, T, L = ctx.shape
    d = g_pooled.shape[-1]
    flat_idx = ctx.transpose(0, 1).reshape(T, B * L)
    flat_g = g_pooled.transpose(0, 1)[:, :, None, :].expand(
        T, B, L, d).reshape(T, B * L, d)
    return flat_idx, flat_g


def row_wise_expand_grads(n_rows: int, ctx: torch.Tensor,
                          g_pooled: torch.Tensor,
                          dtype: Optional[torch.dtype] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 for row-sharded tables at n=1, where this device owns every
    row [0, n_rows): grads of ids outside that range are zeroed and sent
    to row 0, as ``primitives.row_wise_expand_grads`` masks rows owned
    elsewhere. ``dtype`` casts the SMALL (T, B, d) grads before the L-fold
    expansion, as ``row_wise_backward_update`` does (the tables' dtype);
    None keeps theirs."""
    B, T, L = ctx.shape
    d = g_pooled.shape[-1]
    mine = (ctx >= 0) & (ctx < n_rows)
    safe = torch.where(mine, ctx, torch.zeros((), dtype=ctx.dtype,
                                              device=ctx.device))
    g_t = g_pooled.transpose(0, 1)
    if dtype is not None:
        g_t = g_t.to(dtype)
    g_rows = g_t[:, :, None, :].expand(T, B, L, d)
    g_rows = g_rows * mine.transpose(0, 1)[..., None].to(g_rows.dtype)
    return (safe.transpose(0, 1).reshape(T, B * L),
            g_rows.reshape(T, B * L, d))


def row_wise_backward_update(tables: torch.Tensor, idx_all: torch.Tensor,
                             g_pooled: torch.Tensor, update_fn: Callable,
                             lookup_chunk: int = 4096) -> torch.Tensor:
    """Alg. 2, full-sharding branch, at n=1: the pooled grads (their
    all_gather over the ranks is the identity here) expanded to the owned
    rows and applied by ``update_fn(tables, flat_idx, flat_g)`` in batch
    chunks of at most ``lookup_chunk`` samples, each chunk on the tables
    the one before it left. The small (T, chunk, d) grads are cast to the
    tables' dtype BEFORE the L-fold expansion, as the reference does."""
    B = idx_all.shape[0]
    chunk = B if B <= lookup_chunk else _divisor_chunk(B, lookup_chunk)
    for s in range(0, B, chunk):
        tables = update_fn(tables, *row_wise_expand_grads(
            tables.shape[1], idx_all[s:s + chunk], g_pooled[s:s + chunk],
            dtype=tables.dtype))
    return tables


class EmbeddingExchange:
    """Base class; constructed against a concrete (cfg, n devices)."""

    table_keys: Tuple[str, ...] = ("tables",)

    def __init__(self, cfg: DLRMConfig, n: int):
        self.cfg = cfg
        self.n = n

    def forward(self, tables: Tables,
                indices: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """(B, T, L) indices -> ((B, T, d) pooled, backward context)."""
        raise NotImplementedError

    def expand_grads(self, tables: Tables, ctx: Any,
                     g_pooled: torch.Tensor) -> FlatGrads:
        """Route the (B, T, d) pooled-output grads to the rows they came
        from: flat (row id, row grad) pairs per table key."""
        raise NotImplementedError

    def sparse_apply(self, tables: Tables, ctx: Any, g_pooled: torch.Tensor,
                     update_fn: Callable) -> Tables:
        """A stateless (SGD) sparse update of every table group, in place:
        ``update_fn(table, flat_idx, flat_g)`` on each group's flat
        grads."""
        for k, (fi, fg) in self.expand_grads(tables, ctx, g_pooled).items():
            tables[k] = update_fn(tables[k], fi, fg)
        return tables

    # A LOCAL exchange (every looked-up row on this device, no collectives
    # in the forward) can serve through the fused kernel, which never
    # writes the pooled (B, T, d) tensor to device memory.
    def supports_fused_forward(self) -> bool:
        return False

    def fused_forward(self, tables: Tables, bot_out: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
        """(B, d) bottom-MLP output + (B, T, L) indices -> the
        (B, top_mlp_in) interaction features, fused. Only valid when
        ``supports_fused_forward()`` is True."""
        raise NotImplementedError(
            f"{type(self).__name__} has no fused serve path")

    # -- host-tier session hooks (no-ops for device-resident exchanges) ----
    # An exchange whose tables do NOT entirely live on the device (the
    # host tier, ``hoststore.HostTieredExchange``) needs the session's
    # params and every step's indices before the step runs: to build its
    # param layout, and to fault chunks in. Sessions call these hooks
    # around every execution; device-resident exchanges inherit no-ops.

    # True when the exchange keeps the tables itself: a session then draws
    # only the MLPs (the host tier's tables do not fit the device).
    holds_tables = False

    def init_session_params(self, params: Tables) -> Optional[Tables]:
        """Build this exchange's param layout from freshly initialised
        params. None means "not handled": the session places the params
        itself (``shard_dlrm_params``)."""
        return None

    def begin_batch(self, params: Tables, indices: torch.Tensor, depth: int,
                    train: bool = False) -> Tuple[Tables, Any]:
        """Called with a step's indices BEFORE the step runs. Returns
        (possibly updated params, an opaque swap plan or None)."""
        return params, None

    def stall_seconds(self, plan: Any, service_s: float) -> float:
        """Modeled seconds of swap stall the step exposes (virtual clock),
        given the plan from ``begin_batch`` and the measured compute
        time."""
        return 0.0

    def end_batch(self, params: Tables) -> Tables:
        """Called with the step's returned params."""
        return params


class TableWiseExchange(EmbeddingExchange):
    """Paper "unsharded" on one device: every table whole and local."""

    def __init__(self, cfg: DLRMConfig, n: int = 1):
        if n != 1:
            raise NotImplementedError(
                f"table-wise exchange over {n} devices is not ported yet "
                f"(ROADMAP A6b, k ranks)")
        super().__init__(cfg, n)

    def forward(self, tables, indices):
        return dlrm_lib.embedding_bag(tables["tables"], indices), indices

    def expand_grads(self, tables, ctx, g_pooled):
        return {"tables": table_wise_expand_grads(ctx, g_pooled)}

    def supports_fused_forward(self) -> bool:
        return True

    def fused_forward(self, tables, bot_out, indices):
        return ops.fused_bag_interactions(tables["tables"], indices, bot_out)


class RowWiseExchange(EmbeddingExchange):
    """Paper "full sharding" on one device: every table's rows
    range-sharded over the devices, which at n=1 gives this device every
    row. ``mode`` is the wire format, "partial_pool" or "unpooled" (the
    reference's ``RowWiseExchange``, ``src/repro/parallel/exchange.py:172``);
    ``lookup_chunk`` bounds the samples a masked lookup or a sparse update
    handles at once. It has no fused serve path, as in the reference: a
    session serves it composed."""

    def __init__(self, cfg: DLRMConfig, n: int = 1,
                 mode: str = "partial_pool", lookup_chunk: int = 4096):
        if mode not in ("partial_pool", "unpooled"):
            raise ValueError(f"unknown row_wise exchange mode {mode!r}")
        if n != 1:
            raise NotImplementedError(
                f"row-wise exchange over {n} devices is not ported yet "
                f"(ROADMAP A6b, k ranks)")
        super().__init__(cfg, n)
        self.mode = mode
        self.lookup_chunk = lookup_chunk

    def forward(self, tables, indices):
        return row_wise_forward(tables["tables"], indices, self.mode,
                                self.lookup_chunk)

    def expand_grads(self, tables, ctx, g_pooled):
        return {"tables": row_wise_expand_grads(tables["tables"].shape[1],
                                                ctx, g_pooled)}

    def sparse_apply(self, tables, ctx, g_pooled, update_fn):
        tables["tables"] = row_wise_backward_update(
            tables["tables"], ctx, g_pooled, update_fn, self.lookup_chunk)
        return tables


def planned_forward(tables_fast: torch.Tensor, tables_bulk: torch.Tensor,
                    indices: torch.Tensor, perm: torch.Tensor,
                    inv: torch.Tensor, n_fast: int,
                    row_mode: str = "partial_pool",
                    lookup_chunk: int = 4096
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """Mixed Alg. 1 executing the planner's placements at n=1: the fast
    group table-wise, the bulk group row-wise (``row_wise_forward`` in
    ``row_mode``), the pooled outputs restored to the original table
    order. ``perm`` (T,) lists the fast tables' ids, then the bulk ones';
    ``inv`` is its inverse; both long tensors on the ids' device. Returns
    pooled (B, T, d), the fast group's ids and the bulk group's gathered
    ids (None for an empty group)."""
    idx = indices.index_select(1, perm)
    parts = []
    ctx_fast = ctx_bulk = None
    if n_fast:
        ctx_fast = idx[:, :n_fast]
        parts.append(dlrm_lib.embedding_bag(tables_fast, ctx_fast))
    if n_fast < idx.shape[1]:
        pooled_b, ctx_bulk = row_wise_forward(tables_bulk, idx[:, n_fast:],
                                              row_mode, lookup_chunk)
        parts.append(pooled_b)
    return torch.cat(parts, dim=1).index_select(1, inv), ctx_fast, ctx_bulk


class PlannedTieredExchange(EmbeddingExchange):
    """The planner's tier decisions executed on one device: the fast group
    table-wise, the bulk group row-wise (``planned_forward``), under one
    exchange.

    At n=1 the bulk group's row range is every row of its tables, so the
    forward has no collectives and the fused kernel serves it, on the ids
    in their original table order; the composed path and training run
    ``planned_forward``. ``row_mode`` and ``lookup_chunk`` are the bulk
    group's wire mode and chunk, as the reference's. The table permutation
    and the kernel's per-table map to (group, table of the group) are
    device tensors built once here, on ``device`` (None = the card), not
    once per batch."""

    table_keys = ("tables_fast", "tables_bulk")

    def __init__(self, cfg: DLRMConfig, n: int, plan: ShardingPlan,
                 device: DeviceArg = None, row_mode: str = "partial_pool",
                 lookup_chunk: int = 4096):
        if n != 1:
            raise NotImplementedError(
                f"the tiered exchange over {n} devices is not ported yet "
                f"(ROADMAP A6b, k ranks)")
        super().__init__(cfg, n)
        device = resolve_device(device)
        self.groups = plan_table_groups(plan, n)
        self.row_mode = row_mode
        self.lookup_chunk = lookup_chunk
        self.inv_perm = self.groups.inv_perm
        perm = self.groups.fast_ids + self.groups.bulk_ids
        self._perm = torch.as_tensor(perm, dtype=torch.long, device=device)
        self._inv = torch.as_tensor(self.inv_perm, dtype=torch.long,
                                    device=device)
        self._src = grouped_src(self.inv_perm, device)

    def forward(self, tables, indices):
        """``planned_forward``; the backward context is (the fast group's
        ids (B, Tf, L), the bulk group's (B, Tb, L))."""
        pooled, ctx_f, ctx_b = planned_forward(
            tables["tables_fast"], tables["tables_bulk"], indices,
            self._perm, self._inv, len(self.groups.fast_ids), self.row_mode,
            self.lookup_chunk)
        return pooled, (ctx_f, ctx_b)

    def _split_g(self, g_pooled):
        g = g_pooled.index_select(1, self._perm)
        n_fast = len(self.groups.fast_ids)
        return g[:, :n_fast], g[:, n_fast:]

    def expand_grads(self, tables, ctx, g_pooled):
        """The fast group table-wise, the bulk group row-wise (at n=1 this
        device owns every row), as the reference's tiered exchange."""
        g_f, g_b = self._split_g(g_pooled)
        out = {}
        if self.groups.fast_ids:
            out["tables_fast"] = table_wise_expand_grads(ctx[0], g_f)
        if self.groups.bulk_ids:
            out["tables_bulk"] = row_wise_expand_grads(
                tables["tables_bulk"].shape[1], ctx[1], g_b)
        return out

    def sparse_apply(self, tables, ctx, g_pooled, update_fn):
        """As ``expand_grads``, then ``update_fn`` on each group in place;
        the bulk group through ``row_wise_backward_update`` (its grads cast
        to the table dtype before the L-fold expansion: for bf16 tables,
        another rounding than the fast group's)."""
        g_f, g_b = self._split_g(g_pooled)
        if self.groups.fast_ids:
            tables["tables_fast"] = update_fn(
                tables["tables_fast"], *table_wise_expand_grads(ctx[0], g_f))
        if self.groups.bulk_ids:
            tables["tables_bulk"] = row_wise_backward_update(
                tables["tables_bulk"], ctx[1], g_b, update_fn,
                self.lookup_chunk)
        return tables

    def supports_fused_forward(self) -> bool:
        return True

    def fused_forward(self, tables, bot_out, indices):
        return ops.fused_grouped_bag_interactions_unpermuted(
            tables["tables_fast"], tables["tables_bulk"], indices, bot_out,
            inv_perm=self.inv_perm, src=self._src)


def make_exchange(cfg: DLRMConfig, n: int = 1, *,
                  plan: Optional[ShardingPlan] = None,
                  row_wise_exchange: str = "partial_pool",
                  lookup_chunk: int = 4096,
                  device: DeviceArg = None) -> EmbeddingExchange:
    """The exchange for a config on ``n`` devices, as the reference's: a
    placed plan dictates the tiered exchange (built on ``device``, None =
    the card); otherwise ``cfg.sharding`` picks table-wise or row-wise,
    with ``row_wise_exchange`` as the row-wise wire mode (the tiered
    exchange's bulk group's too) and ``lookup_chunk`` its chunk. One
    device; more raise (ROADMAP A6b)."""
    if plan is not None and plan.placements:
        return PlannedTieredExchange(cfg, n, plan, device,
                                     row_mode=row_wise_exchange,
                                     lookup_chunk=lookup_chunk)
    if cfg.sharding == "table_wise":
        return TableWiseExchange(cfg, n)
    return RowWiseExchange(cfg, n, mode=row_wise_exchange,
                           lookup_chunk=lookup_chunk)
