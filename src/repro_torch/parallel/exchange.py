"""EmbeddingExchange: where the tables live, and the forward that follows.

An exchange owns what depends on the tables' placement: which param keys
hold tables and which shard of each this rank keeps (``shards``), the
Alg. 1 forward (indices in, pooled embeddings and a backward context out),
the Alg. 2 backward (pooled-output grads expanded to flat (row id, row
grad) pairs per table group, and applied by a sparse optimizer), and
whether the serve path may run as one fused gather -> pool -> interaction
kernel. The port carries three exchanges over n ranks: the table-wise one
(the paper's "unsharded" layout), the row-wise one (the paper's "full
sharding", in both wire modes) and the planner's tiered one (fast and bulk
table groups, as placed by ``plan="auto"`` or a ``ShardingPlan``; its fast
group table-wise over the ranks, its bulk group row-wise). The host tier
(``hoststore.HostTieredExchange``) is a fourth, built by the Engine, on
one rank.

Over n ranks an exchange runs ``parallel.primitives``' collectives on the
process group of the embedding axis (``launch.mesh.Mesh.group``); at n=1
it has no group, the collectives are skipped, and the forward is local:
only then may the fused kernel serve it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.planner import ShardingPlan
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.fused_serve import grouped_src
from repro_torch.parallel import primitives as prim
from repro_torch.parallel.plan import plan_table_groups
from repro_torch.parallel.primitives import (  # noqa: F401
    Group, row_wise_backward_update, row_wise_expand_grads, row_wise_forward,
    table_wise_expand_grads)

Tables = Dict[str, torch.Tensor]
# table key -> (flat_idx (T, N), flat_g (T, N, d))
FlatGrads = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
# table key -> (the table ids of this rank's shard, its first row, its rows)
Shards = Dict[str, Tuple[Tuple[int, ...], int, int]]


def acc_key(table_key: str) -> str:
    """Param key -> its AdaGrad accumulator's key ("tables" ->
    "table_acc", "tables_fast" -> "table_acc_fast", ...)."""
    return table_key.replace("tables", "table_acc", 1)


def _flat_rows(ctx: torch.Tensor) -> torch.Tensor:
    """(B, T, L) local row ids -> (T, B*L)."""
    B, T, L = ctx.shape
    return ctx.transpose(0, 1).reshape(T, B * L)


class EmbeddingExchange:
    """Base class; constructed against a concrete (cfg, n ranks, their
    process group: None at n=1)."""

    table_keys: Tuple[str, ...] = ("tables",)

    def __init__(self, cfg: DLRMConfig, n: int = 1, group: Group = None):
        if prim.group_size(group) != n:
            raise ValueError(
                f"an exchange over {n} ranks needs the process group of "
                f"those ranks (launch.mesh.Mesh.group); got a group of "
                f"{prim.group_size(group)}")
        self.cfg = cfg
        self.n = n
        self.group = group
        self.rank = prim.group_rank(group)

    def shards(self) -> Shards:
        """This rank's shard of each table key: (the table ids it holds,
        in order; the first row; the rows), the counterpart of the
        reference's ``table_specs``. The AdaGrad accumulators shard alike
        (``acc_specs``)."""
        raise NotImplementedError

    def forward(self, tables: Tables,
                indices: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """(B/n, T, L) indices -> ((B/n, T, d) pooled, backward context)."""
        raise NotImplementedError

    def expand_grads(self, tables: Tables, ctx: Any,
                     g_pooled: torch.Tensor) -> FlatGrads:
        """Route the (B/n, T, d) pooled-output grads to the rows they came
        from: flat (row id, row grad) pairs per table key."""
        raise NotImplementedError

    def touched_rows(self, ctx: Any) -> Dict[str, torch.Tensor]:
        """The rows of this rank's shards that the grads of ``ctx`` reach,
        per table key: (T_local, N) local row ids (rows owned elsewhere
        count as row 0, whose grads are zero there)."""
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
    """Paper "unsharded": rank r holds the T/n whole tables [r T/n,
    (r+1) T/n); pooled-row all-to-alls only. At n=1 every table is local
    and the fused kernel serves it."""

    def __init__(self, cfg: DLRMConfig, n: int = 1, group: Group = None):
        super().__init__(cfg, n, group)
        if cfg.num_tables % n:
            raise ValueError(f"table-wise placement needs T % n == 0, got "
                             f"T={cfg.num_tables}, n={n}")

    def shards(self):
        tn = self.cfg.num_tables // self.n
        return {"tables": (tuple(range(self.rank * tn, (self.rank + 1) * tn)),
                           0, self.cfg.rows_per_table)}

    def forward(self, tables, indices):
        return prim.table_wise_forward(tables["tables"], indices, self.group)

    def expand_grads(self, tables, ctx, g_pooled):
        return {"tables": table_wise_expand_grads(ctx, g_pooled, self.group)}

    def touched_rows(self, ctx):
        return {"tables": _flat_rows(ctx)}

    def supports_fused_forward(self) -> bool:
        return self.n == 1

    def fused_forward(self, tables, bot_out, indices):
        return ops.fused_bag_interactions(tables["tables"], indices, bot_out)


class RowWiseExchange(EmbeddingExchange):
    """Paper "full sharding": every table's rows range-sharded over the
    ranks, rank r holding rows [r R/n, (r+1) R/n) of each (at n=1, every
    row). ``mode`` is the wire format, "partial_pool" or "unpooled" (the
    reference's ``RowWiseExchange``, ``src/repro/parallel/exchange.py:172``);
    ``lookup_chunk`` bounds the samples a masked lookup or a sparse update
    handles at once. It has no fused serve path, as in the reference: a
    session serves it composed."""

    def __init__(self, cfg: DLRMConfig, n: int = 1,
                 mode: str = "partial_pool", lookup_chunk: int = 4096,
                 group: Group = None):
        if mode not in ("partial_pool", "unpooled"):
            raise ValueError(f"unknown row_wise exchange mode {mode!r}")
        super().__init__(cfg, n, group)
        if cfg.rows_per_table % n:
            raise ValueError(f"row-wise placement needs R % n == 0, got "
                             f"R={cfg.rows_per_table}, n={n}")
        self.mode = mode
        self.lookup_chunk = lookup_chunk

    def shards(self):
        rn = self.cfg.rows_per_table // self.n
        return {"tables": (tuple(range(self.cfg.num_tables)), self.rank * rn,
                           rn)}

    def forward(self, tables, indices):
        return row_wise_forward(tables["tables"], indices, self.mode,
                                self.lookup_chunk, self.group)

    def expand_grads(self, tables, ctx, g_pooled):
        return {"tables": row_wise_expand_grads(
            tables["tables"].shape[1], ctx, g_pooled, group=self.group)}

    def touched_rows(self, ctx):
        rn = self.cfg.rows_per_table // self.n
        return {"tables": _flat_rows(prim.local_row_ids(
            ctx, self.rank * rn, rn)[0])}

    def sparse_apply(self, tables, ctx, g_pooled, update_fn):
        tables["tables"] = row_wise_backward_update(
            tables["tables"], ctx, g_pooled, update_fn, self.lookup_chunk,
            self.group)
        return tables


def planned_forward(tables_fast: torch.Tensor, tables_bulk: torch.Tensor,
                    indices: torch.Tensor, perm: torch.Tensor,
                    inv: torch.Tensor, n_fast: int,
                    row_mode: str = "partial_pool",
                    lookup_chunk: int = 4096, group: Group = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """Mixed Alg. 1 executing the planner's placements: the fast group
    table-wise over the ranks of ``group``, the bulk group row-wise
    (``row_wise_forward`` in ``row_mode``), the pooled outputs restored to
    the original table order. ``perm`` (T,) lists the fast tables' ids,
    then the bulk ones'; ``inv`` is its inverse; both long tensors on the
    ids' device. Returns pooled (B/n, T, d), the fast group's owner ids
    and the bulk group's gathered ids (None for an empty group)."""
    idx = indices.index_select(1, perm)
    parts = []
    ctx_fast = ctx_bulk = None
    if n_fast:
        pooled_f, ctx_fast = prim.table_wise_forward(
            tables_fast, idx[:, :n_fast], group)
        parts.append(pooled_f)
    if n_fast < idx.shape[1]:
        pooled_b, ctx_bulk = row_wise_forward(tables_bulk, idx[:, n_fast:],
                                              row_mode, lookup_chunk, group)
        parts.append(pooled_b)
    return torch.cat(parts, dim=1).index_select(1, inv), ctx_fast, ctx_bulk


class PlannedTieredExchange(EmbeddingExchange):
    """The planner's tier decisions executed: the fast group table-wise
    over the ranks, the bulk group row-wise (``planned_forward``), under
    one exchange.

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
                 lookup_chunk: int = 4096, group: Group = None):
        super().__init__(cfg, n, group)
        device = resolve_device(device)
        self.groups = plan_table_groups(plan, n)
        if self.groups.bulk_ids and cfg.rows_per_table % n:
            raise ValueError(f"the bulk group's row-wise placement needs "
                             f"R % n == 0, got R={cfg.rows_per_table}, "
                             f"n={n}")
        self.row_mode = row_mode
        self.lookup_chunk = lookup_chunk
        self.inv_perm = self.groups.inv_perm
        perm = self.groups.fast_ids + self.groups.bulk_ids
        self._perm = torch.as_tensor(perm, dtype=torch.long, device=device)
        self._inv = torch.as_tensor(self.inv_perm, dtype=torch.long,
                                    device=device)
        self._src = grouped_src(self.inv_perm, device)

    def shards(self):
        g, R = self.groups, self.cfg.rows_per_table
        tn = len(g.fast_ids) // self.n
        rn = R // self.n if g.bulk_ids else R
        return {"tables_fast": (g.fast_ids[self.rank * tn:
                                           (self.rank + 1) * tn], 0, R),
                "tables_bulk": (g.bulk_ids, self.rank * rn if g.bulk_ids
                                else 0, rn)}

    def forward(self, tables, indices):
        """``planned_forward``; the backward context is (the fast group's
        owner ids (B, Tf/n, L), the bulk group's gathered ids (B, Tb, L))."""
        pooled, ctx_f, ctx_b = planned_forward(
            tables["tables_fast"], tables["tables_bulk"], indices,
            self._perm, self._inv, len(self.groups.fast_ids), self.row_mode,
            self.lookup_chunk, self.group)
        return pooled, (ctx_f, ctx_b)

    def _split_g(self, g_pooled):
        g = g_pooled.index_select(1, self._perm)
        n_fast = len(self.groups.fast_ids)
        return g[:, :n_fast], g[:, n_fast:]

    def expand_grads(self, tables, ctx, g_pooled):
        """The fast group table-wise, the bulk group row-wise, as the
        reference's tiered exchange."""
        g_f, g_b = self._split_g(g_pooled)
        out = {}
        if self.groups.fast_ids:
            out["tables_fast"] = table_wise_expand_grads(ctx[0], g_f,
                                                         self.group)
        if self.groups.bulk_ids:
            out["tables_bulk"] = row_wise_expand_grads(
                tables["tables_bulk"].shape[1], ctx[1], g_b,
                group=self.group)
        return out

    def touched_rows(self, ctx):
        out = {}
        if self.groups.fast_ids:
            out["tables_fast"] = _flat_rows(ctx[0])
        if self.groups.bulk_ids:
            rn = self.cfg.rows_per_table // self.n
            out["tables_bulk"] = _flat_rows(prim.local_row_ids(
                ctx[1], self.rank * rn, rn)[0])
        return out

    def sparse_apply(self, tables, ctx, g_pooled, update_fn):
        """As ``expand_grads``, then ``update_fn`` on each group in place;
        the bulk group through ``row_wise_backward_update`` (its grads cast
        to the table dtype before the L-fold expansion: for bf16 tables,
        another rounding than the fast group's)."""
        g_f, g_b = self._split_g(g_pooled)
        if self.groups.fast_ids:
            tables["tables_fast"] = update_fn(
                tables["tables_fast"], *table_wise_expand_grads(
                    ctx[0], g_f, self.group))
        if self.groups.bulk_ids:
            tables["tables_bulk"] = row_wise_backward_update(
                tables["tables_bulk"], ctx[1], g_b, update_fn,
                self.lookup_chunk, self.group)
        return tables

    def supports_fused_forward(self) -> bool:
        return self.n == 1

    def fused_forward(self, tables, bot_out, indices):
        return ops.fused_grouped_bag_interactions_unpermuted(
            tables["tables_fast"], tables["tables_bulk"], indices, bot_out,
            inv_perm=self.inv_perm, src=self._src)


def make_exchange(cfg: DLRMConfig, n: int = 1, *,
                  plan: Optional[ShardingPlan] = None,
                  row_wise_exchange: str = "partial_pool",
                  lookup_chunk: int = 4096,
                  device: DeviceArg = None,
                  group: Group = None) -> EmbeddingExchange:
    """The exchange for a config over ``n`` ranks (``group``, their
    process group; None at n=1), as the reference's: a placed plan
    dictates the tiered exchange (built on ``device``, None = the card);
    otherwise ``cfg.sharding`` picks table-wise or row-wise, with
    ``row_wise_exchange`` as the row-wise wire mode (the tiered exchange's
    bulk group's too) and ``lookup_chunk`` its chunk."""
    if plan is not None and plan.placements:
        return PlannedTieredExchange(cfg, n, plan, device,
                                     row_mode=row_wise_exchange,
                                     lookup_chunk=lookup_chunk, group=group)
    if cfg.sharding == "table_wise":
        return TableWiseExchange(cfg, n, group)
    return RowWiseExchange(cfg, n, mode=row_wise_exchange,
                           lookup_chunk=lookup_chunk, group=group)
