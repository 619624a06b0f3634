"""EmbeddingExchange: where the tables live, and the forward that follows.

An exchange owns what depends on the tables' placement: which param keys
hold tables, the Alg. 1 forward (indices in, pooled embeddings and a
backward context out), the Alg. 2 backward (pooled-output grads expanded
to flat (row id, row grad) pairs per table group, and applied by a sparse
optimizer), and whether the serve path may run as one fused gather ->
pool -> interaction kernel. The port carries two exchanges on one
device: the table-wise one (the paper's "unsharded" layout) and the
planner's tiered one (fast and bulk table groups, as placed by
``plan="auto"`` or a ``ShardingPlan``). The host tier
(``hoststore.HostTieredExchange``) is a third, built by the Engine.
The distributed and row-wise exchanges are a later ROADMAP item (A6).
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
                f"(ROADMAP A6, distributed)")
        super().__init__(cfg, n)

    def forward(self, tables, indices):
        return dlrm_lib.embedding_bag(tables["tables"], indices), indices

    def expand_grads(self, tables, ctx, g_pooled):
        return {"tables": table_wise_expand_grads(ctx, g_pooled)}

    def supports_fused_forward(self) -> bool:
        return True

    def fused_forward(self, tables, bot_out, indices):
        return ops.fused_bag_interactions(tables["tables"], indices, bot_out)


class PlannedTieredExchange(EmbeddingExchange):
    """The planner's tier decisions executed on one device: the fast and
    the bulk table group each whole and local, under one exchange.

    At n=1 both groups are table-wise local (the reference runs the bulk
    group row-wise over the mesh, which on one device is the whole table),
    so the forward has no collectives and the fused kernel serves it, on
    the ids in their original table order. The table permutation and the
    kernel's per-table map to (group, table of the group) are device
    tensors built once here, on ``device`` (None = the card), not once per
    batch."""

    table_keys = ("tables_fast", "tables_bulk")
    # samples a chunk of the bulk group's sparse update (the reference's
    # ``lookup_chunk``): the expanded (chunk, Tb, L, d) grad block is the
    # only L-sized tensor
    lookup_chunk = 4096

    def __init__(self, cfg: DLRMConfig, n: int, plan: ShardingPlan,
                 device: DeviceArg = None):
        if n != 1:
            raise NotImplementedError(
                f"the tiered exchange over {n} devices is not ported yet "
                f"(ROADMAP A6, distributed)")
        super().__init__(cfg, n)
        device = resolve_device(device)
        self.groups = plan_table_groups(plan, n)
        self.inv_perm = self.groups.inv_perm
        perm = self.groups.fast_ids + self.groups.bulk_ids
        self._perm = torch.as_tensor(perm, dtype=torch.long, device=device)
        self._inv = torch.as_tensor(self.inv_perm, dtype=torch.long,
                                    device=device)
        self._src = grouped_src(self.inv_perm, device)

    def forward(self, tables, indices):
        """Pool each group, concatenate, restore the original table order
        (``planned_forward`` of the reference at n=1). The backward context
        is each group's ids: (fast (B, Tf, L), bulk (B, Tb, L))."""
        n_fast = len(self.groups.fast_ids)
        idx = indices.index_select(1, self._perm)
        ctx = (idx[:, :n_fast], idx[:, n_fast:])
        parts = []
        if n_fast:
            parts.append(dlrm_lib.embedding_bag(tables["tables_fast"],
                                                ctx[0]))
        if self.groups.bulk_ids:
            parts.append(dlrm_lib.embedding_bag(tables["tables_bulk"],
                                                ctx[1]))
        return torch.cat(parts, dim=1).index_select(1, self._inv), ctx

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
        """As ``expand_grads``, then ``update_fn`` on each group in place.
        The bulk group follows ``row_wise_backward_update``: its pooled
        grads are cast to the table dtype BEFORE the L-fold expansion (for
        bf16 tables, another rounding than the fast group's), in batch
        chunks of at most ``lookup_chunk`` samples."""
        g_f, g_b = self._split_g(g_pooled)
        if self.groups.fast_ids:
            tables["tables_fast"] = update_fn(
                tables["tables_fast"], *table_wise_expand_grads(ctx[0], g_f))
        if self.groups.bulk_ids:
            bulk = tables["tables_bulk"]
            B = g_b.shape[0]
            chunk = _divisor_chunk(B, self.lookup_chunk)
            for s in range(0, B, chunk):
                bulk = update_fn(bulk, *row_wise_expand_grads(
                    bulk.shape[1], ctx[1][s:s + chunk], g_b[s:s + chunk],
                    dtype=bulk.dtype))
            tables["tables_bulk"] = bulk
        return tables

    def supports_fused_forward(self) -> bool:
        return True

    def fused_forward(self, tables, bot_out, indices):
        return ops.fused_grouped_bag_interactions_unpermuted(
            tables["tables_fast"], tables["tables_bulk"], indices, bot_out,
            inv_perm=self.inv_perm, src=self._src)


def _divisor_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (>= 1)."""
    c = max(1, min(n, target))
    while n % c:
        c -= 1
    return c


def make_exchange(cfg: DLRMConfig, n: int = 1, *,
                  plan: Optional[ShardingPlan] = None,
                  device: DeviceArg = None) -> EmbeddingExchange:
    """The exchange for a config on ``n`` devices: a placed plan dictates
    the tiered exchange (built on ``device``, None = the card); otherwise
    ``cfg.sharding`` picks the layout. Resolves one device and raises for
    more."""
    if plan is not None and plan.placements:
        return PlannedTieredExchange(cfg, n, plan, device)
    if cfg.sharding != "table_wise":
        raise NotImplementedError(
            f"sharding={cfg.sharding!r} is not ported yet (ROADMAP A6, "
            f"distributed); this slice serves table_wise configs")
    return TableWiseExchange(cfg, n)
