"""build_step: the one composition of exchange + dense compute + grads.

Every rank of the mesh runs the step on its own shard, as each device
runs the reference's step inside ``shard_map``
(``src/repro/parallel/build.py``). The step takes the GLOBAL batch, as
the reference's jitted step does; each rank keeps its slice over
``dp_axes + axis`` (the ranks draw the same seeded batch). ``axis`` is
the embedding axis, over which the exchange distributes the tables;
``dp_axes`` are pure data-parallel axes over which the tables are
replicated. Without a mesh the step runs on one device and no collective
is called.

Serve mode returns ``step(params, dense, indices) -> probs (B,)``, the
global probs gathered over the ranks, over ``pipeline_depth``
micro-batches. With a fused-capable exchange (one rank, ``fused=True``)
each micro-batch runs bottom MLP -> fused gather -> pool -> interaction
kernel -> top MLP; otherwise the composed path pools through
``exchange.forward`` (the next micro-batch's exchange issued before this
one's dense compute, the reference's overlap order) and runs
``dlrm_forward_from_pooled``. A placed plan selects the tiered exchange,
whose params are plan-split (``tables_fast``, ``tables_bulk``; see
``shard_dlrm_params``).

Train mode returns ``step(params, opt_state, dense, indices, labels) ->
(params, opt_state, loss)`` (paper Alg. 2), as the reference's step:
every micro-batch's forward reads the tables as they were before the
step; autograd gives the dense grads and the pooled grads of each
micro-batch's loss (its BCE over the global batch: / (ranks x depth));
SGD applies each micro-batch's sparse update through the exchange,
AdaGrad concatenates the flat grads of all micro-batches and applies once
(its accumulator must see the whole batch's rows); the dense grads and
the loss are summed over the ranks (the grads through the int8
error-feedback all-reduce under ``compress_grads``) and the dense update
is ``p - lr * g``. Over ``dp_axes`` every replica then applies the sum of
the replicas' table (and accumulator) changes, as the reference's psum of
the deltas: sparsely, over the rows the step touched (``dp_sync="sparse"``),
or as the reference does it, ``tables + psum(new - tables)`` over whole
shards (``dp_sync="dense"``, the deltas summed in fp32, as XLA:CPU runs
the reference's bf16 tables; no data-dependent shape, so a trace on the
meta device runs it). The step updates
the tables, the dense layers and the optimizer state IN PLACE (the
reference returns new arrays from donated ones) and returns the same
objects; the loss is a device scalar.

``local_batch=True`` gives the step this rank's slice of the batch in
place of the global batch, and serving returns this rank's probs (no
gather): each device's view of the reference's step, whose inputs and
outputs are sharded over ``dp_axes + axis``. The dry-run's cells
(``launch.steps``) build rank 0's slice alone that way.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.core.planner import ShardingPlan
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.optim.compression import make_compressed_allreduce
from repro_torch.parallel import primitives as prim
from repro_torch.parallel.exchange import (EmbeddingExchange, acc_key,
                                           make_exchange)
from repro_torch.parallel.plan import (plan_table_groups,
                                       split_dlrm_params_by_plan)
from repro_torch.parallel.updates import adagrad_row_update, sgd_row_update
from repro_torch.runtime.elastic import Spec

Params = Dict[str, object]
# The reference's default mesh axes of the embedding distribution.
AXIS = ("data", "model")


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def shard_dlrm_params(params: Params, plan: Optional[ShardingPlan] = None,
                      exchange: Optional[EmbeddingExchange] = None
                      ) -> Params:
    """Place DLRM params for the step. On one rank (no ``exchange``, or
    one of n=1): with a placed ``plan``, stacked params ({"tables": ...})
    are split into the plan's fast/bulk table groups (new tensors on the
    tables' device); params already split, or no placed plan, pass
    through unchanged. Over more ranks: this rank's shards
    (``exchange.shards()``) of stacked params, each a new tensor on the
    tables' device; params that already are this rank's shards pass
    through. The MLPs are replicated (shared, not copied)."""
    if exchange is None or exchange.n == 1:
        if plan is not None and plan.placements and "tables" in params:
            params = split_dlrm_params_by_plan(params,
                                               plan_table_groups(plan, 1))
        return params
    shards = exchange.shards()
    if all(k in params and tuple(params[k].shape[:2]) == (len(ids), rows)
           for k, (ids, _, rows) in shards.items()):
        return params
    if "tables" not in params:
        raise ValueError(
            f"params over {exchange.n} ranks must be stacked ({{'tables': "
            f"(T, R, d)}}) or this rank's shards {sorted(shards)}")
    tables = params["tables"]
    out = {"bot_mlp": params["bot_mlp"], "top_mlp": params["top_mlp"]}
    for k, (ids, r0, rows) in shards.items():
        idx = torch.as_tensor(ids, dtype=torch.long, device=tables.device)
        out[k] = tables.index_select(0, idx)[:, r0:r0 + rows].contiguous()
    return out


def param_specs(cfg: DLRMConfig, axis=AXIS, groups=None) -> Params:
    """The reference's ``param_specs(cfg, axis, groups)``: the ``Spec`` of
    each leaf of DLRM params over the embedding ``axis`` (this rank's
    shards, as the exchange's ``shards()`` cuts them; replicated over
    ``dp_axes`` and every other axis). The MLPs are replicated; the
    tables table-wise over the axis (``Spec(axis)``) or row-wise
    (``Spec(None, axis)``); with plan ``groups`` (``PlanGroups``) the fast
    group table-wise and the bulk group row-wise, an empty group
    replicated."""
    mlps = {k: [{"w": None, "b": None} for _ in layers]
            for k, layers in dlrm_lib.mlp_shapes(cfg).items()}
    if groups is not None:
        return dict(mlps,
                    tables_fast=Spec(axis) if groups.fast_ids else None,
                    tables_bulk=Spec(None, axis) if groups.bulk_ids
                    else None)
    return dict(mlps, tables=(Spec(axis) if cfg.sharding == "table_wise"
                              else Spec(None, axis)))


def opt_state_specs(cfg: DLRMConfig, optimizer: str,
                    plan: Optional[ShardingPlan] = None, n: int = 1,
                    compress_grads: bool = False, axis=AXIS,
                    dp_axes: Tuple[str, ...] = ()) -> Optional[Params]:
    """The ``Spec`` tree of ``init_dlrm_opt_state``'s state over an
    embedding axis of ``n`` ranks: each AdaGrad accumulator sharded as its
    tables (an empty group replicated), and the error-feedback residuals
    one per rank of ``dp_axes + axis`` (``Spec(stack=...)``: at full
    width the reference's (n_devices, ...) leaves). None where the state
    is None. ``runtime.elastic.gather_tree`` by these specs and
    ``param_specs`` gathers a rank's state at full width."""
    if optimizer == "sgd" and not compress_grads:
        return None
    specs: Params = {}
    if optimizer == "adagrad":
        if plan is None or not plan.placements:
            specs["table_acc"] = param_specs(cfg, axis)["tables"]
        else:
            p = param_specs(cfg, axis, plan_table_groups(plan, n))
            specs["table_acc_fast"] = p["tables_fast"]
            specs["table_acc_bulk"] = p["tables_bulk"]
    if compress_grads:
        stack = _axes(dp_axes) + _axes(axis)
        specs["ef"] = {k: [{n_: Spec(stack=stack) for n_ in layer}
                           for layer in layers]
                       for k, layers in dlrm_lib.mlp_shapes(cfg).items()}
    return specs


def init_local_dlrm(cfg: DLRMConfig, generator: torch.Generator,
                    exchange: EmbeddingExchange) -> Params:
    """This rank's shards of ``dlrm.init_dlrm(cfg, generator)``, bitwise,
    on the generator's device, without the whole tables: the MLPs, then
    every table of the stream in order, each drawn into its place when
    this rank holds it whole, else into a one-table buffer whose owned
    rows are copied out. At n=1: ``init_dlrm`` itself."""
    if exchange.n == 1:
        return dlrm_lib.init_dlrm(cfg, generator)
    params = dlrm_lib.init_mlps(cfg, generator)
    R, d, dev = cfg.rows_per_table, cfg.embed_dim, generator.device
    dests: Dict[int, List[Tuple[str, int, int, int]]] = {}
    for k, (ids, r0, rows) in exchange.shards().items():
        params[k] = torch.empty((len(ids), rows, d), device=dev)
        for slot, t in enumerate(ids):
            dests.setdefault(t, []).append((k, slot, r0, rows))
    scratch = None
    for t in range(cfg.num_tables):
        whole = [x for x in dests.get(t, ()) if x[3] == R]
        if whole:
            src = dlrm_lib.draw_table(params[whole[0][0]][whole[0][1]], cfg,
                                      generator)
        else:
            if scratch is None:
                scratch = torch.empty((R, d), device=dev)
            src = dlrm_lib.draw_table(scratch, cfg, generator)
        for k, slot, r0, rows in dests.get(t, ()):
            dst = params[k][slot]
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src[r0:r0 + rows])
    return params


def init_error_feedback(cfg: DLRMConfig,
                        device: DeviceArg = None) -> Params:
    """This rank's error-feedback residuals of the compressed dense-grad
    all-reduce: fp32 zeros shaped like the MLPs (the reference carries
    one such copy a device, leading dim n_devices sharded over the step's
    axes; here each rank keeps its own)."""
    dev = resolve_device(device)
    return {k: [{n: torch.zeros(s, device=dev) for n, s in layer.items()}
                for layer in layers]
            for k, layers in dlrm_lib.mlp_shapes(cfg).items()}


def init_dlrm_opt_state(cfg: DLRMConfig, optimizer: str,
                        plan: Optional[ShardingPlan] = None, n: int = 1,
                        compress_grads: bool = False,
                        device: DeviceArg = None) -> Optional[Params]:
    """This rank's part of the optimizer state ``build_step(mode=
    "train")`` expects over an embedding axis of ``n`` ranks, on
    ``device`` (None: the card). AdaGrad: an fp32 accumulator per table
    group, sharded as the group's tables ("table_acc" of (T/n, R)
    table-wise or (T, R/n) row-wise; "table_acc_fast" (Tf/n, R) and
    "table_acc_bulk" (Tb, R/n) under a placed plan, whose groups depend on
    ``n``). ``compress_grads``: an "ef" tree of error-feedback residuals
    (``init_error_feedback``). Plain SGD: None."""
    if optimizer not in ("sgd", "adagrad"):
        raise ValueError(f"optimizer must be 'sgd' or 'adagrad', got "
                         f"{optimizer!r}")
    if optimizer == "sgd" and not compress_grads:
        return None
    dev = resolve_device(device)
    state: Params = {}
    R = cfg.rows_per_table

    def zeros(n_tables: int, rows: int) -> torch.Tensor:
        return torch.zeros((n_tables, rows), dtype=torch.float32, device=dev)

    if optimizer == "adagrad":
        if plan is None or not plan.placements:
            if cfg.sharding == "table_wise":
                state["table_acc"] = zeros(cfg.num_tables // n, R)
            else:
                state["table_acc"] = zeros(cfg.num_tables, R // n)
        else:
            groups = plan_table_groups(plan, n)
            nb = len(groups.bulk_ids)
            state["table_acc_fast"] = zeros(len(groups.fast_ids) // n, R)
            state["table_acc_bulk"] = zeros(nb, R // n if nb else R)
    if compress_grads:
        state["ef"] = init_error_feedback(cfg, dev)
    return state


def _mb_slices(x: torch.Tensor, depth: int) -> List[torch.Tensor]:
    b = x.shape[0]
    if b % depth:
        raise ValueError(
            f"pipeline_depth={depth} must divide the per-rank batch ({b} "
            f"samples); pad the batch or lower the depth")
    return list(x.split(b // depth))


def _leaves(tree: Params, like: Optional[Params] = None
            ) -> List[torch.Tensor]:
    """The MLP tensors of a params (or ef) tree, in layer order, each
    layer's in the order of ``like``'s (default: its own)."""
    like = tree if like is None else like
    return [tree[k][i][n] for k in ("bot_mlp", "top_mlp")
            for i, layer in enumerate(like[k]) for n in layer]


def build_step(cfg: DLRMConfig, mesh=None, *, mode: str = "serve",
               axis=AXIS, exchange: Optional[EmbeddingExchange] = None,
               plan: Optional[ShardingPlan] = None,
               row_wise_exchange: str = "partial_pool",
               lookup_chunk: int = 4096, pipeline_depth: int = 1,
               fused: bool = True, optimizer: str = "sgd", lr: float = 0.01,
               compress_grads: bool = False,
               dp_axes: Tuple[str, ...] = (),
               local_batch: bool = False, dp_sync: str = "sparse",
               device: DeviceArg = None) -> Callable:
    """Compose the exchange with the dense compute into one serve or train
    step (see the module doc).

    ``mesh`` (``launch.mesh.Mesh``; None: one device) with ``axis``, the
    embedding axis, and ``dp_axes``. ``exchange`` defaults to
    ``make_exchange`` over the embedding axis's ranks, for ``plan`` in
    ``row_wise_exchange``'s wire mode (a tiered one built on ``device``);
    a session passes its own. ``fused`` (serve mode): run the forward
    through the exchange's fused kernel when it supports one;
    ``fused=False`` forces the composed path. The returned serve step's
    ``serve_kernel`` attribute ("fused" or "composed") names the branch
    it runs. ``optimizer`` ("sgd" | "adagrad"), ``lr``,
    ``compress_grads`` and ``dp_sync`` ("sparse" | "dense", how the
    replicas over ``dp_axes`` agree): train mode. ``local_batch``: see
    the module doc."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    if dp_sync not in ("sparse", "dense"):
        raise ValueError(f"dp_sync must be 'sparse' or 'dense', got "
                         f"{dp_sync!r}")
    dp_axes = _axes(dp_axes)
    if mesh is None:
        if dp_axes:
            raise ValueError(f"dp_axes {dp_axes} need a mesh")
        n, group, n_full, full_group, r_full, dp_group = 1, None, 1, None, \
            0, None
    else:
        full = dp_axes + _axes(axis)
        n, group = mesh.size(axis), mesh.group(axis)
        n_full, full_group, r_full = (mesh.size(full), mesh.group(full),
                                      mesh.rank_in(full))
        dp_group = mesh.group(dp_axes)
    exch = exchange if exchange is not None else make_exchange(
        cfg, n, plan=plan, row_wise_exchange=row_wise_exchange,
        lookup_chunk=lookup_chunk, device=device, group=group)
    if exch.n != n:
        raise ValueError(f"the exchange spans {exch.n} ranks, the "
                         f"embedding axis {n}")
    depth = int(pipeline_depth)
    if depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")

    def local(x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the global batch."""
        if n_full == 1 or local_batch:
            return x
        b = x.shape[0]
        if b % n_full:
            raise ValueError(f"the batch ({b} samples) must split over the "
                             f"{n_full} ranks of {dp_axes + _axes(axis)}")
        m = b // n_full
        return x[r_full * m:(r_full + 1) * m]

    if mode == "train":
        return _train_step(exch, depth, optimizer, lr, local, n_full,
                           full_group, dp_group, compress_grads, dp_sync)
    use_fused = bool(fused) and exch.supports_fused_forward()

    def serve(params: Params, dense: torch.Tensor,
              indices: torch.Tensor) -> torch.Tensor:
        tables = {k: params[k] for k in exch.table_keys}
        den_mb = _mb_slices(local(dense), depth)
        idx_mb = _mb_slices(local(indices), depth)
        outs = []
        if use_fused:
            for den, idx in zip(den_mb, idx_mb):
                bot = dlrm_lib.mlp_forward(params["bot_mlp"], den)
                z = exch.fused_forward(tables, bot, idx)
                logits = dlrm_lib.mlp_forward(params["top_mlp"], z)[:, 0]
                outs.append(torch.sigmoid(logits))
        else:
            nxt = exch.forward(tables, idx_mb[0])
            for i in range(depth):
                pooled, _ = nxt
                if i + 1 < depth:
                    # the next micro-batch's exchange goes out before this
                    # micro-batch's dense compute
                    nxt = exch.forward(tables, idx_mb[i + 1])
                logits = dlrm_lib.dlrm_forward_from_pooled(
                    params, den_mb[i], pooled)
                outs.append(torch.sigmoid(logits))
        probs = outs[0] if depth == 1 else torch.cat(outs)
        return probs if local_batch else prim.all_gather(probs, full_group)

    serve.serve_kernel = "fused" if use_fused else "composed"
    return serve


def _concat_flat_grads(per_mb):
    """Per-micro-batch flat grads joined along N, per table key: the same
    row multiset the whole batch's expansion gives."""
    if len(per_mb) == 1:
        return per_mb[0]
    return {k: (torch.cat([f[k][0] for f in per_mb], dim=1),
                torch.cat([f[k][1] for f in per_mb], dim=1))
            for k in per_mb[0]}


def _psum_leaves(leaves: List[torch.Tensor],
                 group: prim.Group) -> List[torch.Tensor]:
    """``jax.lax.psum`` of a list of tensors: one all-reduce of them all."""
    if prim.group_size(group) == 1:
        return leaves
    summed = prim.psum(torch.cat([x.reshape(-1) for x in leaves]), group)
    out, at = [], 0
    for x in leaves:
        out.append(summed[at:at + x.numel()].reshape(x.shape))
        at += x.numel()
    return out


def _dp_snapshot(exch: EmbeddingExchange, tables, opt_state, ctxs,
                 with_acc: bool):
    """Before the sparse updates: per table key, the rows this rank's
    update reaches (flat ids into its shard, unique) and their values
    (and accumulators)."""
    touched: Dict[str, List[torch.Tensor]] = {}
    for ctx in ctxs:
        for k, rows in exch.touched_rows(ctx).items():
            touched.setdefault(k, []).append(rows)
    snap = {}
    for k, parts in touched.items():
        tab = tables[k]
        T, R = tab.shape[:2]
        rows = torch.cat(parts, dim=1).long()
        lin = torch.unique((rows + torch.arange(
            T, device=rows.device)[:, None] * R).reshape(-1))
        acc = (opt_state[acc_key(k)].reshape(-1)[lin].clone() if with_acc
               else None)
        snap[k] = (lin, tab.reshape(T * R, -1)[lin].clone(), acc)
    return snap


def _dp_apply(flat: torch.Tensor, lin: torch.Tensor, old: torch.Tensor,
              group: prim.Group) -> None:
    """Every replica of ``group`` sets the rows ``lin`` of ``flat`` to
    their value before the step plus the sum, in replica order, of every
    replica's change to its own rows: the reference's ``tables +
    psum(new - tables)`` over the rows that changed."""
    delta = flat[lin] - old
    sizes = prim.all_gather(torch.tensor([lin.numel()], device=flat.device),
                            group).tolist()
    m = max(max(sizes), 1)
    pad = m - lin.numel()
    lin_all = prim.all_gather(torch.cat([lin, lin.new_zeros(pad)]), group)
    d_all = prim.all_gather(torch.cat(
        [delta, delta.new_zeros((pad,) + tuple(delta.shape[1:]))]), group)
    flat[lin] = old
    for j, size in enumerate(sizes):
        flat.index_add_(0, lin_all[j * m:j * m + size],
                        d_all[j * m:j * m + size])


def _dp_dense(cur: torch.Tensor, old: torch.Tensor,
              group: prim.Group) -> None:
    """``cur = old + psum(cur - old)`` over ``group``, in place: the
    reference's ``tables + psum(new - tables, dp_axes)`` over a whole
    shard, the deltas summed in fp32."""
    delta = cur.float()
    if delta is cur:
        delta = cur.clone()
    delta = prim.psum(delta.sub_(old), group)
    cur.copy_(delta.add_(old))


def _train_step(exch: EmbeddingExchange, depth: int, optimizer: str,
                lr: float, local: Callable, n_full: int,
                full_group: prim.Group, dp_group: prim.Group,
                compress_grads: bool, dp_sync: str) -> Callable:
    if optimizer not in ("sgd", "adagrad"):
        raise ValueError(f"optimizer must be 'sgd' or 'adagrad', got "
                         f"{optimizer!r}")
    sgd = sgd_row_update(lr) if optimizer == "sgd" else None
    ada = adagrad_row_update(lr) if optimizer == "adagrad" else None
    car = make_compressed_allreduce(full_group) if compress_grads else None
    replicated = prim.group_size(dp_group) > 1

    def step(params: Params, opt_state: Optional[Params],
             dense: torch.Tensor, indices: torch.Tensor,
             labels: torch.Tensor):
        tables = {k: params[k] for k in exch.table_keys}
        layers = _leaves(params)
        mlps = {k: [{n: p.detach().requires_grad_() for n, p in
                     layer.items()} for layer in params[k]]
                for k in ("bot_mlp", "top_mlp")}
        leaves = _leaves(mlps)
        den_mb = _mb_slices(local(dense), depth)
        lab_mb = _mb_slices(local(labels), depth)
        with torch.no_grad():
            # every micro-batch's forward reads the tables before the step
            fwd = [exch.forward(tables, idx)
                   for idx in _mb_slices(local(indices), depth)]
            if not replicated:
                snap = None
            elif dp_sync == "dense":
                snap = {k: (tables[k].clone(), opt_state[acc_key(k)].clone()
                            if ada is not None else None)
                        for k in exch.table_keys}
            else:
                snap = _dp_snapshot(exch, tables, opt_state,
                                    [ctx for _, ctx in fwd], ada is not None)
        loss = torch.zeros((), device=dense.device)
        g_dense = None
        flat_mbs = []
        for (pooled, ctx), den, lab in zip(fwd, den_mb, lab_mb):
            leaf = pooled.detach().requires_grad_()
            logits = dlrm_lib.dlrm_forward_from_pooled(mlps, den, leaf)
            # the mean over the GLOBAL batch: local mean / (ranks x depth)
            loss_i = dlrm_lib.bce_loss(logits, lab) / (n_full * depth)
            *g_i, g_pooled = torch.autograd.grad(loss_i, leaves + [leaf])
            loss = loss + loss_i.detach()
            g_dense = g_i if g_dense is None else [
                a + b for a, b in zip(g_dense, g_i)]
            if sgd is not None:
                exch.sparse_apply(tables, ctx, g_pooled, sgd)
            else:
                flat_mbs.append(exch.expand_grads(tables, ctx, g_pooled))
        with torch.no_grad():
            if car is not None:
                ef = _leaves(opt_state["ef"], params)
                g_mean, new_ef = car(g_dense, ef)
                grads = [g * n_full for g in g_mean]
                for e, ne in zip(ef, new_ef):
                    e.copy_(ne)
            else:
                grads = _psum_leaves(g_dense, full_group)
            loss = prim.psum(loss, full_group)
            for p, g in zip(layers, grads):
                p.sub_(lr * g)
            if ada is not None:
                for k, (fi, fg) in _concat_flat_grads(flat_mbs).items():
                    ada(tables[k], opt_state[acc_key(k)], fi, fg)
            if snap is not None and dp_sync == "dense":
                for k, (old, acc_old) in snap.items():
                    _dp_dense(tables[k], old, dp_group)
                    if acc_old is not None:
                        _dp_dense(opt_state[acc_key(k)], acc_old, dp_group)
            elif snap is not None:
                for k, (lin, old, acc_old) in snap.items():
                    tab = tables[k]
                    _dp_apply(tab.view(tab.shape[0] * tab.shape[1], -1), lin,
                              old, dp_group)
                    if acc_old is not None:
                        _dp_apply(opt_state[acc_key(k)].view(-1, 1), lin,
                                  acc_old[:, None], dp_group)
        return params, opt_state, loss

    return step
