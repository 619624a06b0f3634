"""build_step: the one composition of exchange + dense compute + grads.

Serve mode returns ``step(params, dense, indices) -> probs (B,)`` over
``pipeline_depth`` micro-batches. With a fused-capable exchange (and
``fused=True``) each micro-batch runs bottom MLP -> fused gather -> pool
-> interaction kernel -> top MLP; otherwise the composed path pools
through ``exchange.forward`` and runs ``dlrm_forward_from_pooled``. The
micro-batches run in sequence on one device, so the result does not
depend on the depth. A placed plan selects the tiered exchange, whose
params are plan-split (``tables_fast``, ``tables_bulk``; see
``shard_dlrm_params``).

Train mode returns ``step(params, opt_state, dense, indices, labels) ->
(params, opt_state, loss)`` (paper Alg. 2 at n=1), as the reference's
step: every micro-batch's forward reads the tables as they were before
the step; autograd gives the dense grads and the pooled grads of each
micro-batch's loss (its BCE / depth); SGD applies each micro-batch's
sparse update through the exchange, AdaGrad concatenates the flat grads
of all micro-batches and applies once (its accumulator must see the whole
batch's rows); the dense update is ``p - lr * g`` of the summed grads.
The step updates the tables, the dense layers and the accumulators IN
PLACE (the reference returns new arrays from donated ones) and returns
the same objects; the loss is a device scalar, so nothing waits for the
device.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.core.planner import ShardingPlan
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.parallel.exchange import (EmbeddingExchange, acc_key,
                                           make_exchange)
from repro_torch.parallel.plan import (plan_table_groups,
                                       split_dlrm_params_by_plan)
from repro_torch.parallel.updates import adagrad_row_update, sgd_row_update

Params = Dict[str, object]


def shard_dlrm_params(params: Params,
                      plan: Optional[ShardingPlan] = None) -> Params:
    """Place DLRM params for the step on one device. With a placed
    ``plan``, stacked params ({"tables": ...}) are split into the plan's
    fast/bulk table groups (new tensors on the tables' device); params
    already split, or no placed plan, pass through unchanged."""
    if plan is not None and plan.placements and "tables" in params:
        params = split_dlrm_params_by_plan(params, plan_table_groups(plan, 1))
    return params


def init_dlrm_opt_state(cfg: DLRMConfig, optimizer: str,
                        plan: Optional[ShardingPlan] = None, n: int = 1,
                        compress_grads: bool = False,
                        device: DeviceArg = None) -> Optional[Params]:
    """The optimizer state ``build_step(mode="train")`` expects, on
    ``device`` (None: the card): None for SGD; for AdaGrad a (T, R) fp32
    accumulator per table group, ``table_acc``, or ``table_acc_fast`` and
    ``table_acc_bulk`` under a placed plan."""
    if n != 1 or compress_grads:
        raise NotImplementedError(
            "optimizer state over more than one device or for compressed "
            "dense grads is not ported yet (ROADMAP A6b, k ranks)")
    if optimizer not in ("sgd", "adagrad"):
        raise ValueError(f"optimizer must be 'sgd' or 'adagrad', got "
                         f"{optimizer!r}")
    if optimizer == "sgd":
        return None
    dev = resolve_device(device)

    def zeros(n_tables: int) -> torch.Tensor:
        return torch.zeros((n_tables, cfg.rows_per_table),
                           dtype=torch.float32, device=dev)

    if plan is None or not plan.placements:
        return {"table_acc": zeros(cfg.num_tables)}
    groups = plan_table_groups(plan, n)
    return {"table_acc_fast": zeros(len(groups.fast_ids)),
            "table_acc_bulk": zeros(len(groups.bulk_ids))}


def _mb_slices(x: torch.Tensor, depth: int) -> List[torch.Tensor]:
    b = x.shape[0]
    if b % depth:
        raise ValueError(
            f"pipeline_depth={depth} must divide the batch ({b} samples); "
            f"pad the batch or lower the depth")
    return list(x.split(b // depth))


def build_step(cfg: DLRMConfig, *, mode: str = "serve",
               exchange: Optional[EmbeddingExchange] = None,
               pipeline_depth: int = 1, fused: bool = True,
               optimizer: str = "sgd", lr: float = 0.01,
               compress_grads: bool = False,
               dp_axes: Tuple[str, ...] = ()) -> Callable:
    """Compose the exchange with the dense compute into one serve or train
    step (see the module doc).

    ``exchange`` defaults to ``make_exchange(cfg)``, the config's own
    layout; a planned session passes its tiered exchange. ``fused`` (serve
    mode): run the forward through the exchange's fused kernel when it
    supports one; ``fused=False`` forces the composed path. The returned
    serve step's ``serve_kernel`` attribute ("fused" or "composed") names
    the branch it runs. ``optimizer`` ("sgd" | "adagrad") and ``lr``:
    train mode."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    if compress_grads or dp_axes:
        raise NotImplementedError(
            "compressed dense grads and pure data-parallel axes are not "
            "ported yet (ROADMAP A6b, k ranks)")
    exch = exchange if exchange is not None else make_exchange(cfg)
    depth = int(pipeline_depth)
    if depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
    if mode == "train":
        return _train_step(exch, depth, optimizer, lr)
    use_fused = bool(fused) and exch.supports_fused_forward()

    def serve(params: Params, dense: torch.Tensor,
              indices: torch.Tensor) -> torch.Tensor:
        tables = {k: params[k] for k in exch.table_keys}
        outs = []
        for den, idx in zip(_mb_slices(dense, depth),
                            _mb_slices(indices, depth)):
            if use_fused:
                bot = dlrm_lib.mlp_forward(params["bot_mlp"], den)
                z = exch.fused_forward(tables, bot, idx)
                logits = dlrm_lib.mlp_forward(params["top_mlp"], z)[:, 0]
            else:
                pooled, _ = exch.forward(tables, idx)
                logits = dlrm_lib.dlrm_forward_from_pooled(params, den,
                                                           pooled)
            outs.append(torch.sigmoid(logits))
        return outs[0] if depth == 1 else torch.cat(outs)

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


def _train_step(exch: EmbeddingExchange, depth: int, optimizer: str,
                lr: float) -> Callable:
    if optimizer not in ("sgd", "adagrad"):
        raise ValueError(f"optimizer must be 'sgd' or 'adagrad', got "
                         f"{optimizer!r}")
    sgd = sgd_row_update(lr) if optimizer == "sgd" else None
    ada = adagrad_row_update(lr) if optimizer == "adagrad" else None

    def step(params: Params, opt_state: Optional[Params],
             dense: torch.Tensor, indices: torch.Tensor,
             labels: torch.Tensor):
        tables = {k: params[k] for k in exch.table_keys}
        layers = [p for k in ("bot_mlp", "top_mlp") for layer in params[k]
                  for p in layer.values()]
        mlps = {k: [{n: p.detach().requires_grad_() for n, p in
                     layer.items()} for layer in params[k]]
                for k in ("bot_mlp", "top_mlp")}
        leaves = [p for k in ("bot_mlp", "top_mlp") for layer in mlps[k]
                  for p in layer.values()]
        den_mb, lab_mb = _mb_slices(dense, depth), _mb_slices(labels, depth)
        with torch.no_grad():
            # every micro-batch's forward reads the tables before the step
            fwd = [exch.forward(tables, idx)
                   for idx in _mb_slices(indices, depth)]
        loss = torch.zeros((), device=dense.device)
        g_dense = None
        flat_mbs = []
        for (pooled, ctx), den, lab in zip(fwd, den_mb, lab_mb):
            leaf = pooled.detach().requires_grad_()
            logits = dlrm_lib.dlrm_forward_from_pooled(mlps, den, leaf)
            loss_i = dlrm_lib.bce_loss(logits, lab) / depth
            *g_i, g_pooled = torch.autograd.grad(loss_i, leaves + [leaf])
            loss = loss + loss_i.detach()
            g_dense = g_i if g_dense is None else [
                a + b for a, b in zip(g_dense, g_i)]
            if sgd is not None:
                exch.sparse_apply(tables, ctx, g_pooled, sgd)
            else:
                flat_mbs.append(exch.expand_grads(tables, ctx, g_pooled))
        with torch.no_grad():
            for p, g in zip(layers, g_dense):
                p.sub_(lr * g)
            if ada is not None:
                for k, (fi, fg) in _concat_flat_grads(flat_mbs).items():
                    ada(tables[k], opt_state[acc_key(k)], fi, fg)
        return params, opt_state, loss

    return step
