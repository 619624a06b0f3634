"""DLRM model (paper Sec. III-D / Fig. 4, Algorithm 1) in PyTorch.

Params are a plain dict with the reference's layout, so weights carry
across from ``repro.core.dlrm`` unchanged (``repro_torch.convert``):

  bot_mlp / top_mlp : list of {"w": (in, out), "b": (out,)} fp32; a layer
                      computes ``x @ w + b``
  tables            : (T, R, d) fp32, stacked (RM2 tables are homogeneous)

Layouts at the public functions follow the reference: dense (B, D) fp32,
indices (B, T, L) int32, pooled (B, T, d), bot_out (B, d).

The model's own lookup and interaction are plain torch, as the
reference's are jnp; the hand-written kernels are reached through
``kernels.ops`` by the serve path and the tiered runtime.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig

Params = Dict[str, object]


def _uniform(shape: Tuple[int, ...], bound: float,
             generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape, device=generator.device).uniform_(
        -bound, bound, generator=generator)


def _mlp_init(dims: Tuple[int, ...], d_in: int,
              generator: torch.Generator) -> List[Dict[str, torch.Tensor]]:
    layers = []
    prev = d_in
    for w in dims:
        # DLRM's uniform(-sqrt(1/n), sqrt(1/n)), as the reference
        bound = math.sqrt(1.0 / prev)
        layers.append({"w": _uniform((prev, w), bound, generator),
                       "b": _uniform((w,), bound, generator)})
        prev = w
    return layers


def init_mlps(cfg: DLRMConfig, generator: torch.Generator) -> Params:
    """The bottom and top MLPs of ``init_dlrm``: its first draws from
    ``generator``, so the tables follow them in the stream."""
    return {
        "bot_mlp": _mlp_init(cfg.bot_mlp_dims, cfg.num_dense, generator),
        "top_mlp": _mlp_init(cfg.top_mlp, cfg.top_mlp_in, generator),
    }


def draw_table(out: torch.Tensor, cfg: DLRMConfig,
               generator: torch.Generator) -> torch.Tensor:
    """Draw one (R, d) table of ``init_dlrm`` into ``out`` (on the
    generator's device), in place: the next table of the stream."""
    bound = math.sqrt(1.0 / cfg.rows_per_table)
    return out.uniform_(-bound, bound, generator=generator)


def init_dlrm(cfg: DLRMConfig, generator: torch.Generator) -> Params:
    """Random params on ``generator.device``, with the reference's uniform
    bounds: the MLPs, then the tables one table at a time, in place on
    that device (at full width they are never built on the host). A
    caller who draws the same tables one by one elsewhere (the host tier,
    ``hoststore.draw_host_tables``) gets them bitwise."""
    params = init_mlps(cfg, generator)
    tables = torch.empty((cfg.num_tables, cfg.rows_per_table, cfg.embed_dim),
                         device=generator.device)
    for t in range(cfg.num_tables):
        draw_table(tables[t], cfg, generator)
    params["tables"] = tables
    return params


def mlp_forward(layers: List[Dict[str, torch.Tensor]], x: torch.Tensor,
                final_activation: Optional[str] = None) -> torch.Tensor:
    """ReLU MLP; the last layer returns logits unless
    ``final_activation="relu"``."""
    n = len(layers)
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1 or final_activation == "relu":
            x = torch.relu(x)
    return x


def embedding_bag(tables: torch.Tensor,
                  indices: torch.Tensor) -> torch.Tensor:
    """Lookup + sum-pool. tables (T, R, d), indices (B, T, L) -> (B, T, d)
    in the tables' dtype.

    Rows are taken as ``jnp.take`` takes them: a negative id counts from
    the end of its table, and an id outside [-R, R) takes a row of NaN."""
    T, R, _ = tables.shape
    idx = indices.long()
    idx = torch.where(idx < 0, idx + R, idx)
    inside = (idx >= 0) & (idx < R)
    t = torch.arange(T, device=tables.device)[None, :, None]
    rows = tables[t, idx.clamp(0, R - 1)]                  # (B, T, L, d)
    return rows.masked_fill(~inside[..., None], float("nan")).sum(dim=2)


def feature_interactions(bot_out: torch.Tensor,
                         pooled: torch.Tensor) -> torch.Tensor:
    """FM pairwise dot products without the diagonal or duplicates (paper
    Sec. III-D), after the bottom-MLP output: the strict lower triangle of
    A A^T, A = [bot_out; pooled], in row-major order.
    bot_out (B, d), pooled (B, T, d) -> (B, d + (T+1)T/2)."""
    T = pooled.shape[1]
    a = torch.cat([bot_out[:, None, :], pooled], dim=1)    # (B, T+1, d)
    f = torch.einsum("bid,bjd->bij", a, a)
    li, lj = torch.tril_indices(T + 1, T + 1, offset=-1, device=a.device)
    return torch.cat([bot_out, f[:, li, lj]], dim=1)


def dlrm_forward(params: Params, dense: torch.Tensor, indices: torch.Tensor,
                 cfg: DLRMConfig) -> torch.Tensor:
    """Single-device forward (Alg. 1, n=1). Returns logits (B,)."""
    pooled = embedding_bag(params["tables"], indices)
    return dlrm_forward_from_pooled(params, dense, pooled)


def dlrm_forward_from_pooled(params: Params, dense: torch.Tensor,
                             pooled: torch.Tensor) -> torch.Tensor:
    """Dense part only, given pooled embeddings."""
    bot = mlp_forward(params["bot_mlp"], dense)
    z = feature_interactions(bot, pooled)
    return mlp_forward(params["top_mlp"], z)[:, 0]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy with logits, mean-reduced."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def predict(params: Params, dense: torch.Tensor, indices: torch.Tensor,
            cfg: DLRMConfig) -> torch.Tensor:
    """P(u, c) in (0, 1), the paper's black-box output (Sec. III-A)."""
    return torch.sigmoid(dlrm_forward(params, dense, indices, cfg))


def reference_train_step(params: Params, dense: torch.Tensor,
                         indices: torch.Tensor, labels: torch.Tensor,
                         cfg: DLRMConfig, lr: float
                         ) -> Tuple[Params, torch.Tensor]:
    """Vanilla-SGD step (paper Alg. 2, n=1), the single-device oracle.

    Autograd runs over the dense layers and the pooled embeddings (a leaf):
    the pooled gradient is expanded to every looked-up row and
    scatter-added into the tables with ``index_add_``, so the dense
    (T, R, d) gradient never exists and the tables never require a
    gradient. The tables are updated IN PLACE (the reference returns new
    ones; at full width a copy is 21.5 GB); the dense layers come back as
    new tensors. Returns (params, loss before the update)."""
    tables = params["tables"]
    with torch.no_grad():
        pooled = embedding_bag(tables, indices)
    mlps = {k: [{n: p.detach().requires_grad_() for n, p in layer.items()}
                for layer in params[k]] for k in ("bot_mlp", "top_mlp")}
    leaf = pooled.detach().requires_grad_()
    loss = bce_loss(dlrm_forward_from_pooled(mlps, dense, leaf), labels)
    ps = [p for k in ("bot_mlp", "top_mlp") for layer in mlps[k]
          for p in layer.values()]
    *grads, g_pooled = torch.autograd.grad(loss, ps + [leaf])
    new = iter([(p - lr * g).detach() for p, g in zip(ps, grads)])
    out = {k: [{n: next(new) for n in layer} for layer in mlps[k]]
           for k in ("bot_mlp", "top_mlp")}

    # expand the pooled grads to every looked-up row, then scatter-add
    T, _, d = tables.shape
    B, _, L = indices.shape
    flat_idx = indices.transpose(0, 1).reshape(T, B * L)
    flat_g = g_pooled.transpose(0, 1)[:, :, None, :].expand(
        T, B, L, d).reshape(T, B * L, d)
    with torch.no_grad():
        scatter_add_rows(tables, flat_idx, -lr * flat_g)
    return {**out, "tables": tables}, loss.detach()


def scatter_add_rows(dst: torch.Tensor, flat_idx: torch.Tensor,
                     values: torch.Tensor) -> None:
    """In place, per table t: ``dst[t] = dst[t].at[flat_idx[t]].add(
    values[t])``. dst (T, R, ...) , flat_idx (T, N), values (T, N, ...) of
    dst's dtype. Repeated ids accumulate (``index_add_``), a negative id
    counts from the end of its table and an id outside [-R, R) is dropped,
    as JAX's scatter-add treats them."""
    T, R = dst.shape[:2]
    idx = flat_idx.long()
    idx = torch.where(idx < 0, idx + R, idx)
    inside = (idx >= 0) & (idx < R)
    rows = torch.where(inside, idx, 0) + torch.arange(
        T, device=dst.device)[:, None] * R
    keep = inside.reshape(inside.shape + (1,) * (values.dim() - 2))
    values = torch.where(keep, values, torch.zeros((), dtype=values.dtype,
                                                   device=values.device))
    dst.view((T * R,) + tuple(dst.shape[2:])).index_add_(
        0, rows.reshape(-1), values.reshape((-1,) + tuple(values.shape[2:])))
