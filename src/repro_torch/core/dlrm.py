"""DLRM model (paper Sec. III-D / Fig. 4, Algorithm 1) in PyTorch.

Params are a plain dict with the reference's layout, so weights carry
across from ``repro.core.dlrm`` unchanged (``repro_torch.convert``):

  bot_mlp / top_mlp : list of {"w": (in, out), "b": (out,)} fp32; a layer
                      computes ``x @ w + b``
  tables            : (T, R, d) fp32, stacked (RM2 tables are homogeneous)

Layouts at the public functions follow the reference: dense (B, D) fp32,
indices (B, T, L) int32, pooled (B, T, d), bot_out (B, d).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.kernels import ref

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


def init_dlrm(cfg: DLRMConfig, generator: torch.Generator) -> Params:
    """Random params on ``generator.device``, with the reference's uniform
    bounds. The tables are drawn in place on that device: at full width
    they are never built on the host."""
    return {
        "bot_mlp": _mlp_init(cfg.bot_mlp_dims, cfg.num_dense, generator),
        "top_mlp": _mlp_init(cfg.top_mlp, cfg.top_mlp_in, generator),
        "tables": _uniform(
            (cfg.num_tables, cfg.rows_per_table, cfg.embed_dim),
            math.sqrt(1.0 / cfg.rows_per_table), generator),
    }


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
    """Lookup + sum-pool. tables (T, R, d), indices (B, T, L) -> (B, T, d)."""
    return ref.embedding_bag_ref(tables, indices)


def feature_interactions(bot_out: torch.Tensor,
                         pooled: torch.Tensor) -> torch.Tensor:
    """FM pairwise dot products without the diagonal or duplicates (paper
    Sec. III-D), after the bottom-MLP output.
    bot_out (B, d), pooled (B, T, d) -> (B, d + (T+1)T/2)."""
    return ref.interactions_ref(bot_out, pooled)


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
