"""Carry weights across from the JAX reference.

The caller turns the reference's params into numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``); this module takes that
tree and never imports JAX. The port keeps the reference's layout (an MLP
weight is (in, out) and a layer computes ``x @ w + b``), so nothing is
transposed. A NamedTuple (the reference's ``AdamWState``) comes across as
the dict of its fields, the port's form of that state.

Over k ranks an LM tree comes across whole and each rank keeps its part
(``local_lm_params``): the MoE layers' expert weights are sharded over
"model" as the body the ``Sharder`` picks reads them
(``models.moe_dist.weight_layout``), every other leaf is whole.
``gather_lm_params`` is the inverse, over the "model" group.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceArg, resolve_device
from repro_torch.models import moe_dist
from repro_torch.models.common import Sharder
from repro_torch.parallel import primitives as P


def params_from_jax_numpy(tree: Any, device: DeviceArg = None) -> Any:
    """The same tree of dicts and lists, with every numpy array (0-d ones
    included) copied into a tensor of the same shape and dtype on
    ``device``, and each NamedTuple made the dict of its fields."""
    dev = resolve_device(device)

    def convert(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return {k: convert(v) for k, v in x._asdict().items()}
        if isinstance(x, (list, tuple)):
            return type(x)(convert(v) for v in x)
        return torch.from_numpy(np.array(x)).to(dev)

    return convert(tree)


def _map_experts(params: Any, cfg, sharder: Sharder, fn) -> Any:
    """``params`` with ``fn(leaf, dim)`` in place of each expert weight a
    layout shards (``dim`` the split dim, past the stacked units dim);
    every other leaf as it is."""
    layout = (moe_dist.weight_layout(cfg, sharder)
              if cfg.moe is not None else None)
    if layout is None:
        return params
    dims = moe_dist.SHARD_DIMS[layout]
    units = [{**u, "moe": {k: fn(v, dims[k] + 1) if k in dims else v
                           for k, v in u["moe"].items()}}
             if "moe" in u else u for u in params["units"]]
    return {**params, "units": units}


def local_lm_params(params: Any, cfg, sharder: Sharder) -> Any:
    """A whole LM tree (the port's, or the reference's through
    ``params_from_jax_numpy``) -> this rank's: each MoE layer's expert
    weights sliced to this rank's 1/|model| along E (the ep body) or d_ff
    (local dispatch), in tensors of their own; other leaves shared."""
    M, r = sharder.model_size, sharder.model_rank

    def mine(x, dim):
        n = x.shape[dim] // M
        return x.narrow(dim, r * n, n).clone()

    return _map_experts(params, cfg, sharder, mine)


def lm_param_specs(params: Any, cfg, sharder: Sharder) -> Any:
    """The ``runtime.elastic.Spec`` tree of this rank's LM params: each
    expert weight a layout shards split over "model" along its dim,
    every other leaf replicated (None)."""
    from repro_torch.runtime.elastic import Spec, none_specs

    def split(_, dim):
        return Spec(*([None] * dim + ["model"]))

    return _map_experts(none_specs(params), cfg, sharder, split)


def gather_lm_params(params: Any, cfg, sharder: Sharder) -> Any:
    """The inverse of ``local_lm_params`` over the "model" group: each
    sharded leaf all-gathered whole (a tree of grads, too)."""
    group = sharder.model_group

    def whole(x, dim):
        return P.all_gather(x.movedim(dim, 0), group).movedim(0, dim) \
            .contiguous()

    return _map_experts(params, cfg, sharder, whole)
