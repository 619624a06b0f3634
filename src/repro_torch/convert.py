"""Carry weights across from the JAX reference.

The caller turns the reference's params into numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``); this module takes that
tree and never imports JAX. The port keeps the reference's layout (an MLP
weight is (in, out) and a layer computes ``x @ w + b``), so nothing is
transposed. A NamedTuple (the reference's ``AdamWState``) comes across as
the dict of its fields, the port's form of that state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceArg, resolve_device


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
