"""Elastic re-placement: move a param tree onto another board's device.

The port's counterpart of ``repro.runtime.elastic``. The reference
re-shards every leaf of a sharded pytree onto a new mesh under its
PartitionSpec, degrading a spec that does not divide to replication. The
port runs one device per board (multi-device meshes are ROADMAP A6b), so
every spec fits and re-placement is device placement: each tensor leaf
becomes a COPY that the new board owns -- the reference's report on a
one-device sub-mesh, ``{"resharded": n_leaves, "replicated_fallback":
0}``. It must be a copy, not an alias: a JAX array is immutable, so a
placement that aliases is still a copy in meaning, while a torch tensor
can be updated in place (online row updates write a replica's tables).

``specs`` is a tree congruent with ``tree`` (``None`` leaves, see
``cluster.replica.Replica.param_specs``); it is checked for shape, since
the reference's tree_map would refuse a tree it does not match.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import DeviceArg, resolve_device

Params = Any


def remesh_tree(tree: Params, specs: Params, device: DeviceArg = None
                ) -> Tuple[Params, Dict[str, int]]:
    """Copy every tensor leaf of ``tree`` onto ``device`` (None: the card).

    Returns (new_tree, report); the report counts the leaves placed
    ("resharded") and those that fell back to replication (always 0 on
    one device)."""
    dev = resolve_device(device)
    report = {"resharded": 0, "replicated_fallback": 0}

    def place(x, spec):
        if isinstance(x, dict):
            if not isinstance(spec, dict) or set(spec) != set(x):
                raise ValueError(f"specs do not match the tree at keys "
                                 f"{sorted(x)}")
            return {k: place(v, spec[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            if not isinstance(spec, (list, tuple)) or len(spec) != len(x):
                raise ValueError(f"specs do not match a sequence of "
                                 f"{len(x)} leaves")
            return type(x)(place(v, s) for v, s in zip(x, spec))
        if spec is not None:
            raise ValueError(f"a spec of one device is None, got {spec!r}")
        report["resharded"] += 1
        return x.to(dev, copy=True)

    return place(tree, specs), report


def none_specs(tree: Params) -> Params:
    """A spec tree of ``None``s congruent with ``tree``: every leaf whole
    on the board's one device."""
    if isinstance(tree, dict):
        return {k: none_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(none_specs(v) for v in tree)
    if not torch.is_tensor(tree):
        raise TypeError(f"param leaves are tensors, got "
                        f"{type(tree).__name__}")
    return None
