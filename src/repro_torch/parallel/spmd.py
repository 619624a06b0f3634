"""Placement by partition spec: a rank's shard of a leaf, of a tree, and
the inverse gather (the port's counterpart of placing arrays with the
reference's ``NamedSharding``s).

A spec (``models.sharding_rules.P``, filtered for the mesh) names, per
dim, the axes the dim is split over, or None (whole). A rank holds the
block at its flattened coordinate along each dim's axes (``Mesh.rank_in``,
the axes in the mesh's order): the block ``[i n / k, (i + 1) n / k)`` of
a dim of ``n`` split ``k`` ways. On a ``PlaceholderMesh`` that is rank
0's block; on a mesh over a world, this rank's.

``shard_numpy`` is ``convert``'s counterpart for the spec-driven LM: the
reference's numpy tree, each leaf cut to this rank's block before it is
copied onto the device, so a rank never holds a whole leaf there.
``gather`` and ``gather_tree`` are the inverse over a world (tests read
whole trees with them).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceArg, resolve_device
from repro_torch.models.sharding_rules import P, _axes, tree_map_with_path
from repro_torch.parallel import primitives as prim

Params = Any


def _blocks(spec: P, ndim: int, mesh):
    """(dim, axes, parts, index) of each split dim of ``spec``."""
    out = []
    for dim, entry in enumerate(tuple(spec)[:ndim]):
        axes = _axes(entry)
        if axes:
            out.append((dim, axes, mesh.size(axes), mesh.rank_in(axes)))
    return out


def local_shape(shape: Tuple[int, ...], spec: P, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape``."""
    out = list(shape)
    for dim, _, parts, _ in _blocks(spec, len(shape), mesh):
        out[dim] //= parts
    return tuple(out)


def shard(x, spec: P, mesh):
    """This rank's block of ``x`` (a tensor or numpy array) under
    ``spec``: a view (a tensor's ``narrow``, an array's slice)."""
    for dim, _, parts, i in _blocks(spec, x.ndim, mesh):
        n = x.shape[dim] // parts
        if isinstance(x, torch.Tensor):
            x = x.narrow(dim, i * n, n)
        else:
            x = x[(slice(None),) * dim + (slice(i * n, (i + 1) * n),)]
    return x


def shard_numpy(tree: Params, specs: Params, mesh,
                device: DeviceArg = None) -> Params:
    """The reference's params (numpy) -> this rank's shards on ``device``:
    each leaf cut on the host, then copied into a tensor of its own
    (``convert``'s counterpart)."""
    dev = resolve_device(device)
    leaves = _by_path(specs)
    return tree_map_with_path(
        lambda path, x: torch.from_numpy(np.array(
            shard(np.asarray(x), leaves[path], mesh))).to(dev), tree)


def gather(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The inverse of ``shard`` over a world: each split dim all-gathered
    over its axes' group, in the mesh's order."""
    for dim, axes, parts, _ in _blocks(spec, x.ndim, mesh):
        if parts > 1:
            x = prim.all_gather(x.movedim(dim, 0).contiguous(),
                                mesh.group(axes)).movedim(0, dim)
    return x.contiguous()


def gather_tree(tree: Params, specs: Params, mesh) -> Params:
    leaves = _by_path(specs)
    return tree_map_with_path(lambda path, x: gather(x, leaves[path], mesh),
                              tree)


def _by_path(specs: Params):
    leaves = {}
    tree_map_with_path(lambda path, s: leaves.__setitem__(path, s), specs)
    return leaves
