"""The mesh of ranks: k processes, each running the same program on its
own shard (the reference's ``src/repro/launch/mesh.py``).

The reference lays its devices out as a ``jax.sharding.Mesh`` and runs
each step's body on every device under ``shard_map``. The port runs one
process a rank over ``torch.distributed`` (gloo), and ``Mesh`` lays the
initialised world out the same way: a shape over named axes, rank r at
the row-major coordinates of r. An axis name, or a tuple of them, names
the flattened group of ranks that differ only along those axes, as the
reference flattens ``("data", "model")``; a tuple must list its axes in
the mesh's order, so that a rank's place in the group is its flattened
coordinate.

Without an initialised process group the world is one rank: every axis
has size 1 and every group is None, which the collectives
(``parallel.primitives``) take as "skip".

A mesh may lay out a subset of the world's ranks (``ranks=``, the
reference's ``submesh`` of a device subset): a board of a fleet. Its
groups are still built on every rank of the world, members or not, in
the same order (``dist.new_group`` is collective over the world); a rank
outside it has no coordinates and None for every group, and takes part
in none of its collectives. Groups are cached by their ranks
(``group_of``), so sub-meshes built again over the same ranks, as a
fleet's scale-up does in the middle of a run, reuse them.

Axis semantics, as in the reference: ``model`` carries the
latency-bound embedding exchanges, ``data`` the data-parallel batch
split; ``dp_axes`` replicate the tables.
"""
from __future__ import annotations

import contextlib
import io
import itertools
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import torch.distributed as dist

Axis = Union[str, Tuple[str, ...]]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


_GROUPS: Dict[Tuple[int, ...], Optional[dist.ProcessGroup]] = {}
_GROUPS_OF: list = [None]        # the world the cache belongs to


def group_of(ranks) -> Optional[dist.ProcessGroup]:
    """The process group of exactly ``ranks`` (global ranks): None for one
    rank, the world's own group for all of them, else one built by
    ``dist.new_group`` the first time these ranks are asked for. Every
    rank of the world must ask for the same groups in the same order,
    members or not; a rank outside ``ranks`` gets a handle it must not
    use."""
    key = tuple(sorted(int(r) for r in ranks))
    if len(key) <= 1:
        return None
    if len(key) == world_size():
        return dist.group.WORLD
    if _GROUPS_OF[0] is not dist.group.WORLD:   # a new world: new groups
        _GROUPS.clear()
        _GROUPS_OF[0] = dist.group.WORLD
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key))
    return _GROUPS[key]


def _axes(axes: Axis) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """A named layout of the world's ranks.

    ``shape`` (sizes) over ``axes`` (names) lays out ``ranks`` (global
    ranks, default the whole world; kept in ascending order, which is
    the order of their groups), whose number must be the product of the
    sizes. Every group of every non-empty set of axes is built here
    (``group_of``), on every rank of the world and in the same order:
    ``group(axes)`` then only looks one up. ``member`` says whether this
    rank is in the mesh; ``lead`` is its first rank."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...],
                 ranks: Optional[Sequence[int]] = None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} must pair "
                             f"up, one distinct name a dimension")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh sizes must be >= 1, got {shape}")
        total = 1
        for s in shape:
            total *= s
        if ranks is None:
            if total != world_size():
                raise ValueError(f"a mesh of shape {shape} needs {total} "
                                 f"ranks; the world has {world_size()}")
            ranks = range(total)
        ranks = tuple(sorted(int(r) for r in ranks))
        if len(ranks) != total or len(set(ranks)) != total:
            raise ValueError(f"a mesh of shape {shape} needs {total} "
                             f"distinct ranks, got {ranks}")
        if ranks[0] < 0 or ranks[-1] >= world_size():
            raise ValueError(f"ranks {ranks} are not all in the world of "
                             f"{world_size()}")
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.axis_names = axes
        self.ranks: Tuple[int, ...] = ranks
        self.lead = ranks[0]
        self.rank = world_rank()
        self.member = self.rank in ranks
        self.coords: Dict[str, int] = {}
        if self.member:
            coords, r = [], ranks.index(self.rank)
            for s in reversed(shape):
                coords.append(r % s)
                r //= s
            self.coords = dict(zip(axes, reversed(coords)))
        self._groups: Dict[Tuple[str, ...], Optional[dist.ProcessGroup]] = {}
        for k in range(1, len(axes) + 1):
            for sub in itertools.combinations(axes, k):
                self._groups[sub] = self._build(sub)

    def _build(self, sub: Tuple[str, ...]) -> Optional[dist.ProcessGroup]:
        """This rank's group over the axes ``sub``, built on every rank of
        the world (None on a rank outside the mesh)."""
        if self.size(sub) == 1:
            return None
        rest = [a for a in self.axis_names if a not in sub]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
            at = dict(zip(rest, fixed))
            ranks = [self._rank_at({**at, **dict(zip(sub, c))})
                     for c in itertools.product(
                         *(range(self.shape[a]) for a in sub))]
            group = group_of(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def _rank_at(self, coords: Dict[str, int]) -> int:
        """The global rank at ``coords``."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return self.ranks[r]

    def _key(self, axes: Axis) -> Tuple[str, ...]:
        key = _axes(axes)
        missing = [a for a in key if a not in self.shape]
        if missing:
            raise ValueError(f"axes {missing} not in mesh {self.shape}")
        if list(key) != [a for a in self.axis_names if a in key] \
                or len(set(key)) != len(key):
            raise ValueError(f"axes {key} must be distinct and listed in "
                             f"the mesh's order {self.axis_names}")
        return key

    def size(self, axes: Optional[Axis] = None) -> int:
        """The number of ranks along ``axes`` (the reference's
        ``axis_size``); None: the whole mesh."""
        n = 1
        for a in (self.axis_names if axes is None else self._key(axes)):
            n *= self.shape[a]
        return n

    def group(self, axes: Axis) -> Optional[dist.ProcessGroup]:
        """The process group of this rank along ``axes`` (None where it is
        one rank). Its ranks run in flattened order: this rank's place in
        it is ``rank_in(axes)``."""
        key = self._key(axes)
        return self._groups[key] if key else None

    def rank_in(self, axes: Axis) -> int:
        """This rank's flattened coordinate along ``axes``."""
        if not self.member:
            raise ValueError(f"rank {self.rank} is not in the mesh over "
                             f"ranks {self.ranks}")
        r = 0
        for a in self._key(axes):
            r = r * self.shape[a] + self.coords[a]
        return r

    def coords_of(self, index: int) -> Dict[str, int]:
        """The coordinates of the mesh's ``index``-th rank."""
        coords = {}
        for a in reversed(self.axis_names):
            coords[a] = index % self.shape[a]
            index //= self.shape[a]
        return coords

    def broadcast_object(self, obj):
        """``obj`` as the lead rank has it, on every rank of the mesh (a
        rank outside it gets its own back)."""
        group = self.group(self.axis_names)
        if group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.lead, group=group)
        return box[0]

    def barrier(self) -> None:
        """Every rank of the mesh waits for the others."""
        group = self.group(self.axis_names)
        if group is not None:
            dist.barrier(group=group)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks}, rank={self.rank})"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """An arbitrary mesh over the initialised world."""
    return Mesh(shape, axes)


def sub_mesh(ranks: Sequence[int], model_axis: int = 1) -> Mesh:
    """The reference's ``submesh(devices, model_axis)`` over ranks: a
    ("data", "model") mesh of shape (len(ranks) // model_axis,
    model_axis), built on every rank of the world."""
    ranks = [int(r) for r in ranks]
    if model_axis < 1 or not ranks or len(ranks) % model_axis:
        raise ValueError(f"{len(ranks)} ranks do not split into "
                         f"model_axis={model_axis} columns")
    return Mesh((len(ranks) // model_axis, model_axis), ("data", "model"),
                ranks)


def make_host_mesh(model: Optional[int] = None) -> Mesh:
    """``(world // model, model)`` over ("data", "model"): every rank of
    the world (one without a process group)."""
    n, model = world_size(), model or 1
    if model < 1 or n % model:
        raise ValueError(f"a world of {n} ranks does not split into "
                         f"model_axis={model} columns")
    return Mesh((n // model, model), ("data", "model"))


def init_from_env() -> bool:
    """Under ``torch.distributed.run`` (``WORLD_SIZE`` > 1 in the
    environment), join its world over gloo and return True; without a
    launcher environment, or in a world already joined, do nothing."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dist.init_process_group("gloo", init_method="env://")
    return True


def leave_world() -> None:
    """Leave the world ``init_from_env`` joined, every rank together: a
    barrier, then the process group destroyed. Left to the interpreter's
    exit, gloo's teardown can abort a rank whose peer has already closed
    its pairs."""
    dist.barrier()
    dist.destroy_process_group()


@contextlib.contextmanager
def rank0_prints() -> Iterator[None]:
    """Let rank 0's prints through and drop the other ranks' (their
    reports are rank 0's)."""
    if world_rank() == 0:
        yield
        return
    with contextlib.redirect_stdout(io.StringIO()):
        yield
