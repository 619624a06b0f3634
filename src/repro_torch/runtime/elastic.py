"""Elastic re-placement: move a param tree onto another set of ranks.

The port's counterpart of ``repro.runtime.elastic``. The reference
re-shards every leaf of a sharded pytree onto a new mesh under its
PartitionSpec, degrading a spec that does not divide to replication and
counting it. Here a ``Spec`` names, per dimension, the axes of a
``launch.mesh.Mesh`` that split it (None: whole), as ``PartitionSpec``
does, and ``remesh_tree`` places a tree onto the ranks of a mesh by its
specs, from one of two sources:

  * a full-width tree that every calling rank holds (a checkpoint read
    from disk, fresh host arrays): each rank of the mesh slices its block;
  * the live shards of another mesh's ranks (``src_mesh``: a replica's
    board, the autoscaler's scale-up): each target rank's block is cut
    from the source blocks that cover it, copied where the source rank is
    the target rank itself, else broadcast over a group of the two.

Every target rank ends up with its own COPY, never an alias: a JAX array
is immutable, so a placement that aliases is still a copy in meaning,
while a torch tensor is updated in place (online row updates write a
replica's tables). ``gather_tree`` is the inverse: the mesh's lead rank
gets each leaf at full width in host memory (a checkpoint's save). Bulk
moves of a card's tensors go through one pinned host buffer a dtype,
kept for the process (``_pinned``).

The straggler policy's EVICT needs nothing here: the reference's
``TrainLoop`` only logs it (``repro.runtime.trainer``), and so does the
port's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceArg, resolve_device
from repro_torch.launch.mesh import Mesh, group_of, world_rank, world_size

Params = Any
# a broadcast moves at most this many elements at a time
CHUNK_ELEMS = 1 << 26


def _names(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Spec:
    """The reference's ``PartitionSpec`` over a ``launch.mesh.Mesh``: per
    leading dimension of a leaf, None (whole) or the axes (a name or a
    tuple, flattened in the order given) that split it; later dimensions
    are whole. ``stack`` names axes over each of whose ranks the leaf is
    one slice of a leading dimension the rank's own tensor lacks (the
    error-feedback residuals, one per rank). ``Spec()`` is
    replicated."""

    def __init__(self, *dims, stack=()):
        self.dims = tuple(None if d is None else _names(d) for d in dims)
        self.stack = _names(stack) if stack else ()

    @property
    def replicated(self) -> bool:
        return not self.stack and all(d is None for d in self.dims)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Spec) and self.dims == other.dims
                and self.stack == other.stack)

    def __hash__(self) -> int:
        return hash((self.dims, self.stack))

    def __repr__(self) -> str:
        stack = f", stack={self.stack}" if self.stack else ""
        return f"Spec({', '.join(map(repr, self.dims))}{stack})"


REPLICATED = Spec()


def _spec(s: Optional[Spec]) -> Spec:
    return REPLICATED if s is None else s


def _pos(coords: Dict[str, int], mesh: Mesh, axes: Tuple[str, ...]) -> int:
    """The flattened coordinate along ``axes``, in their order."""
    r = 0
    for a in axes:
        r = r * mesh.shape[a] + coords[a]
    return r


def fits(shape: Sequence[int], spec: Optional[Spec], mesh: Mesh) -> bool:
    """Whether ``spec`` splits a leaf of global ``shape`` evenly on
    ``mesh`` (the reference's ``_spec_fits``; a stacked leaf's leading
    dimension must be the stack's size)."""
    spec = _spec(spec)
    shape = tuple(shape)
    if spec.stack:
        if not shape or shape[0] != mesh.size(spec.stack):
            return False
        shape = shape[1:]
    for d, axes in enumerate(spec.dims):
        if axes is None:
            continue
        if d >= len(shape) or shape[d] % mesh.size(axes):
            return False
    return True


def global_shape(local: Sequence[int], spec: Optional[Spec],
                 mesh: Mesh) -> Tuple[int, ...]:
    """The full-width shape of a rank's leaf of shape ``local`` laid out
    by ``spec`` on ``mesh``."""
    spec = _spec(spec)
    out = list(local)
    for d, axes in enumerate(spec.dims):
        if axes is not None and d < len(out):
            out[d] *= mesh.size(axes)
    return ((mesh.size(spec.stack),) if spec.stack else ()) + tuple(out)


def block(shape: Sequence[int], spec: Optional[Spec], mesh: Mesh,
          index: int) -> Tuple:
    """The index (ints and slices) of the block of a leaf of global
    ``shape`` that the mesh's ``index``-th rank holds."""
    spec = _spec(spec)
    coords = mesh.coords_of(index)
    out: List[Any] = []
    shape = tuple(shape)
    if spec.stack:
        out.append(_pos(coords, mesh, spec.stack))
        shape = shape[1:]
    for d, n in enumerate(shape):
        axes = spec.dims[d] if d < len(spec.dims) else None
        if axes is None:
            out.append(slice(0, n))
            continue
        size = n // mesh.size(axes)
        p = _pos(coords, mesh, axes)
        out.append(slice(p * size, (p + 1) * size))
    return tuple(out)


# ------------------------------------------------------------ tree walking
def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) in a fixed order: dict keys sorted, sequences by
    position (the checkpoint's order); a None leaf included."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return [kv for i, v in enumerate(tree) for kv in
                _flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _rebuild(like, new: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], new, f"{prefix}{k}/") for k in like}
    if isinstance(like, (list, tuple)) and not isinstance(like, Spec):
        return type(like)(_rebuild(v, new, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return new.get(prefix[:-1])


def _pairs(tree: Params, specs: Params) -> List[Tuple[str, Any, Any]]:
    """(path, leaf, spec) of a tree and its congruent spec tree, None
    leaves of the tree left out (a None holds nothing)."""
    leaves, spec_leaves = _flatten(tree), _flatten(specs)
    if [p for p, _ in leaves] != [p for p, _ in spec_leaves]:
        raise ValueError(f"specs do not match the tree: leaves "
                         f"{[p for p, _ in leaves]}, specs "
                         f"{[p for p, _ in spec_leaves]}")
    return [(p, x, s) for (p, x), (_, s) in zip(leaves, spec_leaves)
            if x is not None]


def _dtype_name(x) -> str:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.empty(0, x.dtype))
    return str(x.dtype).replace("torch.", "")


# -------------------------------------------------------------- placement
def remesh_tree(tree: Params, specs: Params, mesh: Mesh, *,
                src_mesh: Optional[Mesh] = None,
                device: DeviceArg = None) -> Tuple[Params, Dict[str, int]]:
    """Place every leaf of ``tree`` onto the ranks of ``mesh`` (a
    ``launch.mesh.Mesh``) by ``specs`` (a congruent tree of ``Spec`` or
    None), on ``device`` (this rank's; None: the card).

    ``src_mesh`` None: ``tree`` is the full-width tree, held by every
    calling rank; each rank of ``mesh`` slices its block. Else ``tree``
    is this rank's shards of a tree laid out by ``specs`` on ``src_mesh``
    (anything on a rank outside it), and every rank of the world must
    call: the source's lead rank tells the others the full shapes, then
    each target block is cut from the source blocks that cover it. A
    source leaf is taken as laid out by its spec (its full shape its
    shape times the spec's axis sizes).

    A spec that does not divide its dimension on ``mesh`` falls back to
    replication. Returns (this rank's tree, or None on a rank outside
    ``mesh``; the report {"resharded", "replicated_fallback"}, the same on
    every rank)."""
    if src_mesh is None:
        entries = [(p, tuple(x.shape), _dtype_name(x), _spec(s), x)
                   for p, x, s in _pairs(tree, specs)]
    else:
        entries = _source_entries(tree, specs, src_mesh)
    report = {"resharded": 0, "replicated_fallback": 0}
    targets = []
    for path, shape, dtype, spec, x in entries:
        if spec.stack and not fits(shape, spec, mesh):
            raise ValueError(f"{path}: a stacked leaf of shape {shape} "
                             f"needs {mesh.size(spec.stack)} slices on "
                             f"{dict(mesh.shape)}")
        if fits(shape, spec, mesh):
            report["resharded"] += 1
        else:
            report["replicated_fallback"] += 1
            spec = REPLICATED
        targets.append((path, shape, dtype, spec, x))
    dev = resolve_device(device) if mesh.member else None
    if src_mesh is None:
        out = {}
        if mesh.member:
            me = mesh.ranks.index(mesh.rank)
            for path, shape, _, spec, x in targets:
                piece = x[block(shape, spec, mesh, me)]
                if isinstance(x, np.ndarray):
                    piece = torch.from_numpy(np.array(piece))
                out[path] = piece.to(dev, copy=True).contiguous()
        return (_rebuild(specs, out) if mesh.member else None), report
    out = _move(targets, src_mesh, mesh, dev)
    return (_rebuild(specs, out) if mesh.member else None), report


def _source_entries(tree, specs, src_mesh: Mesh):
    """(path, full shape, dtype, spec, this rank's leaf or None) of a tree
    laid out on ``src_mesh``, the shapes and dtypes as its lead rank
    tells them to the world."""
    spec_of = dict(_flatten(specs))
    meta = None
    if world_rank() == src_mesh.lead:
        pairs = _pairs(tree, specs)
        meta = [(p, global_shape(x.shape, s, src_mesh), _dtype_name(x))
                for p, x, s in pairs]
    if world_size() > 1:
        box = [meta]
        dist.broadcast_object_list(box, src=src_mesh.lead)
        meta = box[0]
    local = (dict((p, x) for p, x, _ in _pairs(tree, specs))
             if src_mesh.member else {})
    return [(p, tuple(shape), dtype, _spec(spec_of[p]), local.get(p))
            for p, shape, dtype in meta]


def _overlap(a: Tuple, b: Tuple) -> Optional[Tuple]:
    """The intersection of two blocks of one leaf (None if empty)."""
    out = []
    for x, y in zip(a, b):
        if isinstance(x, int) or isinstance(y, int):
            if isinstance(x, int) and isinstance(y, int) and x != y:
                return None
            out.append(x if isinstance(x, int) else y)
            continue
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if hi <= lo:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _within(piece: Tuple, outer: Tuple) -> Tuple:
    """``piece``'s index relative to the block ``outer`` it lies in."""
    out = []
    for p, o in zip(piece, outer):
        if isinstance(o, int):
            continue                  # the stacked dimension is not held
        out.append(slice(p.start - o.start, p.stop - o.start))
    return tuple(out)


def _move(targets, src: Mesh, dst: Mesh, dev) -> Dict[str, torch.Tensor]:
    """Cut every target rank's blocks out of the source ranks' blocks:
    a copy where the two ranks are one, else a broadcast from the
    source's holder to the target over a group of the two. Every rank of
    the world walks the same list; each runs only the steps it is in, so
    moves between disjoint pairs of ranks run at once."""
    me = world_rank()
    steps = []          # (path, target rank, holder, piece, src blk, dst blk)
    for path, shape, dtype, spec, _ in targets:
        src_spec = spec if fits(shape, spec, src) else REPLICATED
        src_blocks: Dict[Tuple, Tuple[Tuple, List[int]]] = {}
        for i, r in enumerate(src.ranks):
            key = block(shape, src_spec, src, i)
            src_blocks.setdefault(_key(key), (key, []))[1].append(r)
        for j, t in enumerate(dst.ranks):
            dst_blk = block(shape, spec, dst, j)
            for sblk, holders in src_blocks.values():
                piece = _overlap(sblk, dst_blk)
                if piece is None:
                    continue
                holder = t if t in holders else holders[0]
                steps.append((path, t, holder, piece, sblk, dst_blk))
    for pair in sorted({tuple(sorted((h, t))) for _, t, h, *_ in steps
                        if h != t}):
        group_of(pair)                # built on every rank, in one order
    out: Dict[str, torch.Tensor] = {}
    if dst.member:
        for path, shape, dtype, spec, _ in targets:
            idx = block(shape, spec, dst, dst.ranks.index(me))
            size = [s.stop - s.start for s in idx if isinstance(s, slice)]
            out[path] = torch.empty(size, dtype=getattr(torch, dtype),
                                    device=dev)
    local = {path: x for path, _, _, _, x in targets}
    for path, t, holder, piece, sblk, dblk in steps:
        if me not in (t, holder):
            continue
        if holder == t:
            out[path][_within(piece, dblk)] = local[path][_within(piece,
                                                                  sblk)]
            continue
        group = group_of((holder, t))
        if me == holder:
            buf = local[path][_within(piece, sblk)].contiguous()
        else:
            dest = out[path][_within(piece, dblk)]
            buf = dest if dest.is_contiguous() else torch.empty_like(dest)
        broadcast_chunks(buf.view(-1), holder, group)
        if me == t and buf is not dest:
            dest.copy_(buf)
    return out


_PINNED: Dict[torch.dtype, torch.Tensor] = {}


def _pinned(dtype: torch.dtype, n: int) -> torch.Tensor:
    """``n`` (at most CHUNK_ELEMS) elements of the process's pinned host
    buffer of ``dtype``: one a dtype, grown as needed and reused by every
    bulk move, so a fleet's build pins no new memory a table."""
    buf = _PINNED.get(dtype)
    if buf is None or buf.numel() < n:
        buf = _PINNED[dtype] = torch.empty(n, dtype=dtype, pin_memory=True)
    return buf[:n]


def broadcast_chunks(flat: torch.Tensor, src: int, group) -> None:
    """``flat`` (1-D) as the global rank ``src`` holds it, on every rank
    of ``group``, CHUNK_ELEMS at a time. A rank whose tensor is on the
    card moves it through the pinned buffer (``_pinned``), where gloo's
    own path for a CUDA tensor stages each call through host memory of
    its own. The ranks may mix host and card tensors (a holder of rows in
    host memory, a receiver on the card): gloo moves host memory either
    way."""
    from repro_torch.parallel import primitives as prim
    n = flat.numel()
    for a in range(0, n, CHUNK_ELEMS):
        b = min(n, a + CHUNK_ELEMS)
        if not flat.is_cuda:
            prim.broadcast(flat[a:b], src, group)
            continue
        piece = _pinned(flat.dtype, b - a)
        if world_rank() == src:
            piece.copy_(flat[a:b])
        prim.broadcast(piece, src, group)
        if world_rank() != src:
            flat[a:b].copy_(piece)


def _key(blk: Tuple) -> Tuple:
    return tuple(b if isinstance(b, int) else (b.start, b.stop)
                 for b in blk)


def gather_tree(tree: Params, specs: Params, mesh: Mesh
                ) -> Optional[Params]:
    """This rank's ``tree`` (laid out by ``specs`` on ``mesh``) at full
    width in host memory on the mesh's lead rank, each leaf a CPU tensor
    of its own (None on the mesh's other ranks): the reference's
    ``np.asarray`` of a sharded leaf. A split leaf comes to the lead a
    chunk of rows at a time through one gather over the mesh (a card's
    rows staged through the pinned buffer), so no rank holds a
    full-width leaf on the device and each sends only its own block.
    Every rank of the mesh calls, in the same leaf order."""
    from repro_torch.parallel import primitives as prim
    group = mesh.group(mesh.axis_names)
    lead = mesh.rank == mesh.lead
    out = {}
    for path, x, s in _pairs(tree, specs):
        spec = _spec(s)
        shape = global_shape(x.shape, spec, mesh)
        if spec.replicated or group is None or not fits(shape, spec, mesh):
            if lead:
                out[path] = (np.array(x) if isinstance(x, np.ndarray)
                             else x.detach().to("cpu", copy=True))
            continue
        src = torch.as_tensor(x).detach()
        src = src.view(1) if src.dim() == 0 else src
        full = torch.empty(shape, dtype=src.dtype) if lead else None
        dests = []
        for i in range(mesh.size() if lead else 0):
            d = full[block(shape, spec, mesh, i)]
            dests.append(d.view(1) if d.dim() == 0 else d)
        step = max(1, CHUNK_ELEMS // max(1, math.prod(src.shape[1:])))
        for a in range(0, src.shape[0], step):
            piece = src[a:a + step]
            if piece.is_cuda:
                piece = _pinned(piece.dtype, piece.numel()).view(
                    piece.shape).copy_(piece)
            parts = prim.gather(piece, mesh.lead, group)
            for d, part in zip(dests, parts or ()):
                d[a:a + step].copy_(part)
        if lead:
            out[path] = full
    return _rebuild(specs, out) if lead else None


def none_specs(tree: Params) -> Params:
    """A spec tree of ``None``s congruent with ``tree``: every leaf whole
    on every rank."""
    if isinstance(tree, dict):
        return {k: none_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(none_specs(v) for v in tree)
    if not (torch.is_tensor(tree) or isinstance(tree, np.ndarray)):
        raise TypeError(f"param leaves are tensors, got "
                        f"{type(tree).__name__}")
    return None
