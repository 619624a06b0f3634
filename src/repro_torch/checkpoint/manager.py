"""Fault-tolerant checkpointing: atomic step-tagged snapshots + async writer.

As the reference (``repro.checkpoint.manager``):

  * ATOMIC: a checkpoint is visible only when complete. Writes land in
    ``step_NNNNNNNN.tmp-<pid>`` and are renamed (atomic on POSIX) to
    ``step_NNNNNNNN`` last, so a job killed mid-write never leaves a
    half-readable "latest".
  * ASYNC: ``CheckpointManager.save(..., blocking=False)`` copies the
    tensors to host memory (the only point that waits for the device) and
    hands serialization and fsync to one writer thread, so the train loop
    stalls for the copy, not the disk.
  * SELF-DESCRIBING: the manifest lists every leaf by its key path in the
    tree (``0/bot_mlp/0/w``), with dtype and shape; restore checks the
    paths against the target tree and places each leaf on that tree's
    device.
  * BOUNDED: the newest ``keep`` checkpoints are kept; older ones are
    deleted after a successful write, never before.

  * MESH-AGNOSTIC: over a mesh of k ranks (``mesh=``, with the ``specs``
    of the tree's leaves, ``runtime.elastic.Spec``), a save is
    collective: every rank sends its blocks of each sharded leaf, in the
    same leaf order, into the mesh's lead rank's host memory
    (``runtime.elastic.gather_tree``), and the lead alone writes the
    full-width arrays. The manifest's paths, dtypes and shapes are those
    of a one-rank checkpoint of the same tree, so a checkpoint does not
    record how many ranks wrote it, and a restore gives each rank of any
    mesh its blocks of the full-width arrays (the reference's
    ``restore(shardings=)``), each rank reading only its own blocks'
    bytes (a leaf is mapped in place). A leaf whose full shape differs
    from the one the target's layout needs raises ``ValueError`` naming
    its path; a ``layout`` (the manager's, kept in the metadata) that
    differs from the checkpoint's does too.

Format: one ``arrays.npz`` (leaves keyed ``leaf_<i>``) plus
``manifest.json``; no pickle. bf16 tensors are stored as their 16-bit
patterns (numpy has no bf16) and named "bfloat16" in the manifest. The
trees are the port's own (dicts, lists, tuples, tensors, None); a
checkpoint of the JAX package is not read here: weights come across
through ``repro_torch.convert``.
"""
from __future__ import annotations

import json
import math
import os
import queue
import re
import struct
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any
_STEP_RE = re.compile(r"^step_(\d{8})$")


def _leaves(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in a fixed order: dict keys sorted, list and
    tuple items by position; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in
                _leaves(v, f"{prefix}{i}/")]
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(prefix[:-1], tree)]
    raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a "
                    f"{type(tree).__name__}, not a tensor")


Snapshot = List[Tuple[str, str, np.ndarray]]   # (path, dtype, host array)


def _snapshot(tree: Tree, copy: bool = True) -> Snapshot:
    """Every leaf copied to host memory, with its key path and dtype name
    (``copy`` False: the leaves are host copies of their own already). A
    device tensor's copy waits for the device: the one sync point."""
    out = []
    for path, x in _leaves(tree):
        if isinstance(x, np.ndarray):
            out.append((path, str(x.dtype), np.array(x) if copy else x))
            continue
        x = x.detach()
        name = str(x.dtype).replace("torch.", "")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        a = x.cpu().numpy()
        out.append((path, name, a.copy() if copy else a))
    return out


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def latest_step(root: str) -> Optional[int]:
    """The newest complete checkpoint's step under ``root``, or None."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _write(root: str, step: int, snap: Snapshot,
           metadata: Optional[Dict[str, Any]]) -> str:
    os.makedirs(root, exist_ok=True)
    final = _step_dir(root, step)
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, (_, _, a) in enumerate(snap)})
    manifest = {
        "step": step,
        "n_leaves": len(snap),
        "leaves": [{"path": p, "dtype": dt, "shape": list(a.shape)}
                   for p, dt, a in snap],
        "metadata": metadata or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):   # re-save of the same step: replace it
        os.rename(final, final + f".old-{os.getpid()}")
    os.rename(tmp, final)
    return final


def _multi(mesh) -> bool:
    return mesh is not None and mesh.size() > 1


def _collect(tree: Tree, specs: Tree, mesh) -> Optional[Snapshot]:
    """The snapshot a save writes: over a mesh of more than one rank, the
    tree at full width in the lead rank's host memory (the other ranks,
    having sent their blocks, get None)."""
    if not _multi(mesh):
        return _snapshot(tree)
    from repro_torch.runtime.elastic import gather_tree
    full = gather_tree(tree, specs, mesh)
    return None if full is None else _snapshot(full, copy=False)


def save(root: str, step: int, tree: Tree,
         metadata: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic save. Returns the final directory path."""
    return _write(root, step, _snapshot(tree), metadata)


def _mapped(npz: str, name: str) -> Optional[np.ndarray]:
    """The array ``name`` of the npz file ``npz`` mapped read-only in
    place, so a slice of it reads only its own pages (``np.savez`` stores
    its members uncompressed); None where a member is compressed, 0-d or
    empty, or its header is not of format 1.0 or 2.0."""
    with zipfile.ZipFile(npz) as z:
        info = z.getinfo(name + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    fmt = np.lib.format
    with open(npz, "rb") as f:
        f.seek(info.header_offset)
        n, m = struct.unpack("<HH", f.read(30)[26:30])
        f.seek(info.header_offset + 30 + n + m)
        read = {(1, 0): fmt.read_array_header_1_0,
                (2, 0): fmt.read_array_header_2_0}.get(fmt.read_magic(f))
        if read is None:
            return None
        shape, fortran, dtype = read(f)
        offset = f.tell()
    if not shape or not math.prod(shape) or dtype.hasobject:
        return None
    return np.memmap(npz, dtype=dtype, mode="r", offset=offset,
                     shape=shape, order="F" if fortran else "C")


def _rebuild(like: Tree, new: Dict[str, Any], prefix: str = "") -> Tree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], new, f"{prefix}{k}/") for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, new, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return new[prefix[:-1]]


def restore(root: str, tree_like: Tree, step: Optional[int] = None, *,
            specs: Tree = None, mesh=None,
            layout: Optional[Dict[str, Any]] = None
            ) -> Tuple[Tree, int, Dict[str, Any]]:
    """Restore into the structure of ``tree_like``: each leaf a new tensor
    on the device of ``tree_like``'s leaf at the same path. Over a
    ``mesh`` of more than one rank, ``tree_like`` is this rank's shards,
    laid out by ``specs``; each rank maps the full-width arrays and reads
    only its blocks. Raises ValueError if the checkpoint's key paths or dtypes
    differ from the target's, if a leaf's full shape does not fit the
    target's layout (naming its path), or if ``layout`` is given and
    differs from the one the checkpoint was saved under."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like = _leaves(tree_like)
    got = [(m["path"], m["dtype"]) for m in manifest["leaves"]]
    want = [(p, str(x.dtype).replace("torch.", "")) for p, x in like]
    if got != want:
        raise ValueError(f"checkpoint {d} holds leaves {got}; the target "
                         f"tree has {want}: structure changed?")
    saved_layout = manifest["metadata"].get("layout")
    if layout is not None and saved_layout != layout:
        raise ValueError(f"checkpoint {d} was saved under the layout "
                         f"{saved_layout}; this session's is {layout}")
    place = None
    if _multi(mesh):
        from repro_torch.runtime import elastic
        spec_of = dict(elastic._flatten(specs))
        me = mesh.ranks.index(mesh.rank)

        def place(path, x, a):
            spec = spec_of[path]
            return a[elastic.block(a.shape, spec, mesh, me)]
    for (path, x), m in zip(like, manifest["leaves"]):
        full = (tuple(x.shape) if place is None else
                elastic.global_shape(x.shape, spec_of[path], mesh))
        if tuple(m["shape"]) != full:
            raise ValueError(
                f"checkpoint {d}: leaf {path!r} is {tuple(m['shape'])} "
                f"there, but this layout needs {full}; a layout that "
                f"depends on the number of ranks cannot be restored onto "
                f"another")
    new = {}
    npz = os.path.join(d, "arrays.npz")
    with np.load(npz) as data:
        for i, (path, x) in enumerate(like):
            a = None if place is None else _mapped(npz, f"leaf_{i}")
            if a is None:
                a = data[f"leaf_{i}"]
            if place is not None:
                a = np.array(place(path, x, a))     # a copy, 0-d kept
            if isinstance(x, np.ndarray):
                new[path] = a
                continue
            t = torch.from_numpy(a)
            if x.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            new[path] = t.to(x.device)
    return _rebuild(tree_like, new), step, manifest["metadata"]


class CheckpointManager:
    """Async checkpointing with retention. One background writer thread.

    Over a ``mesh`` of more than one rank (``specs``: the ``Spec`` tree of
    the trees it saves) every rank holds a manager and makes the same
    calls: ``save`` is collective, each rank sending its blocks into the
    mesh's lead rank's host memory, and the lead alone writes, on its
    writer thread; ``latest_step`` is the lead rank's
    answer, told to all, so that no rank resumes one checkpoint behind a
    peer whose view of the directory differs; ``wait`` ends in a barrier
    over the mesh, so no rank reads a directory the lead is still
    writing. ``layout`` (JSON-able) goes into every checkpoint's metadata
    and must match on restore."""

    def __init__(self, root: str, keep: int = 3, *, mesh=None,
                 specs: Tree = None,
                 layout: Optional[Dict[str, Any]] = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.root = root
        self.keep = keep
        self.mesh = mesh if _multi(mesh) else None
        self.specs = specs
        self.layout = layout
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- public API ---------------------------------------------------------
    def save(self, step: int, tree: Tree,
             metadata: Optional[Dict[str, Any]] = None,
             blocking: bool = False) -> None:
        """Copy ``tree`` to host memory now (so the caller may update its
        tensors in place right after), then write it: here when
        ``blocking``, else on the writer thread. A failed earlier write
        raises here."""
        self._raise_failed("previous async checkpoint failed")
        snap = _collect(tree, self.specs, self.mesh)
        if snap is None:
            return
        if self.layout is not None:
            metadata = dict(metadata or {}, layout=self.layout)
        if blocking:
            self._write(step, snap, metadata)
        else:
            self._q.put((step, snap, metadata))

    def wait(self) -> None:
        """Block until every queued write is on disk; raise if one
        failed."""
        self._q.join()
        self._raise_failed("async checkpoint failed")
        if self.mesh is not None:
            self.mesh.barrier()

    def latest_step(self) -> Optional[int]:
        if self.mesh is None:
            return latest_step(self.root)
        mine = latest_step(self.root) if self.mesh.rank == self.mesh.lead \
            else None
        return self.mesh.broadcast_object(mine)

    def restore(self, tree_like: Tree, step: Optional[int] = None):
        return restore(self.root, tree_like, step, specs=self.specs,
                       mesh=self.mesh, layout=self.layout)

    # -- internals ----------------------------------------------------------
    def _raise_failed(self, what: str) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(what) from err

    def _write(self, step, snap, metadata):
        _write(self.root, step, snap, metadata)
        self._gc()

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in
            (_STEP_RE.match(n) for n in os.listdir(self.root)) if m)
        for s in steps[:-self.keep] if len(steps) > self.keep else []:
            d = _step_dir(self.root, s)
            for name in os.listdir(d):
                os.unlink(os.path.join(d, name))
            os.rmdir(d)

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                self._write(*item)
            except Exception as e:  # raised again by the next save()/wait()
                self._err = e
            finally:
                self._q.task_done()
