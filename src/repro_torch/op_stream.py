"""The op stream: what one rank's step does, counted from the ops it
dispatches, with the accounting of the reference's XLA analysis
(``src/repro/launch/hlo_analysis.py``). The dry-run's analysis
(``launch.op_analysis``) turns its counts into roofline terms; the
kernels' entry points (``kernels.ops``) and the collectives' wrappers
(``parallel.primitives``) report to it, so it lives below all three.

``OpStream`` is a ``TorchDispatchMode``: every aten op the step runs
under it, forward and backward, passes through ``__torch_dispatch__``
and is counted (per rank):

  flops      : 2 · prod(result) · prod(contracting dims) for each
               matmul-class op (mm, bmm, addmm, baddbmm, mv, dot, ...;
               ``linear`` and ``einsum`` reach it as these); nothing for
               elementwise ops, as the reference counts only dots.
  traffic    : the operand bytes plus the result bytes of each op that
               materialises; views (``OpOverload.is_view``) and ``empty``
               allocations count nothing, as the reference's
               ``_FREE_OPS`` (parameters, constants, bitcasts, tuples)
               count nothing.
  collective : wire bytes with the reference's factors
               (``collective_wire``): all-reduce 2V·(n-1)/n, all-gather
               result - operand, reduce-scatter and all-to-all V·(n-1)/n,
               anything else V. A collective over a placeholder group
               (``PlaceholderGroup``) reports itself (``collective``) with
               its group's size, and adds its operand and result bytes to
               the traffic, as the reference does.

The hand-written kernels launch through ctypes, out of a dispatch mode's
sight, so each entry point of ``kernels.ops`` reports its launch as one op
(``kernel``): its operands, its result and its flops. Its CPU plain
version and its meta branch run ``untraced``, so the card, the CPU and
the meta device count the same stream.

The stream also keeps the high-water mark of live bytes (``peak_bytes``):
every storage an op creates counts from its creation until it is freed,
on top of the storages ``track`` names (the params and inputs the step
finds). On the meta device that is the step's peak without an
allocation; on the card ``torch.cuda.max_memory_allocated`` measures it.

``PlaceholderGroup`` is a group of a placeholder mesh
(``launch.mesh.make_production_mesh``): ranks that do not exist but this
one. A collective over it sends nothing (``fake``): it reports itself to
the stream in force and writes a result of the collective's shape and
dtype made from this rank's own data, as if every rank held what this
one holds.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.float8_e4m3fn: 1,
    torch.float8_e5m2: 1, torch.int16: 2, torch.float16: 2,
    torch.bfloat16: 2, torch.int32: 4, torch.float32: 4, torch.int64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
}

# allocations, which write nothing, and ``_unsafe_view``, a view that
# ``OpOverload.is_view`` does not flag: they move nothing, as the
# reference's parameters, constants and bitcasts move nothing
_FREE_OPS = {aten.empty.memory_format, aten.empty_like.default,
             aten.empty_strided.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten._unsafe_view.default}

# matmul-class ops: (index of the left operand, its contracting dims)
_DOTS = {
    aten.mm.default: (0, (-1,)), aten.bmm.default: (0, (-1,)),
    aten.addmm.default: (1, (-1,)), aten.baddbmm.default: (1, (-1,)),
    aten.addbmm.default: (1, (0, -1)), aten.mv.default: (0, (-1,)),
    aten.addmv.default: (1, (-1,)), aten.dot.default: (0, (-1,)),
    aten.vdot.default: (0, (-1,)),
}

_ACTIVE: List["OpStream"] = []


def active() -> Optional["OpStream"]:
    """The innermost ``OpStream`` in force, else None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def host_work() -> Iterator[None]:
    """Ops run here (the host's index bookkeeping a step derives from
    shapes alone, and its move to the step's device) are not counted by
    the stream in force, if any: the meta device and the CPU then count
    the same stream."""
    stream = active()
    if stream is None:
        yield
        return
    with stream.untraced():
        yield


def nbytes(t: torch.Tensor) -> int:
    """The bytes ``t`` spans: a broadcast (stride-0) dim counts once, as
    the reference counts a fusion's operand before its broadcast."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * DTYPE_BYTES.get(t.dtype, t.element_size())


def tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from tensors(y)


def dot_flops(func, args, out: torch.Tensor) -> float:
    """2 · prod(result) · prod(contracting dims of the left operand)."""
    at, dims = _DOTS[func]
    lhs = args[at]
    contract = 1
    for d in dims:
        contract *= lhs.shape[d]
    return 2.0 * out.numel() * contract


def collective_wire(kind: str, n: int, operand_bytes: float,
                    result_bytes: float) -> float:
    """The reference's ``_collective_wire``: wire bytes a rank of a group
    of ``n`` (lower-bound factors)."""
    frac = (n - 1) / n if n > 1 else 1.0
    if kind == "all-reduce":
        return 2.0 * operand_bytes * frac
    if kind == "all-gather":
        return float(result_bytes - operand_bytes) \
            if result_bytes > operand_bytes else float(result_bytes) * frac
    if kind in ("reduce-scatter", "all-to-all"):
        return operand_bytes * frac
    return float(operand_bytes)


class OpStream(TorchDispatchMode):
    """Counts the ops run under it (see the module doc); ``summary()`` is
    the reference's ``analyze`` output."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[torch.dtype, float] = defaultdict(float)
        self.traffic_bytes = 0.0
        self.coll_by_kind: Dict[str, float] = defaultdict(float)
        self.coll_count_by_kind: Dict[str, int] = defaultdict(int)
        self.coll_by_group: Dict[str, float] = defaultdict(float)
        self.kernels: Dict[str, int] = defaultdict(int)
        self.n_ops = 0
        self._live: Dict[int, tuple] = {}
        self._counted = 0
        self.peak_bytes = 0
        self._paused = 0

    # -- the mode ---------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        self.n_ops += 1
        if func in _DOTS:
            self.flops_by_dtype[out.dtype] += dot_flops(func, args, out)
        if func.is_view:
            return out
        if func not in _FREE_OPS:
            self.traffic_bytes += sum(nbytes(t) for t in tensors(
                (args, kwargs))) + sum(nbytes(t) for t in tensors(out))
        self._allocated(out)
        return out

    @contextlib.contextmanager
    def untraced(self) -> Iterator[None]:
        """Ops run here are neither counted nor tracked (a kernel's plain
        version, a placeholder collective's made-up result)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- what reports itself ----------------------------------------------
    def kernel(self, name: str, inputs, out, flops: float = 0.0,
               dtype: Optional[torch.dtype] = None) -> None:
        """A hand-written kernel's launch, as one op: its operands'
        bytes and its result's as traffic, ``flops`` in ``dtype``."""
        self.n_ops += 1
        self.kernels[name] += 1
        if flops:
            self.flops_by_dtype[dtype or torch.float32] += flops
        self.traffic_bytes += sum(nbytes(t) for t in tensors(inputs)) \
            + sum(nbytes(t) for t in tensors(out))
        self._allocated(out)

    def collective(self, kind: str, n: int, operand_bytes: int,
                   result_bytes: int, axes: Tuple[str, ...] = ()) -> None:
        """A collective over a group of ``n`` ranks along ``axes`` (a
        placeholder group's record)."""
        wire = collective_wire(kind, n, operand_bytes, result_bytes)
        self.coll_by_kind[kind] += wire
        self.coll_by_group[f"{kind}@{','.join(axes)}"] += wire
        self.coll_count_by_kind[kind] += 1
        self.traffic_bytes += operand_bytes + result_bytes

    # -- live memory ------------------------------------------------------
    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live (what the step
        finds allocated: params, optimizer state, inputs)."""
        self._allocated(tree)

    def _allocated(self, tree) -> None:
        """Count ``tree``'s new storages. The freed ones are swept out only
        when the count passes the peak: until then the live bytes, at most
        the count, cannot raise it, so the peak stays exact at a sweep's
        cost a new high rather than an op."""
        for t in tensors(tree):
            st = t.untyped_storage()
            held = self._live.get(st._cdata)
            if held is not None and not held[0].expired():
                continue
            if held is not None:          # a freed storage's address reused
                self._counted -= held[1]
            self._live[st._cdata] = (StorageWeakRef(st), st.nbytes())
            self._counted += st.nbytes()
        if self._counted > self.peak_bytes:
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self._counted)

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self._live.items()
                    if ref.expired()]:
            self._counted -= self._live.pop(key)[1]

    @property
    def live_bytes(self) -> int:
        """The bytes of the storages alive now."""
        self._sweep()
        return self._counted

    # -- the result -------------------------------------------------------
    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    def summary(self) -> Dict[str, object]:
        """The keys of the reference's ``analyze`` that have a
        counterpart, plus ``flops_by_dtype``, ``collective_count_by_kind``,
        the wire bytes by kind and axes ("all-gather@data": the FSDP
        gathers of the spec-driven LM) and the kernels' launches."""
        return {
            "flops_per_chip": self.flops,
            "traffic_bytes_per_chip": float(self.traffic_bytes),
            "collective_bytes_per_chip": float(sum(
                self.coll_by_kind.values())),
            "collective_count": float(sum(self.coll_count_by_kind.values())),
            "collective_by_kind": dict(self.coll_by_kind),
            "collective_count_by_kind": dict(self.coll_count_by_kind),
            "collective_by_group": dict(self.coll_by_group),
            "flops_by_dtype": {str(d).replace("torch.", ""): f
                               for d, f in self.flops_by_dtype.items()},
            "kernel_launches": dict(self.kernels),
            "n_ops": self.n_ops,
        }


# each collective wrapper of ``parallel.primitives`` as the reference's HLO
# names its kind
KINDS = {"all_to_all": "all-to-all", "all_gather": "all-gather",
         "psum_scatter": "reduce-scatter", "psum": "all-reduce",
         "pmax": "all-reduce", "broadcast": "broadcast", "gather": "gather"}


class PlaceholderGroup:
    """The group along ``axes`` of a placeholder mesh: ``size`` ranks, of
    which this process plays the one at ``rank``; the others do not
    exist. A collective over it is ``fake``d: nothing is sent."""

    def __init__(self, axes: Tuple[str, ...], size: int, rank: int):
        self.axes, self.size, self.rank = tuple(axes), int(size), int(rank)

    def fake(self, name: str, out, inp: torch.Tensor) -> None:
        """The collective ``name`` (a wrapper of ``parallel.primitives``)
        of ``inp`` into ``out``: reported to the stream in force, and
        ``out`` written with what this rank would receive if every rank
        held ``inp``: the all-to-all's chunks are its own, an all-gather
        n copies of it, a psum_scatter its first chunk; a psum's, a
        pmax's and a broadcast's ``out`` is ``inp`` already."""
        stream = active()
        if stream is not None:
            stream.collective(KINDS[name], self.size, nbytes(inp),
                              sum(nbytes(t) for t in tensors(out)),
                              self.axes)
        with (stream.untraced() if stream is not None
              else contextlib.nullcontext()):
            if name == "all_to_all":
                out.copy_(inp)
            elif name == "all_gather":
                out.view((self.size,) + tuple(inp.shape)).copy_(inp)
            elif name == "psum_scatter":
                out.copy_(inp[:out.shape[0]])
            elif name == "gather":
                for part in out:
                    part.copy_(inp)

    def __repr__(self) -> str:
        return (f"PlaceholderGroup({self.axes}, size={self.size}, "
                f"rank={self.rank})")
