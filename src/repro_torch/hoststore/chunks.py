"""ChunkParamMgr: host-resident chunked embedding weights + device chunk cache.

The third memory tier, as the reference's ``repro.hoststore.chunks``:

  host  (T, R, d) CPU tensor : the CANONICAL full table weights, partitioned
                               into fixed-size row chunks -- chunk j of
                               table t covers rows [j*K, min((j+1)*K, R)).
  cache (C*K + 1, d) device  : the flat chunk cache (C = cache_slots,
                               K = chunk_rows); slot s holds one chunk's
                               rows at flat positions [s*K, s*K + n_rows).
                               The LAST row is an all-zeros pad every
                               non-resident (or hot-slab) lookup reads.
  pos   (T, R) int32 device  : the indirection table, global row -> flat
                               cache position (pad for non-resident rows),
                               with a host mirror.

``ensure(t_idx, r_idx)`` is the batched fault interface: called before a
step runs with every row the step will touch, it swaps the missing chunks
in -- evicting cold chunks by CLOCK (default) or LFU, writing DIRTY victims
back to host first -- and returns the byte/fault accounting the swap
scheduler (``hoststore.swap``) prices on the virtual clock.

Where the reference updates functionally, the port writes in place: the
cache takes the faulted chunks with ``index_copy_`` and ``pos`` its new
entries with ``index_put_``, so a fault never copies the cache. Victims
are chosen for the whole call at once, in the reference's exact order
(CLOCK: the hand's sweep, second chances and the FIFO case; LFU: count,
then slot), and the transfers are batched: the faulted chunks are
gathered from the host store into a bounded pinned staging ring and copied
to the device piece by piece, and dirty victims come back the same way
(``StagingRing.to_device`` / ``to_host``).
The copies run on the current stream and each ``ensure`` waits for them,
so its measured ``copy_s`` is the wall time of the whole transfer; the
stall the serve path reports stays the reference's modeled one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceArg, resolve_device

# Bytes of one half of the pinned staging ring (two halves: the host
# gathers into one while the other's copy is in flight).
STAGE_BYTES = 128 * 2**20


@dataclass
class EnsureStats:
    """Accounting for one ``ensure`` call (one micro-batch's faults)."""

    requested_rows: int = 0
    needed_chunks: int = 0       # unique chunks the batch touches
    hit_chunks: int = 0          # already resident
    faulted_chunks: int = 0      # swapped in host -> device
    evicted_chunks: int = 0
    writebacks: int = 0          # dirty evictions written device -> host
    bytes_in: int = 0            # host -> device (faulted chunk rows)
    bytes_out: int = 0           # device -> host (dirty writebacks)
    # measured, not part of the reference's accounting: wall seconds of
    # the call's transfers (host gather, copies, cache and pos writes),
    # waited for on the device
    copy_s: float = field(default=0.0, compare=False)

    @property
    def bytes_moved(self) -> int:
        return self.bytes_in + self.bytes_out


@dataclass
class SwapStats:
    """Lifetime counters across every ``ensure`` call."""

    ensures: int = 0
    requested_rows: int = 0
    needed_chunks: int = 0
    hit_chunks: int = 0
    faulted_chunks: int = 0
    evicted_chunks: int = 0
    writebacks: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    copy_s: float = 0.0
    history: List[EnsureStats] = field(default_factory=list)

    def fold(self, e: EnsureStats) -> None:
        self.ensures += 1
        self.requested_rows += e.requested_rows
        self.needed_chunks += e.needed_chunks
        self.hit_chunks += e.hit_chunks
        self.faulted_chunks += e.faulted_chunks
        self.evicted_chunks += e.evicted_chunks
        self.writebacks += e.writebacks
        self.bytes_in += e.bytes_in
        self.bytes_out += e.bytes_out
        self.copy_s += e.copy_s
        self.history.append(e)

    @property
    def chunk_hit_ratio(self) -> float:
        return (self.hit_chunks / self.needed_chunks
                if self.needed_chunks else 1.0)


class StagingRing:
    """Two pinned host buffers of ``STAGE_BYTES`` (plain ones when the
    device is the CPU) and the event of each one's last copy: a half is
    written again only after its copy has left it. Every transfer between
    the host store and the device goes through ``to_device`` or
    ``to_host``, in pieces of at most one half."""

    def __init__(self, device: torch.device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self.events: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0
        self._alloc(STAGE_BYTES // dtype.itemsize)

    def _alloc(self, elems: int) -> None:
        self.elems = elems
        self.bufs = [torch.empty(elems, dtype=self.dtype,
                                 pin_memory=self.device.type == "cuda")
                     for _ in range(2)]

    def _pieces(self, n: int, item: Tuple[int, ...]):
        """(a, b, half, piece): items [a, b) of ``n`` items of shape
        ``item``, each in the next half (once its last copy is done)."""
        size = int(np.prod(item, dtype=np.int64))
        if size > self.elems:          # one item outgrows a half: grow both
            self._wait(0)
            self._wait(1)
            self._alloc(size)
        per = self.elems // size
        for a in range(0, n, per):
            b = min(a + per, n)
            j = self.turn
            self.turn ^= 1
            self._wait(j)
            yield a, b, j, self.bufs[j][:(b - a) * size].view(b - a, *item)

    def _mark(self, j: int) -> None:
        """Note that the copies just issued read or write half ``j``."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.events[j] = ev

    def _wait(self, j: int) -> None:
        if self.events[j] is not None:
            self.events[j].synchronize()
            self.events[j] = None

    def to_device(self, n: int, item: Tuple[int, ...], fill, put) -> None:
        """Host to device, ``n`` items of shape ``item``: ``fill(a, b,
        piece)`` writes items [a, b) into the pinned piece on the host and
        ``put(a, b, piece)`` issues the piece's copy to the device. The
        host fills one half while the other half's copy is in flight."""
        for a, b, j, piece in self._pieces(n, item):
            fill(a, b, piece)
            put(a, b, piece)
            self._mark(j)

    def to_host(self, n: int, item: Tuple[int, ...], get, store) -> None:
        """Device to host, ``n`` items of shape ``item``: ``get(a, b)`` is
        items [a, b) on the device, copied into a pinned piece, and
        ``store(a, b, piece)`` takes the piece on the host once it has
        arrived. The host stores one piece while the next one's copy is in
        flight."""
        inflight: List[Tuple[int, int, int, torch.Tensor]] = []

        def drain():
            a, b, j, piece = inflight.pop(0)
            self._wait(j)
            store(a, b, piece)

        for a, b, j, piece in self._pieces(n, item):
            piece.copy_(get(a, b), non_blocking=True)
            self._mark(j)
            inflight.append((a, b, j, piece))
            if len(inflight) == 2:
                drain()
        while inflight:
            drain()


def copy_to_host(dst: torch.Tensor, src: torch.Tensor,
                 ring: StagingRing) -> None:
    """dst (CPU) <- src (device), of one size, through the pinned ring."""
    dst, src = dst.view(-1), src.reshape(-1)
    ring.to_host(src.numel(), (1,), lambda a, b: src[a:b, None],
                 lambda a, b, piece: dst[a:b].copy_(piece[:, 0]))


class ChunkParamMgr:
    """Host chunk store + device chunk cache with batched faulting.

    Parameters
    ----------
    tables      : (T, R, d) stacked table weights (a tensor or an array);
                  COPIED into a CPU tensor, as the reference copies them,
                  unless ``copy=False`` hands a contiguous CPU tensor over
                  as the store itself (the host tier's own draw, which at
                  full width cannot be held twice).
    chunk_rows  : rows per chunk (the swap granularity).
    cache_slots : device cache capacity in chunks.
    policy      : "clock" (second-chance, default) or "lfu" eviction.
    device      : where the cache and ``pos`` live (None: the card).
    """

    def __init__(self, tables, chunk_rows: int, cache_slots: int, *,
                 policy: str = "clock", device: DeviceArg = None,
                 copy: bool = True):
        if not torch.is_tensor(tables):
            host = torch.from_numpy(np.array(tables, copy=True))
        elif copy:
            host = tables.detach().to("cpu", copy=True).contiguous()
        else:
            host = tables
            if host.device.type != "cpu" or not host.is_contiguous():
                raise ValueError("a store handed over without a copy must "
                                 "be a contiguous CPU tensor")
        if host.dim() != 3:
            raise ValueError(f"tables must be (T, R, d), got "
                             f"{tuple(host.shape)}")
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        if cache_slots < 1:
            raise ValueError(f"cache_slots must be >= 1, got {cache_slots}")
        if policy not in ("clock", "lfu"):
            raise ValueError(f"unknown eviction policy {policy!r}")
        self.host = host
        self.device = resolve_device(device)
        self.T, self.R, self.d = host.shape
        self.chunk_rows = int(chunk_rows)
        self.cache_slots = int(cache_slots)
        self.policy = policy
        self.chunks_per_table = -(-self.R // self.chunk_rows)   # ceil
        self.n_chunks = self.T * self.chunks_per_table
        self.row_bytes = self.d * host.element_size()
        self.chunk_bytes = self.chunk_rows * self.row_bytes

        self.pad_pos = self.cache_slots * self.chunk_rows
        self._chunk_slot = np.full(self.n_chunks, -1, np.int32)
        self._slot_chunk = np.full(self.cache_slots, -1, np.int64)
        self._dirty = np.zeros(self.n_chunks, bool)
        self._freq = np.zeros(self.n_chunks, np.int64)
        self._ref = np.zeros(self.cache_slots, bool)   # CLOCK reference bits
        self._hand = 0
        self._pinned = np.zeros(self.n_chunks, bool)   # one call's pin set
        self._pos_np = np.full((self.T, self.R), self.pad_pos, np.int32)
        self.device_cache = torch.zeros((self.pad_pos + 1, self.d),
                                        dtype=host.dtype, device=self.device)
        self.device_pos = torch.full((self.T, self.R), self.pad_pos,
                                     dtype=torch.int32, device=self.device)
        self._ring: Optional[StagingRing] = None
        self.stats = SwapStats()

    # -- chunk geometry ------------------------------------------------------
    def chunk_of(self, t, r):
        """Global chunk id(s) of rows (t, r) -- vectorized."""
        return np.asarray(t, np.int64) * self.chunks_per_table \
            + np.asarray(r, np.int64) // self.chunk_rows

    def chunk_range(self, c: int) -> Tuple[int, int, int]:
        """Chunk id -> (table, row_lo, row_hi) -- exclusive hi, ragged tail."""
        t, j = divmod(int(c), self.chunks_per_table)
        lo = j * self.chunk_rows
        return t, lo, min(lo + self.chunk_rows, self.R)

    def _chunk_rows(self, chunks: np.ndarray):
        """Chunk ids (k,) -> flat host row ids (k, K) and the mask of the
        ones inside their table (all but a ragged tail's)."""
        t, j = np.divmod(np.asarray(chunks, np.int64), self.chunks_per_table)
        rows = j[:, None] * self.chunk_rows + np.arange(self.chunk_rows)
        return t[:, None] * self.R + rows, rows < self.R

    def _n_rows(self, chunks: np.ndarray) -> int:
        """Rows inside their table of these chunks."""
        if self.R % self.chunk_rows == 0:
            return int(chunks.size) * self.chunk_rows
        return int(self._chunk_rows(chunks)[1].sum())

    def is_resident(self, t, r):
        return self._chunk_slot[self.chunk_of(t, r)] >= 0

    @property
    def resident_chunks(self) -> np.ndarray:
        return np.flatnonzero(self._chunk_slot >= 0)

    @property
    def host_pos(self) -> np.ndarray:
        """Host mirror of the device indirection table (read-only view)."""
        return self._pos_np

    @property
    def _slots(self) -> torch.Tensor:
        """The cache without its pad row, as (C, K, d) slots (a view)."""
        return self.device_cache[:self.pad_pos].view(
            self.cache_slots, self.chunk_rows, self.d)

    def _staging(self) -> StagingRing:
        if self._ring is None:
            self._ring = StagingRing(self.device, self.host.dtype)
        return self._ring

    # -- eviction ------------------------------------------------------------
    def _pick_victims(self, n: int) -> Tuple[np.ndarray, bool]:
        """The next ``n`` victims among the resident, unpinned slots, in the
        order the reference's one-at-a-time ``_pick_victim`` takes them,
        and whether there were fewer candidates than that (all of them are
        returned then: the reference evicts them before it raises).

        CLOCK: the hand sweeps the slots from its place; a candidate with
        its reference bit set loses the bit and is passed over, one without
        it is taken, and the hand stops one past the last victim. So the
        victims are the unreferenced candidates in sweep order, and, when
        more are needed, the referenced ones in the same order on the
        second round (the first round cleared their bits). LFU: the lowest
        access count, ties by slot."""
        if n <= 0:
            return np.empty(0, np.int64), False
        occ = self._slot_chunk >= 0
        cand = occ.copy()
        cand[occ] = ~self._pinned[self._slot_chunk[occ]]
        if self.policy == "lfu":
            slots = np.flatnonzero(cand)
            order = np.lexsort((slots, self._freq[self._slot_chunk[slots]]))
            return slots[order[:n]], slots.size < n
        h = self._hand
        seq = np.concatenate([np.flatnonzero(cand[h:]) + h,
                              np.flatnonzero(cand[:h])])   # in hand order
        ref = self._ref[seq]
        unref = np.flatnonzero(~ref)
        if n <= unref.size:
            last = unref[n - 1]
            self._ref[seq[:last][ref[:last]]] = False
            victims = seq[unref[:n]]
        else:
            self._ref[seq[ref]] = False
            victims = np.concatenate([seq[unref], seq[ref]])[:n]
        if victims.size:
            self._hand = int(victims[-1] + 1) % self.cache_slots
        return victims.astype(np.int64), seq.size < n

    def _evict(self, slots: np.ndarray, st: EnsureStats) -> None:
        """Evict these slots, in order: dirty chunks' live device rows go
        back to the host store first (a dirty chunk is NEVER dropped), and
        their rows point back at the pad, so a stale position never
        aliases a slot's new occupant."""
        chunks = self._slot_chunk[slots]
        dirty = self._dirty[chunks]
        if dirty.any():
            self._write_back(chunks[dirty], slots[dirty])
            st.writebacks += int(dirty.sum())
            st.bytes_out += self._n_rows(chunks[dirty]) * self.row_bytes
            self._dirty[chunks] = False
        self._chunk_slot[chunks] = -1
        self._slot_chunk[slots] = -1
        self._ref[slots] = False
        st.evicted_chunks += int(slots.size)
        self._set_pos(chunks, None)

    # -- transfers -----------------------------------------------------------
    def _write_back(self, chunks: np.ndarray, slots: np.ndarray) -> None:
        """Host store <- the cache rows of these (chunk, slot) pairs."""
        rows, inside = self._chunk_rows(chunks)
        dev_slots = torch.from_numpy(slots).to(self.device)
        host_rows = self.host.view(-1, self.d)

        def store(a, b, piece):
            keep = inside[a:b].reshape(-1)
            host_rows.index_copy_(
                0, torch.from_numpy(rows[a:b].reshape(-1)[keep]),
                piece.view(-1, self.d)[torch.from_numpy(keep)])

        self._staging().to_host(
            chunks.size, (self.chunk_rows, self.d),
            lambda a, b: self._slots.index_select(0, dev_slots[a:b]), store)

    def _load(self, chunks: np.ndarray, slots: np.ndarray) -> None:
        """Cache slots <- these chunks of the host store, through the
        pinned ring; a ragged tail's rows past the table are zeros, as the
        reference's zero-filled staging buffer leaves them."""
        dev_slots = torch.from_numpy(slots).to(self.device)
        if self.R % self.chunk_rows == 0:         # whole chunks, no tail
            src = self.host.view(self.n_chunks, self.chunk_rows, self.d)

            def fill(a, b, piece):
                torch.index_select(src, 0, torch.from_numpy(chunks[a:b]),
                                   out=piece)
        else:
            rows, inside = self._chunk_rows(chunks)
            flat = np.where(inside, rows, 0)

            def fill(a, b, piece):
                torch.index_select(self.host.view(-1, self.d), 0,
                                   torch.from_numpy(flat[a:b].reshape(-1)),
                                   out=piece.view(-1, self.d))
                piece[torch.from_numpy(~inside[a:b])] = 0

        self._staging().to_device(
            chunks.size, (self.chunk_rows, self.d), fill,
            lambda a, b, piece: self._slots.index_copy_(
                0, dev_slots[a:b], piece.to(self.device, non_blocking=True)))

    def rows_to_device(self, flat_rows: np.ndarray,
                       out: torch.Tensor) -> None:
        """out (n, d) on the device <- the host store's rows ``flat_rows``
        (ids into its (T*R, d) view), through the pinned ring."""
        ids = torch.from_numpy(np.ascontiguousarray(flat_rows, np.int64))
        src = self.host.view(-1, self.d)
        self._staging().to_device(
            ids.numel(), (self.d,),
            lambda a, b, piece: torch.index_select(src, 0, ids[a:b],
                                                   out=piece),
            lambda a, b, piece: out[a:b].copy_(piece, non_blocking=True))

    def _set_pos(self, chunks: np.ndarray, slots: Optional[np.ndarray]
                 ) -> None:
        """pos of every row of these chunks <- its flat cache position in
        ``slots`` (None: the pad), on the host mirror and the device."""
        if chunks.size == 0:
            return
        rows, inside = self._chunk_rows(chunks)
        if slots is None:
            vals = np.full(rows.shape, self.pad_pos, np.int32)
        else:
            vals = (slots[:, None] * self.chunk_rows
                    + np.arange(self.chunk_rows)).astype(np.int32)
        rows, vals = rows[inside], vals[inside]
        self._pos_np.reshape(-1)[rows] = vals
        self.device_pos.view(-1).index_put_(
            (torch.from_numpy(rows).to(self.device),),
            torch.from_numpy(vals).to(self.device))

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- the batched fault interface ----------------------------------------
    def ensure(self, t_idx, r_idx, pin=None) -> EnsureStats:
        """Make every row (t_idx[i], r_idx[i]) resident in the device cache.

        Runs before the step. Swaps missing chunks in (evicting by policy,
        writing dirty victims back first) and updates ``device_cache`` /
        ``device_pos`` in place. Chunks needed by THIS call are pinned --
        they are never chosen as victims -- and ``pin`` (chunk ids) extends
        the protection: a pipelined step's swap plan faults micro-batch by
        micro-batch but the step executes on ONE cache snapshot, so every
        micro-batch's chunks must survive until the step runs (the plan
        pins the step's full working set). Raises if pinned chunks exceed
        ``cache_slots``.
        """
        t_arr = np.asarray(t_idx, np.int64).ravel()
        r_arr = np.asarray(r_idx, np.int64).ravel()
        if t_arr.shape != r_arr.shape:
            raise ValueError(f"t_idx/r_idx must align, got {t_arr.shape} "
                             f"vs {r_arr.shape}")
        st = EnsureStats(requested_rows=int(t_arr.size))
        if t_arr.size == 0:
            self.stats.fold(st)
            return st
        if (r_arr < 0).any() or (r_arr >= self.R).any():
            raise ValueError("row index out of range")
        needed, counts = np.unique(self.chunk_of(t_arr, r_arr),
                                   return_counts=True)
        st.needed_chunks = int(needed.size)
        if needed.size > self.cache_slots:
            raise ValueError(
                f"device chunk cache too small: batch working set is "
                f"{needed.size} chunks but cache_slots={self.cache_slots}")
        self._freq[needed] += counts                  # LFU currency
        pin_ids = (needed if pin is None else np.concatenate(
            [needed, np.asarray(pin, np.int64).ravel()]))
        self._pinned[pin_ids] = True
        try:
            slot_of = self._chunk_slot[needed]
            missing = needed[slot_of < 0]
            st.hit_chunks = st.needed_chunks - int(missing.size)
            self._ref[slot_of[slot_of >= 0]] = True   # CLOCK reference bits
            if missing.size:
                t0 = time.perf_counter()
                free = np.flatnonzero(self._slot_chunk < 0)
                victims, short = self._pick_victims(missing.size - free.size)
                self._evict(victims, st)
                if short:
                    raise ValueError(
                        f"device chunk cache too small: one batch needs "
                        f"more than {self.cache_slots} chunks of "
                        f"{self.chunk_rows} rows resident at once; raise "
                        f"cache_slots or chunk_rows")
                slots = np.concatenate([free, victims])[:missing.size]
                self._load(missing, slots)
                self._chunk_slot[missing] = slots
                self._slot_chunk[slots] = missing
                self._ref[slots] = True
                self._set_pos(missing, slots)
                st.faulted_chunks = int(missing.size)
                st.bytes_in = self._n_rows(missing) * self.row_bytes
                self._wait()
                st.copy_s = time.perf_counter() - t0
        finally:
            self._pinned[pin_ids] = False
        self.stats.fold(st)
        return st

    # -- training integration ------------------------------------------------
    def attach_cache(self, device_cache: torch.Tensor) -> None:
        """Point the manager at the step's cache tensor (the port's step
        updates it in place, so this is the same tensor; writebacks must
        read the live values)."""
        if tuple(device_cache.shape) != (self.pad_pos + 1, self.d):
            raise ValueError(
                f"cache shape {tuple(device_cache.shape)} != "
                f"{(self.pad_pos + 1, self.d)}")
        self.device_cache = device_cache

    def mark_dirty(self, t_idx, r_idx) -> None:
        """Mark the (resident) chunks holding these rows dirty -- call after
        a train step scatter-updates their cached rows."""
        t_arr = np.asarray(t_idx, np.int64).ravel()
        r_arr = np.asarray(r_idx, np.int64).ravel()
        if t_arr.size == 0:
            return
        chunks = np.unique(self.chunk_of(t_arr, r_arr))
        if (self._chunk_slot[chunks] < 0).any():
            missing = chunks[self._chunk_slot[chunks] < 0]
            raise ValueError(
                f"mark_dirty on non-resident chunk(s) {missing.tolist()}: "
                f"ensure() the batch before the step updates it")
        self._dirty[chunks] = True

    @property
    def dirty_chunks(self) -> np.ndarray:
        return np.flatnonzero(self._dirty)

    def flush(self) -> torch.Tensor:
        """Write every dirty resident chunk back to host; return a copy of
        the full host weights (T, R, d), as the reference returns one. The
        eviction path keeps the invariant that only RESIDENT chunks are
        ever dirty."""
        chunks = np.flatnonzero(self._dirty)
        slots = self._chunk_slot[chunks].astype(np.int64)
        if (slots < 0).any():
            raise RuntimeError("dirty non-resident chunk: the eviction "
                               "invariant is broken")
        if chunks.size:
            self._write_back(chunks, slots)
            self._dirty[chunks] = False
        return self.host.clone()
