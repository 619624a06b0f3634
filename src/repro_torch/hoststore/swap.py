"""Swap scheduling: micro-batch i+1's chunk faults priced against
micro-batch i's compute, as the reference's ``repro.hoststore.swap``.

``plan_swaps`` slices a step's indices into the SAME micro-batches the
step executes (``parallel.build._mb_slices`` order), faults each slice's
cold rows through the ``ChunkParamMgr`` BEFORE the step launches, and
prices every slice's host->device traffic on the virtual clock
(``perf_model.host_swap_time`` over the ``host_link``).

``overlap_stall`` turns those per-micro-batch swap times into the stall
the step exposes: micro-batch 0's swap is always exposed, and each later
swap hides under the previous micro-batch's compute window -- only the
overflow beyond ``service/depth`` stalls. At depth 1 nothing overlaps.
This is the reference's MODELED stall: the port's transfers complete
before the step starts (``EnsureStats.copy_s`` measures them), and no
overlap is claimed for them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import perf_model

from .chunks import ChunkParamMgr, EnsureStats


@dataclass
class SwapPlan:
    """One step's swap schedule: per-micro-batch fault accounting plus the
    modeled host-link seconds each slice spends on the wire."""

    depth: int
    swap_s: List[float] = field(default_factory=list)
    stats: List[EnsureStats] = field(default_factory=list)

    @property
    def total_swap_s(self) -> float:
        return float(sum(self.swap_s))

    @property
    def bytes_moved(self) -> int:
        return sum(s.bytes_moved for s in self.stats)

    @property
    def faulted_chunks(self) -> int:
        return sum(s.faulted_chunks for s in self.stats)

    @property
    def copy_s(self) -> float:
        """Measured wall seconds of the step's transfers."""
        return float(sum(s.copy_s for s in self.stats))


def micro_batch_indices(indices: np.ndarray, depth: int) -> List[np.ndarray]:
    """Slice a step's (B, T, L) indices exactly like the step slices its
    batch: depth contiguous slices of B // depth samples."""
    b = indices.shape[0]
    if depth <= 1 or b % depth != 0:
        return [indices]
    m = b // depth
    return [indices[i * m:(i + 1) * m] for i in range(depth)]


def plan_swaps(mgr: ChunkParamMgr, indices: np.ndarray, depth: int,
               link: "perf_model.Interconnect", *,
               cold_mask: Optional[np.ndarray] = None) -> SwapPlan:
    """Fault each micro-batch's cold rows and price the traffic.

    indices   : (B, T, L) int step indices (host numpy).
    cold_mask : (B, T, L) bool -- True where the row must come from the
                chunk tier (False rows live in the HBM hot slab and never
                fault). None means everything is cold.
    """
    idx = np.asarray(indices)
    if idx.ndim != 3:
        raise ValueError(f"indices must be (B, T, L), got {idx.shape}")
    mask = np.ones(idx.shape, bool) if cold_mask is None \
        else np.asarray(cold_mask, bool)
    if mask.shape != idx.shape:
        raise ValueError(f"cold_mask {mask.shape} != indices {idx.shape}")
    plan = SwapPlan(depth=max(1, int(depth)))
    # the step executes on ONE cache snapshot: every micro-batch's chunks
    # must be resident simultaneously, so the FULL step working set is
    # pinned across all the per-micro-batch ensures below
    t_all = np.broadcast_to(np.arange(idx.shape[1])[None, :, None],
                            idx.shape)
    step_pin = np.unique(mgr.chunk_of(t_all[mask], idx[mask])) \
        if mask.any() else np.empty(0, np.int64)
    if step_pin.size > mgr.cache_slots:
        raise ValueError(
            f"device chunk cache too small for one step: working set is "
            f"{step_pin.size} chunks but cache_slots={mgr.cache_slots}; "
            f"raise the cache budget, lower hot_fraction, or shrink the "
            f"batch")
    for idx_mb, mask_mb in zip(micro_batch_indices(idx, plan.depth),
                               micro_batch_indices(mask, plan.depth)):
        t_mb = np.broadcast_to(
            np.arange(idx.shape[1])[None, :, None], idx_mb.shape)
        st = mgr.ensure(t_mb[mask_mb], idx_mb[mask_mb], pin=step_pin)
        plan.stats.append(st)
        plan.swap_s.append(perf_model.host_swap_time(
            st.bytes_moved, link,
            n_transfers=st.faulted_chunks + st.writebacks))
    return plan


def overlap_stall(swap_s: Sequence[float], service_s: float,
                  depth: int) -> float:
    """Seconds of swap time the step EXPOSES after pipeline overlap.

    At depth 1 (synchronous faulting) every transfer serializes with
    compute: stall = sum(swap). At depth k, micro-batch i+1's transfer
    runs while micro-batch i computes for ``service_s / k`` seconds, so
    only micro-batch 0's swap plus each later swap's overflow beyond its
    compute window is exposed.
    """
    times = [float(t) for t in swap_s]
    if not times:
        return 0.0
    if depth <= 1 or len(times) == 1:
        return float(sum(times))
    window = float(service_s) / len(times)
    return times[0] + sum(max(0.0, t - window) for t in times[1:])
