"""Per-query tail-latency attribution: where did each query's time go?

The paper's argument is an attribution argument — step time decomposes
into memory-system, collective, and topology terms (PAPER.md §IV–V), and
Gupta et al. 2019 / Hsia et al. 2020 show recommender tail latency is
only explainable with cross-stack breakdowns. This module is that
breakdown for the serving stack: every completed query gets a lifecycle
record (arrival → flush trigger → dispatch → completion) whose latency
decomposes EXACTLY into seven components:

  batch_wait     arrival → flush trigger (waiting for the micro-batch to
                 fill or hit its deadline)
  queue_wait     flush trigger → dispatch (server busy horizon), plus the
                 owner-queue coupling a sharded flush pays when a busy
                 owner board delays its lookup slice
  remesh_barrier the part of the wait spent inside an autoscaler
                 re-partition barrier (sharded fleets quiesce while row
                 ranges migrate)
  compute        real device execution (owner lookups in parallel take
                 their max, + split-table pooling + dense forward)
  link_stall     modeled fabric round (sharded fleets)
  swap_stall     exposed host-tier swap time after pipeline overlap
  update_stall   time spent behind an online delta push (`repro.online`)
                 — the owner's fabric lane was busy propagating row
                 updates when the query wanted to dispatch

The invariant — enforced by construction here and by a hypothesis
property in tests — is `sum(components) == done - arrival` to float
tolerance, so a `BlameReport` aggregating the decomposition over the p99
tail vs the median half turns a "p99 FAIL" into a receipt naming the
layer that caused it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

COMPONENTS: Tuple[str, ...] = ("batch_wait", "queue_wait", "remesh_barrier",
                               "compute", "link_stall", "swap_stall",
                               "update_stall")


@dataclass(frozen=True)
class QueryRecord:
    """One completed query's lifecycle + latency decomposition (seconds)."""

    qid: int
    rid: int                  # board/replica that served it
    arrival_s: float
    flush_s: float            # micro-batch flush trigger
    start_s: float            # dispatch (server free)
    done_s: float
    batch_wait_s: float
    queue_wait_s: float
    remesh_barrier_s: float
    compute_s: float
    link_stall_s: float
    swap_stall_s: float
    update_stall_s: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s

    @property
    def latency_ms(self) -> float:
        return self.latency_s * 1e3

    def components_s(self) -> Dict[str, float]:
        return {c: getattr(self, f"{c}_s") for c in COMPONENTS}

    def residual_s(self) -> float:
        """sum(components) - latency; ~0 up to float addition order."""
        return sum(self.components_s().values()) - self.latency_s


def interval_overlap_s(lo: float, hi: float,
                       intervals: Sequence[Tuple[float, float]]) -> float:
    """Total overlap of [lo, hi] with a set of (start, end) intervals —
    how the fleet carves remesh-barrier time out of a query's wait."""
    if hi <= lo:
        return 0.0
    return float(sum(max(0.0, min(hi, b) - max(lo, a))
                     for a, b in intervals))


class AttributionLog:
    """Collects `QueryRecord`s batch-by-batch as the event loops flush.

    `record_batch` takes the flush-level timeline every serving layer
    already computes (trigger/start/done + the measured/modeled service
    terms) and derives each query's per-query components so the closure
    invariant holds by construction:

      batch_wait = trigger - arrival          (per query)
      queue_wait = (start - trigger - remesh_barrier) + queue_extra
      done - start == compute + link_stall + swap_stall + queue_extra

    `queue_extra` is the sharded fleet's owner-queue coupling (time the
    slowest owner's busy horizon added beyond its pure service time);
    single-board layers pass 0.
    """

    def __init__(self) -> None:
        self.records: List[QueryRecord] = []

    def record_batch(self, queries: Sequence[Tuple[int, float]], *,
                     rid: int, trigger: float, start: float, done: float,
                     compute_s: float, link_stall_s: float = 0.0,
                     swap_stall_s: float = 0.0, queue_extra_s: float = 0.0,
                     barriers: Sequence[Tuple[float, float]] = (),
                     update_ivals: Sequence[Tuple[float, float]] = (),
                     update_extra_s: float = 0.0) -> None:
        """Fold one flushed batch in. `queries` is [(qid, arrival_s)];
        `barriers` are the fleet's remesh-stall intervals (the portion of
        each query's [trigger, start] wait inside one is attributed to
        remesh_barrier, not queue_wait). `update_ivals` are the serving
        board's online delta-push intervals — wait time inside one is
        update_stall, not queue_wait — and `update_extra_s` is the part
        of the owner-queue coupling caused by a remote owner's push (the
        caller guarantees update_extra_s <= queue_extra_s, so the carve
        keeps the closure exact)."""
        wait = max(start - trigger, 0.0)
        remesh = min(interval_overlap_s(trigger, start, barriers), wait)
        upd = min(interval_overlap_s(trigger, start, update_ivals),
                  wait - remesh)
        queue = (wait - remesh - upd) + (queue_extra_s - update_extra_s)
        update = upd + update_extra_s
        for qid, arrival in queries:
            self.records.append(QueryRecord(
                qid=int(qid), rid=int(rid), arrival_s=float(arrival),
                flush_s=float(trigger), start_s=float(start),
                done_s=float(done),
                batch_wait_s=float(trigger - arrival),
                queue_wait_s=float(queue),
                remesh_barrier_s=float(remesh),
                compute_s=float(compute_s),
                link_stall_s=float(link_stall_s),
                swap_stall_s=float(swap_stall_s),
                update_stall_s=float(update)))

    def __len__(self) -> int:
        return len(self.records)

    def blame(self, percentile: float = 99.0) -> Optional["BlameReport"]:
        if not self.records:
            return None
        return BlameReport.from_records(self.records, percentile=percentile)


@dataclass(frozen=True)
class BlameReport:
    """The p99-tail vs median latency decomposition of one run.

    `tail_ms` / `median_ms` hold each component's MEAN milliseconds over
    the tail queries (latency >= the percentile threshold) and over the
    median half (latency <= p50) respectively — the two ends of the
    distribution the SLA argument cares about.
    """

    n_queries: int
    percentile: float
    threshold_ms: float        # latency at `percentile` (the tail gate)
    p50_ms: float
    n_tail: int
    tail_ms: Dict[str, float] = field(default_factory=dict)
    median_ms: Dict[str, float] = field(default_factory=dict)
    dominant_tail: str = ""
    max_residual_ms: float = 0.0

    @classmethod
    def from_records(cls, records: Sequence[QueryRecord], *,
                     percentile: float = 99.0) -> "BlameReport":
        lat = np.asarray([r.latency_ms for r in records], np.float64)
        thresh = float(np.percentile(lat, percentile))
        p50 = float(np.percentile(lat, 50))
        tail = [r for r in records if r.latency_ms >= thresh]
        med = [r for r in records if r.latency_ms <= p50] or list(records)

        def mean_ms(group: Sequence[QueryRecord]) -> Dict[str, float]:
            return {c: float(np.mean([getattr(r, f"{c}_s") for r in group]))
                    * 1e3 for c in COMPONENTS}

        tail_ms = mean_ms(tail)
        dominant = max(tail_ms, key=lambda c: tail_ms[c])
        return cls(
            n_queries=len(records), percentile=float(percentile),
            threshold_ms=thresh, p50_ms=p50, n_tail=len(tail),
            tail_ms=tail_ms, median_ms=mean_ms(med), dominant_tail=dominant,
            max_residual_ms=float(max(abs(r.residual_s()) for r in records))
            * 1e3)

    def summary(self) -> str:
        t_tot = max(sum(self.tail_ms.values()), 1e-12)
        m_tot = max(sum(self.median_ms.values()), 1e-12)
        lines = [
            f"[blame] p{self.percentile:.0f} tail ({self.n_tail} queries "
            f">= {self.threshold_ms:.2f}ms) vs median half "
            f"(<= {self.p50_ms:.2f}ms), component means:",
        ]
        for c in COMPONENTS:
            t, m = self.tail_ms.get(c, 0.0), self.median_ms.get(c, 0.0)
            if t == 0.0 and m == 0.0:
                continue
            lines.append(
                f"[blame]   {c:<14} tail {t:8.3f}ms ({t / t_tot:4.0%})  "
                f"median {m:8.3f}ms ({m / m_tot:4.0%})")
        lines.append(
            f"[blame] tail dominated by {self.dominant_tail} "
            f"({self.tail_ms[self.dominant_tail] / t_tot:.0%} of tail "
            f"latency; decomposition closes to "
            f"{self.max_residual_ms:.2e}ms)")
        return "\n".join(lines)
