"""Dynamic micro-batching and open-loop arrival generation.

The serving observation (Gupta et al., "Architectural Implications of
Facebook's DNN-based Personalized Recommendation"): production recommender
traffic is OPEN-LOOP — queries arrive on their own schedule, so the server
trades batching (throughput) against queueing (tail latency). The
`MicroBatcher` implements the standard policy: flush when the batch is full
OR when the oldest queued query has waited `max_wait_s` (the deadline).

All time handling takes an explicit `now` so the same batcher drives both
the real-time `ServeSession.submit` path and the virtual-clock open-loop
simulator (deterministic, no sleeping).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class QueryFuture:
    """Handle for a submitted query; filled in when its micro-batch runs."""

    qid: int
    arrival: float                    # seconds, caller's clock
    query: Dict[str, "np.ndarray"]    # {"dense": (q, D), "indices": (q, T, L)}
    probs: Optional[np.ndarray] = None
    done: bool = False
    completed_at: Optional[float] = None

    @property
    def latency_ms(self) -> float:
        if not self.done:
            raise RuntimeError(f"query {self.qid} not completed yet")
        return (self.completed_at - self.arrival) * 1e3

    def complete(self, probs: np.ndarray, now: float) -> None:
        self.probs = probs
        self.completed_at = now
        self.done = True


@dataclass
class MicroBatcher:
    """Flush-on-size-or-deadline queue of `QueryFuture`s."""

    capacity: int                 # max queries per micro-batch
    max_wait_s: float             # oldest-query deadline
    queue: List[QueryFuture] = field(default_factory=list)

    def add(self, fut: QueryFuture) -> bool:
        """Enqueue; returns True if the batch is now full (flush time)."""
        if len(self.queue) >= self.capacity:
            raise RuntimeError("batcher over capacity; flush before add")
        self.queue.append(fut)
        return len(self.queue) >= self.capacity

    def deadline(self) -> float:
        """Absolute time the oldest queued query must flush by (inf if empty)."""
        if not self.queue:
            return float("inf")
        return self.queue[0].arrival + self.max_wait_s

    def due(self, now: float) -> bool:
        return bool(self.queue) and (
            len(self.queue) >= self.capacity or now >= self.deadline())

    def drain(self) -> List[QueryFuture]:
        out, self.queue = self.queue, []
        return out


def poisson_arrivals(n: int, qps: float, seed: int = 0) -> np.ndarray:
    """Cumulative arrival times (seconds) of a Poisson process at rate `qps`.

    Deterministic in (n, qps, seed) so open-loop runs are reproducible.
    """
    if qps <= 0:
        raise ValueError(f"open-loop arrival rate must be > 0, got {qps}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


def now_s() -> float:
    return time.perf_counter()
