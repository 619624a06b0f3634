"""Query routing policies: which replica serves the next arrival.

The port's copy of ``repro.cluster.router`` (pure Python and numpy).

The router sees the fleet's queue state at the arrival instant and picks
a replica; the policies are the classical load-balancing ladder:

  round_robin — state-blind rotation. Optimal when every replica and
                every batch costs the same; degrades under bursts and on
                heterogeneous fleets, where it keeps feeding a board
                whose queue drains slower than the others'.
  jsq         — join-shortest-queue, on the EXPECTED-WAIT signal
                (`Replica.expected_wait_s`: busy horizon + queued work
                at the board's measured service rate — a raw query count
                misjudges straggler boards). Queueing-optimal greedy,
                but needs full fleet state per query (a scalability tax
                at real fleet sizes).
  p2c         — power-of-two-choices (Mitzenmacher): sample TWO replicas
                uniformly, join the shorter expected wait. Gets most of
                JSQ's tail benefit with O(1) state probes — the standard
                production compromise, and the paper-relevant point:
                under flash-crowd bursts it beats round-robin's p99
                while probing only two queues.

Policies are deterministic given (policy, seed, arrival order): p2c
draws from its own seeded rng.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

POLICIES = ("round_robin", "jsq", "p2c")


class Router:
    """Base router: subclasses implement `pick(replicas, now)`."""

    name = "?"

    def pick(self, replicas: Sequence, now: float):
        raise NotImplementedError

    def replica_removed(self, replicas: Sequence) -> None:
        """Hook: the autoscaler changed the fleet; reset stale state."""


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self):
        self._i = 0

    def pick(self, replicas, now):
        r = replicas[self._i % len(replicas)]
        self._i += 1
        return r

    def replica_removed(self, replicas):
        self._i %= max(1, len(replicas))


class JoinShortestQueueRouter(Router):
    name = "jsq"

    def pick(self, replicas, now):
        return min(replicas, key=lambda r: (r.expected_wait_s(now), r.rid))


class PowerOfTwoRouter(Router):
    """Sample two distinct replicas, join the shorter expected wait
    (ties: lower replica id). One replica degenerates to that replica."""

    name = "p2c"

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def pick(self, replicas, now):
        if len(replicas) == 1:
            return replicas[0]
        i, j = self._rng.choice(len(replicas), size=2, replace=False)
        a, b = replicas[int(i)], replicas[int(j)]
        ka = (a.expected_wait_s(now), a.rid)
        kb = (b.expected_wait_s(now), b.rid)
        return a if ka <= kb else b


def make_router(policy: str, seed: int = 0) -> Router:
    """Router registry lookup ("round_robin" | "jsq" | "p2c")."""
    if policy == "round_robin":
        return RoundRobinRouter()
    if policy == "jsq":
        return JoinShortestQueueRouter()
    if policy == "p2c":
        return PowerOfTwoRouter(seed)
    raise ValueError(f"unknown router policy {policy!r}; one of {POLICIES}")
