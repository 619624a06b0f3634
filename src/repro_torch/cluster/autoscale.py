"""SLA-driven autoscaling: add boards on sustained p99 violation, drop
them on sustained slack.

The port's copy of ``repro.cluster.autoscale`` (pure Python and numpy).

Policy (deliberately the simple production-shaped one — windowed
percentile + patience + cooldown, no predictive model):

  * completed-query latencies stream into a sliding window;
  * a full window whose p99 exceeds `sla_ms` counts one VIOLATION; a
    full window whose p99 is under `scale_down_frac * sla_ms` counts one
    SLACK; anything else resets both streaks;
  * `patience` consecutive violations -> "up"; `patience` consecutive
    slacks -> "down" (never below `min_replicas` / above
    `max_replicas`);
  * after a decision the autoscaler holds for `cooldown_s` of virtual
    time so the fleet change can take effect before it re-judges.

The MECHANISM lives in the fleet. Replicated mode (`cluster.Cluster`):
scale-up re-places a live replica's params onto the new sub-mesh via
`runtime/elastic.remesh_tree` (`Replica.clone_params_onto`), scale-down
drains and retires a board. Sharded mode (`fabric.ShardedFleet`): the
SAME policy object drives `fabric/elastic.expand_map` / `shrink_map` --
the fleet re-partitions row ranges live, executes the `MigrationPlan`,
and records the movement here via `record_migration`. Every decision is
recorded as a `ScaleEvent` in the fleet's report.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class ScaleEvent:
    """One autoscaler decision, as it lands in the ClusterReport."""

    t_s: float                  # virtual time of the decision
    action: str                 # "up" | "down"
    n_replicas: int             # fleet size AFTER the action
    window_p99_ms: float        # the p99 that triggered it
    remesh: Dict[str, int] = field(default_factory=dict)  # remesh_tree report
    board_seconds: float = 0.0  # running boards x time cost at the decision


class SLAAutoscaler:
    """Windowed-p99 scaling policy; see module docstring."""

    def __init__(self, sla_ms: float, *, min_replicas: int = 1,
                 max_replicas: int = 4, window: int = 24,
                 patience: int = 2, scale_down_frac: float = 0.3,
                 cooldown_s: float = 0.0):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}")
        self.sla_ms = float(sla_ms)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.patience = int(patience)
        self.scale_down_frac = float(scale_down_frac)
        self.cooldown_s = float(cooldown_s)
        self._lat: Deque[float] = deque(maxlen=int(window))
        self._violations = 0
        self._slacks = 0
        self._hold_until = -float("inf")
        # running (t, board_seconds) at each scale decision — the cost side
        # of the autoscaler-economics frontier; the cluster records it
        self.cost_log: List[Tuple[float, float]] = []
        # sharded mode only: (t, bytes_moved, stall_s) per executed
        # MigrationPlan -- what each elastic decision cost the fabric
        self.migration_log: List[Tuple[float, int, float]] = []

    def record_cost(self, now: float, board_seconds: float) -> None:
        """Log the fleet's running boards x time spend at a scale decision
        (called by the cluster, which owns the replica lifetimes)."""
        self.cost_log.append((float(now), float(board_seconds)))

    def record_migration(self, now: float, bytes_moved: int,
                         stall_s: float) -> None:
        """Log one executed row-range migration (sharded fleets only; the
        fleet owns the MigrationPlan, the policy just keeps the ledger)."""
        self.migration_log.append((float(now), int(bytes_moved),
                                   float(stall_s)))

    def window_p99_ms(self) -> float:
        if not self._lat:
            return 0.0
        return float(np.percentile(np.asarray(self._lat), 99))

    def observe(self, latencies_ms, now: float, n_replicas: int
                ) -> Optional[Tuple[str, float]]:
        """Fold one flush's completed latencies in; return ("up"|"down",
        window_p99_ms) when the policy wants the fleet to change."""
        self._lat.extend(float(x) for x in latencies_ms)
        if len(self._lat) < self._lat.maxlen or now < self._hold_until:
            return None
        p99 = self.window_p99_ms()
        if p99 > self.sla_ms:
            self._violations += 1
            self._slacks = 0
        elif p99 < self.scale_down_frac * self.sla_ms:
            self._slacks += 1
            self._violations = 0
        else:
            self._violations = self._slacks = 0
        if self._violations >= self.patience and n_replicas < self.max_replicas:
            self._decided(now)
            return "up", p99
        if self._slacks >= self.patience and n_replicas > self.min_replicas:
            self._decided(now)
            return "down", p99
        return None

    def _decided(self, now: float) -> None:
        self._violations = self._slacks = 0
        self._lat.clear()                      # judge the NEW fleet afresh
        self._hold_until = now + self.cooldown_s
