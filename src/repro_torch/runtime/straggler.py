"""Straggler detection & mitigation policy (the port's copy of
``repro.runtime.straggler``, which imports no JAX; the port keeps its own).

On a synchronous SPMD step, one slow host stalls every chip (the collective
is a barrier). At 1000+ nodes the p99 host IS the step time. The policy
here is the control-plane piece that runs on the coordinator:

  * `StepTimer` keeps an EWMA + robust MAD of per-step wall times.
  * A step slower than `threshold = median + k·MAD` increments a strike
    counter against whichever host reported late (in the single-process
    dry-run environment, the reporter is synthetic).
  * `StragglerPolicy.action()` escalates: LOG -> RESHUFFLE_DATA (give the
    slow host a smaller data-parallel slice next epoch) -> EVICT (trigger
    the elastic re-mesh path without the host).

In the reference, eviction composes with runtime/elastic.py (the job
checkpoint-restores on the reduced device set), which comes to the port
with the distributed item (ROADMAP A6b); on one device the policy only
reports.
"""
from __future__ import annotations

import enum
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict


class Action(str, enum.Enum):
    NONE = "none"
    LOG = "log"
    RESHUFFLE = "reshuffle_data"
    EVICT = "evict"


class StepTimer:
    """Rolling robust stats over step wall-times."""

    def __init__(self, window: int = 64):
        self.window = window
        self.times: Deque[float] = deque(maxlen=window)

    def record(self, seconds: float) -> None:
        self.times.append(seconds)

    @property
    def median(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return s[len(s) // 2]

    @property
    def mad(self) -> float:
        if len(self.times) < 2:
            return 0.0
        med = self.median
        s = sorted(abs(t - med) for t in self.times)
        return s[len(s) // 2]

    def is_straggler_step(self, seconds: float, k: float = 5.0) -> bool:
        if len(self.times) < 8:
            return False
        return seconds > self.median + k * max(self.mad, 0.01 * self.median)


@dataclass
class StragglerPolicy:
    """Escalating per-host strike policy."""

    log_after: int = 1
    reshuffle_after: int = 3
    evict_after: int = 6
    decay_every: int = 128            # strikes decay so transient slowness heals
    strikes: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    _steps: int = 0

    def report(self, host: str, was_straggler: bool) -> Action:
        self._steps += 1
        if self._steps % self.decay_every == 0:
            for h in list(self.strikes):
                self.strikes[h] = max(0, self.strikes[h] - 1)
        if not was_straggler:
            return Action.NONE
        self.strikes[host] += 1
        n = self.strikes[host]
        if n >= self.evict_after:
            return Action.EVICT
        if n >= self.reshuffle_after:
            return Action.RESHUFFLE
        if n >= self.log_after:
            return Action.LOG
        return Action.NONE
