"""OnlineReport: the update stream's ledger for one serving run.

The port's copy of ``repro.online.report``. It rides the stack's
kind-tagged serialization (`obs/serialize.to_jsonable` tags it ``"kind":
"OnlineReport"``) as the optional ``online`` field of the reports of
fleet runs that consumed a delta channel -- how much the trainer pushed,
what the coherence protocol did about it, and how stale the fleet's view
ever got.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class OnlineReport:
    """One run's online-update accounting (virtual-clock seconds)."""

    mode: str = "propagate"          # coherence mode the run used
    n_updates: int = 0               # DeltaBatches applied
    last_version: int = 0            # highest version made visible
    rows_pushed: int = 0             # owner-row writes across all batches
    rows_propagated: int = 0         # cache copies refreshed/admitted
    cache_invalidated_rows: int = 0  # cache copies dropped (cause=update)
    push_bytes: int = 0              # delta payload + coherence traffic
    push_stall_s: float = 0.0        # virtual seconds of owner fabric lanes
    staleness_p50_s: float = 0.0     # emit -> fleet-visible latency
    staleness_max_s: float = 0.0
    mean_train_loss: float = float("nan")

    def summary(self) -> str:
        return (f"[online] {self.n_updates} updates -> v{self.last_version}"
                f" ({self.mode}): {self.rows_pushed} rows pushed, "
                f"{self.rows_propagated} propagated / "
                f"{self.cache_invalidated_rows} invalidated, "
                f"{self.push_bytes / 2**10:.1f} KiB, "
                f"stall {self.push_stall_s * 1e3:.2f}ms; staleness p50 "
                f"{self.staleness_p50_s * 1e3:.2f}ms "
                f"max {self.staleness_max_s * 1e3:.2f}ms")
