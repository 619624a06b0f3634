"""Hit-ratio monitor: watch the fast tier erode under drift, refresh it.

The port's copy of ``repro.cluster.monitor``. The tiered runtime elects
hot rows ONCE from a profiled frequency snapshot. A ``zipf_drift`` stream
rotates which rows are hot, so the elected set serves a shrinking share
of traffic -- the cache keeps paying fast-tier capacity for yesterday's
hot rows. This monitor closes the loop mid-serve:

  * it mirrors the fast tier as a ``TieredTables`` row map (embed dim 1 --
    the map is what matters, not the values) elected from the same
    profile snapshot the plan used;
  * every arriving query is scored against the map (``hit_mask``) into a
    sliding window, and its row accesses are folded into live LFU counts
    (``accumulate_row_freq``) -- the same statistics currency the planner
    uses;
  * when the windowed hit ratio falls below ``refresh_threshold`` x the
    profiled baseline, it fires ``tiered_embedding.lfu_refresh`` with the
    LIVE counts: flush + re-elect the hot set, restoring the ratio.

The shadow store and the counts live on the monitor's device (None: the
card); at RM2-small's full width each is 40 x 4,194,304 x 4 B.

Service-time retiming: the boards have no DDR4 bulk tier, so a measured
service time cannot show the miss cost. ``service_multiplier(h)`` retimes
a measured execution by the hybrid memory model's step-time ratio at hit
ratio ``h`` vs the profiled baseline (``perf_model.inference_breakdown``
on ``recspeed_hybrid_system``, evaluated on the UNREDUCED model config,
where lookups dominate -- the regime the paper's Sec. VII-A hybrid
targets), or by a measured curve from a calibration artifact.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import perf_model
from repro_torch.core import tiered_embedding as te
from repro_torch.device import DeviceArg, resolve_device


class HitRatioMonitor:
    """Windowed fast-tier hit-ratio tracker + drift-triggered LFU refresh.

    Two-phase trigger: when the windowed ratio first crosses below
    ``refresh_threshold * baseline`` the monitor RESETS its live counts --
    the drifted regime's statistics start clean, not diluted by the
    pre-drift era -- and after ``cooldown_queries`` more arrivals it fires
    ``lfu_refresh`` with those pure post-drift counts. (Electing from
    mixed-era counts re-installs yesterday's hot rows; tuning note for
    scenarios: a drift epoch should outlast window + cooldown queries
    for full recovery between rotations.)
    """

    def __init__(self, cfg: DLRMConfig, *, alpha: float = 1.05,
                 seed: int = 0, hot_fraction: float = 0.1,
                 window: int = 24, refresh_threshold: float = 0.7,
                 cooldown_queries: int = 24, profile_batches: int = 4,
                 model_cfg: Optional[DLRMConfig] = None,
                 enabled: bool = True,
                 service_multiplier: Optional[
                     Union[float, Callable[[float], float],
                           str, os.PathLike]] = None,
                 device: DeviceArg = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # off: the hit ratio is still tracked, but the monitor never
        # resets its counts or refreshes (the refresh-off arm of a drift
        # comparison)
        self.enabled = enabled
        self.hot_per_table = max(1, int(hot_fraction * cfg.rows_per_table))
        self.refresh_threshold = float(refresh_threshold)
        self.cooldown_queries = int(cooldown_queries)
        row_freq = te.measure_row_freq(cfg, alpha, seed,
                                       n_batches=profile_batches,
                                       device=self.device)
        # dim-1 value slab: the monitor needs the row MAP, not embeddings
        shadow = torch.zeros((cfg.num_tables, cfg.rows_per_table, 1),
                             dtype=torch.float32, device=self.device)
        self.tiered = te.build_tiered_tables(shadow, row_freq,
                                             self.hot_per_table)
        del shadow
        self.baseline = te.expected_hit_ratio(row_freq, self.tiered)
        del row_freq
        self._counts = torch.zeros((cfg.num_tables, cfg.rows_per_table),
                                   dtype=torch.int32, device=self.device)
        self._window: Deque[float] = deque(maxlen=int(window))
        self._seen = 0
        self._degraded_at: Optional[int] = None
        self._hit_by_qid: Dict[int, float] = {}
        self.history: List[Tuple[float, float]] = []   # (t, per-query hit)
        self.refreshes: List[float] = []               # refresh fire times
        # hybrid-memory retiming curve, evaluated at full model scale --
        # unless the caller injects a calibrated override (see
        # `service_multiplier` below)
        self._model_cfg = model_cfg if model_cfg is not None else cfg
        # one board a replica (the hybrid system's default is 16 chips)
        self._system = dataclasses.replace(
            perf_model.recspeed_hybrid_system(), n_chips=1)
        self._t_step_cache: Dict[float, float] = {}
        if isinstance(service_multiplier, (str, os.PathLike)):
            # a measured calibration artifact (JSON path): the
            # real-hardware hook -- load its service_multiplier curve
            from repro_torch.core.calibration import service_multiplier_from
            try:
                service_multiplier = service_multiplier_from(
                    service_multiplier)
            except OSError as e:
                raise ValueError(
                    f"service_multiplier string must be a calibration-"
                    f"artifact JSON path: {e}") from e
        if service_multiplier is not None and not (
                callable(service_multiplier)
                or isinstance(service_multiplier, (int, float))):
            raise ValueError(
                "service_multiplier must be a number (constant retiming), "
                f"a callable hit_ratio -> multiplier, or a calibration-"
                f"artifact path, got {type(service_multiplier).__name__}")
        self._multiplier_override = service_multiplier

    # -- observation ---------------------------------------------------------
    def observe(self, qid: int, indices: torch.Tensor, now: float) -> float:
        """Score one arriving query against the current hot map; fold its
        accesses into the live LFU counts. Returns the query's hit ratio."""
        idx = indices.to(self.device)
        mask = te.hit_mask(self.tiered, idx)
        h = int(mask.sum()) / mask.numel()
        te.accumulate_row_freq(self._counts, idx)
        self._window.append(h)
        self._seen += 1
        self._hit_by_qid[qid] = h
        self.history.append((now, h))
        if (self.enabled and self._degraded_at is None
                and len(self._window) == self._window.maxlen
                and self.windowed_hit_ratio()
                < self.refresh_threshold * self.baseline):
            # drift detected: restart the stats so the coming refresh
            # elects from the NEW regime's counts only
            self._degraded_at = self._seen
            self._counts.zero_()
        return h

    def windowed_hit_ratio(self) -> float:
        if not self._window:
            return self.baseline
        return float(np.mean(self._window))

    def batch_hit_ratio(self, qids) -> float:
        """Mean hit ratio of a flushed batch (falls back to the window)."""
        hs = [self._hit_by_qid[q] for q in qids if q in self._hit_by_qid]
        return float(np.mean(hs)) if hs else self.windowed_hit_ratio()

    # -- refresh policy -------------------------------------------------------
    def should_refresh(self) -> bool:
        return (self.enabled
                and self._degraded_at is not None
                and self._seen - self._degraded_at >= self.cooldown_queries)

    def refresh(self, now: float) -> None:
        """Fire ``tiered_embedding.lfu_refresh`` with the LIVE counts:
        flush the fast tier, re-elect the hot set from what the drifted
        stream actually accesses, and restart the stats window."""
        self.tiered = te.lfu_refresh(self.tiered, self._counts,
                                     hot_per_table=self.hot_per_table)
        self._counts.zero_()
        self._window.clear()
        self._degraded_at = None
        self.refreshes.append(now)

    def maybe_refresh(self, now: float) -> bool:
        if self.should_refresh():
            self.refresh(now)
            return True
        return False

    # -- memory-tier service retiming ----------------------------------------
    def _t_step(self, hit_ratio: float) -> float:
        key = round(float(hit_ratio), 3)
        if key not in self._t_step_cache:
            self._t_step_cache[key] = perf_model.inference_breakdown(
                self._model_cfg, self._system, "partial_pool",
                hit_ratio=key).t_step
        return self._t_step_cache[key]

    def service_multiplier(self, hit_ratio: float) -> float:
        """Hybrid-memory retiming of a measured service time: modeled step
        time at ``hit_ratio`` relative to the profiled baseline ratio (>= ~1
        when the tier erodes, back to ~1 after a refresh).

        Calibration hook: pass ``HitRatioMonitor(service_multiplier=...)``
        to replace the modeled curve -- a callable ``hit_ratio ->
        multiplier`` built from real HBM+DDR4 measurements, or a constant
        for a fixed retiming. Default (None) keeps the full-scale
        hybrid-memory model unchanged."""
        if self._multiplier_override is not None:
            if callable(self._multiplier_override):
                return float(self._multiplier_override(float(hit_ratio)))
            return float(self._multiplier_override)
        return self._t_step(hit_ratio) / self._t_step(self.baseline)
