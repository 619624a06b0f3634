"""Traffic scenarios: timestamped query streams on the virtual clock.

The port's copy of ``repro.traffic.scenarios``. A single board's
``ServeSession.run_open_loop`` drives a STATIONARY Poisson stream.
Production recommender traffic is none of that: it is diurnal (daily
rate swings of 2x and more), bursty (flash crowds around events), and
hotness-drifting (the set of hot items rotates, eroding any
frequency-elected cache) -- the regimes that stress dynamic batching, the
tiered embedding cache, and capacity planning (Gupta et al., "The
Architectural Implications of Facebook's DNN-based Personalized
Recommendation").

A ``TrafficScenario`` compiles one of those regimes into a list of
``QueryEvent``s -- (arrival time, data-stream step, Zipf alpha, hot-row
permutation salt) -- via Lewis-Shedler thinning of a rate function
lambda(t) against its peak. The event lists are numpy draws, the same as
the reference's for the same (n_queries, qps, seed, start_qid), so a
trace recorded by either package serves in the other. Everything
downstream is a PURE function of the event list:

  * ``materialize_query(cfg, event, query_size, device)`` regenerates the
    dense features + index stream for an event (the step-indexed
    synthetic stream, ``data/recsys.py``) on the given device, so a
    recorded trace (``traffic.trace``) replays bit-identically to live
    generation. The port's generator is a ``torch.Generator``, so the
    CONTENT of a query differs from the reference's; the row rotation
    applied to it is the same;
  * the cluster event loop (``repro_torch.cluster``) consumes events in
    arrival order and merges them with per-replica flush deadlines.

Scenarios:
  stationary  -- homogeneous Poisson at ``qps`` (the open-loop stream).
  diurnal     -- sinusoidally modulated rate: lambda(t) = qps * (1 +
                 amplitude * sin(2*pi*t/period_s)); mean stays ``qps``.
  flash_crowd -- MMPP-style on/off burst modulation: a two-state chain
                 with exponential holding times multiplies the base rate
                 by ``burst_factor`` while "on".
  zipf_drift  -- stationary arrivals whose CONTENT drifts: the stream's
                 Zipf alpha oscillates between ``alpha`` and ``alpha_hi``,
                 and a rotating row-space permutation (salt = rotation
                 count * ``salt_stride``) remaps which rows are hot --
                 degrading a frequency-elected fast tier until it is
                 refreshed (``tiered_embedding.lfu_refresh``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.data.recsys import make_recsys_batch
from repro_torch.device import DeviceArg

Query = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class QueryEvent:
    """One query's arrival + everything needed to regenerate its content.

    The content is a pure function of (cfg, step, seed, alpha, perm_salt),
    so traces that store events replay bit-identically (traffic.trace).
    """

    qid: int
    arrival_s: float     # virtual-clock arrival time
    step: int            # data-stream step index (content selector)
    seed: int            # data-stream seed
    alpha: float         # Zipf skew of the index stream at this instant
    perm_salt: int = 0   # row-space rotation (zipf_drift hotness remap)


def materialize_query(cfg: DLRMConfig, event: QueryEvent,
                      query_size: Optional[int] = None,
                      device: DeviceArg = None) -> Query:
    """Regenerate an event's query content, {"dense", "indices"}, on
    ``device`` (None: the card).

    ``perm_salt`` applies a row-space rotation (a bijection on [0, R))
    AFTER the Zipf draw, ``(idx + salt % R) % R`` in int32, so the
    marginal row-frequency *shape* is unchanged but WHICH rows are hot
    rotates -- the cache-erosion mechanism of ``zipf_drift``.
    """
    b = make_recsys_batch(cfg, event.step, event.seed, event.alpha,
                          batch_size=query_size, device=device)
    idx = b["indices"]
    if event.perm_salt:
        R = cfg.rows_per_table
        idx = ((idx + event.perm_salt % R) % R).to(torch.int32)
    return {"dense": b["dense"], "indices": idx}


class TrafficScenario:
    """Base scenario: homogeneous Poisson arrivals, fixed stream params.

    Subclasses override ``make_rate_fn`` (arrival-rate modulation) and/or
    ``stream_params`` (content drift). ``events`` is the one entry point;
    it is deterministic in (n_queries, qps, seed).
    """

    name = "stationary"

    def __init__(self, *, alpha: float = 0.0):
        self.alpha = float(alpha)

    # -- rate modulation ---------------------------------------------------
    def peak_rate(self, qps: float) -> float:
        """Upper bound on lambda(t) -- the thinning envelope."""
        return qps

    def make_rate_fn(self, qps: float, seed: int) -> Callable[[float], float]:
        """lambda(t); may pre-seed its own rng for a modulating chain."""
        return lambda t: qps

    # -- content drift -----------------------------------------------------
    def stream_params(self, t: float) -> tuple:
        """(alpha, perm_salt) of the index stream at virtual time t."""
        return self.alpha, 0

    # -- event generation --------------------------------------------------
    def events(self, n_queries: int, qps: float, seed: int = 0,
               start_qid: int = 0) -> List[QueryEvent]:
        """First ``n_queries`` arrivals of the scenario's point process.

        Lewis-Shedler thinning: candidate arrivals at the peak rate are
        accepted with probability lambda(t)/peak. Deterministic in
        (n_queries, qps, seed); ``start_qid`` offsets qid AND the data
        step so concatenated segments never repeat content.
        """
        if qps <= 0:
            raise ValueError(f"scenario arrival rate must be > 0, got {qps}")
        rng = np.random.default_rng(seed)
        rate = self.make_rate_fn(qps, seed)
        lam = float(self.peak_rate(qps))
        out: List[QueryEvent] = []
        t = 0.0
        while len(out) < n_queries:
            t += rng.exponential(1.0 / lam)
            if rng.uniform() * lam <= rate(t):
                alpha, salt = self.stream_params(t)
                k = start_qid + len(out)
                out.append(QueryEvent(qid=k, arrival_s=t, step=k, seed=seed,
                                      alpha=float(alpha), perm_salt=int(salt)))
        return out


class StationaryScenario(TrafficScenario):
    """Homogeneous Poisson -- the open-loop stream, as events."""

    name = "stationary"


class DiurnalScenario(TrafficScenario):
    """Sinusoidal rate: lambda(t) = qps * (1 + amplitude*sin(2*pi*t/T)).

    One ``period_s`` is a virtual "day"; the mean rate stays ``qps``.
    """

    name = "diurnal"

    def __init__(self, *, alpha: float = 0.0, amplitude: float = 0.8,
                 period_s: float = 4.0):
        super().__init__(alpha=alpha)
        if not 0.0 <= amplitude < 1.0:
            raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
        self.amplitude = float(amplitude)
        self.period_s = float(period_s)

    def peak_rate(self, qps: float) -> float:
        return qps * (1.0 + self.amplitude)

    def make_rate_fn(self, qps, seed):
        w = 2.0 * math.pi / self.period_s
        return lambda t: qps * (1.0 + self.amplitude * math.sin(w * t))


class FlashCrowdScenario(TrafficScenario):
    """MMPP-style burst modulation: a two-state (off/on) chain with
    exponential holding times (means ``off_s`` / ``on_s``); the "on" state
    multiplies the base rate by ``burst_factor``. ``qps`` is the OFF-state
    base rate, so bursts genuinely overload a system sized for it."""

    name = "flash_crowd"

    def __init__(self, *, alpha: float = 0.0, burst_factor: float = 6.0,
                 on_s: float = 0.5, off_s: float = 1.5):
        super().__init__(alpha=alpha)
        if burst_factor < 1.0:
            raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
        self.burst_factor = float(burst_factor)
        self.on_s = float(on_s)
        self.off_s = float(off_s)

    def peak_rate(self, qps: float) -> float:
        return qps * self.burst_factor

    def make_rate_fn(self, qps, seed):
        # dedicated rng for the modulating chain, independent of the
        # thinning draws, so the burst schedule is a function of seed only
        mod = np.random.default_rng(np.random.SeedSequence([seed, 0x9E3779B9]))
        switches = [0.0]          # state toggles at these times; starts OFF

        def rate(t: float) -> float:
            while switches[-1] <= t:
                # the hold being drawn closes period len(switches)-1;
                # even periods are OFF (the chain starts off)
                p = len(switches) - 1
                hold = self.off_s if p % 2 == 0 else self.on_s
                switches.append(switches[-1] + mod.exponential(hold))
            # state during [switches[i-1], switches[i]) is ON for odd i-1
            i = int(np.searchsorted(switches, t, side="right"))
            on = (i - 1) % 2 == 1
            return qps * (self.burst_factor if on else 1.0)

        return rate


class ZipfDriftScenario(TrafficScenario):
    """Stationary arrivals, drifting CONTENT: alpha(t) oscillates between
    ``alpha`` and ``alpha_hi`` with period ``drift_period_s``, and every
    ``rotate_every_s`` the hot-row permutation advances by ``salt_stride``
    (row-space rotation), so the fast tier elected from old frequencies
    serves a shrinking share of traffic until it is refreshed."""

    name = "zipf_drift"

    def __init__(self, *, alpha: float = 1.05, alpha_hi: float = 1.05,
                 drift_period_s: float = 8.0, rotate_every_s: float = 2.0,
                 salt_stride: int = 37):
        super().__init__(alpha=alpha)
        if rotate_every_s <= 0:
            raise ValueError(f"rotate_every_s must be > 0, got {rotate_every_s}")
        self.alpha_hi = float(alpha_hi)
        self.drift_period_s = float(drift_period_s)
        self.rotate_every_s = float(rotate_every_s)
        self.salt_stride = int(salt_stride)

    def stream_params(self, t: float) -> tuple:
        phase = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.drift_period_s))
        alpha = self.alpha + (self.alpha_hi - self.alpha) * phase
        salt = int(t // self.rotate_every_s) * self.salt_stride
        return alpha, salt


SCENARIOS = {
    "stationary": StationaryScenario,
    "diurnal": DiurnalScenario,
    "flash_crowd": FlashCrowdScenario,
    "zipf_drift": ZipfDriftScenario,
}


def make_scenario(name: str, **kwargs) -> TrafficScenario:
    """Scenario registry lookup; kwargs forward to the constructor."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; one of "
                         f"{sorted(SCENARIOS)}")
    return SCENARIOS[name](**kwargs)
