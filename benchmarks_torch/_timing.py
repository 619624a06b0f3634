"""Timing helpers shared by the port's benchmarks.

On the card a time comes from CUDA events around many calls after a
warm-up, divided by the call count, the calls queued behind a sleep
kernel so that the events time the device's work and not the host's
launch rate (``_elapsed_ms``). ``device=None`` means the card and
raises without one; a CPU time (host clock) is taken only when the caller
names the CPU, as the CPU tests do, and is never a device number.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, List, Sequence

import torch

from repro_torch.device import DeviceArg, resolve_device


def _sleep_cycles_per_ms(dev: torch.device) -> float:
    """The card's clock cycles a ms, as ``torch.cuda._sleep`` counts them:
    one sleep of 10^6 cycles timed by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize(dev)
    return 1e6 / start.elapsed_time(end)


def _elapsed_ms(run: Callable[[], None], dev: torch.device) -> float:
    """ms of ``run()``'s device work: CUDA events on the card, the host
    clock on the CPU.

    On the card ``run()`` is enqueued behind a sleep kernel that outlasts
    its host time (three times the time the host took to enqueue it once
    before), so the events open when the launches are already queued and
    time them back to back: the device's work, not the host's launch
    rate. A ``run()`` that waits on the device inside runs host-bound
    after the sleep, as it would without it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run()
        host_ms = (time.perf_counter() - t0) * 1e3
        cycles = int(3 * host_ms * _sleep_cycles_per_ms(dev)) + 100_000
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) * 1e3


def time_ms(fn: Callable[[int], object], n_sets: int = 1, iters: int = 40,
            device: DeviceArg = None) -> float:
    """ms a call of ``fn(k)``, the input sets k = 0..n_sets-1 in turn: one
    warm-up call a set, then ``iters`` calls timed together."""
    dev = resolve_device(device)
    for k in range(n_sets):
        fn(k)

    def run():
        for i in range(iters):
            fn(i % n_sets)
    return _elapsed_ms(run, dev) / iters


def paired_medians(thunks: Sequence[Callable[[], object]], rounds: int,
                   iters: int, device: DeviceArg = None) -> List[float]:
    """Time each thunk ``iters`` times a round, the thunks interleaved;
    return each thunk's median-over-rounds seconds a call. Interleaving +
    median cancels the drift a shared host shows between back-to-back
    blocks (``benchmarks/bench_tiered_embedding.py:_paired_medians``)."""
    dev = resolve_device(device)
    for fn in thunks:                      # warm: builds, caches
        fn()
    samples: List[List[float]] = [[] for _ in thunks]
    for _ in range(rounds):
        for slot, fn in enumerate(thunks):
            def run(fn=fn):
                for _ in range(iters):
                    fn()
            samples[slot].append(_elapsed_ms(run, dev) / 1e3 / iters)
    return [statistics.median(s) for s in samples]


def host_median_s(fn: Callable[[], object], rounds: int, iters: int,
                  device: DeviceArg = None) -> float:
    """Median over ``rounds`` of the host-clock seconds a call of ``fn``,
    each round ``iters`` calls ending in a synchronize of the device: a
    step's or a query's time, host gaps included. One warm-up call."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fn()
    sync()
    samples = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        samples.append((time.perf_counter() - t0) / iters)
    return statistics.median(samples)
