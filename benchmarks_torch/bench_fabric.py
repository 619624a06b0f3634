"""Sharded-fleet fabric sweep on the card: link latency x remote-row cache
x scenario.

The counterpart of ``benchmarks/bench_fabric.py``, with its three
fabric-level claims, each driven from a RECORDED JSONL trace (the
bench_cluster discipline: generate -> record -> reload -> verify):

  (a) capacity: a table set that PROVABLY exceeds one board's budget (the
      single-board partition raises) is served by the sharded fleet
      within the paper's Eq. 1 SLA, judged at P=95;
  (b) locality: the per-board LFU cache of remote hot rows cuts
      cross-board wire bytes a query >= 3x against cache-off (the claim
      point caches half the remote row space; the sweep also caches 0
      and a quarter), and on a zipf_drift trace the re-elections keep the
      bytes below cache-off;
  (c) interconnect sensitivity: modeled (``perf_model.sharded_query_
      bound``) over the paper's latency grid, the QPS bound falls
      monotonically, and a measured fleet's p50 follows on the same
      trace (a 20 ms link against a 1 us one).

On the card the fleet serves ``dlrm-rm2-small-unsharded`` at full width:
21.47 GB of fp32 tables over ``--boards 2`` boards that share the card,
each budgeted 1.25 x its fair share (13.4 GB), which one board provably
cannot hold. The port budgets boards at the bytes it stores (fp32), where
the reference budgets the config's nominal fp16. The tables are drawn
ONCE, into host memory, and every fleet of the bench serves them through
``params=``: a fleet built without them draws its own 21.47 GB host
copy. ``--reduced`` serves the reference's size (``cfg.reduced()``, batch
8, 512 rows a table). The peak device memory, the host RSS and each
sweep point's wall time are printed: at full width, caching half the
remote row space is 41.9 M rows a board, kept by the host's LFU
bookkeeping.

Run: PYTHONPATH=src python -m benchmarks_torch.bench_fabric [--queries 120]
     [--tiny] [--trace-dir DIR] [--device cpu] [--reduced]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from benchmarks_torch._artifacts import (device_block, device_label,
                                         print_claims, write_bench_json)
from benchmarks_torch._fleet import (Cuts, draw_params, fp32_table_bytes,
                                     memory_line, recorded, release,
                                     trace_dir)
from repro_torch.configs.registry import get_dlrm
from repro_torch.core import perf_model
from repro_torch.device import resolve_device
from repro_torch.fabric import ShardedFleet, fits_one_board, partition_tables
from repro_torch.traffic import make_scenario


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="dlrm-rm2-small-unsharded")
    ap.add_argument("--queries", type=int, default=None,
                    help="queries a trace (default 120, 60 with --tiny)")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke size (fewer queries)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--alpha", type=float, default=1.05,
                    help="Zipf skew of the query stream (the cache claim "
                         "is pinned at ~1.05)")
    ap.add_argument("--boards", type=int, default=2)
    ap.add_argument("--trace-dir", default=None,
                    help="where the JSONL traces land (default: "
                         "<out-dir>/traces)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's size: cfg.reduced(), batch 8, "
                         "512 rows a table")
    ap.add_argument("--emit-json", action="store_true",
                    help="write BENCH_torch_fabric.json (claims + scalars "
                         "+ a representative run's metrics snapshot)")
    ap.add_argument("--out-dir", default=None,
                    help="where --emit-json writes (default build/bench/)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    block = device_block(dev)

    n = args.queries or (60 if args.tiny else 120)
    cfg = get_dlrm(args.config)
    if args.reduced:
        # 512-row tables: the Zipf head is a small fraction of a table
        cfg = dataclasses.replace(cfg.reduced(), batch_size=8,
                                  rows_per_table=512)
    cuts = Cuts()
    boards = args.boards
    tdir = trace_dir(args)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    failures: List[str] = []
    claims = []
    metrics_snapshot = None
    # batching deadline sized to the capacity-batch service time, as the
    # reference sizes it
    common = dict(alpha=args.alpha, seed=args.seed, profile_batches=32,
                  max_batch_queries=4, max_wait_ms=25.0, router="jsq",
                  device=dev)
    table_bytes = fp32_table_bytes(cfg)
    total = sum(table_bytes)
    print(f"# {cfg.name}: {cfg.num_tables} x {cfg.rows_per_table} x "
          f"{cfg.embed_dim} fp32 tables ({total / 1e9:.2f} GB), batch "
          f"{cfg.batch_size}, on {device_label(block)}")
    # budget each board for its fair share + headroom, strictly below the
    # whole table set: the model provably does not fit any single board
    cap = int(np.ceil(1.25 * total / boards))
    if cap >= total:
        raise SystemExit(
            f"--boards {boards}: the capacity claim needs the per-board "
            f"budget ({cap} B) to stay below the table set ({total} B); "
            f"use >= 2 boards")
    t0 = time.perf_counter()
    params = draw_params(cfg, args.seed, dev)
    print(f"# tables drawn once into host memory in "
          f"{time.perf_counter() - t0:.1f} s")

    def fleet(**kw) -> ShardedFleet:
        return ShardedFleet(cfg, n_boards=boards, board_capacity_bytes=cap,
                            params=params, **common, **kw)

    # ---- (a) capacity: too big for one board, served by the fleet --------
    print(f"== (a) capacity: one model over {boards} boards "
          "(SLA judged at P=95)")
    fl = fleet(verbose=True)
    print(f"fits one board ({cap} B for {total} B of tables)? "
          f"{fits_one_board(cfg, cap, table_bytes)}")
    try:
        partition_tables(cfg, np.ones(cfg.num_tables), 1, cap, table_bytes)
        failures.append("capacity: single-board partition did not raise")
    except ValueError as e:
        print(f"single-board partition raises as it must: {e}")
    s_cap = fl.measure_service_time()
    # generous vs the per-query service floor + the batching deadline; the
    # claim is structural (capacity within SLA), not a tail-latency duel
    sla_ms = (25.0 * s_cap / common["max_batch_queries"]
              + 2.0 * common["max_wait_ms"] / 1e3) * 1e3
    qps = 0.3 * common["max_batch_queries"] / s_cap
    print(f"capacity batch {s_cap * 1e3:.2f} ms -> C_SLA {sla_ms:.1f} ms, "
          f"offered {qps:.0f} qps")
    events = recorded(make_scenario("stationary", alpha=args.alpha),
                      n, qps, args.seed,
                      os.path.join(tdir, "fabric_stationary.jsonl"))
    r = fl.run(events, sla_ms=sla_ms, percentile=95.0, scenario="stationary")
    print(r.summary())
    metrics_snapshot = fl.metrics.snapshot()
    del fl
    release(dev)
    claims.append(("capacity", bool(r.ok and not r.fits_one_board),
                   f"p95 {r.ppf_ms:.2f}ms <= {sla_ms:.1f}ms on {boards} "
                   f"boards that individually cannot hold the model"))
    if r.ok and not r.fits_one_board:
        print(f"WIN capacity: {total / 2**20:.2f} MiB of tables "
              f"(> {cap / 2**20:.2f} MiB/board) served at p95 "
              f"{r.ppf_ms:.2f} ms <= {sla_ms:.1f} ms by {boards} boards "
              f"that individually cannot hold the model")
    else:
        failures.append(f"capacity: ok={r.ok} p95={r.ppf_ms:.2f}ms "
                        f"sla={sla_ms:.1f}ms fits={r.fits_one_board}")
    memory_line("after (a)", dev)

    # ---- (b) remote-row cache: bytes/query vs cache size ------------------
    print(f"\n== (b) remote-row cache at Zipf alpha={args.alpha}")
    remote_rows = (cfg.num_tables - cfg.num_tables // boards) \
        * cfg.rows_per_table
    print("cache_rows,bytes_per_query,remote_hit,p50_ms,wall_s")
    by_frac, wall = {}, {}
    for frac in (0.0, 0.25, 0.5):
        rows = int(frac * remote_rows)
        t0 = time.perf_counter()
        fl = fleet(cache_rows=rows, cache_enabled=rows > 0)
        rr = fl.run(events, sla_ms=sla_ms, percentile=95.0,
                    scenario="stationary")
        del fl
        release(dev)
        wall[frac] = time.perf_counter() - t0
        by_frac[frac] = rr
        hit = rr.remote_hit_last if rr.remote_hit_last is not None else 0.0
        print(f"{rows},{rr.bytes_per_query:.0f},{hit:.3f},{rr.p50_ms:.2f},"
              f"{wall[frac]:.1f}")
        memory_line(f"cache point {frac}", dev)
    cut = (by_frac[0.0].bytes_per_query
           / max(by_frac[0.5].bytes_per_query, 1e-9))
    claims.append(("cache", cut >= 3.0,
                   f"bytes/query cut {cut:.1f}x caching half the remote "
                   f"row space"))
    if cut >= 3.0:
        print(f"WIN cache: {by_frac[0.0].bytes_per_query:.0f} -> "
              f"{by_frac[0.5].bytes_per_query:.0f} B/query "
              f"({cut:.1f}x less wire traffic) caching half the remote "
              f"row space")
    else:
        failures.append(f"cache: bytes/query cut {cut:.2f}x < 3x "
                        f"({by_frac[0.0].bytes_per_query:.0f} -> "
                        f"{by_frac[0.5].bytes_per_query:.0f})")

    # graceful degradation under drift: refreshes fire, wire traffic stays
    # well under cache-off
    n_drift = max(n, 120)         # a rotation must outlast window+cooldown
    drift_events = recorded(
        make_scenario("zipf_drift", alpha=args.alpha,
                      rotate_every_s=0.35 * n_drift / qps, salt_stride=37),
        n_drift, qps, args.seed, os.path.join(tdir, "fabric_drift.jsonl"))
    t0 = time.perf_counter()
    fl = fleet(cache_rows=int(0.5 * remote_rows), cache_window=12,
               cache_refresh_threshold=0.7, cache_cooldown=12)
    rd = fl.run(drift_events, sla_ms=sla_ms, percentile=95.0,
                scenario="zipf_drift")
    del fl
    release(dev)
    print(f"zipf_drift: bytes/query {rd.bytes_per_query:.0f} "
          f"(cache-off {by_frac[0.0].bytes_per_query:.0f}), hit "
          f"{rd.remote_hit_first:.3f}->{rd.remote_hit_last:.3f}, "
          f"{rd.cache_refreshes} cache refreshes, "
          f"{time.perf_counter() - t0:.1f} s")
    claims.append(("drift",
                   rd.bytes_per_query < by_frac[0.0].bytes_per_query,
                   f"cached fleet {rd.bytes_per_query:.0f} B/query vs "
                   f"cache-off {by_frac[0.0].bytes_per_query:.0f}"))
    if rd.bytes_per_query >= by_frac[0.0].bytes_per_query:
        failures.append(
            f"drift: cached fleet moved {rd.bytes_per_query:.0f} B/query, "
            f">= cache-off {by_frac[0.0].bytes_per_query:.0f}")

    # ---- (c) link-latency sensitivity -------------------------------------
    print("\n== (c) fabric link sensitivity (paper Fig. 8/9 trend at "
          "board scale)")
    sys_model = dataclasses.replace(perf_model.recspeed_system(), n_chips=1)
    bounds = sensitivity_bounds(cfg, sys_model, boards, by_frac[0.5])
    monotone = all(a >= b for a, b in zip(bounds, bounds[1:]))
    drop = bounds[0] / bounds[-1]
    # measured confirmation: a link slow enough that its modeled term
    # (2 x 20 ms a flush) dwarfs any timing noise MUST cost latency on the
    # same trace; judged with a 20 ms margin. The 1 us point is (b)'s
    # cache-off run: the same fleet (the default link is 1 us) on the same
    # trace, so it is not built again
    slow_us = 20_000.0
    assert perf_model.fabric_link() == perf_model.fabric_link(1.0, 100.0)
    p50s = {1.0: by_frac[0.0].p50_ms}
    fl = fleet(link=perf_model.fabric_link(slow_us, 100.0), cache_rows=0,
               cache_enabled=False)
    p50s[slow_us] = fl.run(events, sla_ms=sla_ms, percentile=95.0).p50_ms
    del fl
    release(dev)
    print(f"measured p50 at 1us link {p50s[1.0]:.2f} ms vs "
          f"{slow_us:.0f}us link {p50s[slow_us]:.2f} ms")
    sens_ok = bool(monotone and drop > 1.05
                   and p50s[slow_us] > p50s[1.0] + 20.0)
    claims.append(("sensitivity", sens_ok,
                   f"modeled QPS bound falls {drop:.2f}x over the latency "
                   f"grid; measured p50 follows"))
    if sens_ok:
        print(f"WIN sensitivity: modeled QPS bound falls {drop:.2f}x from "
              f"{perf_model.LATENCY_GRID_US[0]} -> "
              f"{perf_model.LATENCY_GRID_US[-1]} us link latency "
              f"(monotone), and the measured fleet's p50 follows")
    else:
        failures.append(f"sensitivity: monotone={monotone} drop={drop:.2f} "
                        f"p50@1us={p50s[1.0]:.2f} "
                        f"p50@{slow_us:.0f}us={p50s[slow_us]:.2f}")
    memory_line("after (c)", dev)
    del params
    release(dev)

    print(f"\ntraces: {tdir}")
    print_claims("fabric", claims, block)
    if args.emit_json:
        write_bench_json("fabric", claims, {
            "bytes_per_query_cache_off": by_frac[0.0].bytes_per_query,
            "bytes_per_query_cache_half": by_frac[0.5].bytes_per_query,
            "bytes_per_query_drift": rd.bytes_per_query,
            "modeled_qps_bounds": dict(zip(
                [float(x) for x in perf_model.LATENCY_GRID_US], bounds)),
            "p50_ms_by_link_us": {str(k): v for k, v in p50s.items()},
            "sla_ms": sla_ms,
            "cuts": cuts.cuts,
        }, dev, args.out_dir, metrics=metrics_snapshot)
    if failures:
        for f in failures:
            print(f"FAILED CLAIM: {f}")
        return 1
    return 0


def sensitivity_bounds(cfg, sys_model, boards: int, half) -> List[float]:
    """(c)'s modeled QPS bound at each latency of the paper's grid, at the
    remote fraction and cache miss ratio ``half`` (the half-cache run)
    measured; prints each row."""
    miss = 1.0 - (half.remote_hit_last or 0.0)
    remote_frac = half.remote_lookup_fraction
    print("latency_us,modeled_qps_bound,t_fabric_us")
    bounds = []
    for lat in perf_model.LATENCY_GRID_US:
        link = perf_model.fabric_link(lat, 100.0)
        bd = perf_model.sharded_query_bound(cfg, sys_model, boards, link,
                                            remote_frac * miss)
        bounds.append(bd.qps)
        print(f"{lat},{bd.qps:.0f},{bd.notes['t_fabric'] * 1e6:.2f}")
    return bounds


if __name__ == "__main__":
    import sys
    sys.exit(main())
