"""Cluster serving sweep on the card: scenario x router x replica count.

The counterpart of ``benchmarks/bench_cluster.py``, with its three
fleet-level claims, each driven from a RECORDED JSONL trace (generated
once, written, re-loaded and verified identical, so every number below
reproduces from the trace file alone):

  (a) scale-out:  under stationary load, 2 replicas sustain >= 1.8x the
      single-replica within-SLA throughput, and the load replica 2
      absorbs breaks one replica (its solo run saturates and/or busts the
      SLA); the SLA verdict is judged at P=95, as the reference judges it;
  (b) routing:    under flash_crowd bursts on a fleet with one 2.2x
      straggler board (``Cluster(service_scales=)``), power-of-two-choices
      beats round-robin's p99, judged on the MEDIAN p99 over three
      recorded burst traces;
  (c) drift:      on zipf_drift, the hit-ratio monitor's drift-triggered
      ``lfu_refresh`` restores the fast-tier hit ratio and the tail the
      erosion cost (service times retimed by the hybrid memory model at
      full model scale), against the same trace with the refresh off
      (``HitRatioMonitor(enabled=False)``); p95 as in (a).

Single-board capacities calibrate every offered load, as in the
reference: the per-query floor s1 and the batched rate 4 / s4.

On the card the fleet serves ``dlrm-rm2-small-unsharded`` at full width
(21.47 GB of fp32 tables a replica: a port replica holds its own tables,
so replicas sharing one card share its 80 GB). ``--reduced`` serves the
reference's size (``cfg.reduced()``, batch 8). What one card forces is cut
and recorded in ``scalars.cuts``:

  * (b)'s four replicas hold 2,097,152 rows a table (``DUEL_ROWS``):
    four full replicas are 85.9 GB;
  * the monitor profiles 256 batches (``FULL_PROFILE_BATCHES``), not the
    reference's 4: 4 batches of 200 samples touch so few of 4.2 M rows a
    table that its baseline reads 1.0 and it refreshes before any drift.

Each cluster is released before the next is built. The peak device
memory and the host RSS are printed.

Run: PYTHONPATH=src python -m benchmarks_torch.bench_cluster [--queries 240]
     [--tiny] [--trace-dir DIR] [--device cpu] [--reduced]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import torch

from benchmarks_torch._artifacts import (device_block, device_label,
                                         print_claims, write_bench_json)
from benchmarks_torch._fleet import (Cuts, fp32_table_bytes, memory_line,
                                     recorded, release, trace_dir)
from repro_torch.cluster import Cluster, HitRatioMonitor
from repro_torch.configs.registry import get_dlrm
from repro_torch.device import resolve_device
from repro_torch.engine import Engine
from repro_torch.traffic import make_scenario

DUEL_ROWS = 2_097_152
REF_PROFILE_BATCHES = 4
FULL_PROFILE_BATCHES = 256


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="dlrm-rm2-small-unsharded")
    ap.add_argument("--queries", type=int, default=None,
                    help="queries a trace (default 240, 120 with --tiny)")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke size (120 queries)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--alpha", type=float, default=1.2)
    ap.add_argument("--trace-dir", default=None,
                    help="where the JSONL traces land (default: "
                         "<out-dir>/traces)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's size: cfg.reduced(), batch 8")
    ap.add_argument("--emit-json", action="store_true",
                    help="write BENCH_torch_cluster.json (claims + scalars "
                         "+ a representative run's metrics snapshot)")
    ap.add_argument("--out-dir", default=None,
                    help="where --emit-json writes (default build/bench/)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    block = device_block(dev)

    n = args.queries or (120 if args.tiny else 240)
    full_cfg = get_dlrm(args.config)
    cuts = Cuts()
    if args.reduced:
        cfg = dataclasses.replace(full_cfg.reduced(), batch_size=8)
        duel_cfg = cfg
        profile = REF_PROFILE_BATCHES
    else:
        cfg = full_cfg
        fp32_gb = sum(fp32_table_bytes(cfg)) / 1e9
        duel_cfg = dataclasses.replace(cfg, rows_per_table=cuts.add(
            "duel_rows_per_table", cfg.rows_per_table, DUEL_ROWS,
            f"(b) builds 4-replica clusters; 4 full replicas are "
            f"{4 * fp32_gb:.1f} GB of fp32 tables"))
        profile = cuts.add(
            "monitor_profile_batches", REF_PROFILE_BATCHES,
            FULL_PROFILE_BATCHES, "4 batches leave the monitor's baseline "
            f"at 1.0 over {cfg.rows_per_table} rows a table")
    print(f"# {cfg.name}: {cfg.num_tables} x {cfg.rows_per_table} x "
          f"{cfg.embed_dim} fp32 tables a replica, batch {cfg.batch_size}, "
          f"on {device_label(block)}")
    tdir = trace_dir(args)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    failures: List[str] = []
    claims = []
    metrics_snapshot = None

    # single-board capacities calibrate every offered load: per-query
    # floor s1 and the batched saturation rate cap1 = 4 queries / s4
    probe = Engine(cfg, alpha=args.alpha, device=dev).serve_session(
        max_batch_queries=4)
    s1 = probe.measure_service_time()
    s4 = probe.measure_service_time(4)
    del probe
    release(dev)
    cap1 = 4.0 / s4
    sla_ms = 25.0 * s1 * 1e3     # generous vs service floor, real vs queueing
    print(f"single board: per-query {s1 * 1e3:.2f} ms, batched capacity "
          f"{cap1:.0f} qps -> C_SLA {sla_ms:.1f} ms")
    common = dict(alpha=args.alpha, max_batch_queries=4, max_wait_ms=2.0,
                  device=dev)

    # ---- (a) stationary scale-out: 1 -> 2 replicas -----------------------
    print("\n== (a) stationary scale-out (SLA judged at P=95)")
    print("replicas,offered_qps,achieved_qps,p95_ms,p99_ms,sla,"
          "board_s_per_kq,sla_violations")
    runs = {}
    for replicas, load in ((1, 0.55), (1, 1.2), (2, 1.2)):
        qps = load * cap1
        events = recorded(make_scenario("stationary", alpha=args.alpha),
                          n, qps, args.seed,
                          os.path.join(tdir, f"stationary_{load}.jsonl"))
        cl = Cluster(cfg, n_replicas=replicas, router="jsq", **common)
        r = cl.run(events, sla_ms=sla_ms, percentile=95.0,
                   scenario="stationary")
        runs[(replicas, load)] = r
        if replicas == 2:
            metrics_snapshot = cl.metrics.snapshot()
        del cl
        release(dev)
        print(f"{replicas},{r.offered_qps:.0f},{r.achieved_qps:.0f},"
              f"{r.ppf_ms:.2f},{r.p99_ms:.2f},"
              f"{'PASS' if r.ok else 'FAIL'},"
              f"{1e3 * r.board_seconds / r.n_queries:.1f},"
              f"{r.sla_violations}")
    r1, r1x, r2 = runs[(1, 0.55)], runs[(1, 1.2)], runs[(2, 1.2)]
    scaling = r2.achieved_qps / r1.achieved_qps
    one_board_breaks = (not r1x.ok) or (r1x.achieved_qps
                                        < 0.9 * r1x.offered_qps)
    scale_ok = bool(r1.ok and r2.ok and scaling >= 1.8 and one_board_breaks)
    claims.append(("scale_out", scale_ok,
                   f"{scaling:.2f}x within-SLA QPS from 1->2 replicas"))
    if scale_ok:
        print(f"WIN scale-out: {scaling:.2f}x within-SLA QPS from 1->2 "
              f"replicas (1 replica at the 2-replica load: "
              f"p95 {r1x.ppf_ms:.2f}ms, "
              f"{'SLA FAIL' if not r1x.ok else 'saturated'})")
    else:
        failures.append(f"scale-out: scaling {scaling:.2f}x "
                        f"(r1.ok={r1.ok} r2.ok={r2.ok} "
                        f"one_board_breaks={one_board_breaks})")
    memory_line("after (a)", dev)

    # ---- (b) flash_crowd router duel -------------------------------------
    print("\n== (b) flash_crowd: round_robin vs p2c "
          "(4 replicas, one 2.2x straggler; median p99 of 3 traces)")
    scales = (1.0, 1.0, 1.0, 2.2)
    n_duel = 120                  # the regime tuned for burst overlap
    base = 0.45 * len(scales) * cap1 / float(sum(scales) / len(scales))
    horizon = n_duel / base
    print("trace_seed,router,achieved_qps,p50_ms,p99_ms")
    p99s = {router: [] for router in ("round_robin", "jsq", "p2c")}
    for k in range(3):
        seed = args.seed + k
        events = recorded(
            make_scenario("flash_crowd", alpha=args.alpha, burst_factor=10.0,
                          on_s=0.2 * horizon, off_s=0.3 * horizon),
            n_duel, base, seed,
            os.path.join(tdir, f"flash_crowd_{seed}.jsonl"))
        for router in p99s:
            cl = Cluster(duel_cfg, n_replicas=len(scales), router=router,
                         seed=seed, service_scales=scales, **common)
            r = cl.run(events, sla_ms=sla_ms, scenario="flash_crowd")
            del cl
            release(dev)
            p99s[router].append(r.p99_ms)
            print(f"{seed},{router},{r.achieved_qps:.0f},{r.p50_ms:.2f},"
                  f"{r.p99_ms:.2f}")
    med = {router: sorted(v)[len(v) // 2] for router, v in p99s.items()}
    claims.append(("routing", med["p2c"] < med["round_robin"],
                   f"p2c median p99 {med['p2c']:.2f}ms vs round_robin "
                   f"{med['round_robin']:.2f}ms"))
    if med["p2c"] < med["round_robin"]:
        print(f"WIN routing: p2c median p99 {med['p2c']:.2f}ms < "
              f"round_robin {med['round_robin']:.2f}ms under bursts "
              f"({med['round_robin'] / med['p2c']:.2f}x; jsq "
              f"{med['jsq']:.2f}ms)")
    else:
        failures.append(f"routing: p2c median p99 {med['p2c']:.2f}ms !< "
                        f"round_robin {med['round_robin']:.2f}ms "
                        f"(per-trace {p99s})")
    memory_line("after (b)", dev)

    # ---- (c) zipf_drift: drift-triggered lfu_refresh ---------------------
    print("\n== (c) zipf_drift: drift-triggered lfu_refresh vs refresh-off")
    qps = 0.8 * 2 / s1
    horizon = n / qps
    events = recorded(
        make_scenario("zipf_drift", alpha=args.alpha,
                      rotate_every_s=0.6 * horizon, salt_stride=37),
        n, qps, args.seed, os.path.join(tdir, "zipf_drift.jsonl"))
    print("refresh,hit_first,hit_last,p95_ms,p99_ms,refreshes")
    by_refresh = {}
    for refresh_on in (True, False):
        monitor = HitRatioMonitor(cfg, alpha=args.alpha, window=16,
                                  cooldown_queries=24, model_cfg=full_cfg,
                                  profile_batches=profile,
                                  enabled=refresh_on, device=dev)
        cl = Cluster(cfg, n_replicas=2, router="jsq", monitor=monitor,
                     **common)
        r = cl.run(events, sla_ms=sla_ms, percentile=95.0,
                   scenario="zipf_drift")
        del cl, monitor
        release(dev)
        by_refresh[refresh_on] = r
        print(f"{'on' if refresh_on else 'off'},{r.hit_ratio_first:.3f},"
              f"{r.hit_ratio_last:.3f},{r.ppf_ms:.2f},{r.p99_ms:.2f},"
              f"{len(r.refreshes)}")
    on, off = by_refresh[True], by_refresh[False]
    recovered = bool(on.refreshes
                     and on.hit_ratio_last > 2.0 * off.hit_ratio_last
                     and on.ppf_ms < off.ppf_ms)
    claims.append(("drift", recovered,
                   f"lfu_refresh hit {off.hit_ratio_last:.3f} -> "
                   f"{on.hit_ratio_last:.3f}, p95 {off.ppf_ms:.2f} -> "
                   f"{on.ppf_ms:.2f}ms"))
    if recovered:
        print(f"WIN drift: lfu_refresh restored hit ratio "
              f"{off.hit_ratio_last:.3f} -> {on.hit_ratio_last:.3f} and p95 "
              f"{off.ppf_ms:.2f} -> {on.ppf_ms:.2f}ms "
              f"({len(on.refreshes)} refresh)")
    else:
        failures.append(
            f"drift: refresh-on hit {on.hit_ratio_last:.3f} / p95 "
            f"{on.ppf_ms:.2f}ms vs refresh-off {off.hit_ratio_last:.3f} / "
            f"{off.ppf_ms:.2f}ms (refreshes={len(on.refreshes)})")
    memory_line("after (c)", dev)

    print(f"\ntraces: {tdir}")
    print_claims("cluster", claims, block)
    if args.emit_json:
        write_bench_json("cluster", claims, {
            "scale_out_x": scaling,
            "p99_ms_median": med,
            "hit_ratio_last_refresh_on": on.hit_ratio_last,
            "hit_ratio_last_refresh_off": off.hit_ratio_last,
            "sla_ms": sla_ms,
            "cuts": cuts.cuts,
        }, dev, args.out_dir, metrics=metrics_snapshot)
    if failures:
        for f in failures:
            print(f"FAILED CLAIM: {f}")
        return 1
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
