"""Engine serving sweep on the card: micro-batch capacity x arrival rate x
plan.

The counterpart of ``benchmarks/bench_engine_serve.py``: drives
``repro_torch.engine.ServeSession.run_open_loop`` (Poisson arrivals, each
flush a real, measured execution on the card, on a virtual clock) over the
reference's grid of dynamic-batching capacities and offered loads, for
the unplanned and the auto-planned (tiered placement) serve path, and
looks for the reference's frontier: a swept point where dynamic batching
reaches >= 1.05x the achieved QPS of fixed per-query serving at an equal
or better p99.

On the card it serves the config at full width (``dlrm-rm2-small-
unsharded``: 21.47 GB of tables), where the reference serves
``.reduced()``; ``--reduced`` serves the reference's size. The sessions of
one plan share one table set (a fresh session would draw its own), and
plan none's are released before plan auto's are built: a plan=auto
session splits the tables it is given into its two groups, so it holds
them twice while it is built. The peak is printed
(``torch.cuda.max_memory_allocated``). ``s1``, the per-query service time
that sets the load factors' rates, is printed beside the sweep.

Run: PYTHONPATH=src python -m benchmarks_torch.bench_engine_serve
     [--queries 150] [--capacities 1,4,8] [--load-factors 0.6,1.0,2.0]
"""
from __future__ import annotations

import argparse
import gc
from typing import List, Optional

import torch

from benchmarks_torch._artifacts import (device_block, device_label,
                                         print_claims, write_bench_json)
from repro_torch.configs.registry import get_dlrm
from repro_torch.device import resolve_device
from repro_torch.engine import Engine


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="dlrm-rm2-small-unsharded")
    ap.add_argument("--queries", type=int, default=150)
    ap.add_argument("--capacities", default="1,4,8",
                    help="micro-batch capacities (queries) to sweep")
    ap.add_argument("--load-factors", default="0.6,1.0,2.0",
                    help="offered load as a multiple of the per-query "
                         "saturation rate 1/s1")
    ap.add_argument("--plans", default="none,auto")
    ap.add_argument("--alpha", type=float, default=1.05)
    ap.add_argument("--sla-ms", type=float, default=50.0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--reduced", action="store_true",
                    help="serve cfg.reduced(), the reference's size")
    ap.add_argument("--emit-json", action="store_true",
                    help="write BENCH_torch_engine_serve.json (claims + the "
                         "swept frontier)")
    ap.add_argument("--out-dir", default=None,
                    help="where --emit-json writes (default build/bench/)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    caps = sorted({int(c) for c in args.capacities.split(",")})
    if caps[0] != 1:
        caps = [1] + caps   # the per-query baseline the WIN check needs
        print("note: adding capacity=1 as the per-query baseline")
    factors = [float(f) for f in args.load_factors.split(",")]
    plans = args.plans.split(",")
    cfg = get_dlrm(args.config)
    if args.reduced:
        cfg = cfg.reduced()
    block = device_block(dev)
    print(f"# {cfg.name}: {cfg.num_tables} x {cfg.rows_per_table} x "
          f"{cfg.embed_dim} fp32 tables "
          f"({cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4 / 1e9:.2f}"
          f" GB) on {device_label(block)}")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    print("plan,capacity,load_factor,offered_qps,achieved_qps,mean_batch,"
          "p50_ms,p99_ms")
    results, s1_ms, depth = {}, {}, {}
    for plan in plans:
        engine = Engine(cfg, plan=plan, alpha=args.alpha, device=dev)
        sessions, params = {}, None
        for c in caps:
            sessions[c] = engine.serve_session(max_batch_queries=c,
                                               params=params)
            params = sessions[c].params
        # saturation rate of the fixed per-query server under this plan
        s1 = sessions[1].measure_service_time()
        s1_ms[plan] = s1 * 1e3
        depth[plan] = sessions[1].depth_for_samples(cfg.batch_size)
        print(f"# plan={plan}: s1 = {s1 * 1e3:.4f} ms a query at depth "
              f"{depth[plan]} (the load factors' unit rate {1 / s1:.1f} qps)")
        for cap in caps:
            sess = sessions[cap]
            for f in factors:
                qps = f / s1
                # deadline: half the time a batch takes to fill at this
                # rate, capped so light load isn't penalized
                wait_ms = min(8.0, 0.5 * cap / qps * 1e3)
                r = sess.run_open_loop(
                    args.queries, qps, sla_ms=args.sla_ms,
                    max_wait_ms=wait_ms)
                results[(plan, cap, f)] = r
                print(f"{plan},{cap},{f},{qps:.0f},{r.achieved_qps:.0f},"
                      f"{r.mean_batch_queries:.2f},{r.p50_ms:.2f},"
                      f"{r.p99_ms:.2f}")
        del sessions, sess, params, engine
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 1e9 if on_card
               else None)
    if peak_gb is not None:
        print(f"# peak device memory {peak_gb:.2f} GB "
              f"({device_label(block)})")

    # frontier check: a swept point where dynamic batching beats fixed
    # per-query serving on throughput at equal-or-better p99
    wins = []
    for (plan, cap, f), r in results.items():
        base = results.get((plan, 1, f))
        if base is None or cap == 1:
            continue
        if (r.achieved_qps >= 1.05 * base.achieved_qps
                and r.p99_ms <= base.p99_ms):
            wins.append((plan, cap, f, r.achieved_qps / base.achieved_qps,
                         base.p99_ms, r.p99_ms))
    for plan, cap, f, gain, p99_base, p99 in wins:
        print(f"WIN plan={plan} capacity={cap} load={f}x: "
              f"{gain:.2f}x QPS of per-query at p99 {p99:.2f}ms "
              f"(vs {p99_base:.2f}ms)")
    if not wins:
        print("WARNING: no swept point showed dynamic batching dominating "
              "per-query serving — raise --load-factors past saturation")
    if args.emit_json:
        best = max(wins, key=lambda w: w[3], default=None)
        detail = ("a swept point where dynamic batching beats fixed "
                  "per-query serving by >=1.05x achieved QPS at "
                  "equal-or-better p99")
        if best:
            detail += (f": best {best[3]:.2f}x at plan={best[0]} "
                       f"capacity={best[1]} load={best[2]}x "
                       f"(p99 {best[5]:.2f}ms vs {best[4]:.2f}ms)")
        claims = [("batching_frontier", bool(wins), detail)]
        print_claims("engine_serve", claims, block)
        write_bench_json("engine_serve", claims, {
            "wins": [{"plan": p, "capacity": c, "load_factor": f,
                      "qps_gain": g, "p99_ms_base": pb, "p99_ms": pp}
                     for p, c, f, g, pb, pp in wins],
            "sweep": [{"plan": p, "capacity": c, "load_factor": f,
                       "achieved_qps": r.achieved_qps,
                       "mean_batch": r.mean_batch_queries,
                       "p50_ms": r.p50_ms, "p99_ms": r.p99_ms}
                      for (p, c, f), r in sorted(results.items())],
            "s1_ms": s1_ms, "depth": depth, "peak_gb": peak_gb,
            "config": cfg.name, "queries": args.queries,
        }, dev, args.out_dir)
    return 0 if wins else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
