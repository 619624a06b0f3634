"""Host chunk tier on the card: serving tables BIGGER than the device
budget through the host chunk store (``repro_torch.hoststore``).

The counterpart of ``benchmarks/bench_hoststore.py``, with its three
claims, driven from a RECORDED JSONL trace (generate -> record -> reload
-> verify). Chunk FAULT TRAFFIC is real (every ``ensure`` moves real
bytes host -> card, and each step's fault plan is recorded from live
serving); per-query service is priced on the VIRTUAL CLOCK, as the
reference prices it: the measured compute floor plus the modeled swap
stall (``hoststore.overlap_stall`` over a ``host_link`` CALIBRATED so one
steady-state step's swap traffic costs about one step of compute).

  (a) overlap: at depth 4 the swap scheduler's modeled prefetch recovers
      >= 1.3x the QPS of synchronous (depth-1) faulting on the SAME trace.
      The port's faults complete before the step runs (ROADMAP A5), so
      this is the reference's model applied to measured fault plans;
  (b) PCIe sensitivity: the modeled ``hoststore_query_bound`` falls
      monotonically as the link's bandwidth drops across 64 -> 8 GB/s
      (nominal, scaled to the calibrated link), and the per-query p50
      re-priced from the recorded fault plans follows; no new run;
  (c) bit identity: every host-tiered output is bit-identical to the
      all-in-device reference at the same depth -- a correctness claim.

On the card: ``dlrm-rm2-small-unsharded`` at full width, 21.47 GB of fp32
tables in host memory behind a device budget 1.6x too small (13.4 GB),
``host_hot_fraction=0.25``, ``host_chunk_rows=2``, depth 4 against depth
1. The all-in-device reference fits the card, so (c) is real there. The
host tier pools in plain torch (``pool_mode="paired"``), so the reference
serves the composed path (``fused_serve="off"``: row 1 sums in another
order) and both run under ``torch.use_deterministic_algorithms``: the JAX
reference reaches the same jnp path on both sides. The measured transfer
rate (faulted bytes over the transfers' wall time) is printed beside the
calibrated link. ``--reduced`` serves the reference's size
(``cfg.reduced()``, batch 8).

Run: PYTHONPATH=src python -m benchmarks_torch.bench_hoststore
     [--queries 80] [--tiny] [--emit-json] [--trace-dir DIR]
     [--device cpu] [--reduced]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from benchmarks_torch._artifacts import (device_block, device_label,
                                         print_claims, write_bench_json)
from benchmarks_torch._fleet import (Cuts, memory_line, recorded, release,
                                     trace_dir)
from repro_torch.configs.registry import get_dlrm
from repro_torch.core import perf_model
from repro_torch.core.perf_model import host_swap_time
from repro_torch.device import resolve_device
from repro_torch.engine import Engine
from repro_torch.hoststore import overlap_stall
from repro_torch.obs import default_registry
from repro_torch.traffic import make_scenario, materialize_query


def _serve_trace(session, cfg, events, device):
    """Serve every event in qid order; return (probs, fault plans: the
    host tier's, None for the all-in-device session)."""
    probs, plans = [], []
    for ev in events:
        p, _, _ = session._execute([materialize_query(cfg, ev,
                                                      device=device)])
        probs.append(p)
        plans.append(getattr(session.exchange, "_last_plan", None))
    return probs, plans


def _virtual_service(plans, floor_s, link):
    """Per-query virtual-clock service: compute floor + the swap stall the
    plan's recorded fault traffic exposes under ``link`` at its depth."""
    out = []
    for plan in plans:
        swap_s = [host_swap_time(st.bytes_moved, link,
                                 n_transfers=st.faulted_chunks
                                 + st.writebacks)
                  for st in plan.stats]
        out.append(floor_s + overlap_stall(swap_s, floor_s, plan.depth))
    return np.asarray(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="dlrm-rm2-small-unsharded")
    ap.add_argument("--queries", type=int, default=None,
                    help="queries a trace (default 80, 40 with --tiny)")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke size (40 queries)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--alpha", type=float, default=1.05)
    ap.add_argument("--depth", type=int, default=4,
                    help="overlap pipeline depth (the sync baseline is 1)")
    ap.add_argument("--over-budget", type=float, default=1.6,
                    help="tables exceed the device budget by this factor")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's size: cfg.reduced(), batch 8")
    ap.add_argument("--emit-json", action="store_true",
                    help="write BENCH_torch_hoststore.json")
    ap.add_argument("--out-dir", default=None,
                    help="where --emit-json writes (default build/bench/)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    block = device_block(dev)

    n = args.queries or (40 if args.tiny else 80)
    cfg = get_dlrm(args.config)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), batch_size=8)
    cuts = Cuts()
    tdir = trace_dir(args)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    failures: List[str] = []
    claims = []

    # the device "budget" the tables exceed: actual fp32 table bytes / 1.6
    actual = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    cap_mb = (actual / args.over_budget) / 2 ** 20
    # chunk_rows=2 keeps the per-step working set within the chunk cache
    # (the step pins its FULL working set -- see hoststore.plan_swaps)
    host_kw = dict(host_capacity_mb=cap_mb, host_hot_fraction=0.25,
                   host_chunk_rows=2)
    print(f"# {cfg.name}: tables {actual / 2**20:.3f} MiB vs device budget "
          f"{cap_mb:.3f} MiB ({args.over_budget:.1f}x over), batch "
          f"{cfg.batch_size}, on {device_label(block)}")

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # ---- reference (SAME depth as the host run) + compute floor ------
        ref = Engine(cfg, alpha=args.alpha, seed=args.seed,
                     pipeline_depth=args.depth, fused_serve="off",
                     device=dev).serve_session(max_batch_queries=1)
        floor_s = ref.measure_service_time(alpha=args.alpha)
        events = recorded(
            make_scenario("stationary", alpha=args.alpha), n,
            qps=0.5 / floor_s, seed=args.seed,
            path=os.path.join(tdir, "hoststore_zipf.jsonl"))

        # ---- serve the trace: sync (depth 1) and overlapped (depth k) ----
        runs = {}
        for depth in (1, args.depth):
            s = Engine(cfg, alpha=args.alpha, seed=args.seed,
                       pipeline_depth=depth, device=dev,
                       **host_kw).serve_session(max_batch_queries=1)
            runs[depth] = _serve_trace(s, cfg, events, dev)
            print(f"depth {depth}: {s.exchange.summary()}")
            del s
            release(dev)
            memory_line(f"host tier at depth {depth}", dev)
        probs_host, plans_over = runs[args.depth]
        _, plans_sync = runs[1]

        # ---- (c) bit-identity guard --------------------------------------
        probs_ref, _ = _serve_trace(ref, cfg, events, dev)
        del ref
        release(dev)
    finally:
        torch.use_deterministic_algorithms(deterministic)

    # calibrate the PCIe link off the sync run's steady-state traffic:
    # one step's swap ~ one step of compute (where overlap matters)
    warm = plans_sync[min(8, n // 4):]
    step_bytes = float(np.median([p.bytes_moved for p in warm]))
    bw_cal = max(step_bytes / max(floor_s, 1e-6), 1e6)
    link_cal = perf_model.host_link(latency_us=0.0,
                                    bandwidth_gbs=bw_cal / 1e9)
    moved = sum(p.bytes_moved for p in plans_sync + plans_over)
    copy_s = sum(p.copy_s for p in plans_sync + plans_over)
    rate = moved / copy_s if copy_s > 0 else float("nan")
    print(f"compute floor {floor_s * 1e3:.2f} ms, steady swap "
          f"{step_bytes / 1024:.1f} KiB/step -> calibrated PCIe "
          f"{bw_cal / 1e9:.4f} GB/s; measured transfer {moved / 1e9:.3f} GB "
          f"in {copy_s:.3f} s = {rate / 1e9:.3f} GB/s "
          f"({device_label(block)})")

    # ---- (a) overlap: sync vs prefetch on the virtual clock --------------
    svc_sync = _virtual_service(plans_sync, floor_s, link_cal)
    svc_over = _virtual_service(plans_over, floor_s, link_cal)
    qps_sync = n / float(svc_sync.sum())
    qps_over = n / float(svc_over.sum())
    speedup = qps_over / qps_sync
    ok = speedup >= 1.3
    detail = (f"depth-{args.depth} prefetch {qps_over:.1f} qps vs "
              f"sync {qps_sync:.1f} qps = {speedup:.2f}x "
              f"(need >= 1.3x) at Zipf {args.alpha:g}")
    claims.append(("overlap", ok, detail))
    print(("WIN overlap: " if ok else "") + detail)
    if not ok:
        failures.append(f"overlap: {detail}")

    # ---- (b) PCIe sweep: model monotone, per-query p50 follows -----------
    hit, bound, p50 = pcie_sweep(cfg, plans_over, floor_s, bw_cal,
                                 args.depth)
    sweep_gbs = sorted(bound)
    model_mono = all(bound[a] > bound[b]
                     for a, b in zip(sweep_gbs, sweep_gbs[1:]))
    meas_follows = all(p50[a] >= p50[b]
                       for a, b in zip(sweep_gbs, sweep_gbs[1:])) \
        and p50[sweep_gbs[0]] > p50[sweep_gbs[-1]]
    ok = model_mono and meas_follows
    detail = (f"modeled bound monotone over {sweep_gbs[0]:.0f}->"
              f"{sweep_gbs[-1]:.0f} GB/s: {model_mono}; p50 follows: "
              f"{p50[sweep_gbs[0]]:.3f} ms @ {sweep_gbs[0]:.0f} GB/s -> "
              f"{p50[sweep_gbs[-1]]:.3f} ms @ {sweep_gbs[-1]:.0f} GB/s")
    claims.append(("pcie_sweep", ok, detail))
    print(("WIN pcie-sweep: " if ok else "") + detail)
    if not ok:
        failures.append(f"pcie_sweep: {detail}")

    drift = [ev.qid for ev, a, b in zip(events, probs_ref, probs_host)
             if not np.array_equal(a, b)]
    ok = not drift
    detail = (f"all {n} host-tiered queries bit-identical to the "
              f"all-in-device reference" if ok else
              f"{len(drift)} queries diverged (first qid={drift[0]})")
    claims.append(("bit_identity", ok, detail))
    print(("WIN bit-identity: " if ok else "") + detail)
    if not ok:
        failures.append(f"bit_identity: {detail}")

    print_claims("hoststore", claims, block)
    if args.emit_json:
        write_bench_json("hoststore", claims, {
            "queries": n, "alpha": args.alpha, "depth": args.depth,
            "over_budget": args.over_budget,
            "table_mib": actual / 2 ** 20, "budget_mib": cap_mb,
            "compute_floor_ms": floor_s * 1e3,
            "calibrated_gbs": bw_cal / 1e9,
            "steady_swap_kib_per_step": step_bytes / 1024,
            "qps_sync": qps_sync, "qps_overlap": qps_over,
            "overlap_speedup": speedup,
            "chunk_hit_ratio": hit,
            "modeled_t_step_us": {f"{g:.0f}": bound[g] * 1e6
                                  for g in sweep_gbs},
            "p50_ms": {f"{g:.0f}": p50[g] for g in sweep_gbs},
            "cuts": cuts.cuts,
        }, dev, args.out_dir, metrics=default_registry().snapshot())

    print(f"\ntrace: {tdir}")
    if failures:
        for f in failures:
            print(f"FAILED CLAIM: {f}")
        return 1
    return 0


def pcie_sweep(cfg, plans, floor_s, bw_cal, depth):
    """(b): the chunk hit ratio of ``plans``, then at each nominal PCIe
    generation (scaled so 16 GB/s is the calibrated link) the modeled
    step time and the re-priced p50 (ms); prints each point."""
    hit = np.mean([p.faulted_chunks
                   / max(1, sum(st.needed_chunks for st in p.stats))
                   for p in plans])
    hit = float(1.0 - hit)
    scale = bw_cal / (16.0 * 1e9)
    bound, p50 = {}, {}
    for gbs in (8.0, 16.0, 32.0, 64.0):
        link = perf_model.host_link(latency_us=0.0,
                                    bandwidth_gbs=gbs * scale)
        bd = perf_model.hoststore_query_bound(
            cfg, perf_model.recspeed_system(), link,
            device_hit_ratio=hit, chunk_rows=2, pipeline_depth=depth)
        bound[gbs] = bd.t_step
        p50[gbs] = float(np.median(
            _virtual_service(plans, floor_s, link)) * 1e3)
        print(f"  {gbs:5.0f} GB/s nominal: modeled t_step "
              f"{bd.t_step * 1e6:7.1f} us (qps bound {bd.qps:7.0f}), "
              f"p50 {p50[gbs]:.3f} ms")
    return hit, bound, p50


if __name__ == "__main__":
    import sys
    sys.exit(main())
