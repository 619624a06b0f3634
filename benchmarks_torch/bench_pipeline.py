"""Micro-batch pipeline sweep: depth x exchange x batch, on the card.

The counterpart of ``benchmarks/bench_pipeline.py``; two views of one
question, how much exchange time micro-batch pipelining
(``repro_torch.parallel.build_step``, ``pipeline_depth=k``) hides behind
MLP compute:

  1. MODEL: ``perf_model.pipelined_breakdown`` on the RecSpeed system,
     swept over depth x exchange x batch, copied whole from the
     reference: its output equals the reference's.
  2. MEASURED: the serve step's wall clock (host clock, ending in a
     synchronize of the card) in process on the one card, at n = 1 (so a
     depth needs ``B % k``, not ``B % (k * n)``), for
     ``dlrm-rm2-small-unsharded`` (table-wise, the fused serve kernel)
     and ``dlrm-rm2-small-sharded`` in both wire modes (row-wise at n=1,
     composed) at full width, all on one table set. At n = 1 no exchange
     is on the wire, so this times what depth costs: k launches of
     everything where depth 1 makes one. ``dlrm-rm2-large-sharded`` does
     not fit one card (its tables go to the host tier) and is skipped with
     its reason; the exchange sweep across ranks waits for k ranks
     (ROADMAP A6b). ``--reduced`` times the reference's ``.reduced()``
     configs, all four.

  PYTHONPATH=src python -m benchmarks_torch.bench_pipeline [--tiny]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
from typing import List, Optional

import torch

from benchmarks_torch._artifacts import (device_block, device_label,
                                         print_claims, write_bench_json)
from benchmarks_torch._timing import host_median_s
from repro_torch.device import resolve_device

CONFIGS = [
    # (registry name, row-wise exchange mode or None for table_wise)
    ("dlrm-rm2-small-unsharded", None),
    ("dlrm-rm2-small-sharded", "partial_pool"),
    ("dlrm-rm2-small-sharded", "unpooled"),
    ("dlrm-rm2-large-sharded", "partial_pool"),
]


# ---------------------------------------------------------------------------
# Part 1: executed-schedule model sweep
# ---------------------------------------------------------------------------
def model_sweep(batches: List[int], depths: List[int], mode: str):
    """Returns (any_win, best) where best is the strongest modeled
    (config, exchange, batch, depth, speedup) row."""
    from repro_torch.configs.registry import get_dlrm
    from repro_torch.core import perf_model

    sys_cfg = perf_model.recspeed_system()
    print(f"# model: executed schedule on {sys_cfg.name} "
          f"(n={sys_cfg.n_chips}), mode={mode}")
    print("config,exchange,batch,depth,t_step_us,stage_exch_us,"
          "stage_comp_us,overlap_us,speedup_vs_serial,best")
    any_win = False
    top = None
    for name, exch in CONFIGS:
        cfg = get_dlrm(name)
        exch_label = exch or "pooled_a2a"
        for B in batches:
            bcfg = dataclasses.replace(cfg, batch_size=B)
            rows = {}
            for k in depths:
                if B % (k * sys_cfg.n_chips):
                    continue
                rows[k] = perf_model.pipelined_breakdown(
                    bcfg, sys_cfg, mode, pipeline_depth=k,
                    row_wise_exchange=exch or "unpooled")
            if not rows:
                continue
            t1 = rows.get(1).t_step if 1 in rows else None
            best = min(rows, key=lambda k: rows[k].t_step)
            for k, bd in sorted(rows.items()):
                nt = bd.notes
                speed = (t1 / bd.t_step) if t1 else float("nan")
                print(f"{name},{exch_label},{B},{k},{bd.t_step*1e6:.1f},"
                      f"{nt['t_stage_exchange_mb']*1e6:.2f},"
                      f"{nt['t_stage_compute_mb']*1e6:.2f},"
                      f"{nt['pipeline_overlap']*1e6:.1f},"
                      f"{speed:.2f}x,{'*' if k == best else ''}")
            if best > 1:
                any_win = True
                speed_best = (t1 / rows[best].t_step) if t1 else 0.0
                if top is None or speed_best > top["speedup"]:
                    top = {"config": name, "exchange": exch_label,
                           "batch": B, "depth": best,
                           "speedup": speed_best}
    print(f"model: pipeline_depth>1 beats the serial schedule on at least "
          f"one swept config: {any_win}")
    return any_win, top


# ---------------------------------------------------------------------------
# Part 2: measured serve-step sweep at n = 1, in process
# ---------------------------------------------------------------------------
def _fits(cfg, dev: torch.device) -> bool:
    """Whether the config's fp32 tables fit the device's memory."""
    if dev.type != "cuda":
        return True
    table_bytes = (cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4)
    return table_bytes < torch.cuda.get_device_properties(dev).total_memory


def measured_sweep(batches: List[int], depths: List[int], iters: int,
                   rounds: int, dev: torch.device, reduced: bool
                   ) -> List[dict]:
    """The serve step's median seconds a call at each (config, exchange,
    batch, depth) with ``B % depth == 0``; one table set a width, shared
    by the configs of that width."""
    from repro_torch.configs.registry import get_dlrm
    from repro_torch.core import dlrm as dlrm_lib
    from repro_torch.data import make_recsys_batch
    from repro_torch.parallel import build_step, make_exchange

    print(f"# measured: serve step at n=1 on {device_label(device_block(dev))}"
          f" (host clock to the end of the device's work)")
    print("config,exchange,batch,depth,t_step_ms,speedup_vs_serial,best")
    rows = []
    params, params_width = None, None
    for name, exch in CONFIGS:
        cfg = get_dlrm(name)
        if reduced:
            cfg = cfg.reduced()
        exch_label = exch or "pooled_a2a"
        if not _fits(cfg, dev):
            gb = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4 / 1e9
            print(f"# skip {name},{exch_label}: {gb:.1f} GB of fp32 tables "
                  f"do not fit one card (the host tier serves it)")
            continue
        width = (cfg.num_tables, cfg.rows_per_table, cfg.embed_dim)
        if width != params_width:
            params = None
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            params = dlrm_lib.init_dlrm(
                cfg, torch.Generator(device=dev).manual_seed(0))
            params_width = width
        for B in batches:
            bcfg = dataclasses.replace(cfg, batch_size=B)
            b = make_recsys_batch(bcfg, 0, device=dev)
            exchange = make_exchange(bcfg, row_wise_exchange=exch
                                     or "partial_pool", device=dev)
            times = {}
            for k in depths:
                if B % k:
                    continue
                step = build_step(bcfg, mode="serve", exchange=exchange,
                                  pipeline_depth=k)
                times[k] = host_median_s(
                    lambda: step(params, b["dense"], b["indices"]),
                    rounds, iters, dev)
            if not times:
                continue
            t1 = times.get(1)
            best = min(times, key=times.get)
            for k, t in sorted(times.items()):
                speed = (t1 / t) if t1 else float("nan")
                print(f"{name},{exch_label},{B},{k},{t*1e3:.4f},"
                      f"{speed:.2f}x,{'*' if k == best else ''}")
                rows.append({"config": name, "exchange": exch_label,
                             "batch": B, "depth": k, "t_step_ms": t * 1e3,
                             "speedup": speed})
    del params
    print("# the exchange sweep across ranks waits for k ranks "
          "(ROADMAP A6b): at n=1 no exchange is on the wire")
    return rows


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1024,4096,16384")
    ap.add_argument("--measured-batches", default="256,1024",
                    help="device-timed sweep batches")
    ap.add_argument("--depths", default="1,2,4,8")
    ap.add_argument("--mode", default="training",
                    choices=["inference", "training"])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--no-measure", action="store_true",
                    help="model sweep only (no device timing)")
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized: the query's batch, fewer reps (depth 8 "
                         "stays: it is the planner's at n=1)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--reduced", action="store_true",
                    help="time the configs' .reduced(), the reference's "
                         "size")
    ap.add_argument("--emit-json", action="store_true",
                    help="write BENCH_torch_pipeline.json (claims + scalars)")
    ap.add_argument("--out-dir", default=None,
                    help="where --emit-json writes (default build/bench/)")
    args = ap.parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]
    measured_batches = [int(b) for b in args.measured_batches.split(",")]
    depths = [int(d) for d in args.depths.split(",")]
    if args.tiny:
        measured_batches, batches = [200], [4096]
        args.iters, args.rounds = 2, 3
    ok, top = model_sweep(batches, depths, args.mode)
    measured = []
    dev = None
    if not args.no_measure:
        dev = resolve_device(args.device)
        measured = measured_sweep(measured_batches, depths, args.iters,
                                  args.rounds, dev, args.reduced)
    if args.emit_json:
        claims = [("model_overlap", ok,
                   "modeled executed schedule: pipeline_depth>1 beats the "
                   "serial schedule on at least one swept config"
                   + (f" (best {top['speedup']:.2f}x at depth "
                      f"{top['depth']} on {top['config']}/"
                      f"{top['exchange']} B={top['batch']})" if top
                      else ""))]
        if not args.no_measure:
            deep = [r for r in measured if r["depth"] > 1]
            worst = min((r["speedup"] for r in deep), default=0.0)
            meas_ok = bool(deep) and worst >= 0.5
            claims.append((
                "measured_overhead", meas_ok,
                f"serve step at n=1: {len(deep)} pipelined timings "
                f"collected, worst depth>1 speedup {worst:.2f}x against "
                f"the reference's floor of 0.5x (no exchange on the wire "
                f"to hide at n=1)"))
        dev = dev or resolve_device(args.device)
        print_claims("pipeline", claims, device_block(dev))
        write_bench_json("pipeline", claims, {
            "model_best": top,
            "measured_rows": measured,
        }, dev, args.out_dir)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
