"""Online serving on the card: streamed row updates against periodic
lfu_refresh.

The counterpart of ``benchmarks/bench_online.py``, judged on a RECORDED
zipf_drift trace (generate -> record -> reload -> verify) served by a
sharded fleet over a slow fabric:

  (a) accuracy: continuous training streamed into the live fleet beats
      frozen-after-pretrain serving on the accuracy proxy, the expected
      log-loss of served click probabilities against the planted teacher
      (``repro_torch.online.teacher_probs``). Both arms serve the SAME
      pretrained weights (dense + tables, the dense frozen after), so the
      streamed tables-only updates are the only difference between them;
  (b) sla: the online arm's p99 stays within C_SLA while the whole update
      stream rides the serving fabric (each push priced on the owner's
      lane, ``update_stall`` in the attribution);
  (c) bit_identity: the k-board online fleet serves every query
      bit-identical to the 1-board online reference -- a correctness
      claim;
  (d) closure: the seven-component latency attribution sums exactly to
      each query's latency -- a correctness claim.

Pretraining. The reference pretrains with a jitted dense
``value_and_grad`` over every parameter, tables included; at full width
that is a 21.47 GB table gradient a step. The port runs its own SGD train
step (``parallel.build.build_step(mode="train")``: dense gradients for
the MLPs, the tables' rows updated sparsely from the pooled gradient) on
the same batches, ``make_recsys_batch(cfg, 10_000 + s, seed, alpha,
batch_size=128)``, at the same rate: mathematically the same update
(``pretrain``).

On the card: ``dlrm-rm2-small-unsharded`` at full width, the boards and
the 1-board reference sharing the card, the tables drawn on it,
pretrained there, then kept in host memory and served by every fleet
through ``params=``. Fleets run one after another and are released in
turn; the trainer produces its whole stream before the fleets run (the
reference's record-then-replay) and is released too, so the host holds
the pretrained tables and one fleet's copy on its first write. At full
width few samples reach each of 4.2 M rows a table, so the accuracy claim
is a measurement there, not the reference's 512-row learning regime. A
channel whose JSONL text would pass ``MAX_RECORD_MB`` is kept in memory
and not recorded (a cut): the format writes each value as decimal text.
``--reduced`` serves the reference's size (``cfg.reduced()``, batch 8,
512 rows a table).

Run: PYTHONPATH=src python -m benchmarks_torch.bench_online [--queries 120]
     [--tiny] [--emit-json] [--device cpu] [--reduced]
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
from benchmarks_torch._fleet import (Cuts, fp32_table_bytes, memory_line,
                                     recorded, release, trace_dir)
from repro_torch.configs.registry import get_dlrm
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.core import perf_model
from repro_torch.data.recsys import make_recsys_batch
from repro_torch.device import resolve_device
from repro_torch.fabric import ShardedFleet
from repro_torch.obs.attribution import COMPONENTS
from repro_torch.online import (DeltaChannel, OnlineSource, OnlineTrainer,
                                expected_logloss, teacher_probs)
from repro_torch.parallel.build import build_step
from repro_torch.parallel.exchange import make_exchange
from repro_torch.traffic import make_scenario

# bytes of JSONL text a recorded row takes, per value (decimal floats),
# and the most text the delta channel is recorded as
RECORD_BYTES_PER_VALUE = 20
MAX_RECORD_MB = 256.0


def pretrain(cfg, params, steps: int, *, seed: int, alpha: float,
             lr: float = 0.2, start: int = 10_000, batch_size: int = 128,
             device=None):
    """``steps`` SGD steps on ``params`` in place (dense and tables), on
    batches ``start + s`` of the stream; returns the last step's loss."""
    step = build_step(cfg, mode="train", pipeline_depth=1, optimizer="sgd",
                      lr=lr, exchange=make_exchange(cfg, device=device))
    loss = torch.zeros(())
    for s in range(steps):
        b = make_recsys_batch(cfg, start + s, seed, alpha,
                              batch_size=batch_size, device=device)
        params, _, loss = step(params, None, b["dense"], b["indices"],
                               b["labels"])
    return float(loss)


def _accuracy_proxy(cfg, events, completed, device) -> float:
    """Mean expected log-loss of served probabilities against the planted
    teacher, over every query of the trace."""
    losses = [expected_logloss(teacher_probs(cfg, ev, cfg.batch_size,
                                             device=device),
                               completed[ev.qid].probs)
              for ev in events]
    return float(np.mean(losses))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="dlrm-rm2-small-unsharded")
    ap.add_argument("--queries", type=int, default=None,
                    help="queries a trace (default 120, 60 with --tiny)")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke size (fewer queries, fewer steps an update)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--alpha", type=float, default=1.05)
    ap.add_argument("--boards", type=int, default=2)
    ap.add_argument("--pretrain-steps", type=int, default=600,
                    help="shared full-SGD warm-up steps, the snapshot both "
                         "arms start from")
    ap.add_argument("--online-lr", type=float, default=1.0,
                    help="tables-only SGD rate for the streamed updates")
    ap.add_argument("--online-batch", type=int, default=256)
    ap.add_argument("--steps-per-update", type=int, default=None,
                    help="trainer steps folded into one delta batch "
                         "(default 24 with --tiny, else 32)")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's size: cfg.reduced(), batch 8, "
                         "512 rows a table")
    ap.add_argument("--emit-json", action="store_true",
                    help="write BENCH_torch_online.json (claims + scalars "
                         "+ the online run's metrics snapshot)")
    ap.add_argument("--out-dir", default=None,
                    help="where --emit-json writes (default build/bench/)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    block = device_block(dev)

    n = args.queries or (60 if args.tiny else 120)
    pre_steps = args.pretrain_steps
    cfg = get_dlrm(args.config)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), batch_size=8,
                                  rows_per_table=512)
    cuts = Cuts()
    boards = args.boards
    tdir = trace_dir(args)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    failures: List[str] = []
    claims = []
    total = sum(fp32_table_bytes(cfg))
    cap = int(np.ceil(1.25 * total / boards))
    print(f"# {cfg.name}: {cfg.num_tables} x {cfg.rows_per_table} x "
          f"{cfg.embed_dim} fp32 tables ({total / 1e9:.2f} GB), batch "
          f"{cfg.batch_size}, on {device_label(block)}")
    # constrained fabric: each delta batch costs owner lane time, so
    # update_stall is a real tail component the sla claim has to absorb
    link = perf_model.fabric_link(100.0, 0.03)
    common = dict(alpha=args.alpha, seed=args.seed, profile_batches=32,
                  max_batch_queries=4, max_wait_ms=25.0, router="jsq",
                  link=link, device=dev)

    # -- shared pretraining: full SGD (dense + tables) ----------------------
    # Both arms serve from this checkpoint; the dense MLPs are frozen from
    # here on. start=10_000 offsets the batch stream past every eval qid.
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params_pre = dlrm_lib.init_dlrm(cfg, gen)
    pre_loss = pretrain(cfg, params_pre, pre_steps, seed=args.seed,
                        alpha=args.alpha, device=dev)
    params_pre["tables"] = params_pre["tables"].cpu()
    release(dev)
    print(f"pretrain: {pre_steps} full-SGD steps, loss {pre_loss:.4f} "
          f"({time.perf_counter() - t0:.1f} s)")

    def make_fleet(k):
        c = total if k == 1 else cap
        return ShardedFleet(cfg, n_boards=k, board_capacity_bytes=c,
                            params=params_pre, **common)

    # -- load + trace: zipf_drift with ~3 rotations over the horizon -------
    # the k-board fleet measures the load, then serves as the frozen arm
    # (measuring leaves no state behind): one 21.47 GB build fewer
    frozen = make_fleet(boards)
    s_cap = frozen.measure_service_time()
    sla_ms = (25.0 * s_cap / common["max_batch_queries"]
              + 2.0 * common["max_wait_ms"] / 1e3) * 1e3
    qps = 0.3 * common["max_batch_queries"] / s_cap
    horizon = n / qps
    rotate_every_s = horizon / 3.0
    print(f"capacity batch {s_cap * 1e3:.2f} ms -> C_SLA {sla_ms:.1f} ms, "
          f"offered {qps:.0f} qps, horizon {horizon:.2f}s, rotation every "
          f"{rotate_every_s:.2f}s")
    scenario = make_scenario("zipf_drift", alpha=args.alpha,
                             rotate_every_s=rotate_every_s, salt_stride=37)
    events = recorded(scenario, n, qps, args.seed,
                      os.path.join(tdir, "online_drift.jsonl"))
    horizon = events[-1].arrival_s

    # -- online stream: one batch an update interval, salt tracking drift --
    # tables-only SGD from the shared checkpoint; many steps fold into ONE
    # delta batch an interval (rows touched repeatedly ship once)
    t0 = time.perf_counter()
    trainer = OnlineTrainer(cfg, params_pre, lr=args.online_lr,
                            seed=args.seed, alpha=args.alpha,
                            batch_size=args.online_batch,
                            start_step=10_000 + pre_steps, device=dev)
    steps_per_update = args.steps_per_update or (24 if args.tiny else 32)
    source = OnlineSource(trainer, interval_s=horizon / 8.0,
                          steps_per_update=steps_per_update,
                          salt_fn=lambda t: scenario.stream_params(t)[1])
    online_batches = source.run_to(horizon).emitted
    del trainer, source
    release(dev)
    stream_rows = sum(b.n_rows for b in online_batches)
    print(f"stream: {len(online_batches)} update batches, "
          f"{stream_rows} row updates ({time.perf_counter() - t0:.1f} s)")
    memory_line("after the trainer", dev)
    # record -> reload -> verify, like the query trace, where the text fits
    text_mb = stream_rows * cfg.embed_dim * RECORD_BYTES_PER_VALUE / 2**20
    if text_mb <= MAX_RECORD_MB:
        delta_path = os.path.join(tdir, "online_deltas.jsonl")
        DeltaChannel(online_batches).record(delta_path)
        batches = DeltaChannel.load(delta_path).emitted
        assert len(batches) == len(online_batches)
    else:
        cuts.add("delta_channel_jsonl", "recorded and reloaded",
                 "kept in memory",
                 f"{stream_rows} rows would be ~{text_mb:.0f} MB of JSONL "
                 f"text")
        batches = online_batches

    def run(fleet, stream, label):
        ch = DeltaChannel(stream) if stream else None
        r = fleet.run(events, sla_ms=sla_ms, percentile=99.0,
                      scenario="zipf_drift", online=ch,
                      coherence="propagate")
        acc = _accuracy_proxy(cfg, events, fleet.completed, dev)
        print(f"[{label}] p50={r.p50_ms:.2f}ms p99={r.p99_ms:.2f}ms "
              f"accuracy-proxy={acc:.4f}")
        return r, acc

    # -- the two arms on the recorded trace --------------------------------
    print(f"\n== frozen-after-pretrain baseline (lfu_refresh only) vs "
          f"streamed online updates, {boards} boards")
    r_frozen, acc_frozen = run(frozen, None, "frozen")
    del frozen
    release(dev)
    fleet = make_fleet(boards)
    r_online, acc_online = run(fleet, batches, "online")
    print(r_online.summary())
    online_probs = {q: f.probs for q, f in fleet.completed.items()}
    records = fleet.attribution.records
    online_metrics = fleet.metrics.snapshot()
    del fleet
    release(dev)
    memory_line("after the online arm", dev)

    # (a) accuracy
    acc_ok = bool(acc_online < acc_frozen)
    claims.append(("accuracy", acc_ok,
                   f"expected log-loss vs teacher {acc_online:.4f} (online) "
                   f"< {acc_frozen:.4f} (frozen+lfu_refresh), same "
                   f"{pre_steps}-step pretrained checkpoint"))
    if acc_ok:
        print(f"WIN accuracy: proxy {acc_frozen:.5f} -> {acc_online:.5f} "
              f"(gap {acc_frozen - acc_online:.2e}, "
              f"{(acc_frozen - acc_online) / acc_frozen * 100:.2f}% better) "
              f"with streamed updates")
    else:
        failures.append(f"accuracy: online {acc_online:.5f} >= "
                        f"frozen {acc_frozen:.5f}")

    # (b) within-SLA p99 while the whole stream rides the serving fabric
    push_kib = r_online.online.push_bytes / 1024.0
    sla_ok = bool(r_online.p99_ms <= sla_ms)
    claims.append(("sla", sla_ok,
                   f"online p99 {r_online.p99_ms:.2f}ms <= C_SLA "
                   f"{sla_ms:.1f}ms with {push_kib:.0f} KiB of live "
                   f"updates streamed (frozen no-stream floor "
                   f"{r_frozen.p99_ms:.2f}ms)"))
    if sla_ok:
        print(f"WIN sla: online p99 {r_online.p99_ms:.2f} ms within C_SLA "
              f"{sla_ms:.1f} ms while streaming {push_kib:.0f} KiB of "
              f"updates (frozen floor {r_frozen.p99_ms:.2f} ms)")
    else:
        failures.append(f"sla: online p99 {r_online.p99_ms:.2f}ms vs "
                        f"C_SLA {sla_ms:.1f}ms (frozen floor "
                        f"{r_frozen.p99_ms:.2f}ms)")

    # (c) k-board vs 1-board bit-identity across the whole interleaving
    print(f"\n== bit-identity: {boards}-board online vs 1-board reference")
    ref_fleet = make_fleet(1)
    ref_fleet.run(events, sla_ms=sla_ms, percentile=99.0,
                  scenario="zipf_drift", online=DeltaChannel(batches),
                  coherence="propagate")
    mismatches = [ev.qid for ev in events
                  if not np.array_equal(ref_fleet.completed[ev.qid].probs,
                                        online_probs[ev.qid])]
    del ref_fleet, params_pre
    release(dev)
    memory_line("after the 1-board reference", dev)
    bit_ok = not mismatches
    claims.append(("bit_identity", bit_ok,
                   f"{n} queries served bit-identical between 1 and "
                   f"{boards} boards under {len(batches)} live "
                   f"update batches"))
    if bit_ok:
        print(f"WIN bit_identity: all {n} queries identical across fleet "
              f"sizes at every interleaving point")
    else:
        failures.append(f"bit_identity: {len(mismatches)} queries diverged "
                        f"(first: {mismatches[:5]})")

    # (d) attribution closure with update_stall
    resid = max(abs(sum(getattr(rec, c + "_s") for c in COMPONENTS)
                    - rec.latency_s) for rec in records)
    upd_s = sum(rec.update_stall_s for rec in records)
    closure_ok = bool(resid < 1e-9)
    claims.append(("closure", closure_ok,
                   f"7-component attribution closes to {resid * 1e3:.2e}ms "
                   f"over {len(records)} queries "
                   f"({upd_s * 1e3:.2f}ms total update_stall)"))
    if closure_ok:
        print(f"WIN closure: max residual {resid * 1e3:.2e} ms; "
              f"update_stall carved {upd_s * 1e3:.2f} ms across the run")
    else:
        failures.append(f"closure: max residual {resid * 1e3:.2e}ms")

    print(f"\ntraces: {tdir}")
    print_claims("online", claims, block)
    if args.emit_json:
        ol = r_online.online
        write_bench_json("online", claims, {
            "accuracy_proxy_frozen": acc_frozen,
            "accuracy_proxy_online": acc_online,
            "p99_ms_frozen": r_frozen.p99_ms,
            "p99_ms_online": r_online.p99_ms,
            "sla_ms": sla_ms,
            "n_update_batches": ol.n_updates,
            "rows_pushed": ol.rows_pushed,
            "rows_propagated": ol.rows_propagated,
            "push_bytes": ol.push_bytes,
            "staleness_p50_s": ol.staleness_p50_s,
            "staleness_max_s": ol.staleness_max_s,
            "update_stall_total_ms": upd_s * 1e3,
            "remote_hit_frozen": r_frozen.remote_hit_last,
            "remote_hit_online": r_online.remote_hit_last,
            "bytes_per_query_frozen": r_frozen.bytes_per_query,
            "bytes_per_query_online": r_online.bytes_per_query,
            "cuts": cuts.cuts,
        }, dev, args.out_dir, metrics=online_metrics)
    if failures:
        for f in failures:
            print(f"FAILED CLAIM: {f}")
        return 1
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
