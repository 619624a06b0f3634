"""Serving launcher: a thin argparse adapter over ``repro_torch.engine``.

Implements the deployment scenario of paper Sec. III-B / Fig. 3 on one
device: queries of size B are ranked under the SLA constraint
PPF(D_Q, P) <= C_SLA (Eq. 1). Runs on the card unless ``--device cpu``.

  # closed loop (one query at a time, the per-query service floor)
  PYTHONPATH=src python -m repro_torch.launch.serve --queries 200

  # open loop: Poisson arrivals at 300 QPS, dynamic micro-batching
  PYTHONPATH=src python -m repro_torch.launch.serve --queries 200 \\
      --qps 300 --max-batch-queries 4 --max-wait-ms 2

  # planner placement: profile the stream, place tables in the fast and
  # bulk tiers, serve through the tiered fused kernel; prints "[plan] ..."
  PYTHONPATH=src python -m repro_torch.launch.serve --plan auto --alpha 1.05

  # the reduced config on the CPU, through the plain PyTorch path
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

  # row-wise sharding ("full sharding"), composed, in the paper's wire mode
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --config dlrm-rm2-small-sharded --exchange unpooled

  # the host chunk tier: full weights in host memory, a hot slab and a
  # chunk cache inside a device budget smaller than the tables
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --host-capacity-mb 0.1 --alpha 1.05

  # observability: a Chrome trace of the run's virtual clock, the metrics
  # registry's snapshot and the SLA report as JSON
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --trace-out t.json --metrics-out m.json --report-json r.json

  # fleet: 2 replicas under a flash-crowd burst, p2c routing, autoscaling
  PYTHONPATH=src python -m repro_torch.launch.serve --queries 100 \\
      --replicas 2 --scenario flash_crowd --router p2c --autoscale

  # sharded fleet: 3 boards of 7,000 MiB TOGETHER hold the 20,480 MiB
  # model (a table split into row ranges), lookups over a modeled fabric
  PYTHONPATH=src python -m repro_torch.launch.serve --queries 100 \\
      --replicas 3 --fleet-mode sharded --board-capacity-mb 7000 \\
      --alpha 1.05 --router jsq

  # online updates: a tables-only trainer emits row deltas every 50 ms of
  # virtual time into a 2-replica fleet (recorded for replay), then the
  # recording replayed into a sharded fleet whose caches invalidate
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --replicas 2 --scenario zipf_drift --online-every-s 0.05 \\
      --record-deltas d.jsonl
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --replicas 3 --fleet-mode sharded --replay-deltas d.jsonl \\
      --coherence invalidate

Any of --replicas>1 / --scenario / --autoscale / --record-trace /
--replay-trace routes through the cluster path (``repro_torch.cluster``):
a ``TrafficScenario`` event stream (or a recorded JSONL trace) served by
N replica boards behind the chosen router. ``--fleet-mode sharded`` routes
through the sharded fleet (``repro_torch.fabric``) instead, ``--replicas``
being its board count. On one card the boards share the device, each on
its own virtual busy horizon. The online flags (``--online-*``,
``--coherence``, ``--record-deltas``, ``--replay-deltas``) stream row
deltas into either fleet path (``repro_torch.online``); the stream is
trained and recorded before the run, and the trainer's host copy of the
tables is freed before serving starts. As in the reference, a single
board serves frozen params whatever they say.

The "[plan]" line's predicted_qps is the paper's performance model for
its RecSpeed hybrid HBM+DDR4 system (Table XIV), as the reference prints
it: a ranking of placements, not a prediction for the card. The
reference launcher's multi-device flag is accepted so that it fails
loudly, naming the ROADMAP item that will bring it.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np

from repro_torch.configs.registry import get_dlrm
from repro_torch.device import resolve_device
from repro_torch.engine import Engine
from repro_torch.obs import Tracer, default_registry

# flag -> ROADMAP item; any value other than the flag's default raises
_NOT_PORTED = {"model_axis": "A6b, k ranks"}
_ONLINE_FLAGS = ("online_every_s", "online_steps", "online_lr", "coherence",
                 "record_deltas", "replay_deltas")


def _emit_obs(args, tracer, report, extra_metrics=None) -> None:
    """Write the run's observability artifacts, as the reference launcher
    does: the Chrome trace (--trace-out), the metrics registry's snapshot
    (--metrics-out: the process registry merged with a fleet's own
    per-run registry) and the SLA or fleet report (--report-json)."""
    if args.trace_out and tracer is not None:
        tracer.write(args.trace_out)
        print(f"[serve] trace -> {args.trace_out} "
              f"({tracer.n_events} events)")
    if args.metrics_out:
        snap = dict(default_registry().snapshot())
        if extra_metrics is not None:
            snap.update(extra_metrics.snapshot())
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"[serve] metrics -> {args.metrics_out} ({len(snap)} series)")
    if args.report_json:
        report.to_json(args.report_json)
        print(f"[serve] report -> {args.report_json}")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--config", default="dlrm-rm2-small-unsharded")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config (cfg.reduced())")
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop Poisson arrival rate; 0 = closed-loop "
                         "(back-to-back queries, no batching delay)")
    ap.add_argument("--max-batch-queries", type=int, default=4,
                    help="dynamic micro-batch capacity (queries)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batch deadline: oldest query flushes by this")
    ap.add_argument("--sla-ms", type=float, default=50.0,
                    help="C_SLA (paper Eq. 1), milliseconds")
    ap.add_argument("--sla-percentile", type=float, default=99.0,
                    help="P of the SLA check PPF(D_Q, P) <= C_SLA")
    ap.add_argument("--fused-serve", choices=["auto", "off"], default="auto",
                    help="auto: serve through the fused gather->pool->"
                         "interaction kernel; off: the composed path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", choices=["none", "auto"], default="none",
                    help="auto: profile + place tables, execute placements")
    ap.add_argument("--alpha", type=float, default=0.0,
                    help="zipf skew of the query index stream (0 = uniform, "
                         "the paper's zero-locality case; try 1.05 with "
                         "--plan auto)")
    ap.add_argument("--fast-mb", type=float, default=None,
                    help="fast-tier capacity (MiB) for --plan auto")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="micro-batch pipeline depth inside the serve step; "
                         "0 = auto (planner-resolved per flushed batch "
                         "shape under the engine's plan)")
    ap.add_argument("--host-capacity-mb", type=float, default=None,
                    help="device-memory budget (MiB) that turns the host "
                         "chunk tier on: the tables stay in host memory "
                         "and serve through a hot slab + chunk cache "
                         "inside the budget (repro_torch.hoststore)")
    ap.add_argument("--host-chunk-rows", type=int, default=None,
                    help="rows per host-tier chunk (default: perf-model "
                         "pick)")
    ap.add_argument("--host-hot-fraction", type=float, default=0.5,
                    help="share of the budget for the HBM hot slab")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="measured-hardware calibration JSON "
                         "(repro_torch.core.calibration): host_link "
                         "overrides the host tier's link terms, "
                         "service_multiplier the hit-ratio monitor's "
                         "retiming curve")
    ap.add_argument("--exchange", default="partial_pool",
                    choices=["partial_pool", "unpooled"],
                    help="row-wise wire mode of a row-wise (sharded) "
                         "config")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's virtual-clock trace as Chrome "
                         "trace-event JSON (open in Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry's snapshot as JSON")
    ap.add_argument("--report-json", default=None, metavar="PATH",
                    help="write the SLA report (with its per-query blame "
                         "decomposition) as JSON")
    fleet = ap.add_argument_group(
        "fleets (repro_torch.cluster; sharded: repro_torch.fabric)")
    add = fleet.add_argument
    add("--replicas", type=int, default=1,
        help=">1 serves a fleet of replica boards behind --router "
             "(repro_torch.cluster)")
    add("--scenario", default=None,
        help="traffic scenario for the fleet path: stationary, diurnal, "
             "flash_crowd, zipf_drift (zipf_drift enables the hit-ratio "
             "monitor + lfu_refresh)")
    add("--router", default="round_robin",
        help="routing policy: round_robin, jsq, p2c")
    add("--autoscale", action="store_true",
        help="SLA-driven autoscaling: add boards on sustained p99 "
             "violation, drop them on sustained slack; a new board's "
             "params are copied from a live one (remesh_tree)")
    add("--autoscale-sla-ms", type=float, default=None,
        help="p99 threshold the autoscaler reacts to; default --sla-ms "
             "(set lower to scale before the report SLA is at risk)")
    add("--max-replicas", type=int, default=4)
    add("--min-replicas", type=int, default=1,
        help="autoscaler floor (sharded fleets shrink by retiring boards "
             "down to this)")
    add("--record-trace", default=None, metavar="PATH",
        help="write the generated scenario events as a JSONL trace "
             "before serving")
    add("--replay-trace", default=None, metavar="PATH",
        help="serve a recorded JSONL trace instead of generating events "
             "(bit-identical replay)")
    add("--fleet-mode", choices=["replicated", "sharded"],
        default="replicated",
        help="replicated: every board a full model copy "
             "(repro_torch.cluster); sharded: the boards TOGETHER own one "
             "partitioned table set, lookups routed to owners over the "
             "modeled fabric (repro_torch.fabric.ShardedFleet), "
             "--replicas boards")
    add("--board-capacity-mb", type=float, default=None,
        help="per-board embedding capacity (MiB, at the tables' stored "
             "fp32) for the sharded fleet's partitioner; default: fair "
             "share + 25%%")
    add("--fabric-latency-us", type=float, default=1.0,
        help="inter-board fabric link latency (microseconds)")
    add("--fabric-gbs", type=float, default=100.0,
        help="inter-board fabric bandwidth (GB/s per board)")
    add("--fabric-cache-rows", type=int, default=None,
        help="per-board LFU cache of remote hot rows (rows; 0 disables, "
             "default ~10%% of the board's remote row space)")
    online = ap.add_argument_group(
        "online updates, on either fleet path (repro_torch.online)")
    add = online.add_argument
    add("--online-every-s", type=float, default=0.0,
        help="stream continuous training into the fleet run: emit a "
             "row-delta batch every this many virtual seconds (0 = frozen "
             "params, the default)")
    add("--online-steps", type=int, default=1,
        help="trainer SGD steps folded into each delta batch")
    add("--online-lr", type=float, default=0.05,
        help="online trainer learning rate (tables-only SGD)")
    add("--coherence", choices=["invalidate", "propagate"],
        default="propagate",
        help="update->cache protocol on the sharded fleet: drop every "
             "other board's cached copy of an updated row, or piggyback "
             "the fresh payload into the caches")
    add("--record-deltas", default=None, metavar="PATH",
        help="write the emitted delta channel as JSONL (bit-identical "
             "replay via --replay-deltas)")
    add("--replay-deltas", default=None, metavar="PATH",
        help="consume a recorded delta-channel JSONL (e.g. from "
             "repro_torch.launch.train --emit-deltas) instead of training "
             "inline")
    not_ported = ap.add_argument_group(
        "not ported yet (raises, naming its ROADMAP item)")
    not_ported.add_argument("--model-axis", type=int, default=1)
    return ap


def main(argv: Optional[list] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    fleet_path = (args.fleet_mode == "sharded" or args.replicas > 1
                  or args.scenario or args.autoscale or args.record_trace
                  or args.replay_trace)
    if args.host_capacity_mb is not None and fleet_path:
        raise SystemExit(
            "--host-capacity-mb is single-board only: give each fleet "
            "board its own Engine/host tier instead")
    for dest, item in _NOT_PORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")

    cfg = get_dlrm(args.config)
    full_cfg = cfg
    if args.smoke:
        cfg = cfg.reduced()
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:          # no CUDA device
        raise SystemExit(f"[serve] {err}")
    if args.fleet_mode == "sharded":
        return _fabric_main(args, cfg, device)
    if fleet_path:
        return _cluster_main(args, cfg, full_cfg, device)
    if any(getattr(args, dest) != ap.get_default(dest)
           for dest in _ONLINE_FLAGS):
        print("[serve] the online flags drive the fleet paths (--replicas "
              ">1, --scenario, --fleet-mode sharded); one board serves "
              "frozen params")
    engine = Engine(cfg, plan=args.plan, seed=args.seed, alpha=args.alpha,
                    fast_mb=args.fast_mb,
                    pipeline_depth=args.pipeline_depth or None,
                    fused_serve=args.fused_serve, exchange=args.exchange,
                    device=device,
                    host_capacity_mb=args.host_capacity_mb,
                    host_chunk_rows=args.host_chunk_rows,
                    host_hot_fraction=args.host_hot_fraction,
                    calibration=args.calibration, verbose=True)
    if args.host_capacity_mb is not None:
        tbl_mb = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim \
            * 4 / 2 ** 20
        print(f"[serve] host chunk tier: tables {tbl_mb:.3f} MiB vs device "
              f"budget {args.host_capacity_mb:.3f} MiB")
    session = engine.serve_session(max_batch_queries=args.max_batch_queries,
                                   max_wait_ms=args.max_wait_ms)
    if args.host_capacity_mb is not None:
        print(f"[serve] {session.exchange.summary()}")
    capacity = args.max_batch_queries * session.query_size
    print(f"[serve] serve_kernel={session.serve_kernel} "
          f"device={session.device} pipeline_depth="
          f"{session.depth_for_samples(capacity)} (capacity batch, "
          f"{capacity} samples)")
    tracer = Tracer() if args.trace_out else None
    if args.qps > 0:
        report = session.run_open_loop(
            args.queries, args.qps, sla_ms=args.sla_ms,
            percentile=args.sla_percentile, tracer=tracer)
    else:
        report = session.run_serial(
            args.queries, sla_ms=args.sla_ms,
            percentile=args.sla_percentile, tracer=tracer)
    print(f"[serve] {cfg.name}:")
    print(report.summary())
    _emit_obs(args, tracer, report)
    return 0 if report.ok else 1


def _online_channel(args, cfg, params, events, scen_name, device):
    """Resolve the --online-*/--replay-deltas flags into a
    ``DeltaChannel`` (None = frozen serving). Inline training pre-records
    the whole stream (``OnlineSource.run_to``), so the channel a run
    consumes is identical across fleet sizes and replayable via
    --record-deltas; the trainer, and its host copy of the tables, is
    freed before the run."""
    from repro_torch.online import DeltaChannel, OnlineSource, OnlineTrainer
    from repro_torch.traffic import make_scenario
    if args.replay_deltas:
        ch = DeltaChannel.load(args.replay_deltas)
        print(f"[serve] replaying {len(ch)} delta batches from "
              f"{args.replay_deltas}")
        return ch
    if args.online_every_s <= 0:
        return None
    if not isinstance(params, dict) or "tables" not in params:
        raise SystemExit(
            "--online-every-s needs stacked params with a 'tables' leaf "
            "(plan-split sessions can't take in-place row updates); use "
            "--plan none")
    trainer = OnlineTrainer(cfg, params, lr=args.online_lr,
                            seed=args.seed, alpha=args.alpha, device=device)
    salt_fn = None
    if scen_name == "zipf_drift":
        # train on the drifted stream the fleet is actually serving
        scen = make_scenario(scen_name, alpha=args.alpha)
        salt_fn = lambda t: scen.stream_params(t)[1]
    ch = OnlineSource(trainer, interval_s=args.online_every_s,
                      steps_per_update=args.online_steps,
                      salt_fn=salt_fn).run_to(events[-1].arrival_s)
    print(f"[serve] online: {len(ch)} delta batches (every "
          f"{args.online_every_s:g}s x {args.online_steps} steps, "
          f"lr={args.online_lr:g})")
    if args.record_deltas:
        ch.record(args.record_deltas)
        print(f"[serve] recorded deltas -> {args.record_deltas}")
    return ch


def _fabric_main(args, cfg, device) -> int:
    """Sharded-fleet path: one partitioned model over --replicas boards,
    lookups routed to owners over the modeled fabric (repro_torch.fabric)."""
    from repro_torch.cluster import SLAAutoscaler
    from repro_torch.core.perf_model import fabric_link
    from repro_torch.fabric import fits_one_board
    from repro_torch.traffic import load_trace, make_scenario, record_trace

    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    cap = (int(args.board_capacity_mb * 2 ** 20)
           if args.board_capacity_mb is not None else None)
    # resolve the scenario BEFORE building the fleet: the profile, the
    # partition and the cache warm-up all consume alpha, so a replayed
    # trace's header (or the zipf_drift alpha guard) must inform them
    events = None
    if args.replay_trace:
        meta, events = load_trace(args.replay_trace)
        scen_name = meta.get("scenario", args.scenario or "stationary")
        print(f"[serve] replaying {len(events)} events from "
              f"{args.replay_trace} (scenario={scen_name})")
        if args.alpha == 0.0 and events:
            # profile and cache must see the traffic the trace carries
            args.alpha = float(np.median([e.alpha for e in events]))
            if args.alpha:
                print(f"[serve] --alpha 0 on replay: profiling at the "
                      f"trace's median alpha {args.alpha:g}")
    else:
        scen_name = args.scenario or "stationary"
    if scen_name == "zipf_drift" and args.alpha == 0.0:
        args.alpha = 1.05
        print("[serve] zipf_drift with --alpha 0: using alpha=1.05 "
              "(uniform streams have no hot rows to drift)")
    autoscaler = None
    if args.autoscale:
        # the elastic threshold may sit BELOW the report SLA: scale when
        # latency degrades, not only once the SLA is already violated
        autoscaler = SLAAutoscaler(
            args.autoscale_sla_ms or args.sla_ms,
            min_replicas=args.min_replicas, max_replicas=args.max_replicas)
    engine = Engine(cfg, seed=args.seed, alpha=args.alpha, device=device,
                    verbose=True)
    tracer = Tracer() if args.trace_out else None
    fleet = engine.sharded_fleet(
        n_boards=args.replicas, board_capacity_bytes=cap,
        link=fabric_link(args.fabric_latency_us, args.fabric_gbs),
        cache_rows=args.fabric_cache_rows,
        cache_enabled=(args.fabric_cache_rows is None
                       or args.fabric_cache_rows > 0),
        max_batch_queries=args.max_batch_queries,
        max_wait_ms=args.max_wait_ms, router=args.router,
        autoscaler=autoscaler, tracer=tracer)
    pm = fleet.partition
    if not fits_one_board(cfg, pm.board_capacity_bytes, pm.table_bytes):
        print(f"[serve] table set ({pm.total_bytes / 2**20:.2f} MiB) "
              f"exceeds one board ({pm.board_capacity_bytes / 2**20:.2f} "
              f"MiB): only the sharded fleet can hold this model")

    if events is None:
        qps = args.qps
        if qps <= 0:
            # sharded throughput does NOT scale with boards: every batch's
            # lookups occupy all owner boards, so the fleet behaves like
            # one pipeline of capacity-batch rounds (no board multiplier)
            s_cap = fleet.measure_service_time()
            qps = 0.3 * args.max_batch_queries / s_cap
            print(f"[serve] --qps 0: offering 0.3 x sharded capacity = "
                  f"{qps:.1f} qps (capacity batch {s_cap * 1e3:.2f} ms)")
        scenario = make_scenario(scen_name, alpha=args.alpha)
        events = scenario.events(args.queries, qps=qps, seed=args.seed)
        if args.record_trace:
            record_trace(args.record_trace, events, scenario, qps=qps,
                         seed=args.seed, config=cfg.name)
            print(f"[serve] recorded trace -> {args.record_trace}")

    online = _online_channel(args, cfg, fleet._params, events, scen_name,
                             device)
    report = fleet.run(events, sla_ms=args.sla_ms,
                       percentile=args.sla_percentile, scenario=scen_name,
                       online=online, coherence=args.coherence)
    print(f"[serve] {cfg.name} (sharded, {args.replicas} boards):")
    print(report.summary())
    _emit_obs(args, tracer, report, extra_metrics=fleet.metrics)
    return 0 if report.ok else 1


def _cluster_main(args, cfg, full_cfg, device) -> int:
    """Fleet path: scenario/trace -> router -> N replicas -> ClusterReport."""
    from repro_torch.cluster import Cluster, HitRatioMonitor, SLAAutoscaler
    from repro_torch.traffic import load_trace, make_scenario, record_trace

    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    # resolve the scenario BEFORE building the fleet: a replayed trace's
    # header decides it (so a recorded zipf_drift trace replays with the
    # same monitor/refresh machinery the live run had)
    events = None
    if args.replay_trace:
        meta, events = load_trace(args.replay_trace)
        scen_name = meta.get("scenario", args.scenario or "stationary")
        print(f"[serve] replaying {len(events)} events from "
              f"{args.replay_trace} (scenario={scen_name})")
    else:
        scen_name = args.scenario or "stationary"
    if scen_name == "zipf_drift" and args.alpha == 0.0:
        # a uniform stream has no hot set to erode; without an explicit
        # --alpha use the scenario's default skew so the drift mechanism
        # (and the monitor's baseline) is meaningful
        args.alpha = 1.05
        print("[serve] zipf_drift with --alpha 0: using alpha=1.05 "
              "(uniform streams have no hot rows to drift)")

    monitor = None
    if scen_name == "zipf_drift":
        # drift erodes the frequency-elected fast tier; monitor + refresh;
        # a --calibration artifact replaces the modeled hybrid-memory
        # retiming curve with the measured one
        monitor = HitRatioMonitor(cfg, alpha=args.alpha, seed=args.seed,
                                  model_cfg=full_cfg,
                                  service_multiplier=args.calibration,
                                  device=device)
    autoscaler = (SLAAutoscaler(args.autoscale_sla_ms or args.sla_ms,
                                min_replicas=args.min_replicas,
                                max_replicas=args.max_replicas)
                  if args.autoscale else None)
    tracer = Tracer() if args.trace_out else None
    cluster = Cluster(
        cfg, n_replicas=args.replicas, plan=args.plan,
        exchange=args.exchange, alpha=args.alpha, seed=args.seed,
        fast_mb=args.fast_mb, max_batch_queries=args.max_batch_queries,
        max_wait_ms=args.max_wait_ms, router=args.router,
        autoscaler=autoscaler, monitor=monitor,
        pipeline_depth=args.pipeline_depth or None, tracer=tracer,
        verbose=True, device=device)
    sess = cluster.replicas[0].session
    print(f"[serve] fleet of {args.replicas} replicas on {device}: "
          f"serve_kernel={sess.serve_kernel}")

    if events is None:
        qps = args.qps
        if qps <= 0:
            # default load: ~80% of the fleet's aggregate per-query capacity
            s1 = sess.measure_service_time()
            qps = 0.8 * args.replicas / s1
            print(f"[serve] --qps 0: offering 0.8 x fleet capacity = "
                  f"{qps:.1f} qps (per-query service {s1 * 1e3:.2f} ms)")
        scenario = make_scenario(scen_name, alpha=args.alpha)
        events = scenario.events(args.queries, qps=qps, seed=args.seed)
        if args.record_trace:
            record_trace(args.record_trace, events, scenario, qps=qps,
                         seed=args.seed, config=cfg.name)
            print(f"[serve] recorded trace -> {args.record_trace}")

    online = _online_channel(args, cfg, cluster.replicas[0].session.params,
                             events, scen_name, device)
    report = cluster.run(events, sla_ms=args.sla_ms,
                         percentile=args.sla_percentile, scenario=scen_name,
                         online=online)
    print(f"[serve] {cfg.name}:")
    print(report.summary())
    _emit_obs(args, tracer, report, extra_metrics=cluster.metrics)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
