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

The "[plan]" line's predicted_qps is the paper's performance model for
its RecSpeed hybrid HBM+DDR4 system (Table XIV), as the reference prints
it: a ranking of placements, not a prediction for the card. The
reference launcher's host-tier, fleet and online flags are accepted so
that they fail loudly: each names the ROADMAP item that will bring it.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from repro_torch.configs.registry import get_dlrm
from repro_torch.device import resolve_device
from repro_torch.engine import Engine

# flag -> ROADMAP item; any value other than the flag's default raises
_NOT_PORTED = {
    "host_capacity_mb": "A5, host tier",
    "replicas": "A7, cluster/fabric/online",
    "fleet_mode": "A7, cluster/fabric/online",
    "scenario": "A7, cluster/fabric/online",
    "autoscale": "A7, cluster/fabric/online",
    "record_trace": "A7, cluster/fabric/online",
    "replay_trace": "A7, cluster/fabric/online",
    "online_every_s": "A7, cluster/fabric/online",
    "replay_deltas": "A7, cluster/fabric/online",
}


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
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    not_ported = ap.add_argument_group(
        "not ported yet (each raises, naming its ROADMAP item)")
    not_ported.add_argument("--host-capacity-mb", type=float, default=None)
    not_ported.add_argument("--replicas", type=int, default=1)
    not_ported.add_argument("--fleet-mode",
                            choices=["replicated", "sharded"],
                            default="replicated")
    not_ported.add_argument("--scenario", default=None)
    not_ported.add_argument("--autoscale", action="store_true")
    not_ported.add_argument("--record-trace", default=None)
    not_ported.add_argument("--replay-trace", default=None)
    not_ported.add_argument("--online-every-s", type=float, default=0.0)
    not_ported.add_argument("--replay-deltas", default=None)
    return ap


def main(argv: Optional[list] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    for dest, item in _NOT_PORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")

    cfg = get_dlrm(args.config)
    if args.smoke:
        cfg = cfg.reduced()
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:          # no CUDA device
        raise SystemExit(f"[serve] {err}")
    engine = Engine(cfg, plan=args.plan, seed=args.seed, alpha=args.alpha,
                    fast_mb=args.fast_mb,
                    pipeline_depth=args.pipeline_depth or None,
                    fused_serve=args.fused_serve, device=device,
                    verbose=True)
    session = engine.serve_session(max_batch_queries=args.max_batch_queries,
                                   max_wait_ms=args.max_wait_ms)
    capacity = args.max_batch_queries * session.query_size
    print(f"[serve] serve_kernel={session.serve_kernel} "
          f"device={session.device} pipeline_depth="
          f"{session.depth_for_samples(capacity)} (capacity batch, "
          f"{capacity} samples)")
    if args.qps > 0:
        report = session.run_open_loop(args.queries, args.qps,
                                       sla_ms=args.sla_ms)
    else:
        report = session.run_serial(args.queries, sla_ms=args.sla_ms)
    print(f"[serve] {cfg.name}:")
    print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
