"""Training launcher: a thin argparse adapter over ``repro_torch.engine``.

Maps flags onto ``Engine(...)`` / ``TrainSession`` (plan -> train step ->
params and optimizer state -> checkpointed TrainLoop) and runs real steps
of DLRM on one device: the card unless ``--device cpu``.

  # full width on the card, checkpoints every 50 steps
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --config dlrm-rm2-small-unsharded --steps 200 --ckpt-dir ckpt

  # planner placement and row-wise AdaGrad; prints "[plan] ..."
  PYTHONPATH=src python -m repro_torch.launch.train --plan auto \\
      --alpha 1.05 --optimizer adagrad --steps 50

  # the reduced config on the CPU, through the plain PyTorch path
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 8

  # row-wise sharding ("full sharding") in the paper's wire mode
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --config dlrm-rm2-small-sharded --exchange unpooled --steps 50

  # the host chunk tier (SGD only): dirty chunks write back to host memory
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 8 --host-capacity-mb 0.1 --alpha 1.05

The reference launcher's LM, distributed and online flags are accepted so
that they fail loudly: each names the ROADMAP item that will bring it.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from repro_torch.configs.registry import get_dlrm
from repro_torch.device import resolve_device
from repro_torch.engine import Engine

# flag -> ROADMAP item; any value other than the flag's default raises
_NOT_PORTED = {
    "workload": "A8, LM substrate",
    "arch": "A8, LM substrate",
    "batch": "A8, LM substrate",
    "seq": "A8, LM substrate",
    "compress_grads": "A6b, k ranks",
    "model_axis": "A6b, k ranks",
    "emit_deltas": "A7c, online updates",
    "delta_every_steps": "A7c, online updates",
    "delta_dt_s": "A7c, online updates",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    p.add_argument("--config", default="dlrm-rm2-small-unsharded")
    p.add_argument("--smoke", action="store_true",
                   help="train the reduced config (cfg.reduced())")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha", type=float, default=0.0,
                   help="zipf locality of the synthetic index stream")
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adagrad"])
    p.add_argument("--plan", choices=["none", "auto"], default="none",
                   help="auto: profile + place tables, execute placements")
    p.add_argument("--fast-mb", type=float, default=None,
                   help="fast-tier capacity (MiB) for --plan auto")
    p.add_argument("--pipeline-depth", type=int, default=0,
                   help="micro-batches a train step splits into; 0 = auto "
                        "(planner-chosen under --plan auto, else 1)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--report-json", default=None, metavar="PATH",
                   help="write the run report (train report + plan, when "
                        "one was built) as JSON")
    p.add_argument("--host-capacity-mb", type=float, default=None,
                   help="device-memory budget (MiB) that turns the host "
                        "chunk tier on: train through it (SGD only; "
                        "dirty chunks write back to host memory)")
    p.add_argument("--host-chunk-rows", type=int, default=None,
                   help="rows per host-tier chunk (default: perf-model "
                        "pick)")
    p.add_argument("--host-hot-fraction", type=float, default=0.5,
                   help="share of the budget for the HBM hot slab")
    p.add_argument("--calibration", default=None, metavar="PATH",
                   help="measured-hardware calibration JSON "
                        "(repro_torch.core.calibration): host_link "
                        "overrides the host tier's link terms")
    p.add_argument("--exchange", default="partial_pool",
                   choices=["partial_pool", "unpooled"],
                   help="row-wise wire mode of a row-wise (sharded) config")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA device")
    not_ported = p.add_argument_group(
        "not ported yet (each raises, naming its ROADMAP item)")
    not_ported.add_argument("--workload", choices=["dlrm", "lm"],
                            default="dlrm")
    not_ported.add_argument("--arch", default="internlm2-1.8b",
                            help="LM architecture (with --workload lm)")
    not_ported.add_argument("--batch", type=int, default=8,
                            help="LM batch (with --workload lm)")
    not_ported.add_argument("--seq", type=int, default=128,
                            help="LM sequence length (with --workload lm)")
    not_ported.add_argument("--model-axis", type=int, default=1)
    not_ported.add_argument("--compress-grads", action="store_true")
    not_ported.add_argument("--emit-deltas", default=None, metavar="PATH")
    not_ported.add_argument("--delta-every-steps", type=int, default=10)
    not_ported.add_argument("--delta-dt-s", type=float, default=1.0)
    return p


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
        raise SystemExit(f"[train] {err}")
    engine = Engine(cfg, plan=args.plan, optimizer=args.optimizer,
                    lr=args.lr, alpha=args.alpha, seed=args.seed,
                    exchange=args.exchange,
                    fast_mb=args.fast_mb,
                    pipeline_depth=args.pipeline_depth or None,
                    host_capacity_mb=args.host_capacity_mb,
                    host_chunk_rows=args.host_chunk_rows,
                    host_hot_fraction=args.host_hot_fraction,
                    calibration=args.calibration, device=device,
                    verbose=True)
    session = engine.train_session(ckpt_dir=args.ckpt_dir,
                                   ckpt_every=args.ckpt_every)
    if args.host_capacity_mb is not None:
        print(f"[train] {session.exchange_inst.summary()}")
    print(f"[train] device={session.device} optimizer={args.optimizer} "
          f"pipeline_depth={session.pipeline_depth} resume_step="
          f"{session.resume_step}")
    report = session.run(args.steps)
    print(report.summary())
    if args.report_json:
        plan_report = engine.plan_report("training")
        payload = {"train": report.asdict(),
                   "plan": plan_report.asdict() if plan_report else None}
        with open(args.report_json, "w") as f:
            json.dump(payload, f, indent=2, default=str)
            f.write("\n")
        print(f"[train] report -> {args.report_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
