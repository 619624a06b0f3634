"""Training launcher: a thin argparse adapter over ``repro_torch.engine``.

Maps flags onto ``Engine(...)`` / ``TrainSession`` (plan -> train step ->
params and optimizer state -> checkpointed TrainLoop) and runs real steps
of DLRM, or of an LM (``--workload lm``), on one device: the card unless
``--device cpu``.

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

  # record the rows each 4-step segment changed as a delta channel, for
  # repro_torch.launch.serve --replay-deltas
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 12 --emit-deltas d.jsonl --delta-every-steps 4 \\
      --delta-dt-s 0.05

  # the LM substrate: internlm2-1.8b, AdamW under a cosine schedule
  PYTHONPATH=src python -m repro_torch.launch.train --workload lm \\
      --arch internlm2-1.8b --batch 8 --seq 128 --lr 3e-4 --steps 30

  # its reduced config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --workload lm \\
      --arch internlm2-1.8b --smoke --device cpu --steps 8

The reference launcher's distributed flags are accepted so that they fail
loudly: each names the ROADMAP item that will bring it. Under --workload
lm the DLRM-only flags are ignored with a note, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional

import torch

from repro_torch.configs.registry import get_arch, get_dlrm
from repro_torch.device import resolve_device
from repro_torch.engine import Engine

# flag -> ROADMAP item; any value other than the flag's default raises
_NOT_PORTED = {
    "compress_grads": "A6b, k ranks",
    "model_axis": "A6b, k ranks",
}


def _run_with_deltas(args, session):
    """Run training in --delta-every-steps segments, delta-encoding the
    embedding tables between segments into a recorded
    ``repro_torch.online.DeltaChannel`` JSONL (--emit-deltas), the stream
    ``repro_torch.launch.serve --replay-deltas`` feeds a live fleet.

    The snapshot is one host copy of the tables; each segment's batch is
    ``diff_tables`` of it against the live tables (compared a slice at a
    time on the device, so no second device copy is held), and its rows
    are then written into the snapshot. Rows the batch leaves out compare
    equal (``!=``), so every later diff is the one of whole snapshots."""
    from repro_torch.hoststore.chunks import StagingRing, copy_to_host
    from repro_torch.online import DeltaChannel, diff_tables

    params = session.params
    if not isinstance(params, dict) or "tables" not in params:
        raise SystemExit(
            "--emit-deltas needs stacked params with a 'tables' leaf "
            "(dlrm workload, --plan none, no host tier)")
    tables = params["tables"]
    snap = torch.empty(tables.shape, dtype=tables.dtype)
    if tables.device.type == "cuda":
        ring = StagingRing(tables.device, tables.dtype)
        for t in range(tables.shape[0]):
            copy_to_host(snap[t], tables[t], ring)
    else:
        snap.copy_(tables)
    channel = DeltaChannel()
    seg = max(1, args.delta_every_steps)
    reports = []
    done = 0
    version = 0
    while done < args.steps:
        n = min(seg, args.steps - done)
        reports.append(session.run(n))
        done += n
        version += 1
        batch = diff_tables(
            snap, session.params["tables"], version=version,
            t_emit_s=version * args.delta_dt_s, step=done,
            train_loss=reports[-1].last_loss)
        for d in batch.deltas:
            snap[d.table, torch.from_numpy(d.rows)] = torch.from_numpy(
                d.values).to(snap.dtype)
        channel.push(batch)
    n_batches = channel.record(args.emit_deltas)
    rows = sum(b.n_rows for b in channel.emitted)
    print(f"[train] deltas -> {args.emit_deltas} ({n_batches} batches, "
          f"{rows} row updates)")
    first, last = reports[0], reports[-1]
    return dataclasses.replace(
        last, start_step=first.start_step,
        steps_run=sum(r.steps_run for r in reports),
        first_loss=first.first_loss,
        history=[h for r in reports for h in r.history])


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
    p.add_argument("--emit-deltas", default=None, metavar="PATH",
                   help="record the run's embedding-row updates as a "
                        "delta-channel JSONL (repro_torch.online): the "
                        "table rows each --delta-every-steps segment "
                        "changed, versioned + timestamped, consumable by "
                        "repro_torch.launch.serve --replay-deltas")
    p.add_argument("--delta-every-steps", type=int, default=10,
                   help="trainer steps folded into one delta batch")
    p.add_argument("--delta-dt-s", type=float, default=1.0,
                   help="virtual seconds between delta emits (stamps "
                        "t_emit_s = version x this; match it to the "
                        "serving trace's timescale)")
    p.add_argument("--workload", choices=["dlrm", "lm"], default="dlrm")
    p.add_argument("--arch", default="internlm2-1.8b",
                   help="LM architecture (with --workload lm)")
    p.add_argument("--batch", type=int, default=8,
                   help="LM batch (with --workload lm)")
    p.add_argument("--seq", type=int, default=128,
                   help="LM sequence length (with --workload lm)")
    not_ported = p.add_argument_group(
        "not ported yet (each raises, naming its ROADMAP item)")
    not_ported.add_argument("--model-axis", type=int, default=1)
    not_ported.add_argument("--compress-grads", action="store_true")
    return p


def _lm_flags(args) -> None:
    """The reference's notes for DLRM-only flags under --workload lm: each
    is dropped."""
    if args.plan != "none":
        print("[train] --plan is DLRM-only; ignoring it for the lm "
              "workload")
        args.plan = "none"
    if args.pipeline_depth > 1 or args.compress_grads:
        print("[train] --pipeline-depth/--compress-grads are DLRM-only; "
              "ignoring them for the lm workload")
        args.pipeline_depth, args.compress_grads = 0, False
    if args.host_capacity_mb is not None:
        print("[train] --host-capacity-mb is DLRM-only; ignoring it "
              "for the lm workload")
        args.host_capacity_mb = None


def main(argv: Optional[list] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.workload == "lm":
        _lm_flags(args)
    for dest, item in _NOT_PORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")

    cfg = get_dlrm(args.config) if args.workload == "dlrm" else get_arch(
        args.arch)
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
                                   ckpt_every=args.ckpt_every,
                                   batch=args.batch, seq=args.seq,
                                   schedule_steps=args.steps)
    if args.host_capacity_mb is not None:
        print(f"[train] {session.exchange_inst.summary()}")
    if args.workload == "lm":
        print(f"[train] device={session.device} optimizer=adamw "
              f"batch={args.batch} seq={args.seq} resume_step="
              f"{session.resume_step}")
    else:
        print(f"[train] device={session.device} optimizer={args.optimizer} "
              f"pipeline_depth={session.pipeline_depth} resume_step="
              f"{session.resume_step}")
    if args.emit_deltas:
        report = _run_with_deltas(args, session)
    else:
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
