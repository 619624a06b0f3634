"""End-to-end driver: train a ~100M-parameter DLRM for a few hundred steps
through the port's engine on the card (``--device cpu`` runs it on the
host): the step at n = 1, checkpoints with resume, straggler accounting,
and the deterministic step-indexed data pipeline.

~100M params: 12 tables x 131072 rows x 64d = 100.7M embedding params
(+ ~0.6M dense).

Run: PYTHONPATH=src python examples_torch/dlrm_train_100m.py [--steps 200]
     [--device cpu]
"""
import argparse
import tempfile
import time

from repro_torch.configs.base import DLRMConfig
from repro_torch.device import resolve_device
from repro_torch.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = DLRMConfig(
        name="dlrm-100m", num_tables=12, lookups_per_table=16,
        embed_dim=64, rows_per_table=131_072, num_dense=256,
        batch_size=args.batch, sharding="table_wise")
    n_params = (cfg.num_tables * cfg.rows_per_table * cfg.embed_dim
                + sum(a * b for a, b in zip(
                    (cfg.num_dense,) + cfg.bot_mlp_dims[:-1], cfg.bot_mlp_dims))
                + sum(a * b for a, b in zip(
                    (cfg.top_mlp_in,) + cfg.top_mlp[:-1], cfg.top_mlp)))
    print(f"== {cfg.name}: {n_params/1e6:.1f}M params, batch {cfg.batch_size}"
          f" on {dev}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="dlrm100m_")
    engine = Engine(cfg, optimizer="adagrad", lr=0.2, alpha=0.8, device=dev)
    session = engine.train_session(ckpt_dir=ckpt_dir, ckpt_every=50,
                                   ckpt_keep=2)
    if session.resume_step:
        print(f"== resumed from checkpoint at step {session.resume_step}")

    t0 = time.time()
    report = session.run(args.steps)
    dt = time.time() - t0

    losses = [h["loss"] for h in report.history]
    qps = args.steps * cfg.batch_size / dt
    w = max(1, min(10, len(losses) // 4))
    head = sum(losses[:w]) / w
    tail = sum(losses[-w:]) / w
    print(f"== {args.steps} steps in {dt:.1f}s  ({qps:,.0f} samples/s)")
    print(f"== loss (mean of {w}) {head:.4f} -> {tail:.4f} "
          f"(decreased: {tail < head})")
    print(f"== checkpoints in {ckpt_dir} — rerun with --ckpt-dir to resume")
    if not tail < head:
        raise SystemExit("training must reduce loss")


if __name__ == "__main__":
    main()
