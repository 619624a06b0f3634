"""Quickstart: the paper's workload end to end through the port, on the
card (``--device cpu`` runs it on the host).

1. Build DLRM-RM2 (reduced) and train it through the engine's session API.
2. Serve queries THROUGH the dynamic micro-batcher with the trained weights.
3. Ask the RecSpeed planner what the PAPER'S analysis says about how to
   distribute the FULL model on RecSpeed-class vs DGX-2-class hardware
   (the reference also asks for a TPU system, which the port's perf model
   leaves out).

Run: PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

from repro_torch.configs.registry import get_dlrm
from repro_torch.core.perf_model import dgx2_system, recspeed_system
from repro_torch.core.planner import plan_dlrm
from repro_torch.data import make_recsys_batch
from repro_torch.device import resolve_device
from repro_torch.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_dlrm("dlrm-rm2-small-unsharded").reduced()
    print(f"== DLRM {cfg.name}: {cfg.num_tables} tables x {cfg.rows_per_table}"
          f" rows x d={cfg.embed_dim} on {dev}")

    # --- one engine: config -> plan -> build -> run ----------------------
    engine = Engine(cfg, lr=0.05, device=dev)

    # --- train -----------------------------------------------------------
    train = engine.train_session()
    for _ in range(3):
        rep = train.run(8)
        print(f"  steps {rep.start_step:3d}-{rep.start_step + rep.steps_run - 1}"
              f"  bce={rep.last_loss:.4f}")

    # --- serve (trained weights, dynamic micro-batching) -----------------
    serve = engine.serve_session(max_batch_queries=2, max_wait_ms=5.0,
                                 params=train.params)
    futs = [serve.submit(make_recsys_batch(cfg, 999 + i, device=dev))
            for i in range(2)]
    probs = futs[0].probs
    print(f"== served query of {probs.shape[0]} (micro-batch of {len(futs)}): "
          f"P(click) head = {[round(float(p), 3) for p in probs[:4]]}")

    # --- plan (the paper's contribution as a feature) --------------------
    full = get_dlrm("dlrm-rm2-small-unsharded")
    for system in (recspeed_system(), dgx2_system()):
        plan = plan_dlrm(full, system, "inference")
        print(f"== planner[{system.name}]: mode={plan.mode} "
              f"exchange={plan.exchange} predicted {plan.predicted_qps:,.0f} QPS"
              f"  (table-wise {plan.qps_table_wise:,.0f} / row-wise-unpooled"
              f" {plan.qps_row_wise_unpooled:,.0f} / row-wise-partial"
              f" {plan.qps_row_wise_partial:,.0f})")


if __name__ == "__main__":
    main()
