"""SLA serving scenario — paper Sec. III-B/III-C and Eq. 1, via the port's
engine, on the card (``--device cpu`` runs it on the host).

Two experiments on the reduced DLRM-RM2, at the reference's sizes:

1. Query-size sweep (closed-loop): a stream of ranking queries of size B
   hits the server one at a time; we measure D_Q and check
   PPF(D_Q, P) <= C_SLA — the paper's query-size/tail-latency tradeoff.
2. Open-loop dynamic batching: Poisson arrivals at a rate ABOVE the
   per-query service capacity. Fixed per-query serving saturates and its
   tail explodes; the micro-batcher rides the same load within SLA —
   the production behavior Gupta et al. describe.

Run: PYTHONPATH=src python examples_torch/serve_sla.py [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.configs.registry import get_dlrm
from repro_torch.device import resolve_device
from repro_torch.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    base = get_dlrm("dlrm-rm2-small-unsharded").reduced()
    c_sla_ms, pct = 250.0, 99.0

    print(f"== SLA check on {dev}: PPF(D_Q, {pct:.0f}) <= C_SLA = "
          f"{c_sla_ms} ms")
    print("query_size,p50_ms,p90_ms,p99_ms,qps,sla")
    for B in (8, 32, 128):
        cfg = dataclasses.replace(base, batch_size=B)
        session = Engine(cfg, device=dev).serve_session(max_batch_queries=1)
        r = session.run_serial(60, sla_ms=c_sla_ms, percentile=pct)
        verdict = "PASS" if r.ok else "FAIL"
        print(f"{B},{r.p50_ms:.2f},{r.p90_ms:.2f},{r.p99_ms:.2f},"
              f"{r.achieved_qps:.1f},{verdict}")
    print("== note: larger query size raises per-query latency but amortizes "
          "dispatch — the paper's query-size/tail-latency tradeoff (Sec. III-C)")

    # --- open-loop: batching vs a fixed per-query server ------------------
    cfg = dataclasses.replace(base, batch_size=8)
    engine = Engine(cfg, device=dev)
    fixed = engine.serve_session(max_batch_queries=1)
    qps = 2.0 / fixed.measure_service_time()   # 2x past saturation
    print(f"\n== open-loop at {qps:.0f} QPS (2x the per-query capacity)")
    print("server,achieved_qps,mean_batch,p99_ms")
    batched = engine.serve_session(max_batch_queries=8, max_wait_ms=4.0)
    for name, sess in (("per-query", fixed), ("batched(8)", batched)):
        r = sess.run_open_loop(300, qps, sla_ms=c_sla_ms, percentile=pct)
        print(f"{name},{r.achieved_qps:.1f},{r.mean_batch_queries:.2f},"
              f"{r.p99_ms:.2f}")
    print("== note: dynamic batching sustains the offered rate; the "
          "per-query server queues without bound (open-loop overload)")


if __name__ == "__main__":
    main()
