"""Fleet serving under the SLA -- scenario traffic, routing, autoscaling --
through the port, on the card (``--device cpu`` runs it on the host).

Three short stories on a reduced DLRM-RM2 fleet (``repro_torch.cluster``),
all on the merged virtual clock with real device service times, at the
reference's sizes:

1. A diurnal "day" served by 2 replicas behind power-of-two-choices
   routing: the fleet rides the sinusoidal rate swing within Eq. 1.
2. A flash crowd with SLA-driven autoscaling: the burst drives sustained
   p99 violations, the autoscaler adds boards (live params copied onto
   the new board by ``runtime.elastic.remesh_tree``), the tail comes back
   under control.
3. A zipf_drift stream eroding the tiered fast tier: the hit-ratio
   monitor watches the windowed ratio collapse and fires
   ``tiered_embedding.lfu_refresh`` mid-serve, restoring it; with the
   refresh off (``HitRatioMonitor(enabled=False)``) it stays eroded.

Run: PYTHONPATH=src python examples_torch/cluster_sla.py [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.cluster import Cluster, HitRatioMonitor, SLAAutoscaler
from repro_torch.configs.registry import get_dlrm
from repro_torch.device import resolve_device
from repro_torch.engine import Engine
from repro_torch.traffic import make_scenario


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full = get_dlrm("dlrm-rm2-small-unsharded")
    cfg = dataclasses.replace(full.reduced(), batch_size=8)
    alpha = 1.2

    # calibrate loads against one board's measured batched capacity
    probe = Engine(cfg, alpha=alpha, device=dev).serve_session(
        max_batch_queries=4)
    s1 = probe.measure_service_time()
    cap1 = 4.0 / probe.measure_service_time(4)
    sla_ms = 25.0 * s1 * 1e3
    print(f"one board on {dev}: {cap1:.0f} qps batched capacity; C_SLA "
          f"{sla_ms:.1f} ms")
    common = dict(alpha=alpha, max_batch_queries=4, max_wait_ms=2.0,
                  device=dev)

    # --- 1. diurnal day, 2 replicas, p2c ---------------------------------
    # mean rate such that the 1.8x diurnal PEAK stays at ~70% of the fleet
    qps = 0.7 * 2 * cap1 / 1.8
    diurnal = make_scenario("diurnal", alpha=alpha, amplitude=0.8)
    cl = Cluster(cfg, n_replicas=2, router="p2c", **common)
    rep = cl.run(diurnal.events(160, qps=qps, seed=0), sla_ms=sla_ms,
                 scenario="diurnal")
    print("\n== diurnal day, 2 replicas, p2c routing")
    print(rep.summary())

    # --- 2. flash crowd + autoscaling ------------------------------------
    base = 0.5 * cap1                # bursts push 8x past one board
    horizon = 160 / base
    flash = make_scenario("flash_crowd", alpha=alpha, burst_factor=8.0,
                          on_s=0.25 * horizon, off_s=0.25 * horizon)
    events = flash.events(160, qps=base, seed=0)
    print("\n== flash crowd from 1 replica: autoscaling off vs on")
    for auto in (None, SLAAutoscaler(sla_ms, max_replicas=3, window=16,
                                     patience=2)):
        cl = Cluster(cfg, n_replicas=1, router="jsq", autoscaler=auto,
                     **common)
        rep = cl.run(events, sla_ms=sla_ms, scenario="flash_crowd")
        label = "autoscale on " if auto else "autoscale off"
        ups = sum(1 for e in rep.scale_events if e.action == "up")
        print(f"{label}: p99 {rep.p99_ms:.2f} ms, "
              f"{rep.n_replicas_end} replicas at end ({ups} scale-up)")

    # --- 3. zipf drift + lfu_refresh -------------------------------------
    qps = 0.8 * 2 * cap1
    horizon = 240 / qps
    drift = make_scenario("zipf_drift", alpha=alpha,
                          rotate_every_s=0.6 * horizon, salt_stride=37)
    events = drift.events(240, qps=qps, seed=0)
    print("\n== zipf drift, 2 replicas, hit-ratio monitor")
    for enabled in (False, True):
        monitor = HitRatioMonitor(cfg, alpha=alpha, window=16,
                                  cooldown_queries=24, model_cfg=full,
                                  enabled=enabled, device=dev)
        cl = Cluster(cfg, n_replicas=2, router="jsq", monitor=monitor,
                     **common)
        rep = cl.run(events, sla_ms=sla_ms, scenario="zipf_drift")
        label = "refresh on " if enabled else "refresh off"
        print(f"{label}: hit {rep.hit_ratio_first:.3f} -> "
              f"{rep.hit_ratio_last:.3f}, p99 {rep.p99_ms:.2f} ms, "
              f"{len(rep.refreshes)} lfu_refresh")
    print("== note: the monitor elects the new hot set from LIVE counts; "
          "without the refresh the stale fast tier pays the bulk-tier "
          "miss penalty on nearly every lookup")


if __name__ == "__main__":
    main()
