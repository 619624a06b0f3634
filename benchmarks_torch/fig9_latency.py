"""Paper Fig. 9: QPS vs CC latency at high and low bandwidth (small batch,
small embeddings, unsharded) — the latency-dominance argument."""
from repro_torch.configs.registry import get_dlrm
from repro_torch.core.perf_model import breakdown, latency_sensitivity, sweep_system

LATENCIES_US = (0.5, 1.0, 2.0, 4.0, 6.0, 8.0, 10.0)


def main():
    cfg = get_dlrm("dlrm-rm2-small-unsharded")
    print("# Fig. 9 — latency impact, small/small unsharded")
    print("bandwidth_GBs,latency_us,qps")
    for bw in (100.0, 1000.0):
        for lat in LATENCIES_US:
            bd = breakdown(cfg, sweep_system(lat * 1e-6, bw * 1e9), "inference")
            print(f"{bw:.0f},{lat},{bd.qps:.0f}")
    s = latency_sensitivity(cfg, "inference", 1000.0)
    print(f"# drop(0.5us -> 10us) at 1000GB/s = {s['drop']:.2f}x "
          f"(paper: ~5x)")


if __name__ == "__main__":
    main()
