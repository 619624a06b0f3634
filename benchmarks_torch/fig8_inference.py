"""Paper Fig. 8: inference QPS upper bounds over the CC latency×bandwidth
grid, for the four RM2 configurations."""
from repro_torch.configs.registry import DLRM_CONFIGS
from repro_torch.core.perf_model import cc_sweep

CONFIGS = ["dlrm-rm2-small-unsharded", "dlrm-rm2-small-sharded",
           "dlrm-rm2-large-unsharded", "dlrm-rm2-large-sharded"]


def main(mode: str = "inference"):
    fig = "8" if mode == "inference" else "11"
    print(f"# Fig. {fig} — {mode} QPS upper bounds (8-chip sweep system)")
    print("config,latency_us,bandwidth_GBs,qps,mem_util")
    for name in CONFIGS:
        cfg = DLRM_CONFIGS[name]
        for r in cc_sweep(cfg, mode):
            print(f"{name},{r['latency_us']},{r['bandwidth_gbs']:.0f},"
                  f"{r['qps']:.0f},{r['mem_util']:.3f}")


if __name__ == "__main__":
    main()
