"""Paper Tables XVI/XVII: RecSpeed vs DGX-2 upper bounds (the headline
12-62x inference / 12-45x training claims) + the beyond-paper partial-pool
variant for comparison."""
from repro_torch.configs.registry import DLRM_CONFIGS
from repro_torch.core.perf_model import (PAPER_TABLE_XVI, PAPER_TABLE_XVII,
                                   breakdown, dgx2_system, recspeed_system)

CONFIGS = ["dlrm-rm2-small-unsharded", "dlrm-rm2-small-sharded",
           "dlrm-rm2-large-unsharded", "dlrm-rm2-large-sharded"]


def table(mode: str, paper):
    tag = "XVI (inference)" if mode == "inference" else "XVII (training)"
    print(f"# Table {tag} — RecSpeed vs DGX-2 upper bounds")
    print("config,recspeed_qps,dgx2_qps,speedup,paper_recspeed_qps,"
          "paper_speedup,mem_util,partial_pool_qps")
    rs, dg = recspeed_system(), dgx2_system()
    for name in CONFIGS:
        cfg = DLRM_CONFIGS[name]
        r = breakdown(cfg, rs, mode)
        d = breakdown(cfg, dg, mode)
        pp = breakdown(cfg, rs, mode, row_wise_exchange="partial_pool")
        p_qps, _, _, p_speedup = paper[name]
        print(f"{name},{r.qps:.0f},{d.qps:.0f},{r.qps/d.qps:.0f},"
              f"{p_qps:.0f},{p_speedup},{r.mem_util:.2f},{pp.qps:.0f}")


def main():
    table("inference", PAPER_TABLE_XVI)
    table("training", PAPER_TABLE_XVII)


if __name__ == "__main__":
    main()
