"""Paper Figs. 12/13: training phase breakdown (FWD / ALLREDUCE / SPARSE
UPDT) vs bandwidth, for the two illustrative configs."""
from repro_torch.configs.registry import get_dlrm
from repro_torch.core.perf_model import breakdown, sweep_system


def main():
    print("# Figs. 12/13 — training phase fractions vs bandwidth")
    print("config,latency_us,bandwidth_GBs,qps,frac_fwd,frac_allreduce,"
          "frac_sparse_updt")
    cases = [("dlrm-rm2-small-unsharded", 1.0),    # Fig. 12
             ("dlrm-rm2-large-sharded", 1.0)]      # Fig. 13
    for name, lat in cases:
        cfg = get_dlrm(name)
        for bw in (100.0, 200.0, 400.0, 600.0, 800.0, 1000.0):
            bd = breakdown(cfg, sweep_system(lat * 1e-6, bw * 1e9), "training")
            f = bd.phase_fractions()
            print(f"{name},{lat},{bw:.0f},{bd.qps:.0f},"
                  f"{f['fwd']:.3f},{f['allreduce']:.3f},{f['sparse_updt']:.3f}")


if __name__ == "__main__":
    main()
