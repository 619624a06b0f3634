"""Paper Fig. 10: sharding QPS penalty vs bandwidth — high BW mitigates the
unpooled-exchange cost of full sharding."""
from repro_torch.configs.registry import get_dlrm
from repro_torch.core.perf_model import sharding_penalty


def main():
    print("# Fig. 10 — QPS(unsharded)/QPS(sharded) vs bandwidth")
    print("pair,latency_us,bandwidth_GBs,penalty")
    for small in (True, False):
        u = get_dlrm("dlrm-rm2-small-unsharded" if small
                     else "dlrm-rm2-large-unsharded")
        s = get_dlrm("dlrm-rm2-small-sharded" if small
                     else "dlrm-rm2-large-sharded")
        label = "small" if small else "large"
        for lat in (1.0, 10.0):
            for bw in (100.0, 200.0, 400.0, 600.0, 800.0, 1000.0):
                pen = sharding_penalty(u, s, lat, bw)
                print(f"{label},{lat},{bw:.0f},{pen:.2f}")
    # the paper's headline numbers
    u = get_dlrm("dlrm-rm2-small-unsharded")
    s = get_dlrm("dlrm-rm2-small-sharded")
    print(f"# small @10us: {sharding_penalty(u, s, 10.0, 100.0):.2f}x @100GB/s"
          f" -> {sharding_penalty(u, s, 10.0, 1000.0):.2f}x @1000GB/s"
          f" (paper: ~3.1x -> ~1.2x)")


if __name__ == "__main__":
    main()
