"""Paper Fig. 6: peak random embedding-access bandwidth per memory system.

The reference's rows, less its TPU entry (``tpu-v5e-hbm``), which the
port's ``core/memsys.py`` leaves out."""
from repro_torch.core import memsys

SYSTEMS = {
    "xeon-ddr4-6ch": memsys.xeon_ddr4_6ch(),
    "v100-hbm2-4stack": memsys.v100_hbm2(),
    "a100-hbm2e-5stack": memsys.a100_hbm2e(),
    "recspeed-hbm2e-6stack": memsys.recspeed_hbm2e(),
    "gddr6-tu102": memsys.gddr6_tu102(),
}
SIZES = (64, 128, 256)


def rows():
    out = []
    for name, sys_ in SYSTEMS.items():
        for size in SIZES:
            out.append({
                "system": name,
                "access_bytes": size,
                "random_gbs": sys_.random_access_bytes_per_s(size) / 1e9,
                "stream_gbs": sys_.peak_stream_bytes_per_s / 1e9,
            })
    return out


def main():
    print("# Fig. 6 — random embedding access bandwidth (GB/s)")
    print("system,access_bytes,random_GBs,stream_GBs,efficiency")
    for r in rows():
        print(f"{r['system']},{r['access_bytes']},{r['random_gbs']:.1f},"
              f"{r['stream_gbs']:.1f},{r['random_gbs']/r['stream_gbs']:.3f}")


if __name__ == "__main__":
    main()
