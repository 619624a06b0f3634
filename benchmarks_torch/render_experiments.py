"""Render the §Roofline tables from the port's dry-run reports, baseline
and optimized side by side (the reference's
``benchmarks/render_experiments.py``).

    PYTHONPATH=src python -m benchmarks_torch.render_experiments
        [single|multi] [--reports-dir D]

Reads ``D/dryrun`` (the baseline) and ``D/dryrun_optimized`` (for
instance ``python -m repro_torch.launch.dryrun --dlrm-exchange
partial_pool --out D/dryrun_optimized``); ``D`` defaults to
``reports/torch``.
"""
import argparse
import glob
import json
import os

REPORTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reports", "torch")


def load(dirname, reports=REPORTS):
    recs = {}
    for p in glob.glob(os.path.join(reports, dirname, "*.json")):
        with open(p) as f:
            r = json.load(f)
        recs[r["cell"]] = r
    return recs


def fmt_ms(x):
    return f"{x*1e3:,.0f}"


def table(base, opt, mesh="single"):
    print("| cell | t_comp (ms) | t_mem (ms) | t_coll (ms) | bound | "
          "GiB/dev | opt t_mem | opt t_coll | opt bound | opt GiB |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for cell in sorted(base):
        if not cell.endswith(mesh):
            continue
        b = base[cell]
        o = opt.get(cell)
        if b.get("status") == "not_ported":
            print(f"| {cell} | NOT PORTED | | | | | | | | |")
            continue
        if b.get("status") != "ok":
            print(f"| {cell} | FAIL | | | | | | | | |")
            continue
        rb = b["roofline"]
        mb = b["memory"]["peak_per_device_bytes"] / 2**30
        row = (f"| {cell.replace(':' + mesh, '')} "
               f"| {fmt_ms(rb['t_compute_s'])} "
               f"| {fmt_ms(rb['t_memory_s'])} "
               f"| {fmt_ms(rb['t_collective_s'])} "
               f"| {rb['bottleneck'][:4]} | {mb:.1f} ")
        if o and o.get("status") == "ok":
            ro = o["roofline"]
            mo = o["memory"]["peak_per_device_bytes"] / 2**30
            row += (f"| {fmt_ms(ro['t_memory_s'])} "
                    f"| {fmt_ms(ro['t_collective_s'])} "
                    f"| {ro['bottleneck'][:4]} | {mo:.1f} |")
        else:
            row += "| — | — | — | — |"
        print(row)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("mesh", nargs="?", default="single",
                   choices=["single", "multi"])
    p.add_argument("--reports-dir", default=REPORTS,
                   help="the root of the dry-run's reports (its dryrun/ "
                        "and dryrun_optimized/)")
    args = p.parse_args(argv)
    base = load("dryrun", args.reports_dir)
    if not base:
        print("# No dry-run reports found — run `python -m "
              "repro_torch.launch.dryrun`")
        return 0
    table(base, load("dryrun_optimized", args.reports_dir), args.mesh)
    return 0


if __name__ == "__main__":
    main()
