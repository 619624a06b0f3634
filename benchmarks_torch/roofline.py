"""§Roofline aggregation of the port's dry-run (the reference's
``benchmarks/roofline.py``): reads ``reports/torch/dryrun/*.json``
(written by ``repro_torch.launch.dryrun``) and renders the per-(cell x
mesh) roofline table: three terms, the dominant bottleneck, the
MODEL_FLOPS ratio.

    PYTHONPATH=src python -m benchmarks_torch.roofline [--reports-dir D]

``--reports-dir`` is the root the reports lie under (default
``reports/torch``; the table reads its ``dryrun/``). A cell the port does
not run yet (a MoE or SSM arch's LM cell, ROADMAP A8c-ii-b) is a ``NOT
PORTED`` row.
"""
import argparse
import glob
import json
import os

REPORTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reports", "torch")
REPORT_DIR = os.path.join(REPORTS, "dryrun")


def load_records(report_dir: str = REPORT_DIR):
    recs = []
    for path in sorted(glob.glob(os.path.join(report_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def render(recs, mesh_filter: str = "single"):
    rows = []
    for r in recs:
        if r.get("status") == "not_ported":
            if r["cell"].endswith(mesh_filter):
                rows.append((r["cell"], "NOT PORTED", "", "", "", "", "",
                             ""))
            continue
        if r.get("status") != "ok":
            rows.append((r["cell"], "FAILED", "", "", "", "", "", ""))
            continue
        if not r["cell"].endswith(mesh_filter):
            continue
        rl = r["roofline"]
        mem_gib = r["memory"]["peak_per_device_bytes"] / 2 ** 30
        rows.append((
            r["cell"],
            f"{rl['t_compute_s']*1e3:.2f}",
            f"{rl['t_memory_s']*1e3:.2f}",
            f"{rl['t_collective_s']*1e3:.2f}",
            rl["bottleneck"],
            f"{rl['useful_flops_ratio']:.2f}",
            f"{mem_gib:.2f}",
            f"{rl['model_flops']:.3e}",
        ))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reports-dir", default=REPORTS,
                   help="the root of the dry-run's reports (its dryrun/)")
    args = p.parse_args(argv)
    recs = load_records(os.path.join(args.reports_dir, "dryrun"))
    if not recs:
        print("# No dry-run reports found — run `python -m "
              "repro_torch.launch.dryrun`")
        return 0
    for mesh in ("single", "multi"):
        print(f"# §Roofline — {mesh}-pod mesh "
              f"({'16x16=256' if mesh == 'single' else '2x16x16=512'} "
              "placeholder ranks), terms in ms/step")
        print("cell,t_compute_ms,t_memory_ms,t_collective_ms,bottleneck,"
              "useful_flops_ratio,mem_per_dev_GiB,model_flops")
        for row in render(recs, mesh):
            print(",".join(str(x) for x in row))
        print()
    n_ok = sum(1 for r in recs if r.get("status") == "ok")
    n_np = sum(1 for r in recs if r.get("status") == "not_ported")
    devices = sorted({r["device"] for r in recs if "device" in r})
    print(f"# {n_ok}/{len(recs) - n_np} cells ran ({', '.join(devices)}), "
          f"{n_np} not ported")
    return 0


if __name__ == "__main__":
    main()
