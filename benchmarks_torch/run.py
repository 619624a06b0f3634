"""Benchmark runner of the port: one section per paper table/figure, per
bench and the roofline aggregation (``benchmarks/run.py``'s sections,
plus ``render_experiments``).

    PYTHONPATH=src python -m benchmarks_torch.run [--only NAME]
        [--emit-json] [--device cpu] [--reduced] [--out-dir DIR]
        [--reports-dir DIR]

The figures are the perf model's and run anywhere. The benches run on the
card, at full width, unless ``--device cpu`` (their plain versions on the
host) or ``--reduced`` (the reference's sizes) say otherwise;
``--device``, ``--reduced`` and ``--out-dir`` pass through to every bench
section. The fleet, host-tier and online sections (``cluster``,
``fabric``, ``elastic``, ``hoststore``, ``online``) take the reference's
``--tiny``. ``roofline`` and ``render_experiments`` render the port's
dry-run reports (``repro_torch.launch.dryrun``) under ``--reports-dir``
(default ``reports/torch``).
"""
import argparse
import sys
import time

from benchmarks_torch import (bench_cluster, bench_elastic,
                              bench_engine_serve, bench_fabric,
                              bench_hoststore, bench_online, bench_pipeline,
                              bench_tiered_embedding, fig6_membw,
                              fig8_inference, fig9_latency, fig10_sharding,
                              fig11_training, fig12_13_phases, kernel_bench,
                              render_experiments, roofline,
                              table16_17_upper_bounds)

# (name, main, the section's own arguments, whether it is a bench that
# takes --device / --out-dir / --reduced)
SECTIONS = [
    ("fig6", fig6_membw.main, (), False),
    ("fig8", fig8_inference.main, (), False),
    ("fig9", fig9_latency.main, (), False),
    ("fig10", fig10_sharding.main, (), False),
    ("fig11", fig11_training.main, (), False),
    ("fig12_13", fig12_13_phases.main, (), False),
    ("table16_17", table16_17_upper_bounds.main, (), False),
    ("kernels", kernel_bench.main, (), True),
    ("tiered_embedding", bench_tiered_embedding.main, (), True),
    ("engine_serve", bench_engine_serve.main, ("--queries", "80"), True),
    ("pipeline", bench_pipeline.main, ("--tiny",), True),
    ("cluster", bench_cluster.main, ("--tiny",), True),
    ("fabric", bench_fabric.main, ("--tiny",), True),
    ("elastic", bench_elastic.main, ("--tiny",), True),
    ("hoststore", bench_hoststore.main, ("--tiny",), True),
    ("online", bench_online.main, ("--tiny",), True),
    ("roofline", roofline.main, (), False),
    ("render_experiments", render_experiments.main, (), False),
]

# the reference's sections the port does not run yet, and why
NOT_PORTED: dict = {}

# sections that render the dry-run's reports (they take --reports-dir)
READS_REPORTS = {"roofline", "render_experiments"}

# sections that can write a BENCH_torch_<name>.json artifact
EMITS_JSON = {"kernels", "pipeline", "tiered_embedding", "engine_serve",
              "cluster", "fabric", "elastic", "hoststore", "online"}
# sections with a model config that --reduced cuts to the reference's size
# (tiered_embedding's defaults are the reference's already)
REDUCES = {"kernels", "engine_serve", "pipeline", "cluster", "fabric",
           "elastic", "hoststore", "online"}


def section_args(name: str, emit_json: bool, device=None, reduced=False,
                 out_dir=None, extra=()) -> list:
    """The argv a section's ``main`` gets from the driver."""
    own = dict((n, a) for n, _, a, _ in SECTIONS)[name]
    args = [*own, *extra]
    if emit_json and name in EMITS_JSON:
        args.append("--emit-json")
    if device is not None:
        args += ["--device", device]
    if reduced and name in REDUCES:
        args.append("--reduced")
    if out_dir is not None:
        args += ["--out-dir", out_dir]
    return args


def run_section(name: str, argv: list) -> int:
    """Run one section with ``argv`` (a figure takes none); returns its
    code: nonzero when a headline claim failed."""
    fn, bench = next((f, b) for n, f, _, b in SECTIONS if n == name)
    return (fn(argv) if bench or name in READS_REPORTS else fn()) or 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", default=None,
                   choices=[n for n, _, _, _ in SECTIONS] + list(NOT_PORTED),
                   metavar="SECTION",
                   help="run a single section; one of: "
                        + ", ".join(n for n, _, _, _ in SECTIONS))
    p.add_argument("--emit-json", action="store_true",
                   help="sections that support it write their claims + "
                        "scalars as BENCH_torch_<section>.json")
    p.add_argument("--device", default=None,
                   help="the benches' device (default: the card)")
    p.add_argument("--reduced", action="store_true",
                   help="the benches at the reference's sizes")
    p.add_argument("--out-dir", default=None,
                   help="where --emit-json writes (default build/bench/)")
    p.add_argument("--reports-dir", default=None,
                   help="the dry-run's reports for roofline and "
                        "render_experiments (default reports/torch)")
    args = p.parse_args(argv)
    if args.only in NOT_PORTED:
        p.error(f"section {args.only} is not ported: "
                f"{NOT_PORTED[args.only]}")
    failed = []
    for name, _, _, bench in SECTIONS:
        if args.only and name != args.only:
            continue
        t0 = time.time()
        print(f"{'='*72}\n== {name}\n{'='*72}")
        if bench:
            argv_ = section_args(name, args.emit_json, args.device,
                                 args.reduced, args.out_dir)
        elif name in READS_REPORTS and args.reports_dir is not None:
            argv_ = ["--reports-dir", args.reports_dir]
        else:
            argv_ = []
        rc = run_section(name, argv_)
        # sections signal a failed headline claim with a nonzero return
        if rc:
            failed.append(name)
        print(f"== {name} done in {time.time()-t0:.1f}s"
              f"{' [FAILED]' if rc else ''}\n")
    if failed:
        print(f"sections with failed claims: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
