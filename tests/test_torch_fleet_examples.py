"""The port's fleet and LM examples (``examples_torch.{cluster_sla,
fabric_sharding,lm_mini}``) on the CPU, held against the reference's
(``examples``), and ``benchmarks_torch.run``'s new sections, the
dry-run's ``roofline`` and ``render_experiments`` on a meta dry-run.

``fabric_sharding``'s capacity lines (the table set, the board budget and
the one-board refusal, in the config's nominal bytes) equal the
reference's; the reference's fleets are stubbed there, since only those
lines are compared. ``cluster_sla`` runs its three stories,
``fabric_sharding`` serves its three fleets with identical results cache
on and off, and ``lm_mini`` trains ``internlm2-1.8b`` at ``reduced()`` for
a few steps, then prefills and decodes.
"""
import contextlib
import io
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmarks_torch import render_experiments, run  # noqa: E402
from examples import fabric_sharding as ref_fabric_sharding  # noqa: E402
from examples_torch import cluster_sla, fabric_sharding, lm_mini  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

NEW_SECTIONS = ("cluster", "fabric", "elastic", "hoststore", "online")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().splitlines()


class _NoFleetEngine:
    """The reference example's engine, stubbed: its capacity lines come
    before any fleet is built."""

    def __init__(self, cfg, **kw):
        pass

    def sharded_fleet(self, **kw):
        report = SimpleNamespace(p50_ms=1.0, ppf_ms=1.0, bytes_per_query=1.0,
                                 ok=True)
        return SimpleNamespace(run=lambda *a, **k: report,
                               completed={q: SimpleNamespace(
                                   probs=np.zeros(8)) for q in range(80)})


def test_fabric_sharding_capacity_lines_equal_the_reference(monkeypatch):
    monkeypatch.setattr(ref_fabric_sharding, "Engine", _NoFleetEngine)
    capacity = ("tables:", "1-board partition refuses:")
    want = [ln for ln in _printed(ref_fabric_sharding.main)
            if ln.startswith(capacity)]
    got_all = _printed(fabric_sharding.main, ["--device", "cpu"])
    got = [ln for ln in got_all if ln.startswith(capacity)]
    assert len(want) == 2 and got == want
    assert "fits one board: False" in got[0]
    runs = [ln.split(":")[0] for ln in got_all
            if ln.startswith(("cache on", "cache off", "slow link"))]
    assert runs == ["cache on ", "cache off", "slow link"]
    assert "served results identical with cache on/off: True" in got_all
    cut = [ln for ln in got_all if ln.startswith("remote-row cache:")]
    assert len(cut) == 1 and float(cut[0].split("(")[1].split("x")[0]) > 1


def test_cluster_sla_runs_its_three_stories():
    lines = _printed(cluster_sla.main, ["--device", "cpu"])
    assert [ln for ln in lines if ln.startswith("== ")][:3] == [
        "== diurnal day, 2 replicas, p2c routing",
        "== flash crowd from 1 replica: autoscaling off vs on",
        "== zipf drift, 2 replicas, hit-ratio monitor"]
    flash = [ln for ln in lines if ln.startswith("autoscale o")]
    assert [ln.split(":")[0] for ln in flash] == ["autoscale off",
                                                  "autoscale on "]
    drift = {ln.split(":")[0].strip(): ln for ln in lines
             if ln.startswith("refresh o")}
    assert "0 lfu_refresh" in drift["refresh off"]
    assert "1 lfu_refresh" in drift["refresh on"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-3b"])
def test_lm_mini_trains_prefills_and_decodes(arch):
    lines = _printed(lm_mini.main, ["--device", "cpu", "--arch", arch,
                                    "--steps", "4"])
    assert lines[0].startswith(f"== {arch}-smoke") or arch in lines[0]
    steps = [ln for ln in lines if ln.lstrip().startswith("step")]
    assert len(steps) == 2                      # step 0 and the last
    ce = [float(ln.split("ce=")[1].split()[0]) for ln in steps]
    assert all(np.isfinite(ce))
    gen = [ln for ln in lines if ln.startswith("== prompt")]
    assert len(gen) == 1
    tokens = gen[0].split("generated ")[1].strip("[]").split(", ")
    assert len(tokens) == 9 and all(t.isdigit() for t in tokens)


# ---------------------------------------------------------------------------
# benchmarks_torch.run knows the new sections; the rest refuse without a card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NEW_SECTIONS)
def test_run_knows_the_new_sections(name):
    assert name in [n for n, _, _, _ in run.SECTIONS]
    assert name in run.EMITS_JSON and name in run.REDUCES
    args = run.section_args(name, True, device="cpu", reduced=True,
                            out_dir="o")
    assert args == ["--tiny", "--emit-json", "--device", "cpu",
                    "--reduced", "--out-dir", "o"]


def _quiet(main, argv):
    """``main(argv)`` with its printed lines; returns (rc, lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def dry_run_reports(tmp_path_factory):
    """A tiny dry-run on the meta device: two DLRM cells in both wire
    modes (the optimized reports in partial_pool) and mixtral-8x7b's
    single-pod LM cells, which are not ported (ROADMAP A8c-ii-b)."""
    root = tmp_path_factory.mktemp("reports")
    cells = ("dlrm:dlrm-rm2-small-unsharded:serve:single",
             "dlrm:dlrm-rm2-small-sharded:serve:single")
    for cell in cells:
        for sub, mode in (("dryrun", "unpooled"),
                          ("dryrun_optimized", "partial_pool")):
            rc, lines = _quiet(dryrun.main, [
                "--cell", cell, "--device", "meta", "--dlrm-exchange", mode,
                "--out", str(root / sub)])
            assert rc == 0, lines
    rc, lines = _quiet(dryrun.main, [
        "--arch", "mixtral-8x7b", "--mesh", "single", "--device", "meta",
        "--out", str(root / "dryrun")])
    assert rc == 0, lines
    return root, cells


@pytest.mark.parametrize("name", ["roofline", "render_experiments"])
def test_run_has_the_dry_run_sections(name):
    assert name in [n for n, _, _, _ in run.SECTIONS]
    assert run.NOT_PORTED == {} and name in run.READS_REPORTS


def test_run_renders_the_roofline_of_a_meta_dry_run(dry_run_reports):
    root, cells = dry_run_reports
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks_torch.run", "--only", "roofline",
         "--reports-dir", str(root)], capture_output=True, text=True,
        cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    for cell in cells:
        row = next(ln for ln in lines if ln.startswith(cell + ","))
        fields = row.split(",")
        assert len(fields) == 8
        assert fields[4] in ("compute", "memory", "collective")
        assert all(float(x) >= 0 for x in fields[1:4] + fields[5:7])
    assert "lm:mixtral-8x7b:train_4k:single,NOT PORTED,,,,,," in lines
    assert "# 2/2 cells ran (meta), 4 not ported" in lines


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_run_renders_the_experiments_of_a_meta_dry_run(dry_run_reports,
                                                        mesh):
    root, cells = dry_run_reports
    rc, lines = _quiet(run.main, ["--only", "render_experiments",
                                  "--reports-dir", str(root)])
    assert rc == 0
    rows = [ln for ln in lines if ln.startswith("| ")]
    assert rows[0].startswith("| cell | t_comp (ms)")
    for cell in cells:
        row = next(r for r in rows if r.startswith(
            f"| {cell.replace(':single', '')} |"))
        assert "—" not in row and row.count("|") == 11   # optimized too
    # the section renders the single-pod mesh; the module takes either
    rc, lines = _quiet(render_experiments.main, [mesh, "--reports-dir",
                                                 str(root)])
    assert rc == 0
    body = [r for r in lines if r.startswith("| ")]
    assert len(body) == (1 + 2 + 4 if mesh == "single" else 1)


@pytest.mark.parametrize("main", [cluster_sla.main, fabric_sharding.main,
                                  lm_mini.main])
def test_fleet_examples_refuse_to_run_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
