"""The port's benchmarks (``benchmarks_torch``) on the CPU, held against the
reference's (``benchmarks``).

The seven figures and ``bench_pipeline.model_sweep`` print exactly what
the reference prints (fig. 6 less the TPU system's rows, which the port's
``core/memsys.py`` leaves out). ``kernel_bench``'s modeled HBM traffic
equals the reference's committed ``BENCH_kernels.json``, its
``kernel_times`` load through both packages' ``core/calibration``, and
its kernel-against-kernel claims hold through the plain versions at the
tolerance the bench states (1e-5). ``bench_tiered_embedding`` on shared
numpy ids gives the reference's hit ratio (exactly) and ``model_speedup``
(within 1e-12 relative) through both packages' ``accumulate_row_freq``,
``build_tiered_tables`` and ``hit_mask``. ``bench_engine_serve --reduced``
writes the reference's artifact keys plus ``device``. Every bench refuses
to run without a card unless it is given ``--device cpu``.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax.numpy as jnp  # noqa: E402

from benchmarks import bench_pipeline as ref_pipeline  # noqa: E402
from benchmarks_torch import (_artifacts, _timing, bench_engine_serve,  # noqa: E402
                              bench_pipeline, bench_tiered_embedding,
                              kernel_bench, run)
from repro.core import perf_model as ref_perf_model  # noqa: E402
from repro.core import tiered_embedding as ref_te  # noqa: E402
from repro.core.calibration import kernel_times_from as ref_kernel_times  # noqa: E402
from repro.configs.base import DLRMConfig as RefDLRMConfig  # noqa: E402
from repro_torch.configs.base import DLRMConfig  # noqa: E402
from repro_torch.core import tiered_embedding as te  # noqa: E402
from repro_torch.core.calibration import kernel_times_from  # noqa: E402
from repro_torch.data.recsys import zipf_indices  # noqa: E402

torch.set_num_threads(1)

FIGURES = ("fig6_membw", "fig8_inference", "fig9_latency", "fig10_sharding",
           "fig11_training", "fig12_13_phases", "table16_17_upper_bounds")


def _printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return out.getvalue().splitlines(), result


def _load(out_dir, name):
    with open(os.path.join(out_dir, f"BENCH_torch_{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", FIGURES)
def test_figure_prints_the_reference_lines(name):
    import importlib
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"benchmarks_torch.{name}")
    want, _ = _printed(ref.main)
    got, _ = _printed(port.main)
    if name == "fig6_membw":
        dropped = [ln for ln in want if ln.startswith("tpu-v5e-hbm,")]
        assert len(dropped) == 3
        want = [ln for ln in want if not ln.startswith("tpu-v5e-hbm,")]
    assert got == want and len(got) > 3


@pytest.mark.parametrize("batches,depths,mode", [
    ([1024, 4096, 16384], [1, 2, 4, 8], "training"),
    ([4096], [1, 2, 4], "training"),
    ([1024, 4096], [1, 2, 4, 8], "inference")])
def test_pipeline_model_sweep_equals_the_reference(batches, depths, mode):
    want, want_top = _printed(ref_pipeline.model_sweep, batches, depths, mode)
    got, got_top = _printed(bench_pipeline.model_sweep, batches, depths, mode)
    assert got == want
    assert got_top == want_top


def test_kernel_bench_traffic_model_equals_the_reference_artifact():
    with open(os.path.join(REPO, "BENCH_kernels.json")) as f:
        want = json.load(f)["scalars"]["hbm_traffic_model"]
    shape = kernel_bench._SERVE_SHAPE
    got = kernel_bench.hbm_traffic_model(shape["T"], shape["L"], shape["d"],
                                         shape["B"])
    assert got == want
    assert got["composed_bytes"] == 85_338_400
    assert got["fused_bytes"] == 83_290_400


def test_kernel_bench_receipt_on_the_plain_versions(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_bench, "ITERS", 1)     # host times: plumbing
    monkeypatch.setattr(kernel_bench, "N_SETS", 1)
    rc = kernel_bench.main(["--device", "cpu", "--reduced", "--emit-json",
                            "--out-dir", str(tmp_path)])
    art = _load(tmp_path, "kernels")
    assert rc == 0 and art["ok"]
    assert art["device"]["platform"] == "cpu"
    claims = {c["name"]: c for c in art["claims"]}
    # launches and speed are judged on the card only
    assert set(claims) == {"fused_hbm_roundtrip_eliminated",
                           "fused_matches_composed_single",
                           "fused_matches_composed_tiered"}
    assert all(c["ok"] for c in claims.values())
    with open(os.path.join(REPO, "BENCH_kernels.json")) as f:
        ref_art = json.load(f)
    assert (art["scalars"]["hbm_traffic_model"]
            == ref_art["scalars"]["hbm_traffic_model"])
    # calibration schema, read by both packages
    got = kernel_times_from(art["scalars"])
    assert got == ref_kernel_times(art["scalars"])
    assert set(got) == set(kernel_bench.kernel_times(art["scalars"]["rows"],
                                                     200))
    assert len(got) == 9 and all(us > 0 for us in got.values())
    for row in art["scalars"]["rows"]:
        assert row["bound_ms"] > 0 and row["bytes"] > 0


def test_kernel_bench_tiny_equivalence_holds_through_plain_versions():
    errs = kernel_bench.tiny_equivalence(torch.device("cpu"))
    assert set(errs) == {"single", "tiered"}
    assert max(errs.values()) <= kernel_bench.EQUIV_TOL


def _ids(gen, shape, R, alpha):
    return zipf_indices(gen, shape, R, alpha).numpy()


@pytest.mark.parametrize("alpha", [0.0, 1.05])
@pytest.mark.parametrize("frac", [0.01, 0.05, 0.1])
def test_tiered_hit_ratio_and_model_equal_the_reference(alpha, frac):
    T, R, d, L, B = 4, 4096, 8, 16, 32
    rng = np.random.default_rng(0)
    tables = rng.standard_normal((T, R, d)).astype(np.float32)
    gen = torch.Generator().manual_seed(5)
    profile = [_ids(gen, (B, T, L), R, alpha) for _ in range(4)]
    held_out = _ids(gen, (B, T, L), R, alpha)

    freq = torch.zeros((T, R), dtype=torch.int32)
    ref_freq = jnp.zeros((T, R), jnp.int32)
    for ids in profile:
        te.accumulate_row_freq(freq, torch.from_numpy(ids))
        ref_freq = ref_te.accumulate_row_freq(ref_freq, jnp.asarray(ids))
    np.testing.assert_array_equal(freq.numpy(), np.asarray(ref_freq))

    cfg = DLRMConfig(name="bench-tiered", num_tables=T, lookups_per_table=L,
                     embed_dim=d, rows_per_table=R, batch_size=B)
    store, hit, model = bench_tiered_embedding.sweep_point(
        torch.from_numpy(tables), freq, torch.from_numpy(held_out), frac,
        cfg)
    ref_store = ref_te.build_tiered_tables(
        jnp.asarray(tables), ref_freq, max(1, int(R * frac)))
    np.testing.assert_array_equal(store.row_map.numpy(),
                                  np.asarray(ref_store.row_map))
    ref_hit = float(jnp.mean(ref_te.hit_mask(ref_store,
                                             jnp.asarray(held_out))))
    assert hit == ref_hit
    ref_cfg = RefDLRMConfig(name="bench-tiered", num_tables=T,
                            lookups_per_table=L, embed_dim=d,
                            rows_per_table=R, batch_size=B)
    hybrid = ref_perf_model.recspeed_hybrid_system()
    want = (ref_perf_model.breakdown(ref_cfg, hybrid, "inference",
                                     hit_ratio=ref_hit).qps
            / ref_perf_model.breakdown(ref_cfg, hybrid, "inference",
                                       hit_ratio=0.0).qps)
    assert model == pytest.approx(want, rel=1e-12)


def test_tiered_bench_smoke_writes_its_sweep(tmp_path):
    rc = bench_tiered_embedding.main(["--device", "cpu", "--smoke",
                                      "--emit-json", "--out-dir",
                                      str(tmp_path)])
    art = _load(tmp_path, "tiered_embedding")
    assert rc == 0
    with open(os.path.join(REPO, "BENCH_tiered_embedding.json")) as f:
        ref_art = json.load(f)
    assert set(ref_art) | {"device"} == set(art)
    assert ({c["name"] for c in art["claims"]}
            == {c["name"] for c in ref_art["claims"]})
    want_keys = set(ref_art["scalars"]["sweep"][0])
    assert len(art["scalars"]["sweep"]) == 6
    for row in art["scalars"]["sweep"]:
        assert want_keys <= set(row)
        assert 0.0 <= row["hit_ratio"] <= 1.0


def test_engine_serve_artifact_keys_match_the_reference(tmp_path):
    bench_engine_serve.main(["--device", "cpu", "--reduced", "--queries", "8",
                             "--capacities", "1,4", "--load-factors", "2.0",
                             "--emit-json", "--out-dir", str(tmp_path)])
    art = _load(tmp_path, "engine_serve")
    with open(os.path.join(REPO, "BENCH_engine_serve.json")) as f:
        ref_art = json.load(f)
    assert set(ref_art) | {"device"} == set(art)
    assert art["device"]["platform"] == "cpu"
    assert {"sweep", "wins"} <= set(art["scalars"])
    assert ({c["name"] for c in art["claims"]}
            == {c["name"] for c in ref_art["claims"]})
    assert len(art["scalars"]["sweep"]) == 4     # 2 plans x 2 capacities
    for row in art["scalars"]["sweep"]:
        assert set(row) == set(ref_art["scalars"]["sweep"][0])
    for win in art["scalars"]["wins"]:
        assert set(win) == set(ref_art["scalars"]["wins"][0])
    assert art["scalars"]["config"] == "dlrm-rm2-small-unsharded-smoke"
    assert art["scalars"]["peak_gb"] is None     # no device memory read


def test_run_passes_device_and_out_dir_to_the_benches(tmp_path):
    rc = run.main(["--only", "pipeline", "--device", "cpu", "--reduced",
                   "--emit-json", "--out-dir", str(tmp_path)])
    art = _load(tmp_path, "pipeline")
    assert rc == 0
    assert art["device"]["platform"] == "cpu"
    rows = art["scalars"]["measured_rows"]
    small = {r["depth"] for r in rows
             if r["config"] == "dlrm-rm2-small-unsharded"}
    assert small == {1, 2, 4, 8}
    assert {r["exchange"] for r in rows} == {"pooled_a2a", "partial_pool",
                                            "unpooled"}


def test_run_only_rejects_unknown_section():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks_torch.run", "--only",
         "nosuchsection"], capture_output=True, text=True, cwd=REPO,
        timeout=300, env={**os.environ, "PYTHONPATH": os.path.join(REPO,
                                                                   "src")})
    assert proc.returncode == 2, proc.stderr
    assert "invalid choice" in proc.stderr
    assert "tiered_embedding" in proc.stderr   # valid names are listed


@pytest.mark.parametrize("call", [
    lambda: _timing.time_ms(lambda k: None),
    lambda: _timing.paired_medians([lambda: None], 1, 1),
    lambda: _timing.host_median_s(lambda: None, 1, 1),
    lambda: kernel_bench.main(["--reduced"]),
    lambda: bench_tiered_embedding.main(["--smoke"]),
    lambda: bench_engine_serve.main(["--reduced"]),
    lambda: bench_pipeline.main(["--tiny", "--reduced"])])
def test_benches_refuse_to_time_without_a_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_cpu_device_block_is_not_a_device_number():
    block = _artifacts.device_block(torch.device("cpu"))
    assert block["platform"] == "cpu" and block["power_limit_w"] is None
    assert "not a device number" in _artifacts.device_label(block)
