"""The port's serving slice against repro.engine on the same weights.

The JAX session's params go through numpy into the port's session on the
CPU, and the same numpy queries go to both. Tolerance: fp32 allclose at
rtol = atol = 1e-5 (tests/test_kernels.py).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro.engine import Engine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_dlrm
from repro_torch.engine import Engine, MicroBatcher, SLAReport
from repro_torch.parallel.build import build_step

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "dlrm-rm2-small-unsharded"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX session, port session) over the same weights, capacity 2."""
    jsess = JaxEngine(jax_get_dlrm(NAME).reduced(), plan="none") \
        .serve_session(max_batch_queries=2, max_wait_ms=50.0)
    params = convert.params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jsess.params), "cpu")
    sess = Engine(get_dlrm(NAME).reduced(), device="cpu").serve_session(
        max_batch_queries=2, max_wait_ms=50.0, params=params)
    return jsess, sess


def _query(cfg, seed):
    rng = np.random.default_rng(seed)
    q = cfg.batch_size
    return (rng.standard_normal((q, cfg.num_dense)).astype(np.float32),
            rng.integers(0, cfg.rows_per_table,
                         (q, cfg.num_tables, cfg.lookups_per_table)
                         ).astype(np.int32))


def test_serve_direct_matches_reference(pair):
    jsess, sess = pair
    assert sess.serve_kernel == jsess.serve_kernel == "fused"
    dense, idx = _query(sess.cfg, 0)
    want = jsess.serve_direct(jnp.asarray(dense), jnp.asarray(idx))
    got = sess.serve_direct(torch.from_numpy(dense), torch.from_numpy(idx))
    np.testing.assert_allclose(got, want, **TOL)


def test_submit_and_flush_match_reference(pair):
    """Same submits and polls at injected times: the two batchers flush
    alike (deadline, then full) and the probs agree."""
    jsess, sess = pair
    queries = [_query(sess.cfg, s) for s in (1, 2, 3)]
    futs = {}
    for name, s, conv in (("jax", jsess, jnp.asarray),
                          ("torch", sess, torch.from_numpy)):
        fs = [s.submit({"dense": conv(queries[0][0]),
                        "indices": conv(queries[0][1])}, now=0.0)]
        assert s.pending == 1 and not fs[0].done
        assert not s.poll(now=0.049)               # before the deadline
        assert s.poll(now=0.050) and fs[0].done    # deadline flush
        for i, (d, x) in enumerate(queries[1:]):
            fs.append(s.submit({"dense": conv(d), "indices": conv(x)},
                               now=1.0 + i * 1e-3))
        assert s.pending == 0 and all(f.done for f in fs)   # full flush
        assert fs[2].completed_at == 1.001
        futs[name] = fs
    for fj, ft in zip(futs["jax"], futs["torch"]):
        np.testing.assert_allclose(ft.probs, fj.probs, **TOL)


def test_micro_batcher_flushes_at_injected_now():
    from repro.engine.batching import MicroBatcher as JaxMicroBatcher
    from repro.engine.batching import QueryFuture as JaxQueryFuture
    from repro_torch.engine import QueryFuture
    events = [0.0, 0.001, 0.010, 0.0105, 0.011, 0.030]
    seen = []
    for batcher_cls, fut_cls in ((JaxMicroBatcher, JaxQueryFuture),
                                 (MicroBatcher, QueryFuture)):
        b = batcher_cls(capacity=3, max_wait_s=0.005)
        log = []
        for i, t in enumerate(events):
            if b.due(t):
                log.append(("deadline", t, [f.qid for f in b.drain()]))
            if b.add(fut_cls(i, t, {})):
                log.append(("full", t, [f.qid for f in b.drain()]))
        seen.append(log)
    assert seen[0] == seen[1]
    assert [r for r, _, _ in seen[1]] == ["deadline", "full"]


def test_run_serial_and_open_loop_report_every_query(pair):
    _, sess = pair
    rep = sess.run_serial(5, sla_ms=60_000.0)
    assert isinstance(rep, SLAReport) and rep.mode == "serial"
    assert rep.n_queries == 5 and rep.blame.n_queries == 5 and rep.ok
    rep = sess.run_open_loop(6, qps=1000.0, sla_ms=60_000.0)
    assert rep.n_queries == 6 and rep.blame.n_queries == 6
    assert 1.0 <= rep.mean_batch_queries <= 2.0


def test_composed_path_and_depth_agree_with_fused(pair):
    _, sess = pair
    dense, idx = (torch.from_numpy(a) for a in _query(sess.cfg, 4))
    want = sess.serve_direct(dense, idx)
    cfg = get_dlrm(NAME).reduced()
    for kw in ({"fused_serve": "off"}, {"pipeline_depth": 2}):
        other = Engine(cfg, device="cpu", **kw).serve_session(
            max_batch_queries=2, params=sess.params)
        np.testing.assert_allclose(other.serve_direct(dense, idx), want,
                                   **TOL)
    assert Engine(cfg, device="cpu", fused_serve="off").serve_session(
        params=sess.params).serve_kernel == "composed"


@pytest.mark.parametrize("fused_serve,kernel",
                         [("auto", "fused"), ("off", "composed")])
def test_session_reports_the_branch_build_step_chose(fused_serve, kernel):
    cfg = get_dlrm(NAME).reduced()
    step = build_step(cfg, fused=fused_serve != "off")
    assert step.serve_kernel == kernel
    sess = Engine(cfg, device="cpu", fused_serve=fused_serve).serve_session(
        max_batch_queries=2)
    assert sess.serve_kernel == kernel


def test_pipeline_depth_below_one_is_refused():
    cfg = get_dlrm(NAME).reduced()
    with pytest.raises(ValueError, match="pipeline_depth"):
        build_step(cfg, pipeline_depth=0)
    with pytest.raises(ValueError, match="pipeline_depth"):
        Engine(cfg, device="cpu", pipeline_depth=0).serve_session()


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)


def test_launcher_serves_on_cpu_when_asked():
    proc = _launch("--device", "cpu", "--queries", "4")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "serve_kernel=fused" in proc.stdout


@pytest.mark.parametrize("flags,depth", [
    (["--plan", "auto", "--alpha", "1.05"], 8),
    (["--plan", "auto", "--fast-mb", "0.01", "--pipeline-depth", "2"], 2)])
def test_launcher_serves_a_planned_session(flags, depth):
    proc = _launch("--device", "cpu", "--queries", "3", *flags)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    plan_line = proc.stdout.splitlines()[0]
    assert plan_line.startswith("[plan] mode=table_wise"), proc.stdout
    assert "predicted_qps=" in plan_line
    assert (f"serve_kernel=fused device=cpu pipeline_depth={depth}"
            in proc.stdout)


def test_launcher_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _launch("--queries", "4")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_dlrm(NAME).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg)
    from repro_torch.engine import ServeSession
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeSession(cfg)


@pytest.mark.parametrize("kw", [{"dp_axes": ("data",)}, {"model_axis": 2}])
def test_features_not_ported_fail_loudly(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        Engine(get_dlrm(NAME).reduced(), device="cpu", **kw)


# The host chunk tier (ROADMAP A5) is ported: its Engine keywords and
# launcher flags, which raised naming A5 before, now reach the tier.
HOST_MB = 0.1            # below the reduced config's 0.125 MiB of tables


def _host_session(**kw):
    from repro_torch.hoststore import HostTieredExchange
    sess = Engine(get_dlrm(NAME).reduced(), device="cpu", alpha=1.05,
                  **{"host_capacity_mb": HOST_MB, **kw}).serve_session(
        max_batch_queries=1)
    assert isinstance(sess.exchange, HostTieredExchange)
    assert sess.serve_kernel == "composed"
    return sess


def test_host_capacity_reaches_the_host_tier():
    sess = _host_session(host_capacity_mb=1.0)
    ex = sess.exchange
    cfg = sess.cfg
    assert ex.hot_slots == min(cfg.rows_per_table, int(0.5 * 2 ** 20) // (
        cfg.num_tables * cfg.embed_dim * 4))
    probs, service, stall = sess._execute([sess._make_query(5)])
    assert probs.shape == (1, cfg.batch_size) and 0.0 <= stall <= service


@pytest.mark.parametrize("flag", [
    ["--online-every-s", "1"], ["--coherence", "invalidate"],
    ["--online-lr", "0.1"], ["--online-steps", "2"],
    ["--record-deltas", "deltas.jsonl"]])
def test_single_board_serves_frozen_params_under_online_flags(
        flag, capsys, tmp_path):
    """The online flags drive the fleet paths; on one board they change
    nothing, as in the reference launcher: no channel is trained or
    recorded, and the session serves as it does without them."""
    from repro_torch.launch import serve
    flag = [str(tmp_path / f) if f.endswith(".jsonl") else f for f in flag]
    argv = ["--smoke", "--device", "cpu", "--queries", "2",
            "--report-json", str(tmp_path / "r.json")]
    assert serve.main(argv) == 0
    frozen = capsys.readouterr().out
    assert serve.main([*argv, *flag]) == 0
    out = capsys.readouterr().out
    assert "one board serves frozen params" in out
    assert "[serve] online:" not in out and "[online]" not in out
    assert not (tmp_path / "deltas.jsonl").exists()
    def kept(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("[serve] serve_kernel=", "[serve] dlrm"))]
    assert kept(out) == kept(frozen) and len(kept(out)) == 2


@pytest.mark.parametrize("depth", range(1, 9))
def test_pinned_depth_is_clamped_as_the_reference(pair, depth):
    """A pinned depth is clamped to a divisor of the capacity batch, as
    the reference's ``resolve_pipeline_depth`` clamps it."""
    jsess, sess = pair
    for queries in (1, 2, 3, 4):
        want = JaxEngine(jsess.cfg, pipeline_depth=depth).serve_session(
            max_batch_queries=queries, params=jsess.params).pipeline_depth
        got = Engine(sess.cfg, device="cpu", pipeline_depth=depth) \
            .serve_session(max_batch_queries=queries,
                           params=sess.params).pipeline_depth
        assert got == want, (depth, queries)


def test_launcher_serves_a_pinned_depth_that_needs_clamping():
    proc = _launch("--device", "cpu", "--queries", "3", "--pipeline-depth",
                   "3")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "pipeline_depth=2 (capacity batch, 64 samples)" in proc.stdout


def _serve(capsys, *flags):
    from repro_torch.launch import serve
    rc = serve.main(["--smoke", "--device", "cpu", "--queries", "4",
                     "--max-batch-queries", "2", *flags])
    return rc, capsys.readouterr().out


def test_launcher_sla_percentile(capsys):
    rc, out = _serve(capsys, "--sla-percentile", "90")
    assert rc == 0, out
    assert "SLA check PPF(D_Q, 90)" in out


def test_launcher_trace_out(capsys, tmp_path):
    path = tmp_path / "trace.json"
    rc, out = _serve(capsys, "--qps", "50", "--trace-out", str(path))
    assert rc == 0, out
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "serve_batch" for e in events)
    assert f"trace -> {path}" in out


def test_launcher_metrics_out(capsys, tmp_path):
    path = tmp_path / "metrics.json"
    rc, out = _serve(capsys, "--metrics-out", str(path))
    assert rc == 0, out
    snap = json.loads(path.read_text())
    assert snap["flush_service_ms"]["count"] >= 4
    assert f"metrics -> {path}" in out


def test_launcher_report_json(capsys, tmp_path):
    path = tmp_path / "report.json"
    rc, out = _serve(capsys, "--sla-percentile", "95", "--report-json",
                     str(path))
    assert rc == 0, out
    rep = json.loads(path.read_text())
    assert rep["n_queries"] == 4 and rep["percentile"] == 95.0
    assert rep["mode"] == "serial" and rep["ok"] is True


@pytest.mark.parametrize("flag,item", [(["--model-axis", "2"], "A6b")])
def test_reference_launcher_flags_not_ported_name_their_item(flag, item):
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        serve.main(["--smoke", "--device", "cpu", *flag])


@pytest.mark.parametrize("exchange", ["partial_pool", "unpooled"])
def test_launcher_exchange_flag_serves_the_row_wise_config(capsys, exchange):
    """--exchange, which raised naming A6 before, picks the row-wise wire
    mode: the sharded config serves composed through it."""
    from repro_torch.launch import serve
    rc = serve.main(["--smoke", "--device", "cpu", "--queries", "2",
                     "--config", "dlrm-rm2-small-sharded", "--exchange",
                     exchange])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "serve_kernel=composed" in out
    assert "[serve] dlrm-rm2-small-sharded-smoke:" in out


@pytest.mark.parametrize("flag,want", [
    (["--host-chunk-rows", "2"], "chunk_rows 2,"),
    (["--host-hot-fraction", "0.4"], "40 hot rows a table"),
    (["--calibration", "calib.json"], "link 50.00 GB/s + 3.00 us")])
def test_host_tier_launcher_flags_reach_the_tier(capsys, tmp_path, flag,
                                                 want):
    from repro_torch.launch import serve
    if flag[0] == "--calibration":
        path = tmp_path / flag[1]
        path.write_text(json.dumps(
            {"host_link": {"latency_us": 3.0, "bandwidth_gbs": 50.0}}))
        flag = [flag[0], str(path)]
    rc = serve.main(["--smoke", "--device", "cpu", "--queries", "2",
                     "--alpha", "1.05", "--host-capacity-mb", str(HOST_MB),
                     *flag])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[serve] host chunk tier: tables 0.125 MiB vs device budget " \
        "0.100 MiB" in out
    assert want in out and "serve_kernel=composed" in out


def test_host_tier_refuses_fleet_flags():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="single-board"):
        serve.main(["--smoke", "--device", "cpu", "--host-capacity-mb", "1",
                    "--replicas", "2"])


@pytest.mark.parametrize("kw,item", [
    ({"mesh": object()}, "A6b"), ({"axis": "model"}, "A6b")])
def test_reference_engine_options_not_ported_name_their_item(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Engine(get_dlrm(NAME).reduced(), device="cpu", **kw)


@pytest.mark.parametrize("option", ["host_chunk_rows", "host_hot_fraction",
                                    "host_link", "calibration", "metrics"])
def test_host_tier_engine_options_reach_the_tier(option):
    from repro_torch.core import perf_model
    from repro_torch.obs import MetricsRegistry
    link = perf_model.host_link(latency_us=2.0, bandwidth_gbs=40.0)
    reg = MetricsRegistry()
    value = {"host_chunk_rows": 2, "host_hot_fraction": 0.4,
             "host_link": link, "metrics": reg,
             "calibration": {"host_link": {"bandwidth_gbs": 30.0}}}[option]
    sess = _host_session(**{option: value})
    ex = sess.exchange
    if option == "host_chunk_rows":
        assert ex.mgr.chunk_rows == 2
    elif option == "host_hot_fraction":
        assert ex.hot_slots == 40       # 0.4 of 0.1 MiB, 8 tables of d=32
    elif option == "host_link":
        assert ex.link is link
    elif option == "calibration":
        assert ex.link.bandwidth == pytest.approx(30.0e9)
        assert ex.link.latency == pytest.approx(10.0e-6)
    else:
        sess._execute([sess._make_query(5)])
        assert reg.total("swap_faults") > 0 and reg.total("swap_bytes") > 0


def test_host_tier_options_are_validated_as_the_reference():
    cfg = get_dlrm(NAME).reduced()
    for kw, match in (({"host_capacity_mb": 0}, "must be > 0"),
                      ({"host_capacity_mb": 1.0, "plan": "auto"},
                       "plan='none'"),
                      ({"host_capacity_mb": 1.0, "optimizer": "adagrad"},
                       "SGD-only")):
        with pytest.raises(ValueError, match=match):
            Engine(cfg, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            JaxEngine(jax_get_dlrm(NAME).reduced(), **kw)


def test_host_tier_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.hoststore import build_host_exchange
    cfg = get_dlrm(NAME).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, host_capacity_mb=HOST_MB)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_host_exchange(cfg, device_capacity_bytes=2 ** 16)


def test_reference_axis_default_is_accepted():
    Engine(get_dlrm(NAME).reduced(), device="cpu", axis=["data", "model"])


@pytest.mark.parametrize("kw", [{"batch": 8}, {"seq": 128},
                                {"chain_prob": 0.8},
                                {"schedule_steps": 100}])
def test_lm_train_session_options_name_their_item(kw):
    """The LM-session options are ported (ROADMAP A8a): a DLRM session
    ignores them, as the reference's does; an LM config's session takes
    them."""
    from repro_torch.configs import get_arch
    from repro_torch.engine import TrainSession
    from repro_torch.engine.training import LMTrainSession
    eng = Engine(get_dlrm(NAME).reduced(), device="cpu")
    assert isinstance(eng.train_session(**kw), TrainSession)
    lm = Engine(get_arch("internlm2-1.8b").reduced(), device="cpu")
    assert isinstance(lm.train_session(**kw), LMTrainSession)


def test_serve_launcher_host_tier_smoke_on_cpu():
    proc = _launch("--device", "cpu", "--queries", "4", "--alpha", "1.05",
                   "--host-capacity-mb", str(HOST_MB))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[serve] host tier:" in proc.stdout
    assert "swap_stall" in proc.stdout and "PASS" in proc.stdout
