"""The port's fleet (repro_torch.cluster, runtime.elastic) against
repro.cluster.

Routers, the autoscaler and the monitor are held against the reference's
on the same inputs. Whole fleets run in both packages on the reduced
config: the JAX replicas' params go through numpy into the port's, both
packages materialize the same numpy query for an event, and each
session's ``_execute`` is wrapped so that its service time is a fixed
function of the batch size. Then the virtual clock is the same in both,
and the ClusterReports must be equal field for field; the per-query
probs agree at rtol = atol = 1e-5 (tests/test_kernels.py).
"""
import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cluster as jc
import repro.cluster.cluster as jcluster
import repro.core.tiered_embedding as jte
import repro_torch.cluster as pc
import repro_torch.cluster.cluster as pcluster
import repro_torch.core.tiered_embedding as pte
from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro.engine.serving import ServeSession as JaxServeSession
from repro.runtime.elastic import remesh_tree as jax_remesh_tree
from repro.traffic import make_scenario
from repro_torch import convert
from repro_torch.configs import get_dlrm
from repro_torch.engine.serving import ServeSession
from repro_torch.runtime.elastic import remesh_tree

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "dlrm-rm2-small-unsharded"
ALPHA = 1.2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (dataclasses.replace(jax_get_dlrm(NAME).reduced(), batch_size=8),
            dataclasses.replace(get_dlrm(NAME).reduced(), batch_size=8))


# ---------------------------------------------------------------------------
# Routers and the autoscaler (pure policy, stub replicas)
# ---------------------------------------------------------------------------
def _stubs(waits):
    return [SimpleNamespace(rid=i, expected_wait_s=lambda now, w=w: w[0],
                            backlog=lambda now: 0, w=w)
            for i, w in enumerate([[x] for x in waits])]


@pytest.mark.parametrize("policy", ["round_robin", "jsq", "p2c"])
def test_router_picks_match_the_reference(policy):
    rng = np.random.default_rng(5)
    routers = [jc.make_router(policy, seed=3), pc.make_router(policy, seed=3)]
    assert routers[0].name == routers[1].name == policy
    fleets = [_stubs(rng.uniform(0, 1, 4)) for _ in range(2)]
    for rid in range(2):
        for r in fleets[rid]:
            r.w[0] = fleets[0][r.rid].w[0]
    picks = [[], []]
    for k in range(120):
        waits = rng.choice([0.0, 0.1, 0.2, 0.3], size=len(fleets[0]))
        for side in range(2):
            for r, w in zip(fleets[side], waits):
                r.w[0] = float(w)
            picks[side].append(routers[side].pick(fleets[side], k).rid)
        if k == 60:                            # the fleet shrinks
            for side in range(2):
                fleets[side] = fleets[side][:3]
                routers[side].replica_removed(fleets[side])
    assert picks[0] == picks[1]
    assert pc.POLICIES == jc.POLICIES
    with pytest.raises(ValueError, match="unknown router"):
        pc.make_router("nosuch")


@pytest.mark.parametrize("kw", [
    dict(sla_ms=10.0, max_replicas=3, window=4, patience=2,
         scale_down_frac=0.3, cooldown_s=1.0),
    dict(sla_ms=5.0, min_replicas=1, max_replicas=4, window=8, patience=1),
    dict(sla_ms=20.0, min_replicas=2, max_replicas=6, window=3, patience=3,
         scale_down_frac=0.5, cooldown_s=0.05)])
def test_autoscaler_decisions_match_the_reference(kw):
    rng = np.random.default_rng(11)
    scalers = [jc.SLAAutoscaler(**kw), pc.SLAAutoscaler(**kw)]
    n = [kw.get("min_replicas", 1)] * 2
    decisions = [[], []]
    for k in range(300):
        regime = (k // 40) % 3
        lat = rng.exponential([2.0, 30.0, 8.0][regime], size=rng.integers(1, 5))
        for side, sc in enumerate(scalers):
            d = sc.observe(lat.tolist(), now=k * 0.01, n_replicas=n[side])
            if d is not None:
                n[side] += 1 if d[0] == "up" else -1
                sc.record_cost(k * 0.01, float(n[side]))
            decisions[side].append(d)
    assert decisions[0] == decisions[1]
    assert any(d is not None for d in decisions[1])
    assert scalers[0].cost_log == scalers[1].cost_log
    assert scalers[0].window_p99_ms() == scalers[1].window_p99_ms()
    for pkg in (jc, pc):
        with pytest.raises(ValueError, match="min_replicas"):
            pkg.SLAAutoscaler(10.0, min_replicas=3, max_replicas=2)


# ---------------------------------------------------------------------------
# Shared query content: a skewed numpy stream, rotated by the event's salt
# ---------------------------------------------------------------------------
def _query_np(cfg, ev, q):
    rng = np.random.default_rng([ev.seed, ev.step])
    dense = rng.standard_normal((q, cfg.num_dense)).astype(np.float32)
    u = rng.random((q, cfg.num_tables, cfg.lookups_per_table))
    ranks = np.floor(cfg.rows_per_table * u ** 4).astype(np.int64)
    idx = (ranks * 37 + ev.perm_salt) % cfg.rows_per_table
    return dense, idx.astype(np.int32)


def _freq_np(cfg, n_batches=4):
    counts = np.zeros((cfg.num_tables, cfg.rows_per_table), np.int32)
    t_ix = np.arange(cfg.num_tables)[None, :, None]
    for step in range(n_batches):
        ev = SimpleNamespace(seed=0, step=step, perm_salt=0)
        _, idx = _query_np(cfg, ev, cfg.batch_size)
        np.add.at(counts, (np.broadcast_to(t_ix, idx.shape), idx), 1)
    return counts


@pytest.fixture
def shared_stream(monkeypatch):
    """Both packages materialize the same numpy query for an event and
    profile the same numpy row counts."""
    def jax_query(cfg, ev, q=None):
        d, i = _query_np(cfg, ev, q or cfg.batch_size)
        return {"dense": jnp.asarray(d), "indices": jnp.asarray(i)}

    def port_query(cfg, ev, q=None, device=None):
        d, i = _query_np(cfg, ev, q or cfg.batch_size)
        return {"dense": torch.from_numpy(d).to(device),
                "indices": torch.from_numpy(i).to(device)}

    monkeypatch.setattr(jcluster, "materialize_query", jax_query)
    monkeypatch.setattr(pcluster, "materialize_query", port_query)
    monkeypatch.setattr(
        jte, "measure_row_freq",
        lambda cfg, *a, **kw: jnp.asarray(_freq_np(cfg)))
    monkeypatch.setattr(
        pte, "measure_row_freq",
        lambda cfg, *a, device=None, **kw: torch.from_numpy(
            _freq_np(cfg)).to(device))


def _monitors(cfgs):
    kw = dict(alpha=ALPHA, window=6, cooldown_queries=6,
              model_cfg=None)
    return (jc.HitRatioMonitor(cfgs[0], **{**kw, "model_cfg":
                                           jax_get_dlrm(NAME)}),
            pc.HitRatioMonitor(cfgs[1], **{**kw, "model_cfg": get_dlrm(NAME)},
                               device="cpu"))


def _drift_events(n=90):
    return make_scenario("zipf_drift", alpha=ALPHA, rotate_every_s=0.08,
                         salt_stride=37).events(n, qps=400.0, seed=4)


def test_monitor_matches_the_reference(shared_stream):
    cfgs = _cfgs()
    jmon, pmon = _monitors(cfgs)
    assert pmon.baseline == jmon.baseline and pmon.baseline > 0.4
    for ev in _drift_events():
        hs = []
        for cfg, mon, conv in ((cfgs[0], jmon, jnp.asarray),
                               (cfgs[1], pmon, torch.from_numpy)):
            _, idx = _query_np(cfg, ev, cfg.batch_size)
            hs.append(mon.observe(ev.qid, conv(idx), ev.arrival_s))
            mon.maybe_refresh(ev.arrival_s)
        assert hs[1] == hs[0], ev
    assert pmon.refreshes == jmon.refreshes and len(pmon.refreshes) >= 1
    assert pmon.history == jmon.history
    assert pmon.windowed_hit_ratio() == jmon.windowed_hit_ratio()
    np.testing.assert_array_equal(pmon.tiered.row_map.numpy(),
                                  np.asarray(jmon.tiered.row_map))
    for h in (0.0, 0.05, 0.3, pmon.baseline, 0.9, 1.0):
        assert pmon.service_multiplier(h) == pytest.approx(
            jmon.service_multiplier(h), rel=1e-12)
    assert pmon.service_multiplier(pmon.baseline) == pytest.approx(1.0)
    const = pc.HitRatioMonitor(cfgs[1], alpha=ALPHA, service_multiplier=2.5,
                               device="cpu")
    assert const.service_multiplier(0.42) == 2.5
    with pytest.raises(ValueError, match="service_multiplier"):
        pc.HitRatioMonitor(cfgs[1], alpha=ALPHA, service_multiplier=[1],
                           device="cpu")


# ---------------------------------------------------------------------------
# remesh_tree
# ---------------------------------------------------------------------------
def test_remesh_report_matches_and_returns_copies():
    jcfg, cfg = _cfgs()
    jrep = jc.Replica(0, jcfg, jax.devices()[:1], alpha=ALPHA,
                      max_batch_queries=2)
    params = convert.params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jrep.session.params), "cpu")
    _, jreport = jax_remesh_tree(jrep.session.params, jrep.param_specs(),
                                 jc.submesh(jax.devices()[:1]))
    prep = pc.Replica(0, cfg, [0], alpha=ALPHA, max_batch_queries=2,
                      params=params, device="cpu")
    new, report = prep.clone_params_onto(pc.submesh([0]))
    assert report == jreport
    assert report == {"resharded": len(jax.tree_util.tree_leaves(
        jrep.session.params)), "replicated_fallback": 0}
    old_leaves = jax.tree_util.tree_leaves(prep.session.params)
    new_leaves = jax.tree_util.tree_leaves(new)
    assert len(old_leaves) == len(new_leaves) == report["resharded"]
    for a, b in zip(old_leaves, new_leaves):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    new["tables"][0, 0].add_(1.0)              # an update stays on its board
    assert not torch.equal(new["tables"], prep.session.params["tables"])
    with pytest.raises(ValueError, match="specs do not match"):
        remesh_tree(prep.session.params, {"tables": None}, pc.submesh([0]),
                    device="cpu")


# ---------------------------------------------------------------------------
# Whole fleets, both packages
# ---------------------------------------------------------------------------
def _fixed_service(monkeypatch):
    """Each session's service time: a fixed function of its batch size."""
    for cls in (JaxServeSession, ServeSession):
        def wrapped(self, queries, _orig=cls._execute):
            probs, _, _ = _orig(self, queries)
            return probs, 0.004 + 0.002 * len(queries), 0.0
        monkeypatch.setattr(cls, "_execute", wrapped)


def _fleets(monkeypatch, *, router, autoscalers=(None, None),
            monitors=(None, None), n_replicas=2):
    _fixed_service(monkeypatch)
    jcfg, cfg = _cfgs()
    kw = dict(n_replicas=n_replicas, alpha=ALPHA, router=router,
              max_batch_queries=2, max_wait_ms=2.0)
    jcl = jc.Cluster(jcfg, autoscaler=autoscalers[0], monitor=monitors[0],
                     **kw)
    pcl = pc.Cluster(cfg, autoscaler=autoscalers[1], monitor=monitors[1],
                     device="cpu", **kw)
    for jr, pr in zip(jcl.replicas, pcl.replicas):
        pr.session.params = convert.params_from_jax_numpy(
            jax.tree_util.tree_map(np.asarray, jr.session.params), "cpu")
    return jcl, pcl


def _run_both(jcl, pcl, events, scenario):
    jrep = jcl.run(events, sla_ms=50.0, scenario=scenario)
    prep = pcl.run(events, sla_ms=50.0, scenario=scenario)
    assert prep.asdict() == jrep.asdict()
    assert sorted(pcl.completed) == [e.qid for e in events]
    for ev in events:
        got = pcl.completed[ev.qid].probs
        assert got.shape == (8,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, jcl.completed[ev.qid].probs, **TOL)
    return prep


@pytest.mark.parametrize("router", ["round_robin", "jsq", "p2c"])
def test_cluster_report_matches_the_reference(router, monkeypatch,
                                              shared_stream):
    events = make_scenario("stationary", alpha=ALPHA).events(
        24, qps=500.0, seed=1)
    rep = _run_both(*_fleets(monkeypatch, router=router), events,
                    "stationary")
    assert rep.router == router and rep.n_replicas_end == 2
    assert sum(s["served"] for s in rep.replicas) == 24


def test_flash_crowd_autoscale_matches_the_reference(monkeypatch,
                                                     shared_stream):
    kw = dict(sla_ms=12.0, max_replicas=3, window=4, patience=1)
    jcl, pcl = _fleets(monkeypatch, router="p2c",
                       autoscalers=(jc.SLAAutoscaler(**kw),
                                    pc.SLAAutoscaler(**kw)))
    events = make_scenario("flash_crowd", alpha=ALPHA, on_s=0.05,
                           off_s=0.05).events(48, qps=150.0, seed=2)
    rep = _run_both(jcl, pcl, events, "flash_crowd")
    ups = [e for e in rep.scale_events if e.action == "up"]
    n_leaves = len(jax.tree_util.tree_leaves(pcl.replicas[0].session.params))
    assert ups and ups[0].remesh == {"resharded": n_leaves,
                                     "replicated_fallback": 0}
    assert rep.n_replicas_end >= 3 and len(rep.replicas) >= 3
    assert rep.board_seconds > 2 * rep.makespan_s
    spawned = [r for r in pcl.replicas + pcl._retired if r.rid >= 2]
    assert spawned and all(r.served > 0 for r in spawned)
    assert "[cluster] scale up" in rep.summary()


def test_scale_down_releases_the_retired_replica():
    """A retired replica lets go of its params (the reference keeps them):
    its stats stay in the report, and a later scale-up does not hold one
    more table set than the fleet serves."""
    _, cfg = _cfgs()
    scaler = pc.SLAAutoscaler(1e6, min_replicas=1, max_replicas=2, window=4,
                              patience=1, cooldown_s=0.005)
    cl = pc.Cluster(cfg, n_replicas=2, max_batch_queries=2, autoscaler=scaler,
                    device="cpu")
    events = make_scenario("stationary", alpha=ALPHA).events(
        24, qps=500.0, seed=5)
    rep = cl.run(events, sla_ms=1e6)
    assert [e.action for e in rep.scale_events][:1] == ["down"]
    assert rep.n_replicas_end == 1 and len(rep.replicas) == 2
    gone = cl._retired[0]
    assert gone.session is None and gone.engine is None
    assert gone.served > 0 and gone.retired_at is not None
    assert sorted(cl.completed) == [e.qid for e in events]


def test_zipf_drift_monitor_matches_the_reference(monkeypatch,
                                                  shared_stream):
    monitors = _monitors(_cfgs())
    jcl, pcl = _fleets(monkeypatch, router="round_robin", monitors=monitors)
    rep = _run_both(jcl, pcl, _drift_events(), "zipf_drift")
    assert len(rep.refreshes) >= 1
    assert rep.hit_ratio_first is not None
    assert "lfu_refresh" in rep.summary()


# ---------------------------------------------------------------------------
# What the slice does not carry, and the card by default
# ---------------------------------------------------------------------------
def test_unported_fleet_options_name_their_item():
    """Boards of k ranks are ported (ROADMAP A6b-ii; tests/
    test_torch_boards.py runs them over 4 ranks): on one rank a board of 2
    needs a pool of 2, as the reference's on one device, and a board of
    several devices needs a rank each, while a board of rank 0 is a mesh
    of it. What is left of A6b-ii (online updates into a board of more
    than one rank) is tested there."""
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="pool has 1"):
        pc.Cluster(cfg, n_replicas=1, model_axis=2, device="cpu")
    with pytest.raises(ValueError, match="needs a rank each"):
        pc.Cluster(cfg, n_replicas=1, devices_per_replica=2,
                   devices=["cpu", "cpu"], device="cpu")
    with pytest.raises(ValueError, match="needs a rank each"):
        pc.submesh(["cpu", "cpu"], model_axis=2)
    mesh = pc.submesh([0])
    assert mesh.ranks == (0,) and mesh.member and mesh.shape == {
        "data": 1, "model": 1}
    board = pc.Replica(0, cfg, [0], alpha=ALPHA, max_batch_queries=2,
                       device="cpu")
    assert board.mesh.ranks == (0,) and board.member
    assert board.param_specs()["tables"].dims == (("data", "model"),)
    # online updates (A7c) work: an empty channel changes nothing, and a
    # batch lands in the replica's tables
    from repro_torch.online import DeltaBatch, DeltaChannel, RowDelta
    cl = pc.Cluster(cfg, n_replicas=1, device="cpu", max_batch_queries=2)
    rep = cl.run(make_scenario("stationary").events(2, qps=10.0),
                 online=DeltaChannel())
    assert rep.online.n_updates == 0 and rep.n_queries == 2
    batch = DeltaBatch(version=1, t_emit_s=0.0, step=1, deltas=(
        RowDelta(1, np.array([3]), np.ones((1, cfg.embed_dim), np.float32)),))
    assert cl.replicas[0].apply_row_updates(batch) == 1
    assert torch.equal(cl.replicas[0].session.params["tables"][1, 3],
                       torch.ones(cfg.embed_dim))
    assert pc.slice_devices(["a", "b", "c"], 4, 2) == ["c", "a"]
    with pytest.raises(ValueError, match="pool has"):
        pc.slice_devices(["a"], 0, 2)
    assert sorted(pc.__all__) == sorted(jc.__all__)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA host")
def test_the_fleet_runs_on_the_card_by_default(capsys):
    from repro_torch.launch import serve
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.Cluster(cfg, n_replicas=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.HitRatioMonitor(cfg)
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--smoke", "--replicas", "2"])


# ---------------------------------------------------------------------------
# The launcher's fleet path, in process
# ---------------------------------------------------------------------------
def _serve(capsys, *argv):
    from repro_torch.launch import serve
    rc = serve.main(["--smoke", "--device", "cpu", *argv])
    return rc, capsys.readouterr().out


def test_launcher_serves_a_flash_crowd_fleet(capsys, tmp_path):
    metrics = tmp_path / "m.json"
    rc, out = _serve(capsys, "--queries", "24", "--replicas", "2",
                     "--scenario", "flash_crowd", "--router", "p2c",
                     "--autoscale", "--metrics-out", str(metrics))
    assert rc == 0, out
    assert "[serve] fleet of 2 replicas on cpu: serve_kernel=fused" in out
    assert "[serve] --qps 0: offering 0.8 x fleet capacity" in out
    assert "[cluster] flash_crowd x p2c: 24 queries over 2->" in out
    for line in ("[cluster] p50=", "[cluster] util: r0=",
                 "[cluster] cost: "):
        assert line in out, out
    snap = json.loads(metrics.read_text())
    assert sum(v for k, v in snap.items()
               if k.startswith("queries_served")) == 24


def test_launcher_replays_a_recorded_trace(capsys, tmp_path):
    trace = tmp_path / "t.jsonl"
    reports = [tmp_path / "a.json", tmp_path / "b.json"]
    rc, out = _serve(capsys, "--queries", "12", "--replicas", "2",
                     "--scenario", "zipf_drift", "--qps", "300",
                     "--record-trace", str(trace),
                     "--report-json", str(reports[0]))
    assert rc == 0, out
    assert "[serve] zipf_drift with --alpha 0: using alpha=1.05" in out
    assert f"[serve] recorded trace -> {trace}" in out
    rc, out = _serve(capsys, "--replicas", "2", "--replay-trace",
                     str(trace), "--report-json", str(reports[1]))
    assert rc == 0, out
    assert (f"[serve] replaying 12 events from {trace} "
            f"(scenario=zipf_drift)") in out
    a, b = (json.loads(p.read_text()) for p in reports)
    for key in ("scenario", "n_queries", "offered_qps", "router"):
        assert a[key] == b[key], key
    assert a["hit_ratio_first"] is not None and b["hit_ratio_first"] is not None


def _online_lines(out):
    """(batches the launcher trained, the run's [online] update count)."""
    import re
    trained = re.search(r"\[serve\] online: (\d+) delta batches", out)
    ran = re.search(r"\[online\] (\d+) updates -> v(\d+) \((\w+)\)", out)
    return (int(trained.group(1)) if trained else None,
            (int(ran.group(1)), int(ran.group(2)), ran.group(3))
            if ran else None)


def _replayable(cfg, path):
    """A recorded two-batch channel for --replay-deltas."""
    from repro_torch.online import DeltaBatch, DeltaChannel, RowDelta
    rng = np.random.default_rng(5)
    DeltaChannel([DeltaBatch(version=v, t_emit_s=0.01 * v, step=v, deltas=(
        RowDelta(v, np.array([2, 9]), rng.standard_normal(
            (2, cfg.embed_dim)).astype(np.float32)),)) for v in (1, 2)]
    ).record(str(path))


@pytest.mark.parametrize("flag", [
    ["--online-every-s", "0.01"], ["--online-steps", "2"],
    ["--online-lr", "0.1"], ["--coherence", "invalidate"],
    ["--record-deltas", "d.jsonl"], ["--replay-deltas", "d.jsonl"]])
def test_launcher_online_flags_drive_the_fleet(flag, capsys, tmp_path):
    """Each online flag on the replicated fleet path: the trainer's stream
    is recorded before the run and every batch is applied."""
    from repro_torch.online import DeltaChannel
    flag = [str(tmp_path / f) if f.endswith(".jsonl") else f for f in flag]
    if flag[0] == "--replay-deltas":
        _replayable(_cfgs()[1], flag[1])
    every = [] if flag[0] in ("--online-every-s", "--replay-deltas") else [
        "--online-every-s", "0.02"]
    rc, out = _serve(capsys, "--queries", "12", "--replicas", "2",
                     "--scenario", "zipf_drift", "--qps", "300", *every,
                     *flag)
    assert rc == 0, out
    trained, (n, last, mode) = _online_lines(out)
    assert mode == "replicate" and n == last
    if flag[0] == "--replay-deltas":
        assert trained is None and n == 2
        assert f"[serve] replaying 2 delta batches from {flag[1]}" in out
        return
    assert n == trained > 0
    steps, lr = ("2", "0.05") if flag[0] == "--online-steps" else (
        "1", "0.1" if flag[0] == "--online-lr" else "0.05")
    interval = "0.01" if flag[0] == "--online-every-s" else "0.02"
    assert (f"(every {interval}s x {steps} steps, lr={lr})") in out
    if flag[0] == "--record-deltas":
        assert len(DeltaChannel.load(flag[1])) == n


def test_launcher_refuses_the_host_tier_on_a_fleet():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="single-board"):
        serve.main(["--smoke", "--device", "cpu", "--replicas", "2",
                    "--host-capacity-mb", "0.1"])
