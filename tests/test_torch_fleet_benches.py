"""The port's fleet, host-tier and online benches (``benchmarks_torch.
bench_{cluster,fabric,elastic,hoststore,online}``) and the options they
need, held against the reference on the CPU.

* The options: ``Cluster(service_scales=)`` / ``Replica(service_scale=)``,
  ``HitRatioMonitor(enabled=)``, ``ShardedFleet(service_scales=)`` /
  ``FabricBoard(service_scale=)``. Fleets run in both packages on shared
  arrays with no wall clock in their reports: the replicated fleet's
  sessions take the fixed service times of ``tests/test_torch_cluster.py``;
  the sharded fleet's boards read a fake clock that advances 2**-10 s a
  call, so every measured board time is exactly 2**-10 s before the
  board's scale. The reports must be equal field for field.
* The benches' logic: each bench runs in both packages with its fleets,
  sessions and trainer replaced by the same stubs and the service time a
  constant, so the traces each writes must be byte-equal to the
  reference's, and the claims and scalars each judges equal (the modeled
  parts included: ``sharded_query_bound``, ``hoststore_query_bound`` and
  the virtual service of the same fault plans).
* bench_online's sparse pretraining against the reference's dense jitted
  SGD, 5 steps at 1e-5.
* Each bench end to end at ``--device cpu --reduced``: its correctness
  claims hold, and its artifact has the reference's claim names and
  scalar keys (``BENCH_<name>.json`` at the root, read only), plus
  ``device`` and ``scalars.cuts``.
"""
import dataclasses
import itertools
import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import repro.cluster as jc  # noqa: E402
import repro.engine as jengine  # noqa: E402
import repro.fabric as jf  # noqa: E402
import repro.fabric.fleet as jfleet  # noqa: E402
import repro.online as jonline  # noqa: E402
import repro_torch.cluster as pc  # noqa: E402
import repro_torch.fabric as pf  # noqa: E402
import repro_torch.fabric.fleet as pfleet  # noqa: E402
from benchmarks import _artifacts as ref_artifacts  # noqa: E402
from benchmarks import (bench_cluster as ref_cluster,  # noqa: E402
                        bench_elastic as ref_elastic,
                        bench_fabric as ref_fabric,
                        bench_hoststore as ref_hoststore,
                        bench_online as ref_online)
from benchmarks_torch import (bench_cluster, bench_elastic,  # noqa: E402
                              bench_fabric, bench_hoststore, bench_online)
from repro.core.dlrm import bce_loss, dlrm_forward, init_dlrm  # noqa: E402
from repro.data.recsys import make_recsys_batch as ref_batch  # noqa: E402
from repro.obs.attribution import COMPONENTS  # noqa: E402
from repro.traffic import make_scenario  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.online import DeltaBatch, DeltaChannel  # noqa: E402
from test_torch_cluster import (_cfgs as cluster_cfgs,  # noqa: E402
                                _fixed_service, _monitors, _drift_events,
                                _run_both)
from test_torch_cluster import shared_stream  # noqa: E402,F401  (a fixture)
from test_torch_fabric import (_cfgs as fabric_cfgs, _fp32_bytes,  # noqa: E402
                               _freq_np, _query_np, fleets, run_both)
import repro.core.tiered_embedding as jte  # noqa: E402
import repro.fabric.partition as jpartition  # noqa: E402
import repro_torch.core.tiered_embedding as pte  # noqa: E402

ALPHA = 1.2
BENCHES = ("cluster", "fabric", "elastic", "hoststore", "online")
DT = 2.0 ** -10          # the fake clock's step: every interval is exact


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Cluster(service_scales=), Replica(service_scale=), HitRatioMonitor(enabled=)
# ---------------------------------------------------------------------------
def _cluster_pair(monkeypatch, scales, router, monitors=(None, None)):
    _fixed_service(monkeypatch)
    jcfg, cfg = cluster_cfgs()
    kw = dict(n_replicas=len(scales), alpha=ALPHA, router=router,
              max_batch_queries=2, max_wait_ms=2.0, service_scales=scales)
    jcl = jc.Cluster(jcfg, monitor=monitors[0], **kw)
    pcl = pc.Cluster(cfg, monitor=monitors[1], device="cpu", **kw)
    for jr, pr in zip(jcl.replicas, pcl.replicas):
        pr.session.params = convert.params_from_jax_numpy(
            jax.tree_util.tree_map(np.asarray, jr.session.params), "cpu")
    return jcl, pcl


@pytest.mark.parametrize("router", ["round_robin", "p2c"])
def test_cluster_service_scales_match_the_reference(router, monkeypatch,
                                                    shared_stream):
    events = make_scenario("flash_crowd", alpha=ALPHA, on_s=0.03,
                           off_s=0.03).events(40, qps=400.0, seed=2)
    jcl, pcl = _cluster_pair(monkeypatch, (1.0, 1.0, 2.2), router)
    assert [r.service_scale for r in pcl.replicas] == [1.0, 1.0, 2.2]
    rep = _run_both(jcl, pcl, events, "flash_crowd")
    assert sum(s["served"] for s in rep.replicas) == 40


def test_a_slow_board_is_busy_exactly_its_scale_longer(monkeypatch):
    """Round-robin routing and batching do not depend on service time, so
    the 2.2x board runs the same batches, each 2.2x as long."""
    _fixed_service(monkeypatch)
    _, cfg = cluster_cfgs()
    events = make_scenario("stationary", alpha=ALPHA).events(
        30, qps=300.0, seed=3)
    busy = {}
    for scales in ((1.0, 1.0), (1.0, 2.2)):
        cl = pc.Cluster(cfg, n_replicas=2, router="round_robin",
                        max_batch_queries=2, service_scales=scales,
                        device="cpu")
        rep = cl.run(events, sla_ms=1e6)
        busy[scales] = [s["busy_s"] for s in rep.replicas]
        assert [s["batches"] for s in rep.replicas] == [
            len(r.batch_sizes) for r in cl.replicas]
    base, slow = busy[(1.0, 1.0)], busy[(1.0, 2.2)]
    assert slow[0] == base[0]
    assert slow[1] == pytest.approx(2.2 * base[1], rel=1e-12)


@pytest.mark.parametrize("cls", ["Cluster", "ShardedFleet"])
def test_wrong_length_service_scales_raise_in_both(cls):
    jcfg, cfg = cluster_cfgs()
    for pkg, c, kw in ((jc if cls == "Cluster" else jf, jcfg, {}),
                       (pc if cls == "Cluster" else pf, cfg,
                        dict(device="cpu"))):
        n = "n_replicas" if cls == "Cluster" else "n_boards"
        with pytest.raises(ValueError, match="service_scales"):
            getattr(pkg, cls)(c, **{n: 2}, service_scales=(1.0,), **kw)


def test_monitor_switched_off_matches_the_reference(shared_stream):
    cfgs = cluster_cfgs()
    off = (jc.HitRatioMonitor(cfgs[0], alpha=ALPHA, window=6,
                              cooldown_queries=6, enabled=False),
           pc.HitRatioMonitor(cfgs[1], alpha=ALPHA, window=6,
                              cooldown_queries=6, enabled=False,
                              device="cpu"))
    assert off[1].enabled is False and off[1].baseline == off[0].baseline
    for ev in _drift_events():
        hs = []
        for cfg, mon, conv in ((cfgs[0], off[0], jax.numpy.asarray),
                               (cfgs[1], off[1], torch.from_numpy)):
            _, idx = _query_np(cfg, ev, cfg.batch_size)
            hs.append(mon.observe(ev.qid, conv(idx), ev.arrival_s))
            assert not mon.maybe_refresh(ev.arrival_s)
        assert hs[1] == hs[0]
    assert off[1].history == off[0].history
    assert off[1].refreshes == off[0].refreshes == []
    assert off[1]._degraded_at is None
    assert off[1].windowed_hit_ratio() < 0.7 * off[1].baseline


def test_fleet_with_the_monitor_off_matches_the_reference(monkeypatch,
                                                          shared_stream):
    mons = _monitors(cluster_cfgs())
    for m in mons:
        m.enabled = False
    jcl, pcl = _cluster_pair(monkeypatch, (1.0, 1.0), "round_robin", mons)
    rep = _run_both(jcl, pcl, _drift_events(), "zipf_drift")
    assert not rep.refreshes and rep.hit_ratio_last < rep.hit_ratio_first


# ---------------------------------------------------------------------------
# ShardedFleet(service_scales=), FabricBoard(service_scale=): a fake clock
# ---------------------------------------------------------------------------
def _fake_clock():
    k = itertools.count()
    return SimpleNamespace(perf_counter=lambda: next(k) * DT)


@pytest.fixture
def shared_clock(monkeypatch):
    """As ``test_torch_fabric.shared``, with the boards' measured times
    read off a fake clock instead of wrapped to fixed values."""
    def jax_query(cfg, ev, q=None):
        d, i = _query_np(cfg, ev, q or cfg.batch_size)
        return {"dense": jax.numpy.asarray(d),
                "indices": jax.numpy.asarray(i)}

    def port_query(cfg, ev, q=None, device=None):
        d, i = _query_np(cfg, ev, q or cfg.batch_size)
        return {"dense": torch.from_numpy(d).to(device),
                "indices": torch.from_numpy(i).to(device)}

    monkeypatch.setattr(jfleet, "materialize_query", jax_query)
    monkeypatch.setattr(pfleet, "materialize_query", port_query)
    monkeypatch.setattr(jte, "measure_row_freq",
                        lambda cfg, *a, **kw: jax.numpy.asarray(
                            _freq_np(cfg)))
    monkeypatch.setattr(
        pte, "measure_row_freq",
        lambda cfg, *a, device=None, **kw: torch.from_numpy(
            _freq_np(cfg)).to(device))
    monkeypatch.setattr(jfleet, "default_table_bytes", _fp32_bytes)
    monkeypatch.setattr(jpartition, "default_table_bytes", _fp32_bytes)
    monkeypatch.setattr(jfleet, "time", _fake_clock())
    monkeypatch.setattr(pfleet, "time", _fake_clock())


@pytest.mark.parametrize("router", ["round_robin", "jsq"])
def test_fabric_service_scales_match_the_reference(router, shared_clock):
    jcfg, cfg = fabric_cfgs()
    events = make_scenario("stationary", alpha=ALPHA).events(
        24, qps=600.0, seed=1)
    cap = int(2.8 * cfg.rows_per_table * cfg.embed_dim * 4)
    scales = (1.0, 2.2, 1.0)
    jfl, pfl = fleets(jcfg, cfg, n_boards=3, alpha=ALPHA, router=router,
                      max_batch_queries=2, board_capacity_bytes=cap,
                      service_scales=scales)
    assert [b.service_scale for b in pfl.boards] == list(scales)
    assert pfl.measure_service_time() == jfl.measure_service_time()
    rep = run_both(jfl, pfl, events, "stationary")
    assert sum(s["served"] for s in rep.replicas) == 24


def test_every_measured_board_time_is_scaled(shared_clock):
    _, cfg = fabric_cfgs()
    cap = int(2.8 * cfg.rows_per_table * cfg.embed_dim * 4)
    fl = pf.ShardedFleet(cfg, n_boards=3, alpha=ALPHA, max_batch_queries=2,
                         board_capacity_bytes=cap, device="cpu",
                         service_scales=(1.0, 2.2, 1.0))
    slow = fl.boards[1]
    split = fl.partition.split_tables
    assert split and int(split[0]) in slow.split_rows
    idx = torch.zeros((2, int(slow.table_ids.size), cfg.lookups_per_table),
                      dtype=torch.int32)
    ids = torch.zeros((2, cfg.lookups_per_table), dtype=torch.int64)
    calls = [lambda: slow.lookup(idx),
             lambda: slow.gather_rows(int(split[0]), ids),
             lambda: slow.pool_rows(torch.zeros((1, 4, cfg.embed_dim)),
                                    torch.zeros((2, 1, 2), dtype=torch.int32)),
             lambda: slow.dense_forward(torch.zeros((2, cfg.num_dense)),
                                        torch.zeros((2, cfg.num_tables,
                                                     cfg.embed_dim)))]
    for call in calls:
        assert call()[1] == DT * 2.2
    assert fl.boards[0].lookup(idx[:, :int(fl.boards[0].table_ids.size)]
                               )[1] == DT


# ---------------------------------------------------------------------------
# The benches' logic in both packages, on shared stubs
# ---------------------------------------------------------------------------
S1 = 0.002               # every measured service time: s1, s4, s_cap, floor


def _probs(qid):
    return np.full(8, 0.25 + 0.01 * (qid % 13), np.float32)


class _StubFleet:
    """A fleet of either package, as the benches read it: reports are a
    pure function of what the bench passes, so both packages' benches see
    the same numbers."""

    row_elem = 4            # bytes a value the package's migrations count

    def __init__(self, cfg, *, n_replicas=None, n_boards=None,
                 router="jsq", service_scales=None, monitor=None,
                 autoscaler=None, cache_rows=None, cache_enabled=True,
                 link=None, **kw):
        self.cfg = cfg
        self.n = n_replicas or n_boards or 1
        self.router = router if isinstance(router, str) else "custom"
        self.slow = max(service_scales or (1.0,))
        self.monitor = monitor
        self.autoscaler = autoscaler
        self.cache = (cache_rows if cache_rows is not None else 64
                      ) if cache_enabled else 0
        self.latency_ms = (link.base_latency * 1e3 if link is not None
                           else 0.001)
        self.metrics = SimpleNamespace(snapshot=lambda: {"stub": 1})
        self.completed = {}
        self.attribution = SimpleNamespace(records=[])

    def measure_service_time(self, *a, **kw):
        return S1

    def run(self, events, sla_ms, percentile=99.0, scenario="trace",
            online=None, coherence=None):
        n = len(events)
        offered = n / max(events[-1].arrival_s, 1e-9)
        achieved = min(offered, 500.0 * self.n)
        tail = {"round_robin": 30.0, "jsq": 20.0, "p2c": 10.0}.get(
            self.router, 15.0) * self.slow
        refreshes = ([0.01] if self.monitor is not None
                     and self.monitor.enabled else [])
        for ev in events:
            self.completed[ev.qid] = SimpleNamespace(probs=_probs(ev.qid))
        rec = SimpleNamespace(latency_s=0.0,
                              **{c + "_s": 0.0 for c in COMPONENTS})
        self.attribution.records = [rec]
        scale_events = []
        if self.autoscaler is not None:
            row_b = self.cfg.embed_dim * self.row_elem
            for action, k in (("up", self.n + 1), ("down", self.n)):
                scale_events.append(SimpleNamespace(
                    action=action, n_replicas=k,
                    remesh={"rows_moved": 10, "bytes_moved": 10 * row_b}))
        frac = self.cache / max(self.cfg.rows_per_table
                                * self.cfg.num_tables, 1)
        return SimpleNamespace(
            offered_qps=offered, achieved_qps=achieved, ok=True,
            ppf_ms=0.8 * tail / self.n, p99_ms=tail / self.n,
            p50_ms=2.0 + 2.0 * self.latency_ms, n_queries=n,
            board_seconds=self.n * 0.5 / (2 if self.autoscaler else 1),
            sla_violations=0, hit_ratio_first=0.6,
            hit_ratio_last=0.62 if refreshes else 0.05, refreshes=refreshes,
            fits_one_board=False,
            bytes_per_query=1000.0 * (1.0 - min(frac * 3.0, 0.9)),
            remote_hit_first=0.9 if self.cache else None,
            remote_hit_last=0.8 if self.cache else None,
            cache_refreshes=1 if self.cache else 0,
            remote_lookup_fraction=0.5, makespan_s=0.5,
            scale_events=scale_events,
            migrated_bytes=sum(e.remesh["bytes_moved"]
                               for e in scale_events),
            migration_s=0.001 * len(scale_events), cache_invalidated_rows=3,
            online=SimpleNamespace(push_bytes=4096, n_updates=8,
                                   rows_pushed=80, rows_propagated=40,
                                   staleness_p50_s=0.01,
                                   staleness_max_s=0.02),
            summary=lambda: "[stub] report")


class _RefStubFleet(_StubFleet):
    row_elem = 2            # the reference counts nominal fp16 rows


class _StubMonitor:
    def __init__(self, cfg, *, enabled=True, **kw):
        self.enabled = enabled


class _StubPlan:
    """A recorded fault plan, as both packages' benches read one."""

    def __init__(self, k, depth):
        self.depth = depth
        self.stats = [SimpleNamespace(
            bytes_moved=4096 * (1 + (k + i) % 5), faulted_chunks=8 + k % 3,
            writebacks=k % 2, needed_chunks=20, copy_s=1e-4)
            for i in range(depth)]
        self.bytes_moved = sum(s.bytes_moved for s in self.stats)
        self.faulted_chunks = sum(s.faulted_chunks for s in self.stats)
        self.copy_s = sum(s.copy_s for s in self.stats)


class _StubExchange:
    def __init__(self, depth):
        self.depth, self.k = depth, 0

    @property
    def _last_plan(self):
        self.k += 1
        return _StubPlan(self.k, self.depth)

    def summary(self):
        return "stub host tier"


class _StubSession:
    def __init__(self, depth, host):
        self.exchange = self._exchange_inst = (_StubExchange(depth)
                                               if host else None)

    def measure_service_time(self, *a, **kw):
        return S1

    def _execute(self, queries):
        return np.zeros((1, 8), np.float32), S1, 0.0


class _StubEngine:
    def __init__(self, cfg, *, pipeline_depth=1, host_capacity_mb=None,
                 **kw):
        self.depth, self.host = pipeline_depth, host_capacity_mb is not None

    def serve_session(self, **kw):
        return _StubSession(self.depth, self.host)


class _RefStubTrainer:
    def __init__(self, cfg, params, **kw):
        self.tables = np.zeros((cfg.num_tables, cfg.rows_per_table,
                                cfg.embed_dim), np.float32)
        self.step = 0

    def train_steps(self, n, salt=0):
        self.step += n
        return 0.5


class _PortStubSource:
    """The reference bench's delta loop, each batch empty (its stub
    trainer changes nothing)."""

    def __init__(self, trainer, *, interval_s, steps_per_update, **kw):
        self.interval_s, self.steps = interval_s, steps_per_update

    def run_to(self, horizon):
        batches, t, v = [], self.interval_s, 0
        while t <= horizon:
            v += 1
            batches.append(DeltaBatch(version=v, t_emit_s=t,
                                      step=v * self.steps, deltas=(),
                                      train_loss=0.5))
            t += self.interval_s
        return DeltaChannel(batches)


def _stub_both(monkeypatch, name):
    """Stub the fleets, sessions and trainers of both packages' bench
    ``name``; returns the reference bench's captured artifact."""
    captured = {}
    monkeypatch.setattr(ref_artifacts, "write_bench_json",
                        lambda n, claims, scalars, **kw: captured.update(
                            claims=claims, scalars=scalars))
    if name == "cluster":
        for mod in (jc, bench_cluster):
            monkeypatch.setattr(mod, "Cluster", _StubFleet)
            monkeypatch.setattr(mod, "HitRatioMonitor", _StubMonitor)
        monkeypatch.setattr(ref_cluster, "Engine", _StubEngine)
        monkeypatch.setattr(bench_cluster, "Engine", _StubEngine)
    if name in ("fabric", "elastic", "online"):
        monkeypatch.setattr(jf, "ShardedFleet", _RefStubFleet)
        port = {"fabric": bench_fabric, "elastic": bench_elastic,
                "online": bench_online}[name]
        monkeypatch.setattr(port, "ShardedFleet", _StubFleet)
    if name == "hoststore":
        monkeypatch.setattr(jengine, "Engine", _StubEngine)
        monkeypatch.setattr(bench_hoststore, "Engine", _StubEngine)
    if name == "online":
        monkeypatch.setattr(jonline, "OnlineTrainer", _RefStubTrainer)
        monkeypatch.setattr(bench_online, "OnlineSource", _PortStubSource)
    return captured


REF_MAINS = {"cluster": ref_cluster.main, "fabric": ref_fabric.main,
             "elastic": ref_elastic.main, "hoststore": ref_hoststore.main,
             "online": ref_online.main}
PORT_MAINS = {"cluster": bench_cluster.main, "fabric": bench_fabric.main,
              "elastic": bench_elastic.main,
              "hoststore": bench_hoststore.main,
              "online": bench_online.main}
# scalars whose value depends on the bytes a row counts (fp16 nominal in
# the reference, fp32 in the port)
ROW_BYTES_SCALARS = {"migrated_bytes"}


@pytest.mark.parametrize("name", BENCHES)
def test_bench_traces_and_claims_equal_the_reference(name, monkeypatch,
                                                     tmp_path, capsys):
    captured = _stub_both(monkeypatch, name)
    extra = ["--pretrain-steps", "2"] if name == "online" else []
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    REF_MAINS[name](["--tiny", "--emit-json", "--trace-dir", str(ref_dir),
                     *extra])
    PORT_MAINS[name](["--tiny", "--reduced", "--device", "cpu",
                      "--emit-json", "--out-dir", str(tmp_path / "out"),
                      "--trace-dir", str(port_dir), *extra])
    capsys.readouterr()
    ref_traces = sorted(p.name for p in ref_dir.iterdir())
    assert ref_traces == sorted(p.name for p in port_dir.iterdir())
    assert ref_traces, "no trace written"
    for trace in ref_traces:
        assert ((port_dir / trace).read_bytes()
                == (ref_dir / trace).read_bytes()), trace
    with open(tmp_path / "out" / f"BENCH_torch_{name}.json") as f:
        art = json.load(f)
    got = [(c["name"], c["ok"], c["detail"]) for c in art["claims"]]
    want = [tuple(c) for c in captured["claims"]]
    ref_scalars = json.loads(json.dumps(captured["scalars"]))
    if name in ("cluster", "fabric", "hoststore"):
        assert got == want
    else:           # row bytes (elastic) and the teacher's draws (online)
        assert [g[:2] for g in got] == [w[:2] for w in want]
    scalars = {k: v for k, v in art["scalars"].items() if k != "cuts"}
    assert set(scalars) == set(ref_scalars)
    if name != "online":
        for key, want_v in ref_scalars.items():
            if key not in ROW_BYTES_SCALARS:
                assert scalars[key] == pytest.approx(want_v, rel=1e-12), key


# ---------------------------------------------------------------------------
# bench_online's sparse pretraining against the reference's dense SGD
# ---------------------------------------------------------------------------
def test_online_pretraining_equals_the_reference_dense_sgd(monkeypatch):
    jcfg, cfg = (dataclasses.replace(c, rows_per_table=512)
                 for c in fabric_cfgs())
    params = init_dlrm(jax.random.PRNGKey(0), jcfg)
    port = convert.params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")

    def batch(cfg_, step, seed, alpha, batch_size=None, device=None):
        b = ref_batch(jcfg, step, seed, alpha, batch_size=batch_size)
        return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}

    monkeypatch.setattr(bench_online, "make_recsys_batch", batch)

    @jax.jit
    def pre_sgd(p, dense, idx, labels):
        def loss(q):
            return bce_loss(dlrm_forward(q, dense, idx, jcfg), labels)
        val, g = jax.value_and_grad(loss)(p)
        return jax.tree_util.tree_map(lambda a, b: a - 0.2 * b, p, g), val

    for s in range(5):
        b = ref_batch(jcfg, 10_000 + s, 0, 1.05, batch_size=128)
        params, want_loss = pre_sgd(params, b["dense"], b["indices"],
                                    b["labels"])
    got_loss = bench_online.pretrain(cfg, port, 5, seed=0, alpha=1.05,
                                     device="cpu")
    assert got_loss == pytest.approx(float(want_loss), abs=1e-5)
    want = convert.params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    for (path, got), (_, ref) in zip(
            jax.tree_util.tree_flatten_with_path(port)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=str(path))
    init = np.asarray(init_dlrm(jax.random.PRNGKey(0), jcfg)["tables"])
    moved = (port["tables"].numpy() != init).any(axis=-1)
    assert moved.sum() > 100                   # the tables did train


# ---------------------------------------------------------------------------
# Each bench end to end on the CPU at the reference's size
# ---------------------------------------------------------------------------
CORRECTNESS = {"hoststore": {"bit_identity"},
               "online": {"bit_identity", "closure"},
               "elastic": {"zero_drift", "minimal_movement"},
               "cluster": set(), "fabric": set()}


@pytest.mark.parametrize("name", BENCHES)
def test_bench_runs_at_the_reference_size(name, tmp_path, capsys):
    extra = ["--pretrain-steps", "100"] if name == "online" else []
    PORT_MAINS[name](["--tiny", "--reduced", "--device", "cpu",
                      "--emit-json", "--out-dir", str(tmp_path), *extra])
    out = capsys.readouterr().out
    with open(tmp_path / f"BENCH_torch_{name}.json") as f:
        art = json.load(f)
    with open(os.path.join(REPO, f"BENCH_{name}.json")) as f:
        ref_art = json.load(f)
    # the reference's code attaches a metrics snapshot its committed
    # hoststore artifact predates
    assert set(ref_art) | {"device"} <= set(art)
    assert set(art) <= set(ref_art) | {"device", "metrics"}
    assert art["device"]["platform"] == "cpu"
    assert ([c["name"] for c in art["claims"]]
            == [c["name"] for c in ref_art["claims"]])
    assert set(art["scalars"]) == set(ref_art["scalars"]) | {"cuts"}
    assert art["scalars"]["cuts"] == {}        # the reference's size
    ok = {c["name"]: c["ok"] for c in art["claims"]}
    for claim in CORRECTNESS[name]:
        assert ok[claim], (claim, out)
    for c in art["claims"]:
        assert (f"[bench] {name}: {c['name']} "
                f"{'WIN' if c['ok'] else 'FAILED CLAIM'}") in out
    traces = os.listdir(tmp_path / "traces")
    assert traces and all(t.endswith(".jsonl") for t in traces)


@pytest.mark.parametrize("name", BENCHES)
def test_benches_refuse_to_run_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT_MAINS[name](["--tiny", "--reduced"])
