"""The port's sharded fleet (repro_torch.fabric) against repro.fabric.

The partitioner, the remote-row cache's election and the exchange's wire
accounting are pure numpy in both packages and are held EXACTLY equal on
the same inputs. Whole fleets run in both packages on the reduced config
(batch 8): the JAX fleet's params go through numpy into the port's, both
packages materialize the same numpy query for an event and profile the
same numpy row counts, and each board's lookup, gather, pool and dense
forward is wrapped to a fixed service time. Then the virtual clock is the
same in both and the FabricReports must be equal field for field; the
per-query probs agree at rtol = atol = 1e-5 (tests/test_kernels.py).

The port budgets capacity at the bytes its tables are stored in (fp32),
where the reference budgets the config's nominal fp16; the whole-fleet
tests give the reference the same fp32 table bytes.

Within the port, a k-board fleet's probs are bitwise equal to one full
board's, cache on and off, as the reference's invariant requires.
"""
import dataclasses
import json
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.tiered_embedding as jte
import repro.fabric as jf
import repro.fabric.fleet as jfleet
import repro.fabric.partition as jpartition
import repro_torch.core.tiered_embedding as pte
import repro_torch.fabric as pf
import repro_torch.fabric.fleet as pfleet
from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro.core import perf_model as jperf
from repro.traffic import make_scenario
from repro_torch import convert
from repro_torch.configs import get_dlrm
from repro_torch.core import perf_model as pperf
from repro_torch.engine import Engine
from repro_torch.obs.metrics import MetricsRegistry as PortRegistry
from repro.obs.metrics import MetricsRegistry as JaxRegistry

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "dlrm-rm2-small-unsharded"
ALPHA = 1.2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (dataclasses.replace(jax_get_dlrm(NAME).reduced(), batch_size=8,
                                **kw),
            dataclasses.replace(get_dlrm(NAME).reduced(), batch_size=8,
                                **kw))


def _fp32_bytes(cfg):
    return [cfg.rows_per_table * cfg.embed_dim * 4] * cfg.num_tables


def _shards(shards):
    return [dataclasses.astuple(s) for s in shards]


def _same_map(got, want):
    for f in dataclasses.fields(want):
        if f.name != "shards":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert _shards(got.shards) == _shards(want.shards)


# ---------------------------------------------------------------------------
# Partition: the same shards, bytes, loads, warnings and refusals
# ---------------------------------------------------------------------------
def _zipf_rows(cfg, seed=0):
    rng = np.random.default_rng(seed)
    rank = np.arange(1, cfg.rows_per_table + 1, dtype=np.float64)
    freq = np.stack([rng.permutation(rank ** -1.05)
                     for _ in range(cfg.num_tables)])
    return freq / freq.sum()


@pytest.mark.parametrize("case", [
    dict(n=4, cap_tables=4, freq="table"),
    dict(n=4, cap_tables=2, freq="table"),
    dict(n=3, cap_tables=2.9, freq="rows"),
    dict(n=3, cap_tables=2.7, freq="rows", min_shard_rows=16),
    dict(n=2, cap_tables=4.1, freq="ones", table_bytes="fp32"),
    dict(n=5, cap_tables=1.7, freq="rows", table_bytes="fp32")])
def test_partition_rows_matches_the_reference(case):
    jcfg, cfg = _cfgs()
    tbytes = cfg.rows_per_table * cfg.embed_dim * 2
    cap = int(case["cap_tables"] * tbytes)
    freq = {"table": np.array([1.0 / (t + 1) for t in range(cfg.num_tables)]),
            "rows": _zipf_rows(cfg),
            "ones": np.ones(cfg.num_tables)}[case["freq"]]
    tb = _fp32_bytes(cfg) if case.get("table_bytes") else None
    if tb is not None:
        cap *= 2
    kw = dict(min_shard_rows=case.get("min_shard_rows", 1))
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jf.partition_rows(jcfg, freq, case["n"], cap, tb, **kw)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = pf.partition_rows(cfg, freq, case["n"], cap, tb, **kw)
    _same_map(got, want)
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    for b in range(case["n"]):
        assert _shards(got.shards_of(b)) == _shards(want.shards_of(b))
        assert got.tables_of(b) == want.tables_of(b)
        np.testing.assert_array_equal(got.owned_mask(b), want.owned_mask(b))
    for t in range(cfg.num_tables):
        for a, b in zip(got.owner_cuts(t), want.owner_cuts(t)):
            np.testing.assert_array_equal(a, b)
        assert got.owner_of(t, cfg.rows_per_table - 1) == \
            want.owner_of(t, cfg.rows_per_table - 1)
    assert got.split_tables == want.split_tables
    assert got.whole_tables == want.whole_tables
    assert got.load_balance() == want.load_balance()
    assert got.peak_fill() == want.peak_fill()
    assert got.total_bytes == want.total_bytes
    assert got.table_bytes == want.table_bytes
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert got.summary() == want.summary()
    if not want.split_tables:
        assert got.owner == want.owner
        whole = pf.partition_tables(cfg, freq.reshape(cfg.num_tables, -1)
                                    .sum(axis=1), case["n"], cap, tb)
        assert whole.owner == jf.partition_tables(
            jcfg, freq.reshape(cfg.num_tables, -1).sum(axis=1), case["n"],
            cap, tb).owner


@pytest.mark.parametrize("args,match", [
    (dict(n=2, cap_tables=3, whole=True), "does not fit the fleet"),
    (dict(n=0, cap_tables=1), "n_boards"),
    (dict(n=2, cap_tables=1, freq=np.ones(3)), "one entry per table"),
    (dict(n=2, cap_tables=1, freq=np.ones((8, 5))), "access_freq must be"),
    (dict(n=2, cap_tables=3.9, min_shard_rows=100), "row-range split"),
    (dict(n=2, cap_tables=2, table_bytes=[100] * 8),
     "does not divide into")])
def test_partition_refusals_match_the_reference(args, match):
    jcfg, cfg = _cfgs()
    tbytes = cfg.rows_per_table * cfg.embed_dim * 2
    cap = int(args["cap_tables"] * tbytes)
    freq = args.get("freq", np.ones(cfg.num_tables))
    msgs = []
    for pkg, c in ((jf, jcfg), (pf, cfg)):
        fn = pkg.partition_tables if args.get("whole") else pkg.partition_rows
        kw = ({} if args.get("whole")
              else dict(min_shard_rows=args.get("min_shard_rows", 1)))
        with pytest.raises(ValueError, match=match) as e:
            fn(c, freq, args["n"], cap, args.get("table_bytes"), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_fits_one_board_and_the_plan_time_warning_match():
    jcfg, cfg = _cfgs()
    for cap in (cfg.embedding_bytes - 1, cfg.embedding_bytes):
        assert pf.fits_one_board(cfg, cap) == jf.fits_one_board(jcfg, cap)
        tb = _fp32_bytes(cfg)
        assert pf.fits_one_board(cfg, cap, tb) == jf.fits_one_board(
            jcfg, cap, tb)
    per_board = (cfg.num_tables // 2) * cfg.rows_per_table * cfg.embed_dim * 2
    for pkg, c in ((jf, jcfg), (pf, cfg)):
        with pytest.warns(RuntimeWarning, match="within 5% of overflow"):
            pm = pkg.partition_tables(c, np.ones(8), 2, int(per_board * 1.02))
        assert "WARNING" in pm.summary()
    assert pf.PartitionMap is pf.ShardMap


# ---------------------------------------------------------------------------
# The remote-row cache: the same election, counts, window and refreshes
# ---------------------------------------------------------------------------
def _tied_stream(cfg, n, seed, salt=0):
    """(n, B, T, L) ids whose counts tie often: few distinct rows, drawn
    uniformly from a small head, so many rows share the boundary count."""
    rng = np.random.default_rng(seed)
    head = rng.choice(cfg.rows_per_table, 12, replace=False)
    idx = head[rng.integers(0, 12, (n, cfg.batch_size, cfg.num_tables,
                                    cfg.lookups_per_table))]
    return ((idx + salt) % cfg.rows_per_table).astype(np.int32)


def _caches(cfgs, remote, **kw):
    return (jf.RemoteRowCache(cfgs[0], remote, **kw),
            pf.RemoteRowCache(cfgs[1], remote, **kw))


def _same_cache(pc, jc):
    np.testing.assert_array_equal(pc._cached, jc._cached)
    np.testing.assert_array_equal(pc._counts, jc._counts)
    np.testing.assert_array_equal(pc._remote, jc._remote)
    assert pc.baseline == jc.baseline
    assert pc.refreshes == jc.refreshes and pc.history == jc.history
    assert pc.windowed_hit_ratio() == jc.windowed_hit_ratio()
    assert pc.should_refresh() == jc.should_refresh()
    assert pc.cached_rows == jc.cached_rows
    assert pc.remote_tables == jc.remote_tables


@pytest.mark.parametrize("capacity,remote", [
    (40, "tables"), (13, "mask"), (7, "mask"), (1000, "mask"), (0, "mask")])
def test_remote_row_cache_matches_the_reference(capacity, remote):
    cfgs = _cfgs()
    cfg = cfgs[1]
    rng = np.random.default_rng(capacity)
    if remote == "tables":
        rem = [0, 2, 3, 5]
    else:
        rem = rng.random((cfg.num_tables, cfg.rows_per_table)) < 0.6
    jc, pc = _caches(cfgs, rem, capacity_rows=capacity, window=6,
                     refresh_threshold=0.7, cooldown_queries=5)
    # a profile with ties at the boundary count and zeros
    freq = rng.integers(0, 4, (cfg.num_tables, cfg.rows_per_table))
    assert pc.warm(freq) == jc.warm(freq)
    _same_cache(pc, jc)
    for k, idx in enumerate(np.concatenate(
            [_tied_stream(cfg, 10, 1), _tied_stream(cfg, 30, 2, salt=53)])):
        t = 0.01 * k
        hit_j, hit_p = jc.hit_mask(idx), pc.hit_mask(idx)
        np.testing.assert_array_equal(hit_p, hit_j)
        share = k % 2 == 0
        assert (pc.observe(idx, t, hit=hit_p if share else None)
                == jc.observe(idx, t, hit=hit_j if share else None))
        assert pc.maybe_refresh(t) == jc.maybe_refresh(t)
        _same_cache(pc, jc)
    if capacity and capacity < 1000:
        assert pc.refreshes, "the drift never re-elected"
    assert pc.enabled == jc.enabled == (capacity > 0)


def test_update_ownership_matches_the_reference():
    cfgs = _cfgs()
    cfg = cfgs[1]
    rng = np.random.default_rng(3)
    remote = rng.random((cfg.num_tables, cfg.rows_per_table)) < 0.5
    jc, pc = _caches(cfgs, remote, capacity_rows=50)
    freq = rng.integers(0, 6, remote.shape)
    jc.warm(freq)
    pc.warm(freq)
    for idx in _tied_stream(cfg, 4, 5):
        jc.observe(idx, 0.0)
        pc.observe(idx, 0.0)
    for k in range(3):
        new = rng.random(remote.shape) < 0.5
        assert pc.update_ownership(new) == jc.update_ownership(new) > 0
        _same_cache(pc, jc)
    assert pc.update_ownership(new) == 0


# ---------------------------------------------------------------------------
# The exchange: routing, reassembly and every ExchangeTraffic field
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_boards,cap_tables,with_cache", [
    (2, 8, True), (3, 2.8, True), (3, 2.8, False), (1, 8, True),
    (4, 2.2, True)])
def test_exchange_accounting_matches_the_reference(n_boards, cap_tables,
                                                   with_cache):
    jcfg, cfg = _cfgs()
    freq = _zipf_rows(cfg, 2)
    cap = int(cap_tables * cfg.rows_per_table * cfg.embed_dim * 2)
    jpm = jf.partition_rows(jcfg, freq, n_boards, cap)
    ppm = pf.partition_rows(cfg, freq, n_boards, cap)
    link = jperf.fabric_link(2.0, 50.0)
    jreg, preg = JaxRegistry(), PortRegistry()
    jex = jf.FabricExchange(jcfg, jpm, link, metrics=jreg)
    pex = pf.FabricExchange(cfg, ppm, pperf.fabric_link(2.0, 50.0),
                            metrics=preg)
    assert len(pex.tables_by_board) == len(jex.tables_by_board)
    for a, b in zip(pex.tables_by_board, jex.tables_by_board):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pex.split_tables, jex.split_tables)
    np.testing.assert_array_equal(pex.inv_perm, jex.inv_perm)
    rng = np.random.default_rng(n_boards)
    counts = rng.integers(0, 3, (cfg.num_tables, cfg.rows_per_table))
    for board in range(n_boards):
        remote = ~ppm.owned_mask(board)
        caches = (_caches((jcfg, cfg), remote, capacity_rows=60)
                  if with_cache else (None, None))
        if with_cache:
            for c in caches:
                c.warm(counts)
        for seed in range(3):
            idx = rng.integers(0, cfg.rows_per_table,
                               (5, cfg.num_tables, cfg.lookups_per_table)
                               ).astype(np.int32)
            np.testing.assert_array_equal(pex.lookup_owners(idx),
                                          jex.lookup_owners(idx))
            hit = caches[1].hit_mask(idx) if with_cache else None
            want = jex.account(board, idx, caches[0])
            got = pex.account(board, idx, caches[1], hit=hit)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.bytes_total == want.bytes_total
            assert got.remote_hit_ratio == want.remote_hit_ratio
    assert preg.snapshot() == jreg.snapshot()


# ---------------------------------------------------------------------------
# Whole fleets, both packages, on shared arrays and fixed service times
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


# seconds a board's device work takes, a fixed function of its shape
SERVICE = {"lookup": lambda idx: 1e-3 + 2e-4 * idx.shape[1],
           "gather_rows": lambda idx: 4e-4,
           "pool_rows": lambda idx: 3e-4 + 1e-4 * idx.shape[1],
           "dense_forward": lambda idx: 2e-3}


@pytest.fixture
def shared(monkeypatch):
    """Both packages materialize the same numpy query for an event,
    profile the same numpy row counts, budget fp32 table bytes, and see
    fixed service times."""
    def jax_query(cfg, ev, q=None):
        d, i = _query_np(cfg, ev, q or cfg.batch_size)
        return {"dense": jnp.asarray(d), "indices": jnp.asarray(i)}

    def port_query(cfg, ev, q=None, device=None):
        d, i = _query_np(cfg, ev, q or cfg.batch_size)
        return {"dense": torch.from_numpy(d).to(device),
                "indices": torch.from_numpy(i).to(device)}

    monkeypatch.setattr(jfleet, "materialize_query", jax_query)
    monkeypatch.setattr(pfleet, "materialize_query", port_query)
    monkeypatch.setattr(jte, "measure_row_freq",
                        lambda cfg, *a, **kw: jnp.asarray(_freq_np(cfg)))
    monkeypatch.setattr(
        pte, "measure_row_freq",
        lambda cfg, *a, device=None, **kw: torch.from_numpy(
            _freq_np(cfg)).to(device))
    monkeypatch.setattr(jfleet, "default_table_bytes", _fp32_bytes)
    monkeypatch.setattr(jpartition, "default_table_bytes", _fp32_bytes)
    for cls in (jfleet.FabricBoard, pfleet.FabricBoard):
        for name, fixed in SERVICE.items():
            def wrapped(self, *args, _orig=getattr(cls, name),
                        _fixed=fixed):
                out, _ = _orig(self, *args)
                return out, _fixed(args[-1])
            monkeypatch.setattr(cls, name, wrapped)


def fleets(jcfg, cfg, *, autoscalers=(None, None), **kw):
    """A JAX fleet and a port fleet on the JAX fleet's params."""
    jfl = jf.ShardedFleet(jcfg, autoscaler=autoscalers[0], **kw)
    params = convert.params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jfl._params), "cpu")
    pfl = pf.ShardedFleet(cfg, autoscaler=autoscalers[1], params=params,
                          device="cpu", **kw)
    return jfl, pfl


def run_both(jfl, pfl, events, scenario="trace"):
    jrep = jfl.run(events, sla_ms=50.0, scenario=scenario)
    prep = pfl.run(events, sla_ms=50.0, scenario=scenario)
    assert prep.asdict() == jrep.asdict()
    assert prep.summary() == jrep.summary()
    assert sorted(pfl.completed) == [e.qid for e in events]
    for ev in events:
        got = pfl.completed[ev.qid].probs
        assert got.shape == (8,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, jfl.completed[ev.qid].probs, **TOL)
        assert pfl.completed[ev.qid].query is None
    return prep


@pytest.mark.parametrize("cache_on", [True, False])
@pytest.mark.parametrize("router", ["round_robin", "jsq", "p2c"])
def test_fabric_report_matches_the_reference(router, cache_on, shared):
    jcfg, cfg = _cfgs()
    events = make_scenario("stationary", alpha=ALPHA).events(
        24, qps=600.0, seed=1)
    cap = int(2.8 * cfg.rows_per_table * cfg.embed_dim * 4)
    jfl, pfl = fleets(jcfg, cfg, n_boards=3, alpha=ALPHA, router=router,
                      max_batch_queries=2, board_capacity_bytes=cap,
                      cache_enabled=cache_on)
    _same_map(pfl.partition, jfl.partition)
    assert pfl.partition.split_tables
    assert pfl.measure_service_time() == jfl.measure_service_time()
    rep = run_both(jfl, pfl, events, "stationary")
    assert not rep.fits_one_board and rep.bytes_per_query > 0
    assert (rep.remote_hit_first is None) == (not cache_on)
    assert sum(s["served"] for s in rep.replicas) == 24


def test_zipf_drift_re_election_matches_the_reference(shared):
    jcfg, cfg = _cfgs()
    # a stride prime to the stream's multiplier of 37 moves the hot rows
    events = make_scenario("zipf_drift", alpha=ALPHA, rotate_every_s=0.03,
                           salt_stride=53).events(90, qps=1500.0, seed=3)
    assert len({e.perm_salt for e in events}) > 1
    jfl, pfl = fleets(jcfg, cfg, n_boards=4, alpha=ALPHA, router="jsq",
                      max_batch_queries=2, cache_window=6,
                      cache_refresh_threshold=0.7, cache_cooldown=6)
    rep = run_both(jfl, pfl, events, "zipf_drift")
    assert rep.cache_refreshes > 0
    for jc, pc in zip(jfl.caches, pfl.caches):
        _same_cache(pc, jc)


# ---------------------------------------------------------------------------
# Within the port: k boards serve bit-identically to one full board
# ---------------------------------------------------------------------------
def test_sharded_fleet_bitwise_equals_one_full_board():
    _, cfg = _cfgs()
    events = make_scenario("zipf_drift", alpha=ALPHA, rotate_every_s=0.02,
                           salt_stride=37).events(120, qps=2000.0, seed=3)
    full = sum(_fp32_bytes(cfg))
    ref = pf.ShardedFleet(cfg, n_boards=1, alpha=ALPHA,
                          board_capacity_bytes=full, max_batch_queries=2,
                          device="cpu")
    r1 = ref.run(events, sla_ms=1e6)
    assert r1.fits_one_board and r1.bytes_per_query == 0
    wire = {}
    for cache_on in (True, False):
        fleet = pf.ShardedFleet(cfg, n_boards=4, alpha=ALPHA,
                                max_batch_queries=2, cache_enabled=cache_on,
                                cache_window=6, cache_refresh_threshold=0.7,
                                cache_cooldown=6, router="jsq",
                                device="cpu")
        assert [b.device for b in fleet.boards] == [torch.device("cpu")] * 4
        r = fleet.run(events, sla_ms=1e6, scenario="zipf_drift")
        if cache_on:
            assert r.cache_refreshes > 0
        wire[cache_on] = r.bytes_per_query
        for ev in events:
            assert np.array_equal(fleet.completed[ev.qid].probs,
                                  ref.completed[ev.qid].probs), ev.qid
    assert wire[True] < wire[False]


def test_split_table_serves_bitwise_and_holds_only_its_rows():
    _, cfg = _cfgs(num_tables=1, rows_per_table=768)
    row_b = cfg.embed_dim * 4
    cap = 512 * row_b
    with pytest.raises(ValueError, match="does not fit the fleet"):
        pf.partition_tables(cfg, np.ones(1), 2, cap, [768 * row_b])
    events = make_scenario("stationary", alpha=1.05).events(
        20, qps=1000.0, seed=3)
    ref = pf.ShardedFleet(cfg, n_boards=1, alpha=1.05,
                          board_capacity_bytes=768 * row_b,
                          max_batch_queries=2, device="cpu")
    ref.run(events, sla_ms=1e6)
    fleet = pf.ShardedFleet(cfg, n_boards=2, alpha=1.05,
                            board_capacity_bytes=cap, max_batch_queries=2,
                            device="cpu")
    assert fleet.partition.split_tables == (0,)
    for b in fleet.boards:
        assert b.resident_bytes(row_b) <= cap
        assert b.tables.shape[0] == 0 and set(b.split_rows) == {0}
        ids, rows = b.split_rows[0]
        assert rows.shape == (ids.numel(), cfg.embed_dim)
        np.testing.assert_array_equal(
            rows.numpy(), fleet._tables_host[0, ids].numpy())
    r = fleet.run(events, sla_ms=1e6)
    assert not r.fits_one_board and r.bytes_per_query > 0
    for ev in events:
        assert np.array_equal(fleet.completed[ev.qid].probs,
                              ref.completed[ev.qid].probs)


def test_fleets_share_the_host_tables_without_a_copy():
    _, cfg = _cfgs()
    a = pf.ShardedFleet(cfg, n_boards=2, device="cpu", max_batch_queries=2)
    b = pf.ShardedFleet(cfg, n_boards=3, device="cpu", params=a._params)
    assert b._tables_host.data_ptr() == a._tables_host.data_ptr()
    stacked = Engine(cfg, device="cpu").serve_session().params
    assert torch.equal(a._tables_host, stacked["tables"])
    for got, want in zip(b.boards[0].dense_params["bot_mlp"],
                         stacked["bot_mlp"]):
        assert torch.equal(got["w"], want["w"])
    before = a._tables_host.clone()
    a.run(make_scenario("stationary").events(6, qps=500.0), sla_ms=1e6)
    assert torch.equal(a._tables_host, before)


# ---------------------------------------------------------------------------
# Engine.sharded_fleet, the launcher, and what waits for later items
# ---------------------------------------------------------------------------
def test_engine_builds_a_sharded_fleet():
    _, cfg = _cfgs()
    eng = Engine(cfg, alpha=1.05, seed=7, device="cpu")
    fleet = eng.sharded_fleet(n_boards=2, max_batch_queries=2)
    assert isinstance(fleet, pf.ShardedFleet)
    assert fleet.alpha == 1.05 and fleet.seed == 7 and fleet.n_boards == 2
    assert fleet.device == torch.device("cpu")
    r = fleet.run(make_scenario("stationary", alpha=1.05).events(
        4, qps=400.0, seed=7), sla_ms=1e6)
    assert r.n_queries == 4
    eng.cfg = SimpleNamespace(name="an-lm")
    with pytest.raises(ValueError, match="DLRM-only"):
        eng.sharded_fleet()


def test_unported_fabric_options_name_their_item():
    _, cfg = _cfgs()
    # online updates (A7c) work: an empty channel changes nothing, and a
    # batch lands in the host tables and the owner's resident rows
    from repro_torch.online import DeltaBatch, DeltaChannel, RowDelta
    fleet = pf.ShardedFleet(cfg, n_boards=1, device="cpu")
    rep = fleet.run(make_scenario("stationary").events(2, qps=10.0),
                    online=DeltaChannel(), coherence="invalidate")
    assert rep.online.n_updates == 0 and rep.online.mode == "invalidate"
    batch = DeltaBatch(version=1, t_emit_s=0.0, step=1, deltas=(
        RowDelta(1, np.array([3]), np.ones((1, cfg.embed_dim), np.float32)),))
    fleet._apply_delta(batch, 0.0, "propagate")
    assert torch.equal(fleet._tables_host[1, 3], torch.ones(cfg.embed_dim))
    assert torch.equal(fleet.boards[0].tables[1, 3], torch.ones(cfg.embed_dim))
    with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
        pf.ShardedFleet(cfg, n_boards=1, devices=["cpu", "cpu"],
                        devices_per_board=2)
    with pytest.raises(ValueError, match="n_boards"):
        pf.ShardedFleet(cfg, n_boards=0, device="cpu")
    assert sorted(pf.__all__) == sorted(jf.__all__)
    assert issubclass(pf.FabricReport, pfleet.FleetReport)
    assert pf.FabricReport.tag == "fabric"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA host")
def test_the_sharded_fleet_runs_on_the_card_by_default():
    from repro_torch.launch import serve
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pf.ShardedFleet(cfg, n_boards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg).sharded_fleet()
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--smoke", "--fleet-mode", "sharded"])


def _serve(capsys, *argv):
    from repro_torch.launch import serve
    rc = serve.main(["--smoke", "--device", "cpu", "--fleet-mode", "sharded",
                     *argv])
    return rc, capsys.readouterr().out


def _report(path):
    return json.loads(path.read_text())


def test_launcher_serves_the_sharded_fleet(capsys, tmp_path):
    path = tmp_path / "r.json"
    rc, out = _serve(capsys, "--queries", "16", "--replicas", "3",
                     "--report-json", str(path))
    assert rc == 0, out
    assert "[partition] dlrm-rm2-small-unsharded-smoke: 8 tables" in out
    assert "[serve] --qps 0: offering 0.3 x sharded capacity" in out
    assert "(sharded, 3 boards):" in out
    assert "[fabric] 0.12 MiB tables over 3 boards @ 0.05 MiB" in out
    rep = _report(path)
    assert rep["n_boards"] == 3 and rep["n_queries"] == 16
    # the default budget: the fair share of the fp32 tables + 25%
    assert rep["board_capacity_bytes"] == int(np.ceil(1.25 * 8 * 16384 / 3))
    assert "exceeds one board" in out


@pytest.mark.parametrize("flag,check", [
    (["--board-capacity-mb", "0.045"],
     lambda r, b, o, bo: r["board_capacity_bytes"] == int(0.045 * 2 ** 20)
     and "row-range split" in o and "row-range split" not in bo),
    (["--fabric-cache-rows", "0"],
     lambda r, b, o, bo: r["cache_rows"] == 0
     and r["remote_hit_first"] is None
     and r["bytes_per_query"] > b["bytes_per_query"]),
    (["--fabric-cache-rows", "37"],
     lambda r, b, o, bo: r["cache_rows"] == 37 < b["cache_rows"]
     and r["remote_hit_first"] is not None),
    (["--fabric-latency-us", "500"],
     lambda r, b, o, bo: r["link_stall_share"] > 10 * b["link_stall_share"]),
    (["--fabric-gbs", "0.01"],
     lambda r, b, o, bo: r["link_stall_share"] > 10 * b["link_stall_share"])])
def test_launcher_fabric_flags_take_effect(flag, check, capsys, tmp_path):
    base, path = tmp_path / "base.json", tmp_path / "r.json"
    common = ["--queries", "12", "--replicas", "3", "--qps", "400"]
    rc, base_out = _serve(capsys, *common, "--report-json", str(base))
    assert rc == 0, base_out
    rc, out = _serve(capsys, *common, *flag, "--report-json", str(path))
    assert rc == 0, out
    r, b = _report(path), _report(base)
    assert check(r, b, out, base_out), (r, b, out)


def test_launcher_sharded_fleet_autoscales_and_replays(capsys, tmp_path):
    trace = tmp_path / "t.jsonl"
    rc, out = _serve(capsys, "--queries", "40", "--replicas", "2",
                     "--scenario", "flash_crowd", "--router", "p2c",
                     "--qps", "800", "--autoscale", "--autoscale-sla-ms",
                     "0.5", "--max-replicas", "3", "--record-trace",
                     str(trace))
    assert rc == 0, out
    assert "[fabric] scale up" in out and "re-partitions" in out
    rc, out = _serve(capsys, "--replicas", "2", "--replay-trace",
                     str(trace))
    assert rc == 0, out
    assert "[serve] replaying 40 events" in out
    assert "flash_crowd x round_robin: 40 queries over 2->2" in out


@pytest.mark.parametrize("flag", [
    ["--online-every-s", "0.01"], ["--coherence", "invalidate"],
    ["--replay-deltas", "d.jsonl"]])
def test_launcher_sharded_online_flags_take_effect(flag, capsys, tmp_path):
    """The online flags on the sharded path: inline training or a replayed
    recording, each batch applied under the chosen coherence mode."""
    from test_torch_cluster import _online_lines, _replayable
    path = tmp_path / "r.json"
    if flag[0] == "--replay-deltas":
        flag = [flag[0], str(tmp_path / flag[1])]
        _replayable(_cfgs()[1], flag[1])
    every = [] if flag[0] != "--coherence" else ["--online-every-s", "0.01"]
    rc, out = _serve(capsys, "--queries", "12", "--replicas", "3",
                     "--qps", "400", "--board-capacity-mb", "0.045",
                     "--report-json", str(path), *every, *flag)
    assert rc == 0, out
    trained, (n, last, mode) = _online_lines(out)
    rep = _report(path)["online"]
    assert rep["kind"] == "OnlineReport" and rep["n_updates"] == n == last
    assert mode == ("invalidate" if flag[0] == "--coherence"
                    else "propagate")
    if flag[0] == "--replay-deltas":
        assert trained is None and n == 2 and rep["rows_pushed"] == 4
    else:
        assert n == trained > 0 and rep["rows_pushed"] > 0
    if mode == "invalidate":
        assert rep["rows_propagated"] == 0
