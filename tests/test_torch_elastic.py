"""The port's live re-partitioning (repro_torch.fabric.elastic, the
elastic ShardedFleet) against repro.fabric.

`expand_map`, `shrink_map` and `plan_migration` are pure numpy in both
packages and are held EXACTLY equal. Elastic fleets run in both packages
on shared arrays and fixed service times (tests/test_torch_fabric.py's
`shared` fixture), so their FabricReports, scale events and migration
ledgers must be equal field for field. Within the port, an elastic fleet
serves bit-identically to a static one and a retired board lets go of
its device tensors.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.cluster as jc
import repro.fabric as jf
import repro_torch.cluster as pc
import repro_torch.fabric as pf
from repro.core import perf_model as jperf
from repro.fabric.elastic import grid_to_map as jax_grid_to_map
from repro.fabric.elastic import owner_grid as jax_owner_grid
from repro.traffic import make_scenario
from repro_torch.core import perf_model as pperf
from repro_torch.fabric.elastic import grid_to_map, owner_grid
from test_torch_fabric import (_cfgs, _fp32_bytes, _same_cache, _same_map,
                               _shards, fleets, run_both)
from test_torch_fabric import shared  # noqa: F401  (the fleets' fixture)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zipf_maps(n_boards=2, num_tables=8, cap_boards=None, permute=False):
    """(jax cfg, port cfg, per-row Zipf freq, jax map, port map), capacity
    sized for `cap_boards` boards (default n_boards)."""
    jcfg, cfg = _cfgs(num_tables=num_tables)
    rank = np.arange(1, cfg.rows_per_table + 1, dtype=np.float64)
    freq = np.broadcast_to(rank ** -1.05, (num_tables, cfg.rows_per_table))
    if permute:
        rng = np.random.default_rng(num_tables)
        freq = np.stack([rng.permutation(f) * (t + 1)
                         for t, f in enumerate(freq)])
    freq = freq / freq.sum()
    cap = int(np.ceil(1.25 * cfg.embedding_bytes
                      / (cap_boards or n_boards)))
    return (jcfg, cfg, freq, jf.partition_rows(jcfg, freq, n_boards, cap),
            pf.partition_rows(cfg, freq, n_boards, cap))


def _same_plan(got, want):
    assert _shards(got.moves) == _shards(want.moves)
    for f in dataclasses.fields(want):
        if f.name != "moves":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    link = (pperf.fabric_link(2.0, 50.0), jperf.fabric_link(2.0, 50.0))
    assert got.time_s(link[0]) == want.time_s(link[1])
    assert got.summary() == want.summary()


# ---------------------------------------------------------------------------
# Elastic transforms and migration plans: exactly the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_boards,permute,min_rows", [
    (1, False, 1), (2, False, 1), (2, True, 1), (3, True, 1), (3, False, 8),
    (4, True, 4)])
def test_expand_map_and_its_plan_match_the_reference(n_boards, permute,
                                                     min_rows):
    _, _, freq, jpm, ppm = _zipf_maps(n_boards, permute=permute)
    _same_map(ppm, jpm)
    want = jf.expand_map(jpm, freq, min_shard_rows=min_rows)
    got = pf.expand_map(ppm, freq, min_shard_rows=min_rows)
    _same_map(got, want)
    assert got.n_boards == n_boards + 1
    _same_plan(pf.plan_migration(ppm, got), jf.plan_migration(jpm, want))
    np.testing.assert_array_equal(owner_grid(got), jax_owner_grid(want))
    # no profile: uniform row mass
    _same_map(pf.expand_map(ppm), jf.expand_map(jpm))


@pytest.mark.parametrize("n_boards,cap_boards,permute", [
    (3, 2, False), (3, 2, True), (4, 3, True), (2, 1, False)])
def test_shrink_map_and_its_plan_match_the_reference(n_boards, cap_boards,
                                                     permute):
    _, _, freq, jpm, ppm = _zipf_maps(n_boards, cap_boards=cap_boards,
                                      permute=permute)
    want = jf.shrink_map(jpm, freq)
    got = pf.shrink_map(ppm, freq)
    _same_map(got, want)
    plan = pf.plan_migration(ppm, got)
    _same_plan(plan, jf.plan_migration(jpm, want))
    assert all(m.src == n_boards - 1 for m in plan.moves)
    back = pf.shrink_map(pf.expand_map(ppm, freq), freq)
    _same_map(back, jf.shrink_map(jf.expand_map(jpm, freq), freq))


def test_elastic_refusals_and_grids_match_the_reference():
    jcfg, cfg = _cfgs(num_tables=1, rows_per_table=768)
    cap = 512 * cfg.embed_dim * 2
    maps = (jf.partition_rows(jcfg, np.ones(1), 2, cap),
            pf.partition_rows(cfg, np.ones(1), 2, cap))
    msgs = []
    for pkg, pm in ((jf, maps[0]), (pf, maps[1])):
        with pytest.raises(ValueError, match="cannot shrink") as e:
            pkg.shrink_map(pm)
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="1-board"):
            pkg.shrink_map(pkg.partition_rows(
                jcfg if pkg is jf else cfg, np.ones(1), 1,
                cfg.embedding_bytes))
        with pytest.raises(ValueError, match="different models"):
            pkg.plan_migration(pm, pkg.partition_rows(
                dataclasses.replace(jcfg if pkg is jf else cfg,
                                    rows_per_table=512),
                np.ones(1), 2, cap))
    assert msgs[0] == msgs[1]
    _, _, freq, jpm, ppm = _zipf_maps(3, permute=True)
    grid = owner_grid(ppm)
    grid[:, :7] = 2
    _same_map(grid_to_map(ppm, grid, 3, freq),
              jax_grid_to_map(jpm, grid, 3, freq))
    _same_map(grid_to_map(ppm, grid, 3), jax_grid_to_map(jpm, grid, 3))
    null = pf.plan_migration(ppm, ppm)
    assert null.moves == () and null.bytes_moved == 0
    assert null.time_s(pperf.fabric_link()) == 0.0


def test_repartition_time_matches_the_reference():
    for send, recv in (([1e6, 0.0], [0.0, 1e6]), ([1e6, 0.0], [5e5, 5e5]),
                       ([1e6, 0.0, 0.0], [0.0, 5e5, 5e5]), ([0.0], [0.0])):
        assert pperf.repartition_time(send, recv, pperf.fabric_link(
            2.0, 50.0)) == jperf.repartition_time(
                send, recv, jperf.fabric_link(2.0, 50.0))
    with pytest.raises(ValueError):
        pperf.repartition_time([1.0], [1.0, 2.0], pperf.fabric_link())


def test_migration_ledger_matches_the_reference():
    scalers = (jc.SLAAutoscaler(5.0), pc.SLAAutoscaler(5.0))
    for sc in scalers:
        sc.record_migration(0.25, 4096, 1.5e-4)
        sc.record_migration(np.float64(0.5), np.int64(128), 2e-6)
    assert scalers[1].migration_log == scalers[0].migration_log
    assert [type(x) for x in scalers[1].migration_log[1]] == [
        float, int, float]


def test_cache_ownership_change_keeps_untouched_rows():
    """The reference's invariant: a migration invalidates only the rows
    whose remote-status changed, and both packages agree on which."""
    cfgs = _cfgs()
    cfg = cfgs[1]
    rng = np.random.default_rng(0)
    freq = rng.integers(0, 5, (cfg.num_tables, cfg.rows_per_table))
    remote = np.zeros((cfg.num_tables, cfg.rows_per_table), bool)
    remote[:4] = True
    caches = (jf.RemoteRowCache(cfgs[0], remote, capacity_rows=64),
              pf.RemoteRowCache(cfg, remote, capacity_rows=64))
    for c in caches:
        c.warm(freq)
    before = caches[1]._cached.copy()
    new = remote.copy()
    new[0] = False
    new[4] = True
    assert [c.update_ownership(new) for c in caches] == \
        [2 * cfg.rows_per_table] * 2
    np.testing.assert_array_equal(caches[1]._cached[1:4], before[1:4])
    assert caches[1].remote_tables == (1, 2, 3, 4)
    _same_cache(caches[1], caches[0])


# ---------------------------------------------------------------------------
# Elastic fleets, both packages, fixed service times
# ---------------------------------------------------------------------------
def _scalers(**kw):
    return jc.SLAAutoscaler(**kw), pc.SLAAutoscaler(**kw)


def test_flash_crowd_scale_up_matches_the_reference(shared):
    jcfg, cfg = _cfgs()
    scalers = _scalers(sla_ms=8.0, min_replicas=2, max_replicas=4, window=8,
                       patience=1, cooldown_s=0.005)
    events = make_scenario("flash_crowd", alpha=1.05).events(
        80, qps=800.0, seed=5)
    jfl, pfl = fleets(jcfg, cfg, n_boards=2, alpha=1.05, router="p2c",
                      max_batch_queries=2, autoscalers=scalers)
    rep = run_both(jfl, pfl, events, "flash_crowd")
    assert rep.migrations == len(rep.scale_events) > 0
    assert any(e.action == "up" for e in rep.scale_events)
    assert rep.migrated_bytes > 0 and rep.migration_s > 0
    assert scalers[1].migration_log == scalers[0].migration_log
    assert scalers[1].cost_log == scalers[0].cost_log
    assert len(scalers[1].migration_log) == rep.migrations
    row_b = cfg.embed_dim * 4
    for e in rep.scale_events:
        assert e.remesh["bytes_moved"] == e.remesh["rows_moved"] * row_b
    _same_map(pfl.partition, jfl.partition)
    for jcache, pcache in zip(jfl.caches, pfl.caches):
        _same_cache(pcache, jcache)


def test_slack_scale_down_matches_the_reference(shared):
    jcfg, cfg = _cfgs()
    scalers = _scalers(sla_ms=1e6, min_replicas=1, max_replicas=2, window=8,
                       patience=1, cooldown_s=0.005)
    events = make_scenario("stationary", alpha=1.05).events(
        60, qps=500.0, seed=5)
    jfl, pfl = fleets(jcfg, cfg, n_boards=2, alpha=1.05,
                      max_batch_queries=2, autoscalers=scalers,
                      board_capacity_bytes=sum(_fp32_bytes(cfg)))
    rep = run_both(jfl, pfl, events, "stationary")
    assert any(e.action == "down" for e in rep.scale_events)
    assert rep.n_replicas_end == 1 and len(rep.replicas) == 2
    assert pfl._retired[0].retired_at == jfl._retired[0].retired_at


def test_split_table_fleet_matches_the_reference(shared):
    jcfg, cfg = _cfgs(num_tables=1, rows_per_table=768)
    cap = 512 * cfg.embed_dim * 4
    events = make_scenario("stationary", alpha=1.05).events(
        20, qps=1000.0, seed=3)
    for cache_on in (True, False):
        jfl, pfl = fleets(jcfg, cfg, n_boards=2, alpha=1.05,
                          board_capacity_bytes=cap, max_batch_queries=2,
                          cache_enabled=cache_on)
        assert pfl.partition.split_tables == (0,)
        rep = run_both(jfl, pfl, events)
        assert not rep.fits_one_board and rep.bytes_per_query > 0


# ---------------------------------------------------------------------------
# Within the port: elastic serving equals static serving, bit for bit
# ---------------------------------------------------------------------------
def test_elastic_fleet_bitwise_equals_the_static_fleet():
    _, cfg = _cfgs()
    events = make_scenario("flash_crowd", alpha=1.05).events(
        80, qps=800.0, seed=5)
    ref = pf.ShardedFleet(cfg, n_boards=2, alpha=1.05, max_batch_queries=2,
                          device="cpu")
    ref.run(events, sla_ms=1e6)
    auto = pc.SLAAutoscaler(0.5, min_replicas=2, max_replicas=4, window=8,
                            patience=1, cooldown_s=0.005)
    fleet = pf.ShardedFleet(cfg, n_boards=2, alpha=1.05, max_batch_queries=2,
                            autoscaler=auto, params=ref._params,
                            device="cpu")
    r = fleet.run(events, sla_ms=1e6, scenario="flash_crowd")
    assert r.n_replicas_end > r.n_replicas_start == 2
    assert len(auto.migration_log) == r.migrations > 0
    assert sum(b for _, b, _ in auto.migration_log) == r.migrated_bytes
    assert "re-partitions" in r.summary()
    row_b = cfg.embed_dim * 4
    pm = fleet.partition
    for b in fleet.boards:               # each board holds its map's rows
        whole, ranges = fleet._residency_of(pm, b.rid)
        assert b.holds(whole, ranges)
        assert b.resident_bytes(row_b) == pm.board_bytes[b.rid]
    for ev in events:
        np.testing.assert_array_equal(fleet.completed[ev.qid].probs,
                                      ref.completed[ev.qid].probs)


def test_scale_down_retires_the_last_board_and_frees_it():
    _, cfg = _cfgs()
    events = make_scenario("stationary", alpha=1.05).events(
        60, qps=500.0, seed=5)
    full = sum(_fp32_bytes(cfg))
    ref = pf.ShardedFleet(cfg, n_boards=2, alpha=1.05, max_batch_queries=2,
                          board_capacity_bytes=full, device="cpu")
    ref.run(events, sla_ms=1e6)
    auto = pc.SLAAutoscaler(1e6, min_replicas=1, max_replicas=2, window=8,
                            patience=1, cooldown_s=0.005)
    fleet = pf.ShardedFleet(cfg, n_boards=2, alpha=1.05, max_batch_queries=2,
                            board_capacity_bytes=full, autoscaler=auto,
                            device="cpu")
    r = fleet.run(events, sla_ms=1e6)
    assert r.n_replicas_end == 1 and fleet.boards[0].rid == 0
    gone = fleet._retired[0]
    assert gone.retired_at is not None and gone.served > 0
    assert gone.tables is None and not gone.split_rows
    assert gone.dense_params is None
    assert fleet.boards[0].resident_rows == cfg.num_tables * \
        cfg.rows_per_table
    assert r.board_seconds < 2 * r.makespan_s
    for ev in events:
        np.testing.assert_array_equal(fleet.completed[ev.qid].probs,
                                      ref.completed[ev.qid].probs)
