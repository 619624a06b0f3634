"""The port's online updates (repro_torch.online and the fleets' online
paths) against repro.online.

Test for test the counterpart of tests/test_online.py, on the reduced
config (batch 8) and shared numpy arrays:

  * the delta encoding and channel: `diff_tables` equals the reference's
    (the elementwise ``!=`` rule: a 0.0 -> -0.0 row ships nothing, a NaN
    row always ships), and a JSONL channel written by either package
    loads in the other, field for field;
  * the trainer and its source: both packages' `make_recsys_batch` are
    patched to one numpy-drawn batch, so the tables, the losses and the
    emitted batches agree at rtol = atol = 1e-5 (versions, times, steps
    and row sets exactly); rows no batch touched stay bitwise as they
    were, and each batch equals `diff_tables` of whole snapshots;
  * the coherence adapters leave every cache surface as the reference's;
  * whole fleets in both packages (shared queries, profiles and fixed
    service times) give equal reports, the `OnlineReport` and the
    `update_stall` attribution included; within the port, online serving
    is bitwise equal across fleet sizes in both coherence modes, every
    owner's resident rows equal the host tables after the run, and the
    first write copies the host tables another fleet shares.
"""
import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.online as jo
import repro.online.trainer as jtrainer
import repro_torch.online as po
import repro_torch.online.trainer as ptrainer
import repro.cluster as jc
import repro.fabric as jf
import repro_torch.cluster as pc
import repro_torch.core.tiered_embedding as pte
import repro_torch.fabric as pf
from repro.core import tiered_embedding as jte
from repro.core.dlrm import init_dlrm as jax_init_dlrm
from repro.hoststore.chunks import ChunkParamMgr as JaxChunkParamMgr
from repro.traffic import make_scenario
from repro_torch import convert
from repro_torch.engine import Engine
from repro_torch.hoststore.chunks import ChunkParamMgr
from repro_torch.obs.attribution import COMPONENTS
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.serialize import to_jsonable
from test_torch_cluster import _fleets as cluster_fleets
from test_torch_cluster import shared_stream  # noqa: F401  (a fixture)
from test_torch_fabric import _cfgs, fleets
from test_torch_fabric import shared  # noqa: F401  (the fleets' fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
ALPHA = 1.2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_deltas(cfg, seed):
    """(table, rows, values) slices of a pseudo-random batch: a few
    tables, a few rows each, fresh float32 payloads."""
    rng = np.random.default_rng(seed)
    T, R, d = cfg.num_tables, cfg.rows_per_table, cfg.embed_dim
    n_t = int(rng.integers(1, min(4, T) + 1))
    out = []
    for t in sorted(rng.choice(T, size=n_t, replace=False).tolist()):
        rows = np.unique(rng.integers(0, R, size=int(rng.integers(1, 17))))
        out.append((int(t), rows,
                    rng.standard_normal((len(rows), d)).astype(np.float32)))
    return out


def _batch(pkg, slices, version, t_emit, loss=0.5):
    return pkg.DeltaBatch(version=int(version), t_emit_s=float(t_emit),
                          step=int(version), train_loss=loss,
                          deltas=tuple(pkg.RowDelta(t, r, v)
                                       for t, r, v in slices))


def _rand_batch(cfg, seed, version, t_emit, pkg=po):
    return _batch(pkg, _rand_deltas(cfg, seed), version, t_emit)


def _apply(base, batches):
    """Reference application of batches to a (T, R, d) snapshot, in
    (t_emit, version) order."""
    out = np.array(base, copy=True)
    for b in sorted(batches, key=lambda x: (x.t_emit_s, x.version)):
        for d in b.deltas:
            out[d.table, d.rows] = d.values
    return out


def _same_batch(got, want, values_tol=None):
    assert (got.version, got.t_emit_s, got.step) == (want.version,
                                                     want.t_emit_s,
                                                     want.step)
    assert got.tables == want.tables
    for a, b in zip(got.deltas, want.deltas):
        assert a.table == b.table
        np.testing.assert_array_equal(a.rows, b.rows)
        assert a.values.dtype == b.values.dtype == np.float32
        if values_tol is None:
            np.testing.assert_array_equal(a.values, b.values)
        else:
            np.testing.assert_allclose(a.values, b.values, **values_tol)


def _closure_residual(records):
    return max(abs(sum(getattr(rec, c + "_s") for c in COMPONENTS)
                   - rec.latency_s) for rec in records)


# ---------------------------------------------------------------------------
# Delta encoding + channel
# ---------------------------------------------------------------------------
def test_row_delta_validation_and_wire_bytes():
    from repro.online.delta import ELEM_BYTES, INDEX_BYTES
    from repro_torch.online import delta as pdelta
    assert (pdelta.ELEM_BYTES, pdelta.INDEX_BYTES) == (ELEM_BYTES,
                                                       INDEX_BYTES)
    d = 16
    rd = po.RowDelta(table=2, rows=np.array([3, 7]),
                     values=np.zeros((2, d), np.float32))
    assert rd.n_rows == 2 and rd.rows.dtype == np.int64
    assert rd.payload_bytes() == 2 * (INDEX_BYTES + d * ELEM_BYTES)
    msgs = []
    for pkg in (po, jo):
        with pytest.raises(ValueError, match="rows") as err:
            pkg.RowDelta(table=0, rows=np.array([1, 2, 3]),
                         values=np.zeros((2, d), np.float32))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    b = po.DeltaBatch(version=1, t_emit_s=0.5, step=10, deltas=(
        rd, po.RowDelta(table=5, rows=np.array([0]),
                        values=np.ones((1, d), np.float32))))
    assert b.n_rows == 3 and b.tables == (2, 5)
    assert b.payload_bytes() == 3 * (INDEX_BYTES + d * ELEM_BYTES)


@pytest.mark.parametrize("form", ["numpy", "torch"])
def test_diff_tables_matches_the_reference(form):
    rng = np.random.default_rng(0)
    old = rng.standard_normal((3, 32, 8)).astype(np.float32)
    old[1, 9, 2] = 0.0
    old[1, 11, 0] = np.nan                  # untouched NaN row: ships
    new = old.copy()
    new[0, 5] += 1.0
    new[2, [1, 30]] = 0.0
    new[1, 9, 2] = -0.0                     # 0.0 -> -0.0: ships nothing
    new[2, 7, 3] = np.nan
    wrap = ((lambda x: x) if form == "numpy" else torch.from_numpy)
    want = jo.diff_tables(old, new, version=4, t_emit_s=1.25, step=99,
                          train_loss=0.25)
    got = po.diff_tables(wrap(old), wrap(new), version=4, t_emit_s=1.25,
                         step=99, train_loss=0.25)
    _same_batch(got, want)
    assert got.train_loss == want.train_loss == 0.25
    by_table = {d.table: d.rows.tolist() for d in got.deltas}
    assert by_table == {0: [5], 1: [11], 2: [1, 7, 30]}
    np.testing.assert_array_equal(_apply(old, [got])[~np.isnan(new)],
                                  new[~np.isnan(new)])
    # a snapshot against itself ships only its NaN row
    assert po.diff_tables(wrap(old), wrap(old), version=1,
                          t_emit_s=0.0).n_rows == 1
    with pytest.raises(ValueError) as pe:
        po.diff_tables(wrap(old), wrap(old[:2]), version=1, t_emit_s=0.0)
    with pytest.raises(ValueError) as je:
        jo.diff_tables(old, old[:2], version=1, t_emit_s=0.0)
    assert str(pe.value) == str(je.value)


def test_diff_tables_compares_a_slice_at_a_time(monkeypatch):
    """The chunked compare gives the whole compare's batch: slices of 5
    rows over tables of 32."""
    from repro_torch.online import delta as pdelta
    rng = np.random.default_rng(1)
    old = rng.standard_normal((2, 32, 4)).astype(np.float32)
    new = old.copy()
    new[0, [0, 4, 5, 31]] += 1.0
    new[1, [10, 14, 15]] -= 1.0
    want = jo.diff_tables(old, new, version=1, t_emit_s=0.0)
    monkeypatch.setattr(pdelta, "DIFF_CHUNK_ELEMS", 5 * 4)
    _same_batch(po.diff_tables(torch.from_numpy(old), torch.from_numpy(new),
                               version=1, t_emit_s=0.0), want)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_delta_channel_order_record_replay(writer, tmp_path):
    cfg = _cfgs()[1]
    times = [(1, 1, 0.1), (2, 2, 0.3), (3, 3, 0.7)]
    batches = [_rand_batch(cfg, s, v, t) for s, v, t in times]
    ch = po.DeltaChannel(batches[:2])
    assert len(ch) == 2 and ch.next_time() == 0.1
    assert [b.version for b in ch.poll(0.3)] == [1, 2]
    assert ch.next_time() is None and ch.poll(10.0) == []
    ch.push(batches[2])
    assert ch.next_time() == 0.7
    with pytest.raises(ValueError, match="time-ordered"):
        ch.push(_rand_batch(cfg, 4, 4, 0.2))
    # record captures drained AND pending batches; the other package loads
    # it field for field, and the files are the same bytes
    path = str(tmp_path / "deltas.jsonl")
    other = str(tmp_path / "other.jsonl")
    jbatches = [_rand_batch(cfg, s, v, t, pkg=jo) for s, v, t in times]
    if writer == "port":
        assert ch.record(path) == 3
        re = jo.DeltaChannel.load(path)
        assert jo.DeltaChannel(jbatches).record(other) == 3
    else:
        assert jo.DeltaChannel(jbatches).record(path) == 3
        re = po.DeltaChannel.load(path)
        assert ch.record(other) == 3
    assert len(re) == 3
    for a, b in zip(ch.emitted, re.emitted):
        _same_batch(b, a)
        assert a.train_loss == b.train_loss
    with open(path) as f, open(other) as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------------------
# Trainer + source, both packages on one numpy-drawn stream
# ---------------------------------------------------------------------------
def _batch_np(cfg, step, seed, alpha, batch_size):
    rng = np.random.default_rng([seed, step, 77])
    b = batch_size or cfg.batch_size
    dense = rng.standard_normal((b, cfg.num_dense)).astype(np.float32)
    u = rng.random((b, cfg.num_tables, cfg.lookups_per_table))
    ranks = np.floor(cfg.rows_per_table * u ** 4).astype(np.int64)
    idx = ((ranks * 37) % cfg.rows_per_table).astype(np.int32)
    labels = (rng.random(b) < 0.5).astype(np.float32)
    return dense, idx, labels


@pytest.fixture
def shared_batches(monkeypatch):
    def jax_batch(cfg, step, seed=0, alpha=0.0, batch_size=None):
        d, i, y = _batch_np(cfg, step, seed, alpha, batch_size)
        return {"dense": jnp.asarray(d), "indices": jnp.asarray(i),
                "labels": jnp.asarray(y)}

    def port_batch(cfg, step, seed=0, alpha=0.0, batch_size=None,
                   device=None):
        d, i, y = _batch_np(cfg, step, seed, alpha, batch_size)
        return {k: torch.from_numpy(v).to(device) for k, v in
                (("dense", d), ("indices", i), ("labels", y))}

    monkeypatch.setattr(jtrainer, "make_recsys_batch", jax_batch)
    monkeypatch.setattr(ptrainer, "make_recsys_batch", port_batch)


def _trainers(**kw):
    jcfg, cfg = _cfgs()
    jparams = jax_init_dlrm(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    kw = dict(lr=0.5, seed=0, alpha=1.05, batch_size=16, **kw)
    return (jo.OnlineTrainer(jcfg, jparams, **kw),
            po.OnlineTrainer(cfg, params, device="cpu", **kw), params)


def test_trainer_matches_the_reference(shared_batches):
    jt, pt, params = _trainers()
    base = params["tables"].numpy().copy()
    for salt in (0, 5, 1 << 40):
        jl = jt.train_steps(2, salt=salt)
        pl = pt.train_steps(2, salt=salt)
        np.testing.assert_allclose(pl, jl, **TOL)
        np.testing.assert_allclose(pt.tables, jt.tables, **TOL)
    assert pt.step == jt.step == 6
    # rows no step touched are bitwise what they were; touched ones moved
    moved = np.any(jt.tables != base, axis=-1)
    np.testing.assert_array_equal(np.any(pt.tables != base, axis=-1), moved)
    np.testing.assert_array_equal(pt.tables[~moved], base[~moved])
    # tables-only: the dense MLPs are frozen, updates are purely row deltas
    p_out = pt.params()
    assert p_out["bot_mlp"] is params["bot_mlp"]
    assert p_out["top_mlp"] is params["top_mlp"]
    assert p_out["tables"].data_ptr() == pt.tables.ctypes.data
    assert not np.array_equal(pt.tables, params["tables"].numpy())


def test_trainer_determinism_and_source_schedule(shared_batches):
    def mk_src(pkg_index, **kw):
        tr = _trainers()[pkg_index]
        pkg = (jo, po)[pkg_index]
        return pkg.OnlineSource(tr, interval_s=0.5, steps_per_update=2,
                                n_updates=3, salt_fn=lambda t: int(t * 10),
                                **kw)

    src = mk_src(1)
    assert src.next_time() == 0.5
    got = src.poll(1.0)
    assert [b.version for b in got] == [1, 2]
    assert [b.t_emit_s for b in got] == [0.5, 1.0]
    assert src.next_time() == 1.5
    ch = src.run_to(5.0)                      # capped by n_updates
    assert len(ch) == 3 and src.next_time() is None
    # the schedule is a pure function of (trainer seed, interval, salts)
    for a, b in zip(ch.emitted, mk_src(1).run_to(5.0).emitted):
        _same_batch(a, b)
        assert a.train_loss == b.train_loss
    # ...and the reference's stream, batch for batch
    want = mk_src(0).run_to(5.0)
    assert len(want) == 3
    for a, b in zip(ch.emitted, want.emitted):
        _same_batch(a, b, values_tol=TOL)
        np.testing.assert_allclose(a.train_loss, b.train_loss, **TOL)


def test_source_batches_equal_whole_snapshot_diffs(shared_batches):
    """Each emitted batch is `diff_tables` of the snapshots before and
    after its steps, the NaN rows of the tables included."""
    _, pt, params = _trainers()
    R = pt.cfg.rows_per_table
    params["tables"][3, 17, 1] = float("nan")    # a NaN no step will touch
    pt = po.OnlineTrainer(pt.cfg, params, lr=0.5, alpha=1.05, batch_size=16,
                          device="cpu")
    assert pt.nan_rows.tolist() == [3 * R + 17]
    src = po.OnlineSource(pt, interval_s=0.25, steps_per_update=3)
    snap = pt.tables.copy()
    for k in range(3):
        (got,) = src.poll(0.25 * (k + 1))
        want = po.diff_tables(snap, pt.tables, version=k + 1,
                              t_emit_s=0.25 * (k + 1), step=pt.step)
        _same_batch(got, want)
        assert 17 in {d.table: d.rows for d in got.deltas}[3]
        snap = pt.tables.copy()


def test_teacher_probs_and_expected_logloss():
    jcfg, cfg = _cfgs()
    ev = make_scenario("stationary", alpha=1.05).events(3, qps=100.0,
                                                        seed=4)[1]
    p = po.teacher_probs(cfg, ev, device="cpu")
    assert p.shape == (cfg.batch_size,) and ((p > 0) & (p < 1)).all()
    q = np.clip(p + 0.05, 0.0, 1.0)
    assert po.expected_logloss(p, q) == jo.expected_logloss(p, q)
    assert po.expected_logloss(p, p) < po.expected_logloss(p, q)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA host")
def test_the_trainer_runs_on_the_card_by_default():
    _, cfg = _cfgs()
    params = Engine(cfg, device="cpu").serve_session().params
    with pytest.raises(RuntimeError, match="no CUDA device"):
        po.OnlineTrainer(cfg, params)


# ---------------------------------------------------------------------------
# Coherence protocol, per cache surface, against the reference
# ---------------------------------------------------------------------------
def _same_cache_state(pc_, jc_):
    np.testing.assert_array_equal(pc_._cached, jc_._cached)
    np.testing.assert_array_equal(pc_._counts, jc_._counts)
    np.testing.assert_array_equal(pc_._last_used, jc_._last_used)
    assert pc_.cached_rows == jc_.cached_rows


@pytest.mark.parametrize("mode", ["invalidate", "propagate"])
@pytest.mark.parametrize("capacity", [32, 4])
def test_coherence_remote_cache_matches_the_reference(mode, capacity):
    for pkg in (po, jo):
        with pytest.raises(ValueError, match="coherence mode"):
            pkg.check_mode("gossip")
    jcfg, cfg = _cfgs()
    remote = [0, 1, 2, 3]
    rng = np.random.default_rng(capacity)
    freq = rng.integers(0, 3, (cfg.num_tables, cfg.rows_per_table))
    caches = (jf.RemoteRowCache(jcfg, remote, capacity_rows=capacity),
              pf.RemoteRowCache(cfg, remote, capacity_rows=capacity))
    for c in caches:
        c.warm(freq)
    idx = rng.integers(0, cfg.rows_per_table, (3, 8, cfg.num_tables,
                                               cfg.lookups_per_table))
    for k, q in enumerate(idx):                   # last-use times differ
        for c in caches:
            c.observe(q.astype(np.int32), 0.01 * (k + 1))
    _same_cache_state(caches[1], caches[0])
    cached0 = np.flatnonzero(caches[1]._cached[0])[:4]
    uncached0 = np.flatnonzero(~caches[1]._cached[0])[:6]
    slices = [(0, np.unique(np.concatenate([cached0, uncached0])),
               np.ones((len(cached0) + len(uncached0), cfg.embed_dim),
                       np.float32)),
              (1, np.arange(8), np.ones((8, cfg.embed_dim), np.float32)),
              (5, np.arange(4), np.ones((4, cfg.embed_dim), np.float32))]
    counts = caches[1]._counts.copy()
    got = po.apply_to_remote_cache(caches[1], _batch(po, slices, 1, 0.1),
                                   now=0.1, mode=mode)
    want = jo.apply_to_remote_cache(caches[0], _batch(jo, slices, 1, 0.1),
                                    now=0.1, mode=mode)
    assert got == want
    _same_cache_state(caches[1], caches[0])
    assert caches[1].cached_rows <= caches[1].capacity_rows
    assert caches[1].cached_rows == int(caches[1]._cached.sum())
    assert not caches[1]._cached[5].any()        # local table: untouched
    if mode == "invalidate":
        assert got == (len(cached0), 0)
        np.testing.assert_array_equal(caches[1]._counts, counts)
    else:
        assert got[0] == 0 and got[1] > 0


def test_coherence_refresh_tiered_matches_the_reference():
    T, R, d, H = 3, 64, 8, 8
    tables = np.random.default_rng(0).standard_normal((T, R, d)).astype(
        np.float32)
    freq = np.zeros((T, R), np.int32)
    freq[0, :H] = np.arange(H, 0, -1)            # table 0 rows 0..H-1 hot
    jt = jte.build_tiered_tables(jnp.asarray(tables), jnp.asarray(freq), H)
    pt_ = pte.build_tiered_tables(torch.from_numpy(tables),
                                  torch.from_numpy(freq), H)
    before = [x.clone() for x in pt_]
    slices = [(0, np.array([2, 5, 40]),
               np.arange(3 * d, dtype=np.float32).reshape(3, d)),
              (2, np.array([1, 63]), -np.ones((2, d), np.float32))]
    (jfresh, jn), (pfresh, pn) = (
        jo.refresh_tiered(jt, _batch(jo, slices, 1, 0.0)),
        po.refresh_tiered(pt_, _batch(po, slices, 1, 0.0)))
    # rows 2 and 5 of table 0 are hot, and row 1 of table 2 (its zero
    # counts elect rows 0..H-1 by id)
    assert pn == jn == 3
    for got, want in zip(pfresh, jfresh):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, was in zip(pt_, before):            # the input is unchanged
        assert torch.equal(got, was)
    assert int(pfresh.row_map[0, 40]) < 0


def test_coherence_write_through_host_matches_the_reference():
    T, R, d = 3, 64, 8
    tables = np.random.default_rng(0).standard_normal((T, R, d)).astype(
        np.float32)
    jm = JaxChunkParamMgr(jnp.asarray(tables), chunk_rows=8, cache_slots=4)
    pm = ChunkParamMgr(tables, chunk_rows=8, cache_slots=4, device="cpu")
    for m in (jm, pm):
        m.ensure(np.array([0, 0, 2]), np.array([2, 5, 60]))
    cache = pm.device_cache                      # what a session's params hold
    view = cache[:-1]
    slices = [(0, np.array([2, 5, 40]),
               np.arange(3 * d, dtype=np.float32).reshape(3, d)),
              (2, np.array([57, 63]), -np.ones((2, d), np.float32))]
    got = po.write_through_host(pm, _batch(po, slices, 1, 0.0))
    want = jo.write_through_host(jm, _batch(jo, slices, 1, 0.0))
    assert got == want == 4                      # 40 is not resident
    assert pm.device_cache is cache              # written in place
    np.testing.assert_array_equal(pm.host.numpy(), jm.host)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(jm.device_cache))
    pos = pm.host_pos[0, [2, 5]]
    np.testing.assert_array_equal(view[pos].numpy(), slices[0][2][:2])
    np.testing.assert_array_equal(pm.host_pos, jm.host_pos)
    assert pm.host_pos[0, 40] == pm.pad_pos
    assert not pm.dirty_chunks.size


# ---------------------------------------------------------------------------
# Whole fleets, both packages: reports equal field for field
# ---------------------------------------------------------------------------
def _events(n=10, seed=3):
    return make_scenario("zipf_drift", alpha=ALPHA, rotate_every_s=0.02,
                         salt_stride=37).events(n, qps=2000.0, seed=seed)


@pytest.mark.parametrize("mode", ["invalidate", "propagate"])
def test_fleet_online_report_matches_the_reference(mode, shared):
    jcfg, cfg = _cfgs()
    events = _events(24)
    horizon = events[-1].arrival_s
    plan = [(11, 1, 0.3 * horizon), (12, 2, 0.6 * horizon),
            (13, 3, 0.6 * horizon)]
    cap = int(2.8 * cfg.rows_per_table * cfg.embed_dim * 4)
    jfl, pfl = fleets(jcfg, cfg, n_boards=3, alpha=ALPHA, router="jsq",
                      max_batch_queries=2, board_capacity_bytes=cap)
    assert pfl.partition.split_tables
    base = pfl._tables_host.clone()
    jrep = jfl.run(events, sla_ms=50.0, online=jo.DeltaChannel(
        [_rand_batch(jcfg, s, v, t, pkg=jo) for s, v, t in plan]),
        coherence=mode)
    batches = [_rand_batch(cfg, s, v, t) for s, v, t in plan]
    prep = pfl.run(events, sla_ms=50.0, online=po.DeltaChannel(batches),
                   coherence=mode)
    assert prep.asdict() == jrep.asdict()
    assert prep.summary() == jrep.summary()
    assert prep.online.n_updates == 3 and prep.online.mode == mode
    assert prep.blame is not None
    assert any(r.update_stall_s > 0 for r in pfl.attribution.records)
    for ev in events:
        np.testing.assert_allclose(pfl.completed[ev.qid].probs,
                                   jfl.completed[ev.qid].probs, **TOL)
    np.testing.assert_array_equal(pfl._tables_host.numpy(),
                                  _apply(base.numpy(), batches))
    np.testing.assert_array_equal(pfl._tables_host.numpy(),
                                  jfl._tables_host)
    for pcache, jcache in zip(pfl.caches, jfl.caches):
        _same_cache_state(pcache, jcache)
    assert pfl.metrics.snapshot() == jfl.metrics.snapshot()


def test_cluster_online_report_matches_the_reference(monkeypatch,
                                                    shared_stream):
    jcl, pcl = cluster_fleets(monkeypatch, router="jsq")
    cfg = pcl.cfg
    events = make_scenario("stationary", alpha=ALPHA).events(
        24, qps=500.0, seed=1)
    horizon = events[-1].arrival_s
    plan = [(21, 1, 0.25 * horizon), (22, 2, 0.7 * horizon)]
    jrep = jcl.run(events, sla_ms=50.0, scenario="stationary",
                   online=jo.DeltaChannel(
                       [_rand_batch(cfg, s, v, t, pkg=jo)
                        for s, v, t in plan]))
    prep = pcl.run(events, sla_ms=50.0, scenario="stationary",
                   online=po.DeltaChannel([_rand_batch(cfg, s, v, t)
                                           for s, v, t in plan]))
    assert prep.asdict() == jrep.asdict()
    assert prep.summary() == jrep.summary()
    assert prep.online.n_updates == 2 and prep.online.mode == "replicate"
    for ev in events:
        np.testing.assert_allclose(pcl.completed[ev.qid].probs,
                                   jcl.completed[ev.qid].probs, **TOL)
    for jr, pr in zip(jcl.replicas, pcl.replicas):
        np.testing.assert_array_equal(pr.session.params["tables"].numpy(),
                                      np.asarray(jr.session.params["tables"]))


# ---------------------------------------------------------------------------
# Within the port: update barriers, served versions, bit identity
# ---------------------------------------------------------------------------
def _check_owners(fleet):
    """Every owner's resident rows equal the fleet's host tables."""
    host = fleet._tables_host
    for b in fleet.boards:
        for j, t in enumerate(b.table_ids):
            assert torch.equal(b.tables[j], host[int(t)])
        for t, (ids, rows) in b.split_rows.items():
            assert torch.equal(rows, host[t, ids])


def test_fleet_applies_updates_and_accounts():
    _, cfg = _cfgs()
    events = _events()
    horizon = events[-1].arrival_s
    batches = [_rand_batch(cfg, 11, 1, 0.3 * horizon),
               _rand_batch(cfg, 12, 2, 0.6 * horizon)]
    n_rows = sum(b.n_rows for b in batches)
    for mode in ("invalidate", "propagate"):
        fleet = pf.ShardedFleet(cfg, n_boards=2, alpha=1.05, seed=0,
                                max_batch_queries=2, device="cpu")
        base = fleet._tables_host.clone()
        r = fleet.run(events, online=po.DeltaChannel(batches),
                      coherence=mode)
        assert isinstance(r.online, po.OnlineReport)
        assert r.online.mode == mode
        assert r.online.n_updates == 2 and r.online.last_version == 2
        assert r.online.rows_pushed == n_rows
        assert r.online.staleness_max_s >= 0.0
        assert r.online.mean_train_loss == 0.5
        np.testing.assert_array_equal(fleet._tables_host.numpy(),
                                      _apply(base.numpy(), batches))
        _check_owners(fleet)
        m = fleet.metrics
        assert m.value("update_batches") == 2
        assert m.total("rows_pushed") == n_rows
        assert m.histogram("update_staleness_s").count == 2
        assert m.value("cache_invalidated_rows", cause="update") \
            == r.online.cache_invalidated_rows
        assert m.value("rows_propagated") == r.online.rows_propagated
        if mode == "invalidate":
            assert r.online.rows_propagated == 0
        assert _closure_residual(fleet.attribution.records) < 1e-9
        assert to_jsonable(r.online)["kind"] == "OnlineReport"
    frozen = pf.ShardedFleet(cfg, n_boards=2, alpha=1.05, seed=0,
                             max_batch_queries=2, device="cpu")
    assert frozen.run(events).online is None
    with pytest.raises(ValueError, match="coherence mode"):
        frozen.run(events, online=po.DeltaChannel(batches),
                   coherence="gossip")


def test_served_version_matches_owner_latest():
    """Every query's served values are the owner's LATEST VISIBLE version:
    bit-equal to a frozen single-board fleet holding exactly the tables
    with V(q) = #{batches emitted at or before its arrival} applied."""
    _, cfg = _cfgs()
    events = _events(8)
    arr = [e.arrival_s for e in events]
    batches = [_rand_batch(cfg, 21, 1, (arr[2] + arr[3]) / 2),
               _rand_batch(cfg, 22, 2, (arr[5] + arr[6]) / 2)]
    fleet = pf.ShardedFleet(cfg, n_boards=2, alpha=1.05, seed=0,
                            max_batch_queries=1, device="cpu")
    params0 = dict(fleet._params)
    base = params0["tables"].numpy().copy()
    fleet.run(events, online=po.DeltaChannel(batches), coherence="propagate")
    visible = {ev.qid: sum(b.t_emit_s <= ev.arrival_s for b in batches)
               for ev in events}
    assert set(visible.values()) == {0, 1, 2}   # all three versions served
    for v in sorted(set(visible.values())):
        ref = pf.ShardedFleet(
            cfg, n_boards=1, alpha=1.05, seed=0, max_batch_queries=1,
            device="cpu", params={**params0, "tables": torch.from_numpy(
                _apply(base, batches[:v]))})
        ref.run(events)
        for ev in events:
            if visible[ev.qid] == v:
                assert np.array_equal(fleet.completed[ev.qid].probs,
                                      ref.completed[ev.qid].probs), \
                    f"query {ev.qid} diverged from its version-{v} reference"


@pytest.mark.parametrize("mode", ["invalidate", "propagate"])
def test_online_serving_is_bitwise_across_fleet_sizes(mode):
    _, cfg = _cfgs()
    events = _events(40)
    horizon = events[-1].arrival_s
    batches = [_rand_batch(cfg, 30 + k, k + 1, f * horizon)
               for k, f in enumerate((0.2, 0.45, 0.7))]
    full = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    served = {}
    for k, cap in ((1, full), (2, None), (3, int(0.36 * full))):
        fleet = pf.ShardedFleet(cfg, n_boards=k, alpha=ALPHA, seed=0,
                                max_batch_queries=2, device="cpu",
                                board_capacity_bytes=cap,
                                router="jsq" if k > 1 else "round_robin")
        if k == 3:
            assert fleet.partition.split_tables
        base = fleet._tables_host.clone()
        rep = fleet.run(events, online=po.DeltaChannel(batches),
                        coherence=mode)
        assert rep.online.n_updates == 3
        np.testing.assert_array_equal(fleet._tables_host.numpy(),
                                      _apply(base.numpy(), batches))
        _check_owners(fleet)
        served[k] = {ev.qid: fleet.completed[ev.qid].probs for ev in events}
    for k in (2, 3):
        for ev in events:
            assert np.array_equal(served[k][ev.qid], served[1][ev.qid]), \
                (k, ev.qid)


def test_online_random_interleaving_bit_identity_property():
    """THE online invariant, property-tested: random row pushes + lookups
    interleaved across a 2-board fabric serve bit-identically to the
    1-board online reference at every interleaving point, the host tables
    converge to the last version, and the latency attribution closes
    exactly with update_stall. Uses Hypothesis when available; otherwise
    a seeded random case sweep, as the reference's test does."""
    _, cfg = _cfgs()
    events = _events()
    horizon = events[-1].arrival_s

    def check(fracs, seeds, mode):
        batches = [_rand_batch(cfg, seeds[i], i + 1, fracs[i] * horizon)
                   for i in range(len(fracs))]

        def serve(k):
            fleet = pf.ShardedFleet(cfg, n_boards=k, alpha=1.05, seed=0,
                                    max_batch_queries=2, device="cpu",
                                    router="jsq" if k > 1 else "round_robin")
            base = fleet._tables_host.clone()
            fleet.run(events, online=po.DeltaChannel(batches),
                      coherence=mode)
            return fleet, base

        (ref, base), (fleet, _) = serve(1), serve(2)
        for ev in events:
            assert np.array_equal(ref.completed[ev.qid].probs,
                                  fleet.completed[ev.qid].probs), \
                f"query {ev.qid} diverged between 1 and 2 boards"
        expected = _apply(base.numpy(), batches)
        for f in (ref, fleet):
            np.testing.assert_array_equal(f._tables_host.numpy(), expected)
            _check_owners(f)
            assert _closure_residual(f.attribution.records) < 1e-9
        assert fleet.metrics.histogram("update_staleness_s").count \
            == len(batches)

    try:
        from hypothesis import HealthCheck, given, settings
        from hypothesis import strategies as st
    except ImportError:
        rng = np.random.default_rng(0)
        for i, mode in enumerate(("invalidate", "propagate", "propagate")):
            check(sorted(rng.uniform(0.02, 0.98, i + 1).tolist()),
                  rng.integers(0, 2 ** 16, i + 1).tolist(), mode)
        return

    @settings(max_examples=4, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(data=st.data())
    def run(data):
        n_b = data.draw(st.integers(1, 3))
        fracs = sorted(data.draw(st.lists(
            st.floats(0.02, 0.98, allow_nan=False), min_size=n_b,
            max_size=n_b)))
        seeds = data.draw(st.lists(st.integers(0, 2 ** 16), min_size=n_b,
                                   max_size=n_b))
        mode = data.draw(st.sampled_from(("invalidate", "propagate")))
        check(fracs, seeds, mode)

    run()


def test_first_write_copies_the_shared_host_tables():
    _, cfg = _cfgs()
    a = pf.ShardedFleet(cfg, n_boards=2, device="cpu", max_batch_queries=2)
    b = pf.ShardedFleet(cfg, n_boards=3, device="cpu", params=a._params)
    shared_ptr = a._tables_host.data_ptr()
    assert b._tables_host.data_ptr() == shared_ptr
    before = a._tables_host.clone()
    events = _events(6)
    batch = _rand_batch(cfg, 5, 1, events[2].arrival_s)
    b.run(events, online=po.DeltaChannel([batch]))
    assert b._tables_host.data_ptr() != shared_ptr and b.host_copy_s > 0
    assert torch.equal(a._tables_host, before)
    assert a._params["tables"].data_ptr() == shared_ptr
    assert not torch.equal(b._tables_host, before)
    copied = b._tables_host.data_ptr()
    b.run(events, online=po.DeltaChannel([batch]))      # copied once
    assert b._tables_host.data_ptr() == copied


# ---------------------------------------------------------------------------
# Cluster broadcast
# ---------------------------------------------------------------------------
def test_cluster_broadcasts_updates_bit_identically():
    _, cfg = _cfgs()
    events = make_scenario("stationary", alpha=1.05).events(8, qps=2000.0,
                                                            seed=2)
    arr = [e.arrival_s for e in events]
    rng = np.random.default_rng(7)
    # a full-table rewrite guarantees every post-update lookup moves
    full = po.DeltaBatch(version=1, t_emit_s=(arr[0] + arr[1]) / 2, step=1,
                         deltas=tuple(
                             po.RowDelta(t, np.arange(cfg.rows_per_table),
                                         rng.standard_normal(
                                             (cfg.rows_per_table,
                                              cfg.embed_dim))
                                         .astype(np.float32))
                             for t in range(cfg.num_tables)))
    kw = dict(alpha=1.05, seed=0, max_batch_queries=1, device="cpu")
    c1 = pc.Cluster(cfg, n_replicas=1, **kw)
    c1.run(events, online=po.DeltaChannel([full]))
    c2 = pc.Cluster(cfg, n_replicas=2, **kw)
    r2 = c2.run(events, online=po.DeltaChannel([full]))
    frozen = pc.Cluster(cfg, n_replicas=2, **kw)
    frozen.run(events)
    for ev in events:
        assert np.array_equal(c1.completed[ev.qid].probs,
                              c2.completed[ev.qid].probs)
    assert any(not np.array_equal(frozen.completed[ev.qid].probs,
                                  c2.completed[ev.qid].probs)
               for ev in events[1:])
    assert np.array_equal(frozen.completed[events[0].qid].probs,
                          c2.completed[events[0].qid].probs)
    assert isinstance(r2.online, po.OnlineReport)
    assert r2.online.n_updates == 1
    assert r2.online.rows_pushed == cfg.num_tables * cfg.rows_per_table
    assert to_jsonable(r2.online)["kind"] == "OnlineReport"
    assert c2.metrics.histogram("update_staleness_s").count == 1


def test_replica_row_updates_in_place_and_on_a_spawned_copy():
    _, cfg = _cfgs()
    rep = pc.Replica(0, cfg, [0], alpha=1.05, max_batch_queries=2,
                     device="cpu")
    tables = rep.session.params["tables"]
    spawned_params, _ = rep.clone_params_onto(pc.submesh([0]))
    spawned = pc.Replica(1, cfg, [0], alpha=1.05, max_batch_queries=2,
                         params=spawned_params, device="cpu")
    before = tables.clone()
    batch = _rand_batch(cfg, 9, 1, 0.0)
    assert rep.apply_row_updates(batch) == batch.n_rows
    assert rep.session.params["tables"] is tables         # in place
    np.testing.assert_array_equal(tables.numpy(),
                                  _apply(before.numpy(), [batch]))
    assert torch.equal(spawned.session.params["tables"], before)
    assert spawned.apply_row_updates(batch) == batch.n_rows
    assert torch.equal(spawned.session.params["tables"], tables)
    split = SimpleNamespace(session=SimpleNamespace(
        params={"tables_fast": tables, "tables_bulk": tables}))
    with pytest.raises(ValueError, match="plan-split sessions") as err:
        pc.Replica.apply_row_updates(split, batch)
    with pytest.raises(ValueError) as jerr:
        jc.Replica.apply_row_updates(split, batch)
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# Metrics scoping (regression: cross-run contamination)
# ---------------------------------------------------------------------------
def test_metrics_scoped_per_run_no_cross_contamination():
    """Two serving runs handed their OWN registries each count exactly
    their own queries and leave the process-wide singleton untouched;
    runs without `metrics=` still land on the singleton."""
    _, cfg = _cfgs()
    sess = Engine(cfg, plan="none", alpha=1.05, device="cpu").serve_session(
        max_batch_queries=2)
    before = default_registry().total("queries_served")
    m1, m2 = MetricsRegistry(), MetricsRegistry()
    sess.run_open_loop(6, 2000.0, metrics=m1)
    sess.run_open_loop(6, 2000.0, metrics=m2)
    assert m1.total("queries_served") == 6
    assert m2.total("queries_served") == 6
    assert default_registry().total("queries_served") == before
    sess.run_serial(3)
    assert default_registry().total("queries_served") == before + 3


def test_online_package_exports_match_the_reference():
    assert sorted(po.__all__) == sorted(jo.__all__)
    assert po.COHERENCE_MODES == jo.COHERENCE_MODES
    assert [f.name for f in dataclasses.fields(po.OnlineReport)] \
        == [f.name for f in dataclasses.fields(jo.OnlineReport)]
    rep = dict(mode="invalidate", n_updates=3, last_version=4,
               rows_pushed=120, rows_propagated=7, cache_invalidated_rows=9,
               push_bytes=4096, push_stall_s=1e-3, staleness_p50_s=2e-4,
               staleness_max_s=5e-4, mean_train_loss=0.6)
    assert po.OnlineReport(**rep).summary() == jo.OnlineReport(**rep).summary()
    assert json.loads(json.dumps(to_jsonable(po.OnlineReport(**rep)))) == {
        "kind": "OnlineReport", **rep}
