"""The port's traffic package against repro.traffic.

Scenario events are numpy draws in both packages, so they must be equal
field for field, exactly; traces and ingested logs are JSON, so either
package reads what the other wrote. Query CONTENT comes from each
package's own generator (the port's is a torch.Generator), so the
row rotation of ``materialize_query`` is held on shared numpy indices.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.traffic as jt
import repro.traffic.scenarios as jscen
import repro_torch.traffic as pt
import repro_torch.traffic.scenarios as pscen
from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro_torch.configs import get_dlrm

NAME = "dlrm-rm2-small-unsharded"
SCENARIO_KW = {
    "stationary": dict(alpha=1.05),
    "diurnal": dict(alpha=1.05, amplitude=0.8, period_s=0.2),
    "flash_crowd": dict(alpha=1.05, burst_factor=6.0, on_s=0.05, off_s=0.1),
    "zipf_drift": dict(alpha=1.0, alpha_hi=1.4, drift_period_s=0.4,
                       rotate_every_s=0.06, salt_stride=37),
}
# (n_queries, qps, seed, start_qid)
DRAWS = [(50, 200.0, 7, 0), (120, 900.0, 3, 500), (1, 5.0, 0, 0)]


def _fields(events):
    return [dataclasses.astuple(e) for e in events]


@pytest.mark.parametrize("draw", DRAWS, ids=lambda d: f"n{d[0]}-s{d[2]}")
@pytest.mark.parametrize("name", sorted(SCENARIO_KW))
def test_events_equal_the_reference(name, draw):
    n, qps, seed, start = draw
    for kw in (SCENARIO_KW[name], {}):          # tuned and default knobs
        want = jt.make_scenario(name, **kw).events(n, qps, seed, start)
        got = pt.make_scenario(name, **kw).events(n, qps, seed, start)
        assert _fields(got) == _fields(want)
        assert [type(v) for v in dataclasses.astuple(got[-1])] == \
            [type(v) for v in dataclasses.astuple(want[-1])]


@pytest.mark.parametrize("writer,reader", [(jt, pt), (pt, jt)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_a_trace_recorded_by_either_package_loads_in_the_other(
        writer, reader, tmp_path):
    for name in sorted(SCENARIO_KW):
        sc = writer.make_scenario(name, **SCENARIO_KW[name])
        events = sc.events(40, qps=300.0, seed=3, start_qid=7)
        path = tmp_path / f"{name}.jsonl"
        writer.record_trace(str(path), events, sc, qps=300.0, seed=3,
                            config=NAME)
        meta_r, got = reader.load_trace(str(path))
        meta_w, own = writer.load_trace(str(path))
        assert meta_r == meta_w and meta_r["scenario"] == name
        assert meta_r["n"] == 40 and meta_r["config"] == NAME
        assert _fields(got) == _fields(own) == _fields(events)


def test_trace_errors_match_the_reference(tmp_path):
    sc = pt.make_scenario("stationary")
    path = tmp_path / "t.jsonl"
    pt.record_trace(str(path), sc.events(5, qps=100.0), sc)
    lines = path.read_text().splitlines()
    path.write_text("\n".join(lines[:-1]) + "\n")
    for pkg in (jt, pt):
        with pytest.raises(ValueError, match="truncated"):
            pkg.load_trace(str(path))
    path.write_text('{"trace_version": 99, "n": 0}\n')
    for pkg in (jt, pt):
        with pytest.raises(ValueError, match="trace_version"):
            pkg.load_trace(str(path))


def _write_log(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write((r if isinstance(r, str) else json.dumps(r)) + "\n")


def test_ingest_matches_the_reference(tmp_path):
    rng = np.random.default_rng(7)
    t = 1712009423.0
    recs = []
    for _ in range(60):
        t += float(rng.exponential(0.01))
        recs.append({"ts": t, "items": [int(i) for i in
                                        rng.zipf(1.5, size=5) % 500]})
    rng.shuffle(recs)
    recs.insert(13, "{not json")
    recs.insert(29, {"ts": 1.0, "items": []})
    log = tmp_path / "requests.jsonl"
    _write_log(log, recs)
    for kw in (dict(seed=3, strict=False), dict(alpha=1.05, start_qid=9,
                                                strict=False)):
        jm, je = jt.ingest_jsonl(str(log), **kw)
        pm, pe = pt.ingest_jsonl(str(log), **kw)
        assert pm == jm and pm["skipped"] == 2
        assert _fields(pe) == _fields(je)
    for pkg in (jt, pt):
        with pytest.raises(pkg.IngestError, match=r"requests\.jsonl:14: "
                                                  r"invalid JSON"):
            pkg.ingest_jsonl(str(log))
    # an ingested stream is a first-class trace in either package
    _, events = pt.ingest_jsonl(str(log), strict=False)
    trace = tmp_path / "ingested.jsonl"
    pt.record_trace(str(trace), events, source=str(log))
    assert _fields(jt.load_trace(str(trace))[1]) == _fields(events)


def test_zipf_alpha_estimate_matches_the_reference():
    rng = np.random.default_rng(0)
    hists = [np.bincount(rng.integers(0, 200, size=5000)),
             np.bincount(rng.zipf(2.0, size=5000) % 200),
             np.bincount(rng.zipf(1.2, size=900) % 3000), [5], [], [0, 0, 3]]
    for h in hists:
        assert pt.estimate_zipf_alpha(h) == jt.estimate_zipf_alpha(h)


@pytest.mark.parametrize("salt", [0, 37, 128 + 5, 2 ** 31 - 1])
def test_materialize_rotates_shared_indices_as_the_reference(
        salt, monkeypatch):
    """Both packages' ``materialize_query`` on the same numpy batch: the
    rotation ``(idx + salt % R) % R`` gives the same int32 ids, and the
    dense features pass through unchanged."""
    jcfg, cfg = jax_get_dlrm(NAME).reduced(), get_dlrm(NAME).reduced()
    rng = np.random.default_rng(salt % 1000)
    dense = rng.standard_normal((8, cfg.num_dense)).astype(np.float32)
    idx = rng.integers(0, cfg.rows_per_table,
                       (8, cfg.num_tables, cfg.lookups_per_table),
                       dtype=np.int32)
    seen = []

    def fake(conv):
        def make(cfg_, step, seed, alpha, batch_size=None, **kw):
            seen.append((step, seed, alpha, batch_size, kw.get("device")))
            return {"dense": conv(dense), "indices": conv(idx),
                    "labels": conv(np.zeros(8, np.float32))}
        return make

    monkeypatch.setattr(jscen, "make_recsys_batch", fake(jnp.asarray))
    monkeypatch.setattr(pscen, "make_recsys_batch", fake(torch.from_numpy))
    jev = jt.QueryEvent(qid=3, arrival_s=0.5, step=11, seed=2, alpha=1.1,
                        perm_salt=salt)
    pev = pt.QueryEvent(**dataclasses.asdict(jev))
    want = jt.materialize_query(jcfg, jev, 8)
    got = pt.materialize_query(cfg, pev, 8, device="cpu")
    assert got["indices"].dtype == torch.int32
    np.testing.assert_array_equal(got["indices"].numpy(),
                                  np.asarray(want["indices"]))
    np.testing.assert_array_equal(got["dense"].numpy(),
                                  np.asarray(want["dense"]))
    assert seen == [(11, 2, 1.1, 8, None), (11, 2, 1.1, 8, "cpu")]


def test_materialize_draws_on_the_asked_device_and_rotates():
    cfg = get_dlrm(NAME).reduced()
    base = pt.QueryEvent(qid=0, arrival_s=0.1, step=5, seed=0, alpha=1.1)
    q0 = pt.materialize_query(cfg, base, device="cpu")
    q1 = pt.materialize_query(
        cfg, dataclasses.replace(base, perm_salt=37), device="cpu")
    assert q0["dense"].device.type == "cpu"
    assert q0["indices"].shape == (cfg.batch_size, cfg.num_tables,
                                   cfg.lookups_per_table)
    torch.testing.assert_close(q1["dense"], q0["dense"], rtol=0, atol=0)
    assert torch.equal(q1["indices"],
                       ((q0["indices"] + 37) % cfg.rows_per_table).int())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.materialize_query(cfg, base)


def test_scenario_validation_matches_the_reference():
    for pkg in (jt, pt):
        with pytest.raises(ValueError, match="unknown scenario"):
            pkg.make_scenario("nosuch")
        with pytest.raises(ValueError, match="rate must be > 0"):
            pkg.make_scenario("stationary").events(5, qps=0.0)
        with pytest.raises(ValueError, match="amplitude"):
            pkg.make_scenario("diurnal", amplitude=1.5)
        with pytest.raises(ValueError, match="burst_factor"):
            pkg.make_scenario("flash_crowd", burst_factor=0.5)
        with pytest.raises(ValueError, match="rotate_every_s"):
            pkg.make_scenario("zipf_drift", rotate_every_s=0.0)
    assert sorted(pt.SCENARIOS) == sorted(jt.SCENARIOS)
    assert sorted(pt.__all__) == sorted(jt.__all__)
