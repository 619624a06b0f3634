"""The port's planner stage against the reference's, number for number.

`core.{perf_model,memsys,collectives,planner}`, `parallel.plan` and
`engine.planning` compute in plain Python floats in both packages, so the
port must return EXACTLY the reference's numbers (no tolerance). The
profile pass draws its ids from a torch.Generator in the port and from
jax.random in the reference; the per-table frequencies the planner ranks
are B*L*batches in both, so the plans must still be equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro.core import perf_model as jax_pm
from repro.core import planner as jax_planner
from repro.engine import Engine as JaxEngine
from repro.engine import planning as jax_planning
from repro.parallel import plan as jax_plan
from repro_torch.configs import get_dlrm
from repro_torch.core import perf_model, planner
from repro_torch.engine import Engine, ServeSession, planning
from repro_torch.parallel import plan as plan_lib

CONFIGS = ["dlrm-rm2-small-unsharded", "dlrm-rm2-small-sharded",
           "dlrm-rm2-large-unsharded", "dlrm-rm2-large-sharded"]
SMALL = "dlrm-rm2-small-unsharded"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _systems(n):
    """(reference system, port system) pairs at n chips."""
    pairs = []
    for name in ("recspeed_system", "recspeed_hybrid_system", "dgx2_system"):
        pairs.append((dataclasses.replace(getattr(jax_pm, name)(), n_chips=n),
                      dataclasses.replace(getattr(perf_model, name)(),
                                          n_chips=n)))
    pairs.append((jax_pm.sweep_system(2e-6, 400e9, n),
                  perf_model.sweep_system(2e-6, 400e9, n)))
    return pairs


def _fields(bd):
    return dataclasses.asdict(bd)


def _placements_of(placements):
    return [(p.table_id, p.tier, p.mode, p.owner) for p in placements]


def _plan_key(plan):
    d = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
         if f.name != "placements"}
    return d, _placements_of(plan.placements), plan.predicted_qps


@pytest.mark.parametrize("mode", ["inference", "training"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", CONFIGS)
def test_perf_model_numbers_equal_reference(name, n, mode):
    jcfg, cfg = jax_get_dlrm(name), get_dlrm(name)
    for jsys, tsys in _systems(n):
        for ex in ("unpooled", "partial_pool"):
            for hit in (0.0, 0.5):
                assert _fields(perf_model.breakdown(cfg, tsys, mode, ex,
                                                    hit_ratio=hit)) == \
                    _fields(jax_pm.breakdown(jcfg, jsys, mode, ex,
                                             hit_ratio=hit))
                for k in (1, 2, 4, 8):
                    assert _fields(perf_model.pipelined_breakdown(
                        cfg, tsys, mode, k, ex, hit)) == _fields(
                        jax_pm.pipelined_breakdown(jcfg, jsys, mode, k, ex,
                                                   hit))
                assert perf_model.optimal_pipeline_depth(
                    cfg, tsys, mode, row_wise_exchange=ex, hit_ratio=hit) == \
                    jax_pm.optimal_pipeline_depth(
                        jcfg, jsys, mode, row_wise_exchange=ex, hit_ratio=hit)
        assert _plan_key(planner.plan_dlrm(cfg, tsys, mode)) == \
            _plan_key(jax_planner.plan_dlrm(jcfg, jsys, mode))


def _freqs(T):
    rng = np.random.default_rng(T)
    skew = (np.arange(T, 0, -1) ** 2).astype(np.float64)
    zero = np.ones(T)
    zero[::3] = 0.0
    return {"uniform": np.full(T, 640.0), "skewed": skew,
            "random": rng.integers(0, 1000, T).astype(np.float64),
            "zeros": zero}


@pytest.mark.parametrize("freq_name", ["uniform", "skewed", "random",
                                       "zeros"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", [SMALL, "dlrm-rm2-large-sharded"])
def test_placement_and_reconcile_equal_reference(name, n, freq_name):
    jcfg, cfg = jax_get_dlrm(name), get_dlrm(name)
    freq = _freqs(cfg.num_tables)[freq_name]
    tbytes = cfg.rows_per_table * cfg.embed_dim * 2
    jsys = dataclasses.replace(jax_pm.recspeed_system(), n_chips=n)
    tsys = dataclasses.replace(perf_model.recspeed_system(), n_chips=n)
    for fast_tables in (0, 3, 13):
        fast = fast_tables * tbytes
        bulk = cfg.num_tables * tbytes
        want = jax_planner.place_tables(jcfg, freq, fast, bulk, n)
        got = planner.place_tables(cfg, freq, fast, bulk, n)
        assert [_placements_of(got[0]), got[1:]] == \
            [_placements_of(want[0]), want[1:]]
        jplan = jax_planner.plan_with_placement(jcfg, jsys, freq, fast, bulk)
        tplan = planner.plan_with_placement(cfg, tsys, freq, fast, bulk)
        assert _plan_key(tplan) == _plan_key(jplan)
        for af in (None, freq):
            assert _plan_key(plan_lib.reconcile_plan_with_mesh(
                tplan, n, af)) == _plan_key(
                jax_plan.reconcile_plan_with_mesh(jplan, n, af))
        if tplan.placements:
            tg = plan_lib.plan_table_groups(tplan, n)
            jg = jax_plan.plan_table_groups(jplan, n)
            assert (tg.fast_ids, tg.bulk_ids, tg.inv_perm) == \
                (jg.fast_ids, jg.bulk_ids, jg.inv_perm)


@pytest.mark.parametrize("alpha", [0.0, 1.05])
def test_build_auto_plan_equals_reference(alpha):
    jcfg, cfg = jax_get_dlrm(SMALL).reduced(), get_dlrm(SMALL).reduced()
    want = jax_planning.build_auto_plan(jcfg, 1, alpha=alpha)
    got = planning.build_auto_plan(cfg, 1, alpha=alpha, device="cpu")
    assert _plan_key(got.plan) == _plan_key(want.plan)
    assert (got.mode, got.predicted_qps, got.pipeline_depth,
            got.depth_sweep, got.serve_kernel) == \
        (want.mode, want.predicted_qps, want.pipeline_depth,
         want.depth_sweep, want.serve_kernel)
    assert got.summary() == want.summary()
    assert got.asdict() == want.asdict()


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("queries", [1, 2, 4])
def test_default_depth_is_the_reference_engines(reduced, queries):
    """Engine(cfg) without a depth resolves the reference's depth per
    flushed batch shape (8 for dlrm-rm2-small-unsharded at n=1)."""
    jcfg, cfg = jax_get_dlrm(SMALL), get_dlrm(SMALL)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    samples = queries * cfg.batch_size
    want = JaxEngine(jcfg).make_depth_resolver("inference")(samples)
    eng = Engine(cfg, device="cpu")
    assert eng.pipeline_depth is None
    assert eng.make_depth_resolver("inference")(samples) == want
    if not reduced:
        assert want == 8


def test_session_depth_is_clamped_to_the_batch():
    """A resolved depth that does not divide the flushed batch drops to
    the largest depth that does, as the reference's depth_for_samples."""
    cfg = get_dlrm(SMALL).reduced()
    sess = ServeSession(cfg, device="cpu", max_batch_queries=2,
                        pipeline_depth=None, depth_resolver=lambda b: 8)
    assert [sess.depth_for_samples(b) for b in (16, 12, 7, 3)] == \
        [8, 6, 7, 3]
    assert Engine(cfg, device="cpu", pipeline_depth=2).serve_session(
        max_batch_queries=2).depth_for_samples(16) == 2
