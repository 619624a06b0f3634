"""The slice as a whole: planner-placed tiered serving against repro.engine.

A JAX ``Engine(..., plan=P)`` session and the port's
``Engine(..., plan=P, device="cpu")`` serve the reduced config on the JAX
session's plan-split params, carried over by ``convert``; the same numpy
queries go to both. P is "auto" (alpha 0 and 1.05) or a concrete
``ShardingPlan`` with interleaved tiers. Tolerance: fp32 allclose at
rtol = atol = 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro.core.planner import ShardingPlan as JaxPlan
from repro.core.planner import TablePlacement as JaxPlacement
from repro.engine import Engine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_dlrm
from repro_torch.core.planner import ShardingPlan, TablePlacement
from repro_torch.engine import Engine
from repro_torch.parallel import (merge_dlrm_params_by_plan,
                                  plan_table_groups)

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "dlrm-rm2-small-unsharded"
PLANS = ["auto-0", "auto-1.05", "interleaved"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _interleaved(plan_cls, placement_cls, T):
    """Even tables fast, odd tables bulk."""
    return plan_cls(
        config=NAME + "-smoke", mode="table_wise", exchange="unpooled",
        qps_table_wise=1.0, qps_row_wise_unpooled=0.5,
        qps_row_wise_partial=0.5,
        placements=tuple(
            placement_cls(t, "fast", "table_wise", 0) if t % 2 == 0
            else placement_cls(t, "bulk", "row_wise", None)
            for t in range(T)),
        hit_ratio=0.5)


def _engines(which):
    jcfg, cfg = jax_get_dlrm(NAME).reduced(), get_dlrm(NAME).reduced()
    if which == "interleaved":
        jkw = {"plan": _interleaved(JaxPlan, JaxPlacement, jcfg.num_tables)}
        kw = {"plan": _interleaved(ShardingPlan, TablePlacement,
                                   cfg.num_tables)}
    else:
        alpha = float(which.split("-")[1])
        jkw = {"plan": "auto", "alpha": alpha}
        kw = {"plan": "auto", "alpha": alpha}
    return JaxEngine(jcfg, **jkw), Engine(cfg, device="cpu", **kw)


@pytest.fixture(scope="module", params=PLANS)
def planned(request):
    """(JAX engine, JAX session, port engine, port session) on the same
    plan-split weights, capacity 2 queries."""
    jeng, eng = _engines(request.param)
    jsess = jeng.serve_session(max_batch_queries=2, max_wait_ms=50.0)
    params = convert.params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jsess.params), "cpu")
    sess = eng.serve_session(max_batch_queries=2, max_wait_ms=50.0,
                             params=params)
    return jeng, jsess, eng, sess


def _query(cfg, seed, n=1):
    rng = np.random.default_rng(seed)
    q = cfg.batch_size * n
    return (rng.standard_normal((q, cfg.num_dense)).astype(np.float32),
            rng.integers(0, cfg.rows_per_table,
                         (q, cfg.num_tables, cfg.lookups_per_table)
                         ).astype(np.int32))


def test_plan_kernel_and_depth_equal_reference(planned):
    jeng, jsess, eng, sess = planned
    assert sess.serve_kernel == jsess.serve_kernel == "fused"
    assert [(p.table_id, p.tier) for p in sess.plan.placements] == \
        [(p.table_id, p.tier) for p in jsess.plan.placements]
    assert sess.plan.hit_ratio == jsess.plan.hit_ratio
    jrep, rep = jeng.plan_report("inference"), eng.plan_report("inference")
    assert (rep is None) == (jrep is None)
    if rep is not None:
        assert rep.serve_kernel == "fused"
        assert rep.asdict() == jrep.asdict()
    for n in (1, 2):
        b = n * sess.query_size
        assert sess.depth_for_samples(b) == jsess.depth_for_samples(b)


@pytest.mark.parametrize("n", [1, 2])
def test_serve_direct_matches_reference(planned, n):
    _, jsess, _, sess = planned
    dense, idx = _query(sess.cfg, 10 + n, n)
    want = jsess.serve_direct(jnp.asarray(dense), jnp.asarray(idx))
    got = sess.serve_direct(torch.from_numpy(dense), torch.from_numpy(idx))
    np.testing.assert_allclose(got, want, **TOL)


def test_submit_matches_reference(planned):
    _, jsess, _, sess = planned
    queries = [_query(sess.cfg, s) for s in (1, 2, 3)]
    futs = {}
    for name, s, conv in (("jax", jsess, jnp.asarray),
                          ("torch", sess, torch.from_numpy)):
        fs = [s.submit({"dense": conv(d), "indices": conv(x)},
                       now=i * 1e-3) for i, (d, x) in enumerate(queries)]
        assert s.poll(now=1.0)                   # deadline flush of the 3rd
        assert all(f.done for f in fs)
        futs[name] = fs
    for fj, ft in zip(futs["jax"], futs["torch"]):
        np.testing.assert_allclose(ft.probs, fj.probs, **TOL)


def test_composed_path_and_depths_agree_with_fused(planned):
    _, _, _, sess = planned
    dense, idx = (torch.from_numpy(a) for a in _query(sess.cfg, 4, 2))
    want = sess.serve_direct(dense, idx)
    for kw in ({"fused_serve": "off"}, {"pipeline_depth": 1},
               {"pipeline_depth": 8}):
        other = Engine(sess.cfg, device="cpu", plan=sess.plan,
                       **kw).serve_session(max_batch_queries=2,
                                           params=sess.params)
        assert other.params["tables_fast"] is sess.params["tables_fast"]
        np.testing.assert_allclose(other.serve_direct(dense, idx), want,
                                   **TOL)


def test_stacked_params_split_into_the_plan_groups(planned):
    """Stacked weights given to a planned session are split into its
    groups; the split merges back to the stacked tables exactly."""
    _, _, eng, sess = planned
    groups = plan_table_groups(sess.plan, 1)
    stacked = merge_dlrm_params_by_plan(sess.params, groups)
    split = eng.serve_session(max_batch_queries=2, params=stacked)
    for key in ("tables_fast", "tables_bulk"):
        assert torch.equal(split.params[key], sess.params[key])
    assert "tables" not in split.params
    dense, idx = (torch.from_numpy(a) for a in _query(sess.cfg, 5))
    np.testing.assert_allclose(split.serve_direct(dense, idx),
                               sess.serve_direct(dense, idx), **TOL)


def test_plan_split_params_of_another_plan_are_refused():
    cfg = get_dlrm(NAME).reduced()
    eng = Engine(cfg, device="cpu",
                 plan=_interleaved(ShardingPlan, TablePlacement,
                                   cfg.num_tables))
    params = eng.serve_session(max_batch_queries=2).params
    wrong = dict(params, tables_fast=params["tables_fast"][:1])
    with pytest.raises(ValueError, match="plan groups"):
        eng.serve_session(max_batch_queries=2, params=wrong)
    with pytest.raises(ValueError, match="no placed plan"):
        Engine(cfg, device="cpu").serve_session(params=params)


def test_convert_carries_plan_split_trees():
    """A plan-split JAX param tree converts with nothing new: the same
    keys, shapes and values."""
    jsess = JaxEngine(jax_get_dlrm(NAME).reduced(),
                      plan="auto").serve_session(max_batch_queries=2)
    tree = jax.tree_util.tree_map(np.asarray, jsess.params)
    params = convert.params_from_jax_numpy(tree, "cpu")
    assert set(params) == {"bot_mlp", "top_mlp", "tables_fast",
                           "tables_bulk"}
    for key in ("tables_fast", "tables_bulk"):
        np.testing.assert_array_equal(params[key].numpy(), tree[key])
    for key in ("bot_mlp", "top_mlp"):
        for jl, tl in zip(tree[key], params[key]):
            np.testing.assert_array_equal(tl["w"].numpy(), jl["w"])


@pytest.mark.parametrize("case", ["row_wise_config", "two_devices"])
def test_row_wise_and_multi_device_plans_fail_loudly(case):
    """A tiered exchange over more ranks needs their process group (it runs
    over 2 and 4 gloo ranks in tests/test_torch_ranks.py); a row-wise
    config, which raised naming A6 before, now serves a placed plan
    (A6a)."""
    from repro_torch.parallel import PlannedTieredExchange, make_exchange
    cfg = get_dlrm(NAME).reduced()
    plan = _interleaved(ShardingPlan, TablePlacement, cfg.num_tables)
    if case == "row_wise_config":
        sess = Engine(get_dlrm("dlrm-rm2-small-sharded").reduced(),
                      device="cpu", plan="auto").serve_session(
            max_batch_queries=1)
        assert isinstance(sess.exchange, PlannedTieredExchange)
        assert sess.serve_kernel == "fused"
        probs, _, _ = sess._execute([sess._make_query(0)])
        assert np.isfinite(probs).all()
        return
    with pytest.raises(ValueError, match="process group"):
        make_exchange(cfg, 2, plan=plan)


def test_tiered_exchange_defaults_to_the_card():
    """A placed plan's exchange is built on the card unless the CPU is
    named: without a card it raises rather than landing on the CPU."""
    from repro_torch.parallel import make_exchange
    cfg = get_dlrm(NAME).reduced()
    plan = _interleaved(ShardingPlan, TablePlacement, cfg.num_tables)
    exch = make_exchange(cfg, plan=plan, device="cpu")
    assert exch._src.tolist() == list(exch.inv_perm)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_exchange(cfg, plan=plan)


def _tiered(T, fast):
    """A ShardingPlan with table t in the fast tier iff fast(t)."""
    return ShardingPlan(
        config=NAME + "-smoke", mode="table_wise", exchange="unpooled",
        qps_table_wise=1.0, qps_row_wise_unpooled=0.5,
        qps_row_wise_partial=0.5,
        placements=tuple(
            TablePlacement(t, "fast", "table_wise", 0) if fast(t)
            else TablePlacement(t, "bulk", "row_wise", None)
            for t in range(T)),
        hit_ratio=0.5)


TIERS = {"identity": lambda T: lambda t: t < T // 2,
         "interleaved": lambda T: lambda t: t % 3 != 1,
         "no_fast": lambda T: lambda t: False,
         "no_bulk": lambda T: lambda t: True}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tiers", sorted(TIERS))
def test_unpermuted_serve_form_equals_reference_shaped_op(tiers, dtype):
    """The tiered exchange's fused forward reads the ids in their original
    table order (``ops.fused_grouped_bag_interactions_unpermuted``); it
    must equal the reference-shaped op on the permuted ids, the JAX
    package's ``fused_grouped_bag_interactions_ref`` and the single-group
    op on the tables in original order, at the reduced config's widths."""
    from repro.kernels import ref as jax_ref
    from repro_torch.kernels import fused_serve, ops, ref
    from repro_torch.parallel import make_exchange
    cfg = get_dlrm(NAME).reduced()
    T, R, d, L = (cfg.num_tables, cfg.rows_per_table, cfg.embed_dim,
                  cfg.lookups_per_table)
    exch = make_exchange(cfg, plan=_tiered(T, TIERS[tiers](T)), device="cpu")
    fast_ids, bulk_ids = exch.groups.fast_ids, exch.groups.bulk_ids
    inv = exch.inv_perm
    if tiers == "identity":
        assert list(inv) == list(range(T))
    rng = np.random.default_rng(sorted(TIERS).index(tiers))
    B = 2 * cfg.batch_size
    tables = rng.uniform(-1, 1, (T, R, d)).astype(np.float32)
    ids = rng.integers(-R, R, (B, T, L)).astype(np.int32)
    bot = rng.uniform(-1, 1, (B, d)).astype(np.float32)
    perm = list(fast_ids) + list(bulk_ids)
    tf = torch.from_numpy(tables[list(fast_ids)]).to(dtype)
    tb = torch.from_numpy(tables[list(bulk_ids)]).to(dtype)
    t_ids, t_bot = torch.from_numpy(ids), torch.from_numpy(bot)
    ops.reset_launch_counts()
    got = exch.fused_forward({"tables_fast": tf, "tables_bulk": tb}, t_bot,
                             t_ids)
    assert ops.launch_counts["fused_grouped_bag_interactions"] == 0
    shaped = ops.fused_grouped_bag_interactions(
        tf, tb, t_ids[:, perm], t_bot, inv_perm=inv,
        pos=fused_serve.grouped_pos(inv, torch.device("cpu")))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_ref.fused_grouped_bag_interactions_ref(
        jnp.asarray(tf.float().numpy(), jdt),
        jnp.asarray(tb.float().numpy(), jdt), jnp.asarray(ids[:, perm]),
        jnp.asarray(bot), tuple(inv))
    stacked = ref.fused_bag_interactions_ref(
        torch.from_numpy(tables).to(dtype), t_ids, t_bot)
    assert got.shape == (B, d + (T + 1) * T // 2)
    np.testing.assert_array_equal(got.numpy(), shaped.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), stacked.numpy(), **TOL)
