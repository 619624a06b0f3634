"""The port's DLRM training path against the JAX reference.

Params come from ``repro.core.dlrm.init_dlrm`` through numpy
(``convert.params_from_jax_numpy``); batches from
``repro.data.make_recsys_batch`` as numpy, so both packages see the same
values. The JAX train steps donate their inputs: each gets its own copy.
Sizes are ``cfg.reduced()`` (8 tables x 128 rows x 32, L = 4). Tolerance:
fp32 allclose at rtol = atol = 1e-5 (tests/test_kernels.py) unless a test
says otherwise.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro import parallel as jax_parallel
from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro.core import dlrm as jax_dlrm
from repro.core.planner import ShardingPlan as JaxPlan
from repro.core.planner import TablePlacement as JaxPlacement
from repro.data import make_recsys_batch as jax_batch
from repro.launch.mesh import make_host_mesh
from repro.parallel import updates as jax_updates
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs import get_dlrm
from repro_torch.core import dlrm
from repro_torch.core.planner import ShardingPlan, TablePlacement
from repro_torch.engine import Engine
from repro_torch.launch import train as train_launcher
from repro_torch.parallel import (PlannedTieredExchange, build_step,
                                  init_dlrm_opt_state, make_exchange,
                                  shard_dlrm_params)
from repro_torch.parallel.exchange import (row_wise_expand_grads,
                                           table_wise_expand_grads)
from repro_torch.parallel.updates import adagrad_row_update, sgd_row_update

TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "dlrm-rm2-small-unsharded"
REPO = Path(__file__).resolve().parents[1]
LR = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(batch_size=None):
    jcfg, cfg = jax_get_dlrm(NAME).reduced(), get_dlrm(NAME).reduced()
    if batch_size is not None:
        import dataclasses
        jcfg = dataclasses.replace(jcfg, batch_size=batch_size)
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    return jcfg, cfg


def _np_params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_dlrm.init_dlrm(jax.random.PRNGKey(seed), jcfg))


def _batch(jcfg, step, alpha=0.0):
    return {k: np.array(v) for k, v in
            jax_batch(jcfg, step, 0, alpha).items()}


def _t(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _leaves_np(tree):
    out = []

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        else:
            a = x.float().numpy() if torch.is_tensor(x) else np.asarray(
                x, np.float32)
            out.append((path, a))
    walk(tree, "")
    return out


def _assert_trees_close(got, want, **tol):
    g, w = _leaves_np(got), _leaves_np(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, err_msg=path, **(tol or TOL))


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


# ------------------------------------------------ the model's own pieces
def test_feature_interactions_gradient_matches_jax_grad():
    rng = np.random.default_rng(0)
    bot = rng.standard_normal((5, 32)).astype(np.float32)
    pooled = rng.standard_normal((5, 6, 32)).astype(np.float32)
    w = rng.standard_normal((5, 32 + 7 * 6 // 2)).astype(np.float32)

    def f(b, p):
        return jnp.sum(jnp.asarray(w) * jax_dlrm.feature_interactions(b, p))

    want_b, want_p = jax.grad(f, argnums=(0, 1))(jnp.asarray(bot),
                                                  jnp.asarray(pooled))
    tb = torch.from_numpy(bot).requires_grad_()
    tp = torch.from_numpy(pooled).requires_grad_()
    out = dlrm.feature_interactions(tb, tp)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jax_dlrm.feature_interactions(jnp.asarray(bot),
                                                 jnp.asarray(pooled))),
        **TOL)
    (torch.from_numpy(w) * out).sum().backward()
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_b), **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_p), **TOL)


def test_model_pieces_do_not_run_kernel_oracles(monkeypatch):
    """The model's lookup and interaction have bodies of their own: they
    never reach the kernels' plain versions."""
    from repro_torch.kernels import ref

    def boom(*_, **__):
        raise AssertionError("the model ran a kernel's plain version")

    for name in ("embedding_bag_ref", "interactions_ref"):
        monkeypatch.setattr(ref, name, boom)
    jcfg, cfg = _cfgs()
    params = convert.params_from_jax_numpy(_np_params(jcfg), "cpu")
    b = _t(_batch(jcfg, 0))
    dlrm.predict(params, b["dense"], b["indices"], cfg)
    dlrm.reference_train_step(params, b["dense"], b["indices"], b["labels"],
                              cfg, LR)


def test_reference_train_step_matches_reference_for_three_steps():
    jcfg, cfg = _cfgs()
    p0 = _np_params(jcfg, 1)
    jstep = jax.jit(jax_dlrm.reference_train_step,
                    static_argnames=("cfg", "lr"))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = convert.params_from_jax_numpy(p0, "cpu")
    for s in range(3):
        b = _batch(jcfg, s)
        jp, jloss = jstep(jp, *(_j(b)[k] for k in ("dense", "indices",
                                                   "labels")), jcfg, LR)
        tb = _t(b)
        tp, loss = dlrm.reference_train_step(
            tp, tb["dense"], tb["indices"], tb["labels"], cfg, LR)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _assert_trees_close(tp, jax.tree_util.tree_map(np.asarray, jp))


def test_reference_train_step_only_touches_looked_up_rows():
    jcfg, cfg = _cfgs()
    p0 = _np_params(jcfg, 2)
    params = convert.params_from_jax_numpy(p0, "cpu")
    b = _t(_batch(jcfg, 0))
    p2, _ = dlrm.reference_train_step(params, b["dense"], b["indices"],
                                      b["labels"], cfg, 0.1)
    touched = np.zeros((cfg.num_tables, cfg.rows_per_table), bool)
    idx = b["indices"].numpy()
    for t in range(cfg.num_tables):
        touched[t, idx[:, t, :].reshape(-1)] = True
    diff = np.abs(p2["tables"].numpy() - p0["tables"]).sum(-1)
    assert (diff[~touched] == 0).all(), "untouched rows changed"
    assert (diff[touched] > 0).all(), "a touched row did not change"
    assert p2["tables"] is params["tables"], "the tables were copied"


# ------------------------------------------------------- row updates
def _dup_case(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    T, R, N, d = 3, 10, 24, 8
    tables = rng.uniform(-1, 1, (T, R, d)).astype(dtype)
    idx = rng.integers(0, R, (T, N)).astype(np.int32)
    idx[:, :6] = idx[:, :1]                  # one row six times a table
    g = rng.standard_normal((T, N, d)).astype(np.float32)
    acc = rng.uniform(0, 1, (T, R)).astype(np.float32)
    return tables, idx, g, acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgd_row_update_with_duplicate_ids_matches_reference(dtype):
    tables, idx, g, _ = _dup_case(3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_updates.sgd_row_update(LR)(jnp.asarray(tables, jdt),
                                          jnp.asarray(idx), jnp.asarray(g))
    tab = torch.from_numpy(tables).to(dtype)
    got = sgd_row_update(LR)(tab, torch.from_numpy(idx), torch.from_numpy(g))
    assert got is tab and got.dtype == dtype
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_adagrad_row_update_with_duplicate_ids_matches_reference():
    """The accumulator takes every duplicate before any row reads it."""
    tables, idx, g, acc = _dup_case(4)
    want_t, want_a = jax_updates.adagrad_row_update(LR)(
        jnp.asarray(tables), jnp.asarray(acc), jnp.asarray(idx),
        jnp.asarray(g))
    tab, a = torch.from_numpy(tables.copy()), torch.from_numpy(acc.copy())
    got_t, got_a = adagrad_row_update(LR)(tab, a, torch.from_numpy(idx),
                                          torch.from_numpy(g))
    assert got_t is tab and got_a is a
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)


def test_row_updates_wrap_negative_ids_and_drop_out_of_range():
    """As JAX's scatter-add: -1 is the last row, R and -R-1 are dropped."""
    tables, idx, g, acc = _dup_case(5)
    idx[:, 6], idx[:, 7], idx[:, 8] = -1, 10, -11
    want = jax_updates.sgd_row_update(LR)(jnp.asarray(tables),
                                          jnp.asarray(idx), jnp.asarray(g))
    got = sgd_row_update(LR)(torch.from_numpy(tables.copy()),
                             torch.from_numpy(idx), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_t, want_a = jax_updates.adagrad_row_update(LR)(
        jnp.asarray(tables), jnp.asarray(acc), jnp.asarray(idx),
        jnp.asarray(g))
    got_t, got_a = adagrad_row_update(LR)(
        torch.from_numpy(tables.copy()), torch.from_numpy(acc.copy()),
        torch.from_numpy(idx), torch.from_numpy(g))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)


# ---------------------------------------------------------- train step
def _run_both(jcfg, cfg, optimizer, depth, plan=None, jplan=None, steps=3,
              lr=LR):
    """The same params and batches through JAX's build_step(mode="train")
    on a 1-device mesh and the port's; returns both (params, opt, losses)."""
    mesh = make_host_mesh(model=1)
    p0 = _np_params(jcfg, 4)
    jstep = jax_parallel.build_step(jcfg, mesh, mode="train", plan=jplan,
                                    optimizer=optimizer, lr=lr,
                                    pipeline_depth=depth)
    jp = jax_parallel.shard_dlrm_params(
        jax.tree_util.tree_map(jnp.array, p0), jcfg, mesh, ("data", "model"),
        plan=jplan)
    jo = jax_parallel.init_dlrm_opt_state(jcfg, optimizer, jplan, n=1)
    tstep = build_step(cfg, mode="train",
                       exchange=make_exchange(cfg, plan=plan, device="cpu"),
                       optimizer=optimizer, lr=lr, pipeline_depth=depth)
    tp = shard_dlrm_params(convert.params_from_jax_numpy(p0, "cpu"), plan)
    to = init_dlrm_opt_state(cfg, optimizer, plan, device="cpu")
    jl, tl = [], []
    for s in range(steps):
        b = _batch(jcfg, s, alpha=1.05)
        jb, tb = _j(b), _t(b)
        jp, jo, loss = jstep(jp, jo, jb["dense"], jb["indices"],
                             jb["labels"])
        jl.append(float(loss))
        tp, to, loss = tstep(tp, to, tb["dense"], tb["indices"],
                             tb["labels"])
        tl.append(float(loss))
    to_np = jax.tree_util.tree_map(np.asarray, (jp, jo))
    return (tp, to, tl), (*to_np, jl)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_train_step_plan_none_matches_reference(optimizer, depth):
    jcfg, cfg = _cfgs()
    (tp, to, tl), (jp, jo, jl) = _run_both(jcfg, cfg, optimizer, depth)
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_trees_close(tp, jp)
    if optimizer == "sgd":
        assert to is None and jo is None
    else:
        _assert_trees_close(to, jo)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_train_step_sharding_plan_matches_reference(optimizer):
    """A concrete ShardingPlan (even tables fast, odd bulk), depth 2."""
    jcfg, cfg = _cfgs()
    (tp, to, tl), (jp, jo, jl) = _run_both(
        jcfg, cfg, optimizer, 2,
        plan=_interleaved(ShardingPlan, TablePlacement, cfg.num_tables),
        jplan=_interleaved(JaxPlan, JaxPlacement, jcfg.num_tables))
    assert set(tp) == {"bot_mlp", "top_mlp", "tables_fast", "tables_bulk"}
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_trees_close(tp, jp)
    if optimizer == "adagrad":
        assert set(to) == {"table_acc_fast", "table_acc_bulk"}
        _assert_trees_close(to, jo)


def _copy_into(dst, src):
    """Copy a numpy tree into a torch tree of the same structure."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for x, y in zip(dst, src):
            _copy_into(x, y)
    else:
        dst.copy_(torch.from_numpy(np.array(src)))


def test_adagrad_at_the_launchers_lr_diverges_as_the_reference():
    """Row-wise AdaGrad at lr 0.01 (the train launchers' default) on the
    alpha = 1.05 stream diverges in the reference too: at the full widths
    (40 tables, L = 80, batch 200, depth 8) with the rows cut to 4,096 and
    the tables placed fast and bulk in turn, the port and the reference,
    each running on its own, reach a non-finite loss at the same step.
    Their losses drift apart as the run blows up (fp32 roundings grow with
    it), so every step is also taken by the port from the reference's
    state of that step, and that loss is held at rtol = atol = 1e-5."""
    import dataclasses
    jcfg, cfg = (dataclasses.replace(c, rows_per_table=4096)
                 for c in (jax_get_dlrm(NAME), get_dlrm(NAME)))
    lr, depth = 0.01, 8
    jplan = _interleaved(JaxPlan, JaxPlacement, jcfg.num_tables)
    plan = _interleaved(ShardingPlan, TablePlacement, cfg.num_tables)
    mesh = make_host_mesh(model=1)
    p0 = _np_params(jcfg, 4)
    jstep = jax_parallel.build_step(jcfg, mesh, mode="train", plan=jplan,
                                    optimizer="adagrad", lr=lr,
                                    pipeline_depth=depth)
    jp = jax_parallel.shard_dlrm_params(
        jax.tree_util.tree_map(jnp.array, p0), jcfg, mesh, ("data", "model"),
        plan=jplan)
    jo = jax_parallel.init_dlrm_opt_state(jcfg, "adagrad", jplan, n=1)
    tstep = build_step(cfg, mode="train",
                       exchange=make_exchange(cfg, plan=plan, device="cpu"),
                       optimizer="adagrad", lr=lr, pipeline_depth=depth)

    def fresh():
        return (shard_dlrm_params(convert.params_from_jax_numpy(p0, "cpu"),
                                  plan),
                init_dlrm_opt_state(cfg, "adagrad", plan, device="cpu"))

    free, forced = fresh(), fresh()
    jl, tl, fl = [], [], []
    for s in range(10):
        _copy_into(forced, jax.tree_util.tree_map(np.asarray, (jp, jo)))
        b = _batch(jcfg, s, alpha=1.05)
        jb, tb = _j(b), _t(b)
        args = (tb["dense"], tb["indices"], tb["labels"])
        fl.append(float(tstep(*forced, *args)[2]))
        *free, loss = tstep(*free, *args)
        tl.append(float(loss))
        jp, jo, loss = jstep(jp, jo, jb["dense"], jb["indices"],
                             jb["labels"])
        jl.append(float(loss))
    print("losses (port, port from the reference's state, reference):",
          list(zip(tl, fl, jl)))
    finite = np.isfinite(jl)
    assert not finite.all(), "the reference did not diverge"
    first = int(np.argmin(finite))
    assert first >= 3 and not finite[first:].any()
    np.testing.assert_array_equal(np.isfinite(tl), finite)
    np.testing.assert_array_equal(np.isfinite(fl), finite)
    np.testing.assert_allclose(fl[:first], jl[:first], **TOL)
    np.testing.assert_allclose(tl[:3], jl[:3], **TOL)


def test_bulk_sparse_apply_casts_before_expansion_bf16():
    """bf16 tables: the bulk group casts its pooled grads to bf16 BEFORE
    the L-fold expansion (primitives.py row_wise_backward_update), the
    fast group after (in the update). Held against the reference's tiered
    exchange on a 1-device mesh; the bulk result differs from a cast after
    expansion. Tolerance: exact; with no repeated row both sides round
    the same values once each."""
    jcfg, cfg = _cfgs()
    jplan = _interleaved(JaxPlan, JaxPlacement, jcfg.num_tables)
    plan = _interleaved(ShardingPlan, TablePlacement, cfg.num_tables)
    rng = np.random.default_rng(8)
    B, T, L, R, d = 6, cfg.num_tables, 4, cfg.rows_per_table, 32
    tf = rng.uniform(-1, 1, (T // 2, R, d)).astype(np.float32)
    tb = rng.uniform(-1, 1, (T // 2, R, d)).astype(np.float32)
    # no row twice in a table: each row takes one rounded add, the same on
    # both sides (repeated bf16 adds round in another order in each)
    idx = np.stack([rng.permutation(R)[:B * L].reshape(B, L)
                    for _ in range(T)], axis=1).astype(np.int32)
    g = rng.standard_normal((B, T, d)).astype(np.float32) * 0.37

    mesh = make_host_mesh(model=1)
    jexch = jax_parallel.make_exchange(jcfg, ("data", "model"), 1,
                                       plan=jplan)

    def apply(f, b, i, gp):
        tabs = {"tables_fast": f, "tables_bulk": b}
        _, ctx = jexch.forward(tabs, i)
        out = jexch.sparse_apply(tabs, ctx, gp,
                                 jax_updates.sgd_row_update(LR))
        return out["tables_fast"], out["tables_bulk"]

    jf, jb = jax.jit(shard_map(apply, mesh=mesh, in_specs=(P(),) * 4,
                               out_specs=(P(), P()), check_rep=False))(
        jnp.asarray(tf, jnp.bfloat16), jnp.asarray(tb, jnp.bfloat16),
        jnp.asarray(idx), jnp.asarray(g))
    exch = make_exchange(cfg, plan=plan, device="cpu")
    assert isinstance(exch, PlannedTieredExchange)
    tabs = {"tables_fast": torch.from_numpy(tf).bfloat16(),
            "tables_bulk": torch.from_numpy(tb).bfloat16()}
    before = tabs["tables_bulk"].clone()
    _, ctx = exch.forward(tabs, torch.from_numpy(idx))
    exch.sparse_apply(tabs, ctx, torch.from_numpy(g), sgd_row_update(LR))
    np.testing.assert_array_equal(tabs["tables_fast"].float().numpy(),
                                  np.asarray(jf, np.float32))
    np.testing.assert_array_equal(tabs["tables_bulk"].float().numpy(),
                                  np.asarray(jb, np.float32))
    # the same bulk update with the cast after the expansion differs
    g_b = torch.from_numpy(g)[:, 1::2]
    late = sgd_row_update(LR)(before, *table_wise_expand_grads(ctx[1], g_b))
    assert not torch.equal(late, tabs["tables_bulk"])
    early = sgd_row_update(LR)(before.clone().copy_(
        torch.from_numpy(tb).bfloat16()), *row_wise_expand_grads(
            R, ctx[1], g_b, dtype=torch.bfloat16))
    assert torch.equal(early, tabs["tables_bulk"])


def test_train_options_not_ported_raise():
    jcfg, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="A6b"):
        build_step(cfg, mode="train", compress_grads=True)
    with pytest.raises(NotImplementedError, match="A6b"):
        build_step(cfg, mode="train", dp_axes=("pod",))
    with pytest.raises(NotImplementedError, match="A6b"):
        Engine(cfg, compress_grads=True, device="cpu")
    # the row-wise wire mode is ported (A6a): a table-wise config keeps
    # its own exchange, and the mode reaches a row-wise config's
    eng = Engine(cfg, exchange="unpooled", device="cpu")
    assert eng.exchange == "unpooled"
    assert isinstance(eng.train_session().exchange_inst,
                      type(make_exchange(cfg)))
    sharded = get_dlrm("dlrm-rm2-small-sharded").reduced()
    ex = Engine(sharded, exchange="unpooled", device="cpu").train_session(
        ).exchange_inst
    assert (type(ex).__name__, ex.mode) == ("RowWiseExchange", "unpooled")
    with pytest.raises(NotImplementedError, match="A6b"):
        init_dlrm_opt_state(cfg, "adagrad", n=2, device="cpu")


# -------------------------------------------------------------- sessions
def test_train_session_loss_descends_windowed_mean():
    """Windowed means (tests/test_engine.py's check, at its batch of 128
    and lr 1.0), not the first and the last single-batch loss. The port's
    stream is drawn by torch.Generator, not jax.random, and its descent
    starts later than the reference's: 150 steps instead of 100."""
    _, cfg = _cfgs(batch_size=128)
    sess = Engine(cfg, lr=1.0, device="cpu").train_session()
    rep = sess.run(150)
    assert rep.steps_run == 150 and rep.start_step == 0
    losses = [h["loss"] for h in rep.history]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.02, losses


@pytest.mark.parametrize("plan,optimizer", [("none", "sgd"),
                                            ("auto", "adagrad")])
def test_train_resume_roundtrip(tmp_path, plan, optimizer):
    """ckpt at step 4, resume, run 4 more == an uninterrupted 8-step run."""
    _, cfg = _cfgs(batch_size=8)
    kw = dict(plan=plan, optimizer=optimizer, lr=LR, alpha=1.05,
              device="cpu")
    s1 = Engine(cfg, **kw).train_session(ckpt_dir=str(tmp_path),
                                         ckpt_every=4)
    s1.run(4)
    s2 = Engine(cfg, **kw).train_session(ckpt_dir=str(tmp_path),
                                         ckpt_every=4)
    assert s2.resume_step == 4
    rep2 = s2.run(4)
    assert rep2.start_step == 4
    straight = Engine(cfg, **kw).train_session()
    straight.run(8)
    _assert_trees_close(s2.state, straight.state, rtol=1e-5, atol=1e-6)
    if plan == "auto":
        assert set(s2.opt_state) == {"table_acc_fast", "table_acc_bulk"}


def test_trained_params_handoff_to_serve():
    """TrainSession.params (plan-split under plan=auto) feed
    serve_session of the same engine; split params without a plan are
    rejected."""
    _, cfg = _cfgs(batch_size=8)
    eng = Engine(cfg, plan="auto", alpha=1.05, lr=LR, device="cpu")
    train = eng.train_session()
    train.run(3)
    sess = eng.serve_session(max_batch_queries=2, params=train.params)
    b = _t(_batch(_cfgs(batch_size=8)[0], 0, alpha=1.05))
    fut = sess.submit({"dense": b["dense"], "indices": b["indices"]},
                      now=0.0)
    sess.flush(now=0.0)
    np.testing.assert_allclose(fut.probs,
                               sess.serve_direct(b["dense"], b["indices"]),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="no placed plan"):
        Engine(cfg, device="cpu").serve_session(params=train.params)


@pytest.mark.parametrize("fast", [(0, 3, 4, 6), (), (5, 1, 0, 2, 4, 3, 6, 7),
                                  (7,)])
def test_split_in_place_equals_the_split_copy(fast):
    """The training session's split: the same groups as
    split_dlrm_params_by_plan, as views of the one stacked tensor."""
    from repro_torch.parallel.plan import (PlanGroups,
                                           split_dlrm_params_by_plan,
                                           split_dlrm_params_in_place)
    _, cfg = _cfgs()
    groups = PlanGroups(tuple(sorted(fast)), tuple(
        t for t in range(cfg.num_tables) if t not in fast))
    params = convert.params_from_jax_numpy(_np_params(_cfgs()[0], 6), "cpu")
    want = split_dlrm_params_by_plan(params, groups)
    stacked = params["tables"]
    got = split_dlrm_params_in_place(params, groups)
    for k in ("tables_fast", "tables_bulk"):
        assert torch.equal(got[k], want[k]), k
        assert got[k].is_contiguous()
        assert got[k].untyped_storage().data_ptr() == \
            stacked.untyped_storage().data_ptr()


def test_train_depth_is_the_planners_training_depth():
    """plan="auto" trains at the training plan's depth (as the reference's
    Engine.resolve_pipeline_depth), plan="none" at 1, a pinned depth is
    clamped to a divisor of the batch."""
    _, cfg = _cfgs(batch_size=16)
    eng = Engine(cfg, plan="auto", alpha=1.05, device="cpu")
    sess = eng.train_session()
    assert eng.plan_report("training").mode == "training"
    assert eng.plan_report("inference") is None
    assert sess.pipeline_depth == eng.plan_report("training").pipeline_depth
    assert Engine(cfg, device="cpu").train_session().pipeline_depth == 1
    pinned = Engine(cfg, pipeline_depth=3, device="cpu")
    assert pinned.resolve_pipeline_depth("training", 16) == 2
    assert pinned.train_session().pipeline_depth == 2


# ------------------------------------------------------------ checkpoints
def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return ({"w": [torch.randn(3, 4, generator=g)],
             "tables": torch.randn(2, 5, 4, generator=g).bfloat16()},
            {"acc": torch.rand(2, 5, generator=g)})


def test_checkpoint_manager_keeps_the_newest_and_writes_atomically(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root, keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(step))
    mgr.wait()
    assert sorted(os.listdir(root)) == ["step_00000003", "step_00000004"]
    # a write cut short never shows: no manifest, or a tmp dir not renamed
    os.makedirs(os.path.join(root, "step_00000009"))
    os.makedirs(os.path.join(root, "step_00000010.tmp-1"))
    assert latest_step(root) == 4
    got, step, _ = restore(root, _tree(0))
    assert step == 4
    _assert_trees_close(got, _tree(4), rtol=0, atol=0)
    assert got[0]["tables"].dtype == torch.bfloat16
    with open(os.path.join(root, "step_00000004", "manifest.json")) as f:
        text = f.read()
    assert '"0/tables"' in text and '"bfloat16"' in text


def test_checkpoint_restore_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1), blocking=True)
    other = ({"w": [torch.zeros(3, 4)]}, None)
    with pytest.raises(ValueError, match="structure changed"):
        mgr.restore(other)


def test_checkpoint_async_failure_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker / "ck"))
    mgr.save(1, _tree(1))
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        mgr.wait()


# -------------------------------------------------------------- launcher
def test_train_launcher_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    report = tmp_path / "r.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--steps", "4", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-every", "2", "--report-json", str(report)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[train] dlrm dlrm-rm2-small-unsharded-smoke: steps=4" \
        in proc.stdout
    assert report.exists() and latest_step(str(tmp_path / "ck")) == 4


@pytest.mark.parametrize("every,steps", [(4, 10), (3, 3)])
def test_train_launcher_emits_deltas(every, steps, capsys, tmp_path):
    """--emit-deltas records, each --delta-every-steps segment, the batch
    ``diff_tables`` gives for whole snapshots of the tables before and
    after it, stamped at version x --delta-dt-s; applied in order they
    rebuild the trained tables."""
    from repro_torch.online import DeltaChannel, diff_tables
    path = tmp_path / "d.jsonl"
    rc = train_launcher.main([
        "--device", "cpu", "--smoke", "--steps", str(steps),
        "--emit-deltas", str(path), "--delta-every-steps", str(every),
        "--delta-dt-s", "0.25"])
    out = capsys.readouterr().out
    assert rc == 0, out
    got = DeltaChannel.load(str(path)).emitted
    n_seg = -(-steps // every)
    assert f"[train] deltas -> {path} ({n_seg} batches," in out
    assert f"steps={steps} (from 0)" in out
    sess = Engine(get_dlrm("dlrm-rm2-small-unsharded").reduced(),
                  device="cpu").train_session()
    tables = sess.params["tables"]
    start = tables.clone()
    snap = tables.clone()
    done = 0
    for v, batch in enumerate(got, start=1):
        n = min(every, steps - done)
        rep = sess.run(n)
        done += n
        want = diff_tables(snap, sess.params["tables"], version=v,
                           t_emit_s=0.25 * v, step=done,
                           train_loss=rep.last_loss)
        assert (batch.version, batch.t_emit_s, batch.step, batch.train_loss,
                batch.tables) == (want.version, want.t_emit_s, want.step,
                                  want.train_loss, want.tables)
        for a, b in zip(batch.deltas, want.deltas):
            np.testing.assert_array_equal(a.rows, b.rows)
            np.testing.assert_array_equal(a.values, b.values)
        assert batch.n_rows > 0
        snap = sess.params["tables"].clone()
    assert len(got) == n_seg and done == steps
    rebuilt = start.numpy().copy()
    for batch in got:
        for d in batch.deltas:
            rebuilt[d.table, d.rows] = d.values
    np.testing.assert_array_equal(rebuilt, sess.params["tables"].numpy())


@pytest.mark.parametrize("flag,item", [
    (["--compress-grads"], "A6b"), (["--model-axis", "2"], "A6b")])
def test_train_launcher_flags_not_ported_raise(flag, item):
    """The distributed flags raise, naming A6b (every LM arch trains:
    ``test_torch_lm_train``)."""
    with pytest.raises(NotImplementedError, match=item):
        train_launcher.main(["--device", "cpu", "--smoke", *flag])


def test_train_launcher_lm_flags_are_ignored_under_dlrm(capsys):
    """--seq and --batch are the LM session's; a DLRM run ignores them, as
    the reference's launcher does."""
    rc = train_launcher.main(["--device", "cpu", "--smoke", "--steps", "2",
                              "--seq", "64", "--batch", "3"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[train] dlrm dlrm-rm2-small-unsharded-smoke: steps=2" in out


def test_train_launcher_exchange_flag_trains_the_row_wise_config(capsys):
    """--exchange, which raised naming A6 before, picks the row-wise wire
    mode of the sharded config."""
    rc = train_launcher.main(["--device", "cpu", "--smoke", "--steps", "3",
                              "--config", "dlrm-rm2-small-sharded",
                              "--exchange", "unpooled"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[train] dlrm dlrm-rm2-small-sharded-smoke: steps=3" in out


def test_train_launcher_host_capacity_reaches_the_tier(capsys):
    """--host-capacity-mb, which raised naming A5 before, trains through
    the host tier: a budget below the tables' bytes, dirty chunks."""
    rc = train_launcher.main(["--device", "cpu", "--smoke", "--steps", "6",
                              "--alpha", "1.05", "--host-capacity-mb",
                              "0.1", "--host-chunk-rows", "2"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[train] host tier: 51 hot rows a table, chunk_rows 2," in out
    assert "[train] dlrm dlrm-rm2-small-unsharded-smoke: steps=6" in out


def test_train_launcher_host_tier_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--steps", "4", "--alpha", "1.05",
         "--host-capacity-mb", "0.1"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[train] host tier:" in proc.stdout
    assert "steps=4" in proc.stdout


def test_train_launcher_refuses_host_tier_checkpoints(tmp_path):
    """A checkpoint would not hold the host store or the chunk manager's
    bookkeeping: --ckpt-dir with the host tier raises naming A5, before
    any directory is written."""
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        train_launcher.main(["--device", "cpu", "--smoke", "--alpha", "1.05",
                             "--host-capacity-mb", "0.1", "--ckpt-dir",
                             str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


def test_engine_refuses_host_tier_checkpoints(tmp_path):
    cfg = get_dlrm("dlrm-rm2-small-unsharded").reduced()
    eng = Engine(cfg, device="cpu", alpha=1.05, host_capacity_mb=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        eng.train_session(ckpt_dir=str(tmp_path / "ck"))
    # a TrainSession handed a host exchange refuses it the same way
    from repro_torch.engine import TrainSession
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        TrainSession(cfg, device="cpu", exchange=eng._host_exchange(),
                     ckpt_dir=str(tmp_path / "ck"))
    assert not (tmp_path / "ck").exists()
    assert eng.train_session().run(1).steps_run == 1


def test_host_tier_training_refuses_adagrad():
    with pytest.raises(ValueError, match="SGD-only"):
        train_launcher.main(["--device", "cpu", "--smoke", "--optimizer",
                             "adagrad", "--host-capacity-mb", "1"])
