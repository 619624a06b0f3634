"""Row-wise sharding at n=1 (the paper's "full sharding") against the JAX
reference.

The reference runs ``RowWiseExchange`` on a one-device mesh (inside
``shard_map``, as its own tests do) or under its ``Engine``; the port runs
the same functions on the CPU. Inputs are made with numpy from a seed (or
are the JAX session's params, carried over by ``convert``) and go to both
packages. Sizes are ``cfg.reduced()`` (8 tables x 128 rows x 32, L = 4);
a ``lookup_chunk`` of 8 at B = 32 forces the chunked branches.
Tolerance: fp32 allclose at rtol = atol = 1e-5 (tests/test_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro import parallel as jax_parallel
from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro.core.planner import ShardingPlan as JaxPlan
from repro.core.planner import TablePlacement as JaxPlacement
from repro.engine import Engine as JaxEngine
from repro.launch.mesh import make_host_mesh
from repro.parallel import updates as jax_updates
from repro_torch import convert
from repro_torch.configs import get_dlrm
from repro_torch.core import dlrm
from repro_torch.core.planner import ShardingPlan, TablePlacement
from repro_torch.engine import Engine
from repro_torch.hoststore import HostTieredExchange
from repro_torch.kernels import ops
from repro_torch.parallel import (PlannedTieredExchange, RowWiseExchange,
                                  make_exchange, row_wise_backward_update,
                                  row_wise_forward)
from repro_torch.parallel.updates import adagrad_row_update, sgd_row_update

TOL = dict(rtol=1e-5, atol=1e-5)
SHARDED = "dlrm-rm2-small-sharded"
MODES = ["partial_pool", "unpooled"]
AXIS = ("data", "model")
CHUNKS = {"one_shot": 4096, "chunked": 8}
B = 32
LR = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return jax_get_dlrm(SHARDED).reduced(), get_dlrm(SHARDED).reduced()


def _case(cfg, seed):
    """Tables and (B, T, L) ids, a few of them outside [0, R): the
    row-wise masks pool those to zero in both packages."""
    rng = np.random.default_rng(seed)
    T, R, L, d = (cfg.num_tables, cfg.rows_per_table, cfg.lookups_per_table,
                  cfg.embed_dim)
    tables = rng.uniform(-1, 1, (T, R, d)).astype(np.float32)
    idx = rng.integers(0, R, (B, T, L)).astype(np.int32)
    idx[0, 0, 0], idx[1, 2, 3], idx[5, 7, 1] = -1, R, R + 7
    return tables, idx


def _on_mesh(fn, n_args):
    """fn on a one-device mesh, every argument and output replicated."""
    return jax.jit(shard_map(fn, mesh=make_host_mesh(model=1),
                             in_specs=(P(),) * n_args, out_specs=P(),
                             check_rep=False))


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("mode", MODES)
def test_row_wise_forward_matches_reference(mode, chunk):
    jcfg, cfg = _cfgs()
    tables, idx = _case(cfg, seed=1)
    jexch = jax_parallel.make_exchange(jcfg, AXIS, 1, row_wise_exchange=mode,
                                       lookup_chunk=CHUNKS[chunk])
    want, want_ctx = _on_mesh(
        lambda t, i: jexch.forward({"tables": t}, i), 2)(
        jnp.asarray(tables), jnp.asarray(idx))
    exch = make_exchange(cfg, row_wise_exchange=mode,
                         lookup_chunk=CHUNKS[chunk], device="cpu")
    assert isinstance(exch, RowWiseExchange) and exch.mode == mode
    got, ctx = exch.forward({"tables": torch.from_numpy(tables)},
                            torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(ctx.numpy(), np.asarray(want_ctx))
    # in range, a row-wise pool is the table-wise one
    ok = torch.from_numpy(idx).clamp(0, cfg.rows_per_table - 1)
    np.testing.assert_allclose(
        row_wise_forward(torch.from_numpy(tables), ok, mode,
                         CHUNKS[chunk])[0].numpy(),
        dlrm.embedding_bag(torch.from_numpy(tables), ok).numpy(), **TOL)


def _updates(optimizer, acc):
    """The same update_fn in both packages; AdaGrad reads one fixed
    accumulator (a copy a call on the port's side, whose update writes it
    in place), so every chunk sees the same state in both."""
    if optimizer == "sgd":
        return jax_updates.sgd_row_update(LR), sgd_row_update(LR)
    jada, ada = jax_updates.adagrad_row_update(LR), adagrad_row_update(LR)
    return ((lambda t, i, g: jada(t, jnp.asarray(acc), i, g)[0]),
            (lambda t, i, g: ada(t, torch.from_numpy(acc.copy()), i, g)[0]))


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_row_wise_backward_update_matches_reference(optimizer, chunk):
    """Chunks apply in sequence, each to the tables the last one left;
    the grads' rows outside [0, R) go to row 0 at zero."""
    jcfg, cfg = _cfgs()
    tables, idx = _case(cfg, seed=2)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((B, cfg.num_tables, cfg.embed_dim)).astype(
        np.float32)
    acc = rng.uniform(0, 1, (cfg.num_tables, cfg.rows_per_table)).astype(
        np.float32)
    jupd, upd = _updates(optimizer, acc)
    jexch = jax_parallel.make_exchange(jcfg, AXIS, 1,
                                       lookup_chunk=CHUNKS[chunk])
    want = _on_mesh(lambda t, i, gp: jexch.sparse_apply(
        {"tables": t}, i, gp, jupd)["tables"], 3)(
        jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(g))
    tab = torch.from_numpy(tables.copy())
    got = row_wise_backward_update(tab, torch.from_numpy(idx),
                                   torch.from_numpy(g), upd, CHUNKS[chunk])
    assert got is tab, "the update copied the tables"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    exch = make_exchange(cfg, lookup_chunk=CHUNKS[chunk], device="cpu")
    tabs = {"tables": torch.from_numpy(tables.copy())}
    exch.sparse_apply(tabs, torch.from_numpy(idx), torch.from_numpy(g), upd)
    np.testing.assert_allclose(tabs["tables"].numpy(), np.asarray(want),
                               **TOL)


def _query(cfg, seed, n=1):
    rng = np.random.default_rng(seed)
    q = cfg.batch_size * n
    return (rng.standard_normal((q, cfg.num_dense)).astype(np.float32),
            rng.integers(0, cfg.rows_per_table,
                         (q, cfg.num_tables, cfg.lookups_per_table)
                         ).astype(np.int32))


def _serve_pair(jkw, kw):
    jcfg, cfg = _cfgs()
    jsess = JaxEngine(jcfg, **jkw).serve_session(max_batch_queries=2,
                                                 max_wait_ms=50.0)
    params = convert.params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jsess.params), "cpu")
    sess = Engine(cfg, device="cpu", **kw).serve_session(
        max_batch_queries=2, max_wait_ms=50.0, params=params)
    return jsess, sess


def _agree(jsess, sess, seeds=(0, 1), n=2):
    for s in seeds:
        dense, idx = _query(sess.cfg, s, n)
        want = jsess.serve_direct(jnp.asarray(dense), jnp.asarray(idx))
        got = sess.serve_direct(torch.from_numpy(dense),
                                torch.from_numpy(idx))
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_row_wise_serve_session_matches_reference(mode):
    """plan="none" on a row-wise config: composed through the row-wise
    exchange in both packages, no kernel launched; the probs also equal a
    table-wise session's on the same weights (at n=1 the sums are the
    same)."""
    jsess, sess = _serve_pair({"plan": "none", "exchange": mode},
                              {"plan": "none", "exchange": mode})
    assert sess.serve_kernel == jsess.serve_kernel == "composed"
    assert isinstance(sess.exchange, RowWiseExchange)
    assert sess.exchange.mode == mode
    ops.reset_launch_counts()
    _agree(jsess, sess)
    assert not any(ops.launch_counts.values())
    table_wise = Engine(get_dlrm("dlrm-rm2-small-unsharded").reduced(),
                        device="cpu").serve_session(
        max_batch_queries=2, params=sess.params)
    dense, idx = _query(sess.cfg, 5, 2)
    np.testing.assert_allclose(
        sess.serve_direct(torch.from_numpy(dense), torch.from_numpy(idx)),
        table_wise.serve_direct(torch.from_numpy(dense),
                                torch.from_numpy(idx)), **TOL)


def _interleaved(plan_cls, placement_cls, T, exchange):
    """Even tables fast, odd tables bulk, the bulk group in ``exchange``."""
    return plan_cls(
        config=SHARDED + "-smoke", mode="row_wise", exchange=exchange,
        qps_table_wise=0.5, qps_row_wise_unpooled=1.0,
        qps_row_wise_partial=1.0,
        placements=tuple(
            placement_cls(t, "fast", "table_wise", 0) if t % 2 == 0
            else placement_cls(t, "bulk", "row_wise", None)
            for t in range(T)),
        hit_ratio=0.5)


@pytest.mark.parametrize("plan", ["auto", "interleaved-unpooled"])
def test_planned_forward_serves_a_row_wise_config_as_the_reference(plan):
    """A placed plan on the row-wise config, composed (fused_serve="off"):
    the bulk group runs row_wise_forward in the plan's wire mode."""
    if plan == "auto":
        jkw = kw = {"plan": "auto", "alpha": 1.05}
    else:
        T = get_dlrm(SHARDED).reduced().num_tables
        jkw = {"plan": _interleaved(JaxPlan, JaxPlacement, T, "unpooled")}
        kw = {"plan": _interleaved(ShardingPlan, TablePlacement, T,
                                   "unpooled")}
    jsess, sess = _serve_pair({**jkw, "fused_serve": "off"},
                              {**kw, "fused_serve": "off"})
    assert sess.serve_kernel == jsess.serve_kernel == "composed"
    exch = sess.exchange
    assert isinstance(exch, PlannedTieredExchange)
    assert exch.row_mode == sess.plan.exchange
    if plan != "auto":
        assert exch.row_mode == "unpooled"
    _agree(jsess, sess)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("mode", MODES)
def test_train_session_trajectory_matches_reference(mode, optimizer,
                                                   monkeypatch):
    """A TrainSession of the row-wise config against the JAX Engine's, from
    the JAX session's init (copied into the port's params) over the JAX
    session's stream (its batches handed to the port's session through
    numpy): the losses of 3 steps and the params and accumulators after
    them."""
    from repro.data import make_recsys_batch as jax_batch
    from repro_torch.engine import training
    jcfg, cfg = _cfgs()
    monkeypatch.setattr(
        training, "make_recsys_batch",
        lambda _cfg, s, seed, alpha, device=None: {
            k: torch.from_numpy(np.array(v))
            for k, v in jax_batch(jcfg, s, seed, alpha).items()})
    jsess = JaxEngine(jcfg, exchange=mode, optimizer=optimizer, lr=LR,
                      alpha=1.05).train_session()
    p0 = jax.tree_util.tree_map(np.array, jsess.state[0])
    sess = Engine(cfg, exchange=mode, optimizer=optimizer, lr=LR,
                  alpha=1.05, device="cpu").train_session()
    assert isinstance(sess.exchange_inst, RowWiseExchange)
    assert sess.exchange_inst.mode == mode
    with torch.no_grad():
        params = convert.params_from_jax_numpy(p0, "cpu")
        sess.params["tables"].copy_(params["tables"])
        for k in ("bot_mlp", "top_mlp"):
            for dst, src in zip(sess.params[k], params[k]):
                for n in dst:
                    dst[n].copy_(src[n])
    jrep, rep = jsess.run(3), sess.run(3)
    np.testing.assert_allclose([h["loss"] for h in rep.history],
                               [h["loss"] for h in jrep.history], **TOL)
    jp, jo = jax.tree_util.tree_map(np.asarray, jsess.state)
    np.testing.assert_allclose(sess.params["tables"].numpy(), jp["tables"],
                               **TOL)
    for k in ("bot_mlp", "top_mlp"):
        for got, want in zip(sess.params[k], jp[k]):
            for n in got:
                np.testing.assert_allclose(got[n].numpy(), want[n], **TOL)
    if optimizer == "adagrad":
        np.testing.assert_allclose(sess.opt_state["table_acc"].numpy(),
                                   jo["table_acc"], **TOL)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_row_wise_session_trains_as_the_table_wise_one(optimizer):
    """At n=1 the row-wise session of the sharded config and the table-wise
    session of the unsharded one, from the same seed and stream, end equal
    (the check chip_smoke.py's phase 8c makes at full width)."""
    out = []
    for name, mode in (("dlrm-rm2-small-unsharded", "partial_pool"),
                       (SHARDED, "partial_pool"), (SHARDED, "unpooled")):
        sess = Engine(get_dlrm(name).reduced(), exchange=mode,
                      optimizer=optimizer, lr=LR, alpha=1.05,
                      device="cpu").train_session()
        rep = sess.run(3)
        out.append(([h["loss"] for h in rep.history], sess.params,
                    sess.opt_state))
    for losses, params, opt in out[1:]:
        np.testing.assert_allclose(losses, out[0][0], **TOL)
        np.testing.assert_allclose(params["tables"].numpy(),
                                   out[0][1]["tables"].numpy(), **TOL)
        if optimizer == "adagrad":
            np.testing.assert_allclose(opt["table_acc"].numpy(),
                                       out[0][2]["table_acc"].numpy(), **TOL)


def test_large_sharded_config_routes_to_the_host_tier():
    """Under host_capacity_mb a row-wise config gets the host tier's
    exchange, as the reference's Engine returns it first."""
    from repro.hoststore import HostTieredExchange as JaxHostExchange
    name = "dlrm-rm2-large-sharded"
    cfg = get_dlrm(name).reduced()
    mb = 0.4               # below the reduced config's 0.5 MiB of tables
    assert cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4 > mb * 2**20
    jeng = JaxEngine(jax_get_dlrm(name).reduced(), host_capacity_mb=mb,
                     alpha=1.05)
    _, jex = jeng._plan_and_exchange("inference")
    assert isinstance(jex, JaxHostExchange)
    eng = Engine(cfg, host_capacity_mb=mb, alpha=1.05, device="cpu")
    sess = eng.serve_session(max_batch_queries=1)
    ex = sess.exchange
    assert isinstance(ex, HostTieredExchange)
    assert sess.serve_kernel == "composed"
    assert (ex.hot_slots, ex.mgr.chunk_rows) == (jex.hot_slots,
                                                jex.mgr.chunk_rows)
    probs, service, stall = sess._execute([sess._make_query(3)])
    assert probs.shape == (1, cfg.batch_size) and np.isfinite(probs).all()
    assert isinstance(eng.train_session().exchange_inst, HostTieredExchange)


def test_row_wise_exchange_refuses_other_modes_and_devices():
    cfg = get_dlrm(SHARDED).reduced()
    with pytest.raises(ValueError, match="unknown row_wise exchange mode"):
        Engine(cfg, exchange="pooled", device="cpu")
    with pytest.raises(ValueError, match="unknown row_wise exchange mode"):
        RowWiseExchange(cfg, mode="pooled")
    # more ranks need their process group (tests/test_torch_ranks.py runs
    # the exchange over 2 and 4 gloo ranks)
    with pytest.raises(ValueError, match="process group"):
        make_exchange(cfg, 2)
    ex = make_exchange(cfg)
    assert not ex.supports_fused_forward()
    with pytest.raises(NotImplementedError, match="no fused serve path"):
        ex.fused_forward({}, None, None)


@pytest.mark.parametrize("mode", MODES)
def test_sessions_built_directly_take_the_row_wise_mode(mode):
    """A ServeSession or TrainSession built without the Engine makes its
    row-wise exchange in the mode ``row_wise_exchange`` names, and serves
    and trains as the Engine's session of that mode."""
    from repro_torch.engine import ServeSession, TrainSession
    cfg = get_dlrm(SHARDED).reduced()
    eng = Engine(cfg, exchange=mode, lr=LR, device="cpu")
    sess = ServeSession(cfg, device="cpu", max_batch_queries=2,
                        row_wise_exchange=mode)
    assert isinstance(sess.exchange, RowWiseExchange)
    assert sess.exchange.mode == mode == eng.serve_session().exchange.mode
    dense, idx = (torch.from_numpy(a) for a in _query(cfg, 9, 2))
    np.testing.assert_allclose(
        sess.serve_direct(dense, idx),
        eng.serve_session(max_batch_queries=2).serve_direct(dense, idx),
        **TOL)
    train = TrainSession(cfg, device="cpu", lr=LR, row_wise_exchange=mode)
    assert train.exchange_inst.mode == mode
    losses = [h["loss"] for h in train.run(2).history]
    np.testing.assert_allclose(
        losses, [h["loss"] for h in eng.train_session().run(2).history],
        **TOL)
