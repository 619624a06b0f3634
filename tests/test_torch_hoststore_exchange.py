"""The port's host-tier exchange against repro.hoststore, and the host
tier's session contracts within the port.

Against the reference, on shared numpy tables and hot rows, at
``cfg.reduced()`` with batch 8: ``build_host_exchange``'s sizing equal;
the swap plans ``begin_batch`` makes equal; ``forward`` (both pool modes;
``"cached_bag"`` against the reference's ``_cached_bag_pool``, whose
Pallas kernel runs in interpret mode here), ``sparse_apply`` and
``flush_host_weights`` fp32 allclose at rtol = atol = 1e-5.

Within the port, bitwise, as the reference's own subprocess tests hold
it (``tests/test_hoststore.py``): a model 1.6x over its device budget
serves through ``Engine(host_capacity_mb=...)`` exactly as the plan-none
session at the same depth, cold and warm; host-tier SGD training, flushed
back, equals plain training (tables, MLPs, losses).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro.hoststore import ChunkParamMgr as JaxMgr
from repro.hoststore import HostTieredExchange as JaxExchange
from repro.hoststore import build_host_exchange as jax_build
from repro.parallel.updates import sgd_row_update as jax_sgd
from repro_torch.configs import get_dlrm
from repro_torch.core import dlrm
from repro_torch.engine import Engine
from repro_torch.hoststore import (ChunkParamMgr, HostTieredExchange,
                                   build_host_exchange, draw_host_tables)
from repro_torch.parallel.updates import sgd_row_update

NAME = "dlrm-rm2-small-unsharded"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (dataclasses.replace(jax_get_dlrm(NAME).reduced(), batch_size=8),
            dataclasses.replace(get_dlrm(NAME).reduced(), batch_size=8))


def _table_bytes(cfg):
    return cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4


def _shared(seed=0, hot=20):
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    tables = rng.uniform(-1, 1, (cfg.num_tables, cfg.rows_per_table,
                                 cfg.embed_dim)).astype(np.float32)
    hot_rows = np.stack([rng.permutation(cfg.rows_per_table)[:hot]
                         for _ in range(cfg.num_tables)])
    return jcfg, cfg, tables, hot_rows, rng


def _pair(pool_mode="paired", chunk_rows=2, slots=300, seed=0):
    jcfg, cfg, tables, hot_rows, rng = _shared(seed)
    want = JaxExchange(jcfg, None, 1,
                       mgr=JaxMgr(tables, chunk_rows, slots),
                       hot_rows=hot_rows, pool_mode=pool_mode)
    got = HostTieredExchange(cfg, 1, mgr=ChunkParamMgr(
        tables, chunk_rows, slots, device="cpu"), hot_rows=hot_rows,
        pool_mode=pool_mode)
    return want, got, tables, rng


def _jax_tables(ex):
    return {"hs_hot": jnp.asarray(ex._hot_init),
            "hs_cache": ex.mgr.device_cache,
            "hs_hot_map": jnp.asarray(ex._hot_map_np),
            "hs_pos": ex.mgr.device_pos}


def _indices(cfg, rng, b=4):
    """(b, T, L) uniform ids: at most b*T*L = 128 chunks a step."""
    return rng.integers(0, cfg.rows_per_table,
                        (b, cfg.num_tables,
                         cfg.lookups_per_table)).astype(np.int32)


def _begin(want, got, idx, depth=1, train=False):
    _, pw = want.begin_batch(_jax_tables(want), idx, depth, train=train)
    params = got.init_session_params({"bot_mlp": [], "top_mlp": []})
    _, pg = got.begin_batch(params, torch.from_numpy(idx), depth,
                            train=train)
    return pw, pg, params


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_begin_batch_plans_equal_the_reference(depth):
    want, got, _, rng = _pair(slots=128)
    for _ in range(3):
        idx = _indices(got.cfg, rng)
        pw, pg, _ = _begin(want, got, idx, depth)
        assert pg.swap_s == pw.swap_s and pg.depth == pw.depth
        for a, b in zip(pw.stats, pg.stats):
            for f in dataclasses.fields(a):
                assert getattr(b, f.name) == getattr(a, f.name), f.name
    np.testing.assert_array_equal(got.mgr.host_pos, want.mgr.host_pos)
    np.testing.assert_array_equal(got._hot_map_np, want._hot_map_np)
    assert want.mgr.stats.evicted_chunks > 0


@pytest.mark.parametrize("pool_mode", ["paired", "cached_bag"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_the_reference(pool_mode, seed):
    want, got, tables, rng = _pair(pool_mode, seed=seed)
    idx = _indices(got.cfg, rng, b=8)
    idx[0, 0, :] = idx[0, 0, 0]                          # repeated ids
    _, _, params = _begin(want, got, idx)
    tw = _jax_tables(want)
    pooled_w, (fi_w, pos_w) = want.forward(tw, jnp.asarray(idx))
    if pool_mode == "cached_bag":
        # the reference's Pallas cached-bag kernel, in interpret mode
        pooled_w = want._cached_bag_pool(tw["hs_hot"], tw["hs_cache"],
                                         fi_w, pos_w)
    pooled, (fi, pos) = got.forward(params, torch.from_numpy(idx))
    np.testing.assert_array_equal(fi.numpy(), np.asarray(fi_w))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_w))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_w), **TOL)
    # and the exact bag of the shared tables
    np.testing.assert_allclose(
        pooled.numpy(), dlrm.embedding_bag(torch.from_numpy(tables),
                                           torch.from_numpy(idx)).numpy(),
        **TOL)


def test_cached_bag_reads_the_flat_cache_in_place(monkeypatch):
    """The cached-bag mode hands the cached-bag op the flat chunk cache
    itself and the lookups' cache positions: no (B, T, L, d) gather and no
    (T, B*L, d) slab is built on the way."""
    from repro_torch.kernels import ops
    _, got, _, rng = _pair("cached_bag")
    idx = _indices(got.cfg, rng, b=8)
    params = got.init_session_params({"bot_mlp": [], "top_mlp": []})
    got.begin_batch(params, torch.from_numpy(idx), 1)
    seen, op = [], ops.cached_embedding_bag

    def spy(fast, bulk, fast_idx, bulk_idx):
        seen.append((fast, bulk, fast_idx, bulk_idx))
        return op(fast, bulk, fast_idx, bulk_idx)

    monkeypatch.setattr(ops, "cached_embedding_bag", spy)
    pooled, (fi, pos) = got.forward(params, torch.from_numpy(idx))
    (fast, bulk, fast_idx, bulk_idx), = seen
    assert fast is params["hs_hot"] and bulk is params["hs_cache"]
    assert bulk.dim() == 2 and fast_idx is fi and bulk_idx is pos
    assert pooled.shape == (8, got.cfg.num_tables, got.cfg.embed_dim)


def test_sparse_apply_and_flush_match_the_reference():
    """Three training rounds: faults marked dirty, the split SGD scatter,
    the pads re-zeroed; then a round that evicts the dirty chunks (their
    rows written back), and the flushed host weights."""
    want, got, _, rng = _pair(slots=128)
    lr = 0.05
    for step in range(3):
        idx = _indices(got.cfg, rng)
        _, _, params = _begin(want, got, idx, train=True)
        tw = _jax_tables(want)
        if step:
            tw["hs_hot"] = want._device_hot
        _, ctx_w = want.forward(tw, jnp.asarray(idx))
        _, ctx = got.forward(params, torch.from_numpy(idx))
        g = rng.normal(size=(idx.shape[0], got.cfg.num_tables,
                             got.cfg.embed_dim)).astype(np.float32)
        new_w = want.sparse_apply(tw, ctx_w, jnp.asarray(g), jax_sgd(lr))
        want.end_batch(new_w)
        new = got.sparse_apply(params, ctx, torch.from_numpy(g),
                               sgd_row_update(lr))
        got.end_batch(new)
        np.testing.assert_allclose(new["hs_hot"].numpy(),
                                   np.asarray(new_w["hs_hot"]), **TOL)
        np.testing.assert_allclose(new["hs_cache"].numpy(),
                                   np.asarray(new_w["hs_cache"]), **TOL)
        assert not new["hs_cache"][-1].any()
        assert not new["hs_hot"][:, -1].any()
    assert want.mgr.stats.writebacks == got.mgr.stats.writebacks > 0
    np.testing.assert_allclose(got.flush_host_weights().numpy(),
                               want.flush_host_weights(), **TOL)


@pytest.mark.parametrize("ratio,hot_fraction,chunk_rows,cache_slots", [
    (1.6, 0.5, None, None), (1.6, 0.25, 2, None), (4.0, 0.0, None, None),
    (1.1, 0.9, 4, None), (2.0, 0.5, 1, 7)])
def test_build_host_exchange_sizing_equals_the_reference(
        ratio, hot_fraction, chunk_rows, cache_slots):
    jcfg, cfg, tables, _, _ = _shared()
    kw = dict(device_capacity_bytes=int(_table_bytes(cfg) / ratio),
              tables=tables, hot_fraction=hot_fraction,
              chunk_rows=chunk_rows, cache_slots=cache_slots, alpha=1.05)
    want = jax_build(jcfg, **kw)
    got = build_host_exchange(cfg, device="cpu", **kw)
    assert got.hot_slots == want.hot_slots
    assert got.mgr.chunk_rows == want.mgr.chunk_rows
    assert got.mgr.cache_slots == want.mgr.cache_slots
    assert got.hot_slab.shape == want._hot_init.shape
    # the given tables were copied, as the reference copies them
    assert np.array_equal(got.mgr.host.numpy(), tables)
    for t in range(cfg.num_tables):
        np.testing.assert_array_equal(
            got.hot_slab[t, :got.hot_slots].numpy(),
            tables[t, got._hot_rows[t]])


def test_build_host_exchange_validates_as_the_reference():
    jcfg, cfg = _cfgs()
    for fn, c, dev in ((jax_build, jcfg, {}), (build_host_exchange, cfg,
                                                {"device": "cpu"})):
        with pytest.raises(ValueError, match="device_capacity_bytes"):
            fn(c, device_capacity_bytes=0, **dev)
        with pytest.raises(ValueError, match="hot_fraction"):
            fn(c, device_capacity_bytes=1024, hot_fraction=1.0, **dev)


def test_the_host_tier_draws_the_stacked_tables_bitwise():
    _, cfg = _cfgs()
    want = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(3))["tables"]
    assert torch.equal(draw_host_tables(cfg, seed=3, device="cpu"), want)
    ex = build_host_exchange(cfg, device_capacity_bytes=_table_bytes(cfg)
                             // 2, seed=3, device="cpu")
    assert torch.equal(ex.mgr.host, want)


# ------------------------------------------- the port's session contracts
def _over_budget_mb(cfg):
    return _table_bytes(cfg) / 1.6 / 2 ** 20     # tables 1.6x the budget


def test_host_tier_serving_is_bitwise_the_plan_none_session():
    """24 queries of the alpha = 1.05 stream, cold then warm, at depth 4;
    the plain session serves the composed path, as the host tier does."""
    _, cfg = _cfgs()
    ref = Engine(cfg, device="cpu", pipeline_depth=4, fused_serve="off") \
        .serve_session(max_batch_queries=1)
    host = Engine(cfg, device="cpu", pipeline_depth=4, alpha=1.05,
                  host_capacity_mb=_over_budget_mb(cfg),
                  host_hot_fraction=0.25, host_chunk_rows=1) \
        .serve_session(max_batch_queries=1)
    assert host.serve_kernel == "composed"
    ex = host._exch
    queries = [ref._make_query(q, alpha=1.05) for q in range(24)]
    faults = []
    for _ in ("cold", "warm"):
        before = ex.mgr.stats.faulted_chunks
        for q in queries:
            p_ref, _, _ = ref._execute([q])
            p_host, service, stall = host._execute([q])
            assert np.array_equal(p_ref, p_host)
            assert 0.0 <= stall <= service
        faults.append(ex.mgr.stats.faulted_chunks - before)
    assert ex.mgr.stats.evicted_chunks > 0
    assert faults[1] < faults[0], "the warm replay should fault less"


def test_host_tier_training_round_trips_to_plain_training():
    _, cfg = _cfgs()
    kw = dict(device="cpu", lr=0.05, pipeline_depth=4)
    ref = Engine(cfg, **kw).train_session()
    rep_r = ref.run(6)
    host = Engine(cfg, host_capacity_mb=_over_budget_mb(cfg),
                  host_hot_fraction=0.25, host_chunk_rows=2,
                  **kw).train_session()
    rep_h = host.run(6)
    assert host.exchange_inst.mgr.stats.writebacks > 0
    assert torch.equal(host.exchange_inst.flush_host_weights(),
                       ref.params["tables"])
    for k in ("bot_mlp", "top_mlp"):
        for a, b in zip(ref.params[k], host.params[k]):
            for n in a:
                assert torch.equal(a[n], b[n])
    assert [float(h["loss"]) for h in rep_r.history] == \
        [float(h["loss"]) for h in rep_h.history]
