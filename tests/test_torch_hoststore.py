"""The port's host chunk manager and swap scheduler against
repro.hoststore.

Both run on the same numpy tables and the same request streams. The
manager's whole state must be EQUAL to the reference's after every
``ensure``: the chunk<->slot maps, the CLOCK hand and reference bits, the
LFU counts, the dirty bits, the indirection table on the host and the
device, the host store and the device cache, each ``EnsureStats`` and
every victim, in order. The swap plans' accounting and modeled seconds
must be equal too.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import perf_model as jax_perf_model
from repro.hoststore import ChunkParamMgr as JaxMgr
from repro.hoststore import micro_batch_indices as jax_micro_batch_indices
from repro.hoststore import overlap_stall as jax_overlap_stall
from repro.hoststore import plan_swaps as jax_plan_swaps
from repro_torch.core import perf_model
from repro_torch.hoststore import chunks as chunks_mod
from repro_torch.hoststore import (ChunkParamMgr, micro_batch_indices,
                                   overlap_stall, plan_swaps)

T, R, D = 3, 13, 4          # R = 13: every chunk size but 1 has a ragged tail
SLOTS = 6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(t=T, r=R, d=D, seed=0):
    return np.random.default_rng(seed).normal(size=(t, r, d)).astype(
        np.float32)


def _pair(chunk_rows, slots=SLOTS, policy="clock", tables=None):
    tables = _tables() if tables is None else tables
    want = JaxMgr(tables, chunk_rows, slots, policy=policy)
    got = ChunkParamMgr(tables, chunk_rows, slots, policy=policy,
                        device="cpu")
    return want, got


def _record_victims(want, got):
    """Lists that fill with each manager's victims, in eviction order."""
    w, g = [], []
    want_evict, got_evict = want._evict, got._evict

    def jax_evict(slot, st):
        w.append(int(slot))
        return want_evict(slot, st)

    def torch_evict(slots, st):
        g.extend(int(s) for s in slots)
        return got_evict(slots, st)

    want._evict, got._evict = jax_evict, torch_evict
    return w, g


def _same_stats(want, got):
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def _same_state(want, got):
    for name in ("_chunk_slot", "_slot_chunk", "_ref", "_freq", "_dirty"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got._hand == want._hand
    np.testing.assert_array_equal(got.host_pos, want.host_pos)
    np.testing.assert_array_equal(got.device_pos.numpy(),
                                  np.asarray(want.device_pos))
    np.testing.assert_array_equal(got.host.numpy(), want.host)
    np.testing.assert_array_equal(got.device_cache.numpy(),
                                  np.asarray(want.device_cache))


@pytest.mark.parametrize("policy", ["clock", "lfu"])
@pytest.mark.parametrize("chunk_rows", [1, 2, 3, 5])
def test_manager_state_equals_the_reference_on_random_streams(policy,
                                                              chunk_rows):
    _random_stream(policy, chunk_rows)


@pytest.mark.parametrize("policy,chunk_rows", [("clock", 1), ("lfu", 3)])
def test_transfers_in_pieces_equal_the_reference(policy, chunk_rows,
                                                 monkeypatch):
    """The same streams through a staging ring of 7 floats a half, which
    grows to one chunk where a chunk is larger: every load, writeback and
    flush moves one chunk a piece, through both halves in turn."""
    monkeypatch.setattr(chunks_mod, "STAGE_BYTES", 7 * 4)
    _random_stream(policy, chunk_rows)


def test_copy_to_host_and_rows_to_device_in_pieces(monkeypatch):
    monkeypatch.setattr(chunks_mod, "STAGE_BYTES", 7 * 4)
    tables = _tables()
    src = torch.from_numpy(tables.copy())
    dst = torch.empty_like(src)
    chunks_mod.copy_to_host(dst, src, chunks_mod.StagingRing(
        torch.device("cpu"), torch.float32))
    assert torch.equal(dst, src)
    mgr = ChunkParamMgr(tables, 2, 4, device="cpu")
    rows = np.array([0, 12, 13, 38, 5, 5])
    out = torch.empty((rows.size, D))
    mgr.rows_to_device(rows, out)
    np.testing.assert_array_equal(out.numpy(), tables.reshape(-1, D)[rows])


def _random_stream(policy, chunk_rows):
    """60 ensures of 1-4 chunks a call, some with pinned resident chunks,
    about half followed by a "training" update of the cached rows and
    ``mark_dirty``, so that dirty victims are written back: the state,
    stats and victims equal the reference's after every call."""
    want, got = _pair(chunk_rows, policy=policy)
    w_victims, g_victims = _record_victims(want, got)
    rng = np.random.default_rng(chunk_rows + (policy == "lfu"))
    n_chunks = want.n_chunks
    for step in range(60):
        chunks = rng.choice(n_chunks, size=rng.integers(1, 5),
                            replace=False)
        rows_t, rows_r = [], []
        for c in chunks:
            t, lo, hi = want.chunk_range(c)
            k = rng.integers(1, 4)
            rows_t += [t] * k
            rows_r += list(rng.integers(lo, hi, k))
        resident = np.flatnonzero(want._chunk_slot >= 0)
        pin = None
        if resident.size and rng.random() < 0.4:
            pin = rng.choice(resident, size=min(2, resident.size),
                             replace=False)
        st_w = want.ensure(np.array(rows_t), np.array(rows_r), pin=pin)
        st_g = got.ensure(np.array(rows_t), np.array(rows_r), pin=pin)
        _same_stats(st_w, st_g)
        assert g_victims == w_victims
        if rng.random() < 0.5:
            pos = want.host_pos[rows_t, rows_r]
            delta = rng.normal(size=(len(pos), D)).astype(np.float32)
            want.device_cache = want.device_cache.at[pos].add(delta)
            got.device_cache.index_put_((torch.from_numpy(pos).long(),),
                                        torch.from_numpy(delta),
                                        accumulate=True)
            want.mark_dirty(rows_t, rows_r)
            got.mark_dirty(rows_t, rows_r)
        _same_state(want, got)
    assert w_victims, "the stream evicted nothing"
    assert want.stats.writebacks, "the stream wrote nothing back"
    assert got.stats.writebacks == want.stats.writebacks
    np.testing.assert_array_equal(got.flush().numpy(), want.flush())
    _same_state(want, got)


@pytest.mark.parametrize("policy", ["clock", "lfu"])
def test_victims_when_every_candidate_is_referenced(policy):
    """A full cache whose slots all carry a reference bit: CLOCK clears
    them on its first round and takes victims on the second; LFU takes
    the least counted, ties by slot."""
    want, got = _pair(1, slots=4, policy=policy)
    w_victims, g_victims = _record_victims(want, got)
    for mgr in (want, got):
        mgr.ensure(np.zeros(4, int), np.arange(4))
        mgr.ensure(np.zeros(3, int), np.array([3, 1, 1]))   # re-reference
        mgr.ensure(np.zeros(2, int), np.array([7, 8]),
                   pin=np.array([1], np.int64))
        mgr.ensure(np.zeros(3, int), np.array([9, 10, 11]))
    assert g_victims == w_victims and len(w_victims) == 5
    _same_state(want, got)


def test_errors_match_the_reference():
    want, got = _pair(1, slots=3)
    for mgr in (want, got):
        with pytest.raises(ValueError, match="chunk cache"):
            mgr.ensure(np.zeros(4, int), np.arange(4))
        with pytest.raises(ValueError, match="out of range"):
            mgr.ensure(np.zeros(1, int), np.array([R]))
        with pytest.raises(ValueError, match="non-resident"):
            mgr.mark_dirty(np.array([0]), np.array([0]))
    for kw in ({"chunk_rows": 0, "cache_slots": 4},
               {"chunk_rows": 2, "cache_slots": 0}):
        with pytest.raises(ValueError):
            ChunkParamMgr(_tables(), device="cpu", **kw)
    with pytest.raises(ValueError, match="policy"):
        ChunkParamMgr(_tables(), 2, 4, policy="rand", device="cpu")
    with pytest.raises(ValueError, match="cache shape"):
        got.attach_cache(torch.zeros((2, 2)))
    # pinning everything resident leaves no victim: both raise
    want, got = _pair(1, slots=2)
    for mgr in (want, got):
        mgr.ensure(np.array([0, 0]), np.array([0, 1]))
        with pytest.raises(ValueError, match="too small"):
            mgr.ensure(np.array([0]), np.array([5]),
                       pin=np.array([0, 1], np.int64))


def test_store_handed_over_without_a_copy():
    host = torch.from_numpy(_tables())
    mgr = ChunkParamMgr(host, 2, 4, device="cpu", copy=False)
    assert mgr.host.data_ptr() == host.data_ptr()
    copied = ChunkParamMgr(host, 2, 4, device="cpu")
    assert copied.host.data_ptr() != host.data_ptr()
    assert torch.equal(copied.host, host)
    with pytest.raises(ValueError, match="contiguous CPU"):
        ChunkParamMgr(host.transpose(1, 2), 2, 4, device="cpu", copy=False)


def test_rows_to_device_gathers_the_store_rows():
    tables = _tables()
    mgr = ChunkParamMgr(tables, 2, 4, device="cpu")
    rows = np.array([0, 12, 13, 38, 5, 5])
    out = torch.empty((rows.size, D))
    mgr.rows_to_device(rows, out)
    np.testing.assert_array_equal(out.numpy(), tables.reshape(-1, D)[rows])


# ---------------------------------------------------------------- swaps
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_micro_batch_indices_equal_the_reference(depth):
    idx = np.arange(8 * 2 * 3).reshape(8, 2, 3)
    want = jax_micro_batch_indices(idx, depth)
    got = micro_batch_indices(idx, depth)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("policy", ["clock", "lfu"])
def test_plan_swaps_equal_the_reference(depth, policy):
    """Four steps of (8, 3, 2) indices with a cold mask, each touching at
    most 10 chunks, over a 12-slot cache: per-micro-batch stats, modeled
    seconds and the manager's state after every step."""
    tables = _tables(t=3, r=32, d=2)
    want, got = _pair(2, slots=12, policy=policy, tables=tables)
    rng = np.random.default_rng(depth)
    link = (jax_perf_model.host_link(latency_us=5.0, bandwidth_gbs=12.0),
            perf_model.host_link(latency_us=5.0, bandwidth_gbs=12.0))
    t_of = np.broadcast_to(np.arange(3)[None, :, None], (8, 3, 2))
    for _ in range(4):
        while True:
            idx = rng.integers(0, 32, (8, 3, 2))
            cold = rng.random(idx.shape) < 0.5
            if np.unique(want.chunk_of(t_of[cold], idx[cold])).size <= 10:
                break
        pw = jax_plan_swaps(want, idx, depth, link[0], cold_mask=cold)
        pg = plan_swaps(got, idx, depth, link[1], cold_mask=cold)
        assert pg.depth == pw.depth and pg.swap_s == pw.swap_s
        assert len(pg.stats) == len(pw.stats)
        for a, b in zip(pw.stats, pg.stats):
            _same_stats(a, b)
        assert pg.bytes_moved == pw.bytes_moved
        assert pg.faulted_chunks == pw.faulted_chunks
        assert pg.total_swap_s == pw.total_swap_s
        _same_state(want, got)
    assert want.stats.evicted_chunks, "the steps evicted nothing"


def test_plan_swaps_refuses_a_step_larger_than_the_cache():
    tables = _tables(t=1, r=32, d=2)
    idx = np.arange(16).reshape(8, 1, 2)
    for mgr, fn, link in (
            (JaxMgr(tables, 2, 6), jax_plan_swaps,
             jax_perf_model.host_link()),
            (ChunkParamMgr(tables, 2, 6, device="cpu"), plan_swaps,
             perf_model.host_link())):
        with pytest.raises(ValueError, match="working set"):
            fn(mgr, idx, 4, link)


@pytest.mark.parametrize("seed", range(4))
def test_overlap_stall_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for depth in (1, 2, 4, 8):
        swap = list(rng.random(depth) * 1e-3)
        service = float(rng.random() * 2e-3)
        assert overlap_stall(swap, service, depth) == jax_overlap_stall(
            swap, service, depth)
    assert overlap_stall([], 1.0, 4) == jax_overlap_stall([], 1.0, 4) == 0.0
