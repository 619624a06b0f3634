"""Plain versions of the tiered path's kernels against the JAX reference.

`embedding_bag_ref` and `cached_embedding_bag_ref` are held against the
reference's Pallas kernels in interpret mode (tiny sizes: one Python step
per looked-up row) and against its refs; `fused_grouped_bag_interactions_ref`
against `repro.kernels.ref`, which the reference's ops run off-TPU (its
Pallas grouped kernel cannot trace on this jax). Inputs are numpy arrays
from a seed. Tolerance: fp32 allclose at rtol = atol = 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.cached_embedding_bag import cached_embedding_bag_pallas
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro_torch.kernels import embedding_bags as bag_kernels
from repro_torch.kernels import fused_serve, ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jdt(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _tables(rng, T, R, d):
    return rng.uniform(-1, 1, (T, R, d)).astype(np.float32)


def _ids(rng, B, T, L, R):
    return rng.integers(0, R, (B, T, L)).astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,L,d,R", [(3, 2, 4, 32, 16), (2, 3, 3, 128, 8),
                                       (1, 1, 1, 32, 4)])
def test_embedding_bag_ref_matches_pallas_and_ref(B, T, L, d, R, dtype):
    rng = np.random.default_rng(B * 100 + d)
    tables, idx = _tables(rng, T, R, d), _ids(rng, B, T, L, R)
    idx[0, 0, :] = idx[0, 0, 0]                         # repeats count
    jt = jnp.asarray(tables, _jdt(dtype))
    got = ref.embedding_bag_ref(torch.from_numpy(tables).to(dtype),
                                torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (B, T, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(embedding_bag_pallas(
        jt, jnp.asarray(idx), interpret=True)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref.embedding_bag_ref(jt, jnp.asarray(idx))), **TOL)


def _cached(rng, B, T, L, S, R, d):
    fast = _tables(rng, T, S + 1, d)
    bulk = _tables(rng, T, R + 1, d)
    fast[:, S] = 0.0
    bulk[:, R] = 0.0
    hot = rng.random((B, T, L)) < 0.5
    fi = np.where(hot, rng.integers(0, S, (B, T, L)), S).astype(np.int32)
    bi = np.where(hot, R, rng.integers(0, R, (B, T, L))).astype(np.int32)
    return fast, bulk, fi, bi


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad_zero", [True, False])
def test_cached_embedding_bag_ref_matches_pallas_and_ref(pad_zero, dtype):
    """Two pools added; both rows of each lookup are read, so a pad slot
    that is not zero shows up in the sum exactly as in the reference."""
    rng = np.random.default_rng(5)
    fast, bulk, fi, bi = _cached(rng, 3, 2, 4, 5, 16, 32)
    if not pad_zero:
        fast[:, -1] = 0.25
        bulk[:, -1] = -0.5
    jf, jb = jnp.asarray(fast, _jdt(dtype)), jnp.asarray(bulk, _jdt(dtype))
    got = ref.cached_embedding_bag_ref(
        torch.from_numpy(fast).to(dtype), torch.from_numpy(bulk).to(dtype),
        torch.from_numpy(fi), torch.from_numpy(bi))
    assert got.dtype == torch.float32 and got.shape == (3, 2, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        cached_embedding_bag_pallas(jf, jb, jnp.asarray(fi), jnp.asarray(bi),
                                    interpret=True)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref.cached_embedding_bag_ref(jf, jb, jnp.asarray(fi),
                                         jnp.asarray(bi))), **TOL)


def _fake_slab_pool(fast, cache, fast_idx, pos, dtype):
    """The reference's cached-bag pool of the host tier: the cache rows
    gathered into a fake (T, B*L, d) bulk slab exactly as
    ``repro.hoststore.exchange.HostTieredExchange._cached_bag_pool``
    builds it, then ``repro.kernels.ref.cached_embedding_bag_ref``."""
    b, t, l = fast_idx.shape
    cold_rows = jnp.take(jnp.asarray(cache, _jdt(dtype)), jnp.asarray(pos),
                         axis=0)                       # (B, T, L, d)
    fake = cold_rows.transpose(1, 0, 2, 3).reshape(t, b * l, -1)
    fake_idx = jnp.broadcast_to(
        (jnp.arange(b)[:, None, None] * l
         + jnp.arange(l)[None, None, :]).astype(jnp.int32), (b, t, l))
    return np.asarray(jax_ref.cached_embedding_bag_ref(
        jnp.asarray(fast, _jdt(dtype)), fake, jnp.asarray(fast_idx),
        fake_idx))


def _shared_bulk(rng, B, T, L, S, C, d, pad_zero):
    """A hot slab (T, S+1, d), a flat cache (C+1, d) whose last row is its
    pad, and the slots of a host-tier lookup: each lookup hot (its cache
    position the pad) or cold (its slab slot the pad)."""
    fast = _tables(rng, T, S + 1, d)
    cache = rng.uniform(-1, 1, (C + 1, d)).astype(np.float32)
    if pad_zero:
        fast[:, S] = 0.0
        cache[C] = 0.0
    hot = rng.random((B, T, L)) < 0.5
    fi = np.where(hot, rng.integers(0, S, (B, T, L)), S).astype(np.int32)
    pos = np.where(hot, C, rng.integers(0, C, (B, T, L))).astype(np.int32)
    return fast, cache, fi, pos


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad_zero", [True, False])
def test_shared_bulk_matches_the_reference_on_its_fake_slab(pad_zero, dtype):
    """The cached bag with one (R+1, d) bulk tier that every table reads
    (the host tier's flat chunk cache) against the reference's pool over
    the fake slab it gathers from that cache; slots at the pads, by their
    index and counted from the end, and ids out of range (NaN where the
    reference gives NaN)."""
    rng = np.random.default_rng(17)
    B, T, L, S, C, d = 3, 4, 6, 5, 40, 32
    fast, cache, fi, pos = _shared_bulk(rng, B, T, L, S, C, d, pad_zero)
    fi[0, 0, :] = S                   # a bag of pad slots on the hot side
    pos[0, 0, :] = C                  # ... and on the cold side
    fi[0, 1, 0], pos[0, 1, 1] = -1, -1          # the pads, from the end
    fi[1, 2, 0], pos[1, 3, 2] = -2, -3          # real rows, from the end
    want = _fake_slab_pool(fast, cache, fi, pos, dtype)
    t = torch.from_numpy
    got = ops.cached_embedding_bag(t(fast).to(dtype), t(cache).to(dtype),
                                   t(fi), t(pos))
    assert got.dtype == torch.float32 and got.shape == (B, T, d)
    assert not np.isnan(want).any()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the shared form equals the 3-D form on the tier expanded per table
    np.testing.assert_array_equal(got.numpy(), ref.cached_embedding_bag_ref(
        t(fast).to(dtype), t(cache).to(dtype)[None].expand(T, -1, -1),
        t(fi), t(pos)).numpy())
    fi[2, 3, 2] = S + 1                          # past the hot slab
    pos[1, 0, 4] = C + 1                         # past the cache
    pos[2, 1, 0] = -(C + 2)                      # before the cache
    want = _fake_slab_pool(fast, cache, fi, pos, dtype)
    got = ops.cached_embedding_bag(t(fast).to(dtype), t(cache).to(dtype),
                                   t(fi), t(pos)).numpy()
    nan = np.isnan(want)
    assert nan[2, 3].all() and nan[1, 0].all() and nan[2, 1].all()
    assert nan.sum() == 3 * d
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], **TOL)


def test_cached_bag_shapes_that_disagree_raise():
    rng = np.random.default_rng(19)
    t = torch.from_numpy
    fast, cache, fi, pos = (t(x) for x in _shared_bulk(rng, 2, 3, 4, 5, 9,
                                                        32, True))
    with pytest.raises(ValueError, match="tiers disagree"):
        ops.cached_embedding_bag(fast, cache[:, :16], fi, pos)
    with pytest.raises(ValueError, match="tiers disagree"):
        ops.cached_embedding_bag(fast, cache, fi, pos[:, :, :3])
    with pytest.raises(ValueError, match="tiers disagree"):
        ops.cached_embedding_bag(fast, cache, fi, pos[:1])
    with pytest.raises(ValueError, match="tiers disagree"):
        ops.cached_embedding_bag(fast, cache[None].expand(2, -1, -1), fi,
                                 pos)
    with pytest.raises(ValueError, match="want bulk"):
        ops.cached_embedding_bag(fast, cache[0], fi, pos)
    with pytest.raises(ValueError, match="shapes disagree"):
        ops.cached_embedding_bag(fast, cache, fi[:, :2], pos[:, :2])
    with pytest.raises(ValueError, match="CUDA tensor"):
        bag_kernels.cached_embedding_bag(fast, cache, fi, pos)


def _grouped(seed, B, Tf, Tb, L, d, Rf, Rb, inv_perm):
    rng = np.random.default_rng(seed)
    tf, tb = _tables(rng, Tf, Rf, d) * 0.1, _tables(rng, Tb, Rb, d) * 0.1
    idx = np.concatenate([_ids(rng, B, Tf, L, Rf), _ids(rng, B, Tb, L, Rb)],
                         axis=1)
    bot = rng.uniform(-1, 1, (B, d)).astype(np.float32)
    return tf, tb, idx, bot, tuple(inv_perm)


GROUPED = {
    "interleaved": (4, 3, 3, 5, 32, 16, 16, (0, 3, 1, 4, 2, 5)),
    "rows_differ": (3, 2, 3, 4, 32, 8, 24, (4, 0, 2, 1, 3)),
    "no_fast": (3, 0, 4, 4, 32, 16, 16, (2, 0, 3, 1)),
    "no_bulk": (3, 4, 0, 4, 32, 16, 16, (1, 3, 0, 2)),
    "d128": (2, 2, 2, 3, 128, 8, 8, (3, 1, 2, 0)),
}


def _grouped_both(case, dtype, edit=None):
    tf, tb, idx, bot, inv = _grouped(len(case), *GROUPED[case])
    if edit is not None:
        edit(idx)
    jdt = _jdt(dtype)
    want = jax_ref.fused_grouped_bag_interactions_ref(
        jnp.asarray(tf, jdt), jnp.asarray(tb, jdt), jnp.asarray(idx),
        jnp.asarray(bot), inv)
    got = ref.fused_grouped_bag_interactions_ref(
        torch.from_numpy(tf).to(dtype), torch.from_numpy(tb).to(dtype),
        torch.from_numpy(idx), torch.from_numpy(bot), inv)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(GROUPED))
def test_grouped_ref_matches_reference(case, dtype):
    want, got = _grouped_both(case, dtype)
    T, d = len(GROUPED[case][-1]), GROUPED[case][4]
    assert got.shape == (GROUPED[case][0], d + (T + 1) * T // 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_grouped_ref_unpermutes_the_output():
    """Against the stacked single-group version on the tables put back in
    original order: the grouped output is in the ORIGINAL table order."""
    tf, tb, idx, bot, inv = _grouped(1, *GROUPED["interleaved"])
    both = torch.cat([torch.from_numpy(tf), torch.from_numpy(tb)])
    inv_t = torch.tensor(inv)
    stacked = both[inv_t]
    idx_orig = torch.from_numpy(idx)[:, inv_t]
    want = ref.fused_bag_interactions_ref(stacked, idx_orig,
                                          torch.from_numpy(bot))
    got = ref.fused_grouped_bag_interactions_ref(
        torch.from_numpy(tf), torch.from_numpy(tb), torch.from_numpy(idx),
        torch.from_numpy(bot), inv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _oob(idx):
    idx[0, 0, 0] = -1                 # counts from the end
    idx[1, 2, 1] = 99                 # past the table: NaN
    idx[2, 4, 0] = -30                # before the table: NaN


def test_grouped_ref_out_of_range_and_repeated_ids():
    def repeat(idx):
        idx[:, :, :] = idx[:, :, :1]
    for edit, nan in ((repeat, False), (_oob, True)):
        want, got = _grouped_both("interleaved", torch.float32, edit)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).any() == nan
        keep = ~np.isnan(want)
        np.testing.assert_allclose(got[keep], want[keep], **TOL)


def test_ops_on_cpu_take_plain_versions_and_count_nothing():
    rng = np.random.default_rng(3)
    tables, idx = _tables(rng, 2, 16, 32), _ids(rng, 3, 2, 4, 16)
    fast, bulk, fi, bi = _cached(rng, 3, 2, 4, 5, 16, 32)
    tf, tb, gidx, bot, inv = _grouped(2, *GROUPED["interleaved"])
    ops.reset_launch_counts()
    t = torch.from_numpy
    np.testing.assert_allclose(
        ops.embedding_bag(t(tables), t(idx)).numpy(),
        ref.embedding_bag_ref(t(tables), t(idx)).numpy(), **TOL)
    np.testing.assert_allclose(
        ops.cached_embedding_bag(t(fast), t(bulk), t(fi), t(bi)).numpy(),
        ref.cached_embedding_bag_ref(t(fast), t(bulk), t(fi), t(bi)).numpy(),
        **TOL)
    np.testing.assert_allclose(
        ops.fused_grouped_bag_interactions(
            t(tf), t(tb), t(gidx), t(bot), inv_perm=inv,
            pos=fused_serve.grouped_pos(inv, torch.device("cpu"))).numpy(),
        ref.fused_grouped_bag_interactions_ref(t(tf), t(tb), t(gidx), t(bot),
                                               inv).numpy(), **TOL)
    assert set(ops.launch_counts) == {
        "fused_bag_interactions", "fused_cached_bag_interactions",
        "fused_grouped_bag_interactions", "embedding_bag",
        "cached_embedding_bag", "embedding_bag_blocked", "interactions",
        "flash_attention", "flash_decode"}
    assert all(v == 0 for v in ops.launch_counts.values())


def test_grouped_pos_is_zero_then_one_plus_inv_perm():
    pos = fused_serve.grouped_pos((2, 0, 1), torch.device("cpu"))
    assert pos.dtype == torch.int32 and pos.tolist() == [0, 3, 1, 2]


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: a CPU tensor raises
    rather than running anything."""
    rng = np.random.default_rng(4)
    t = torch.from_numpy
    tables, idx = t(_tables(rng, 2, 8, 32)), t(_ids(rng, 2, 2, 3, 8))
    bot = torch.zeros((2, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bag_kernels.embedding_bag(tables, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bag_kernels.cached_embedding_bag(tables, tables, idx, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_serve.fused_grouped_bag_interactions(
            tables[:1], tables[1:], idx, bot,
            fused_serve.grouped_pos((1, 0), torch.device("cpu")))
