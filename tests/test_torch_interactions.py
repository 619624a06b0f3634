"""The port's interaction op (row 7) and two-tier fused serve op (row 2)
against the JAX reference.

Inputs are drawn with numpy from a seed and fed to both packages.
`interactions_ref` is held against the reference's Pallas kernel in
interpret mode (as tests/test_kernels.py runs it) and against its ref;
`fused_cached_bag_interactions_ref` against
`repro.kernels.ref.fused_cached_bag_interactions_ref`, since the Pallas
kernel of the fused family cannot trace on this jax
(`src/repro/kernels/fused_serve.py:113`). Tolerance: fp32 allclose at
rtol = atol = 1e-5, the contract of tests/test_kernels.py; bf16 inputs are
rounded once from the same fp32 values in both packages and summed in fp32
by both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.interactions import interactions_pallas
from repro_torch.core import tiered_embedding as te
from repro_torch.kernels import feature_interactions, fused_serve, ops, ref

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


def _pair_inputs(B, T, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, d)).astype(np.float32),
            rng.standard_normal((B, T, d)).astype(np.float32))


# -------------------------------------------------------------- row 7
@pytest.mark.parametrize("pooled_dtype", DTYPES)
@pytest.mark.parametrize("B,T,d", [(8, 4, 32), (5, 40, 128), (3, 40, 32),
                                   (1, 2, 8)])
def test_interactions_ref_matches_pallas_and_ref(B, T, d, pooled_dtype):
    bot, pooled = _pair_inputs(B, T, d, seed=B + T)
    jp = jnp.asarray(pooled, _jdt(pooled_dtype))
    got = ref.interactions_ref(torch.from_numpy(bot),
                               torch.from_numpy(pooled).to(pooled_dtype))
    assert got.shape == (B, d + (T + 1) * T // 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(interactions_pallas(
        jnp.asarray(bot), jp, block_b=4, interpret=True)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref.interactions_ref(jnp.asarray(bot), jp)), **TOL)


@pytest.mark.parametrize("bot_dtype,pooled_dtype",
                         [(a, b) for a in DTYPES for b in DTYPES])
def test_interactions_ref_mixed_dtypes(bot_dtype, pooled_dtype):
    """bot_out and pooled may each be bf16: both are widened exactly, and
    bot_out's first d columns come out as its fp32 values."""
    bot, pooled = _pair_inputs(6, 5, 16, seed=3)
    got = ref.interactions_ref(torch.from_numpy(bot).to(bot_dtype),
                               torch.from_numpy(pooled).to(pooled_dtype))
    want = jax_ref.interactions_ref(jnp.asarray(bot, _jdt(bot_dtype)),
                                    jnp.asarray(pooled, _jdt(pooled_dtype)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        got[:, :16].numpy(), torch.from_numpy(bot).to(bot_dtype).float())


def test_interactions_excludes_diagonal_and_duplicates():
    """Paper Sec. III-D: the strict lower triangle only, (T+1)T/2 entries."""
    B, T, d = 2, 3, 4
    got = ref.interactions_ref(torch.ones(B, d), torch.ones(B, T, d))
    assert got.shape == (B, d + T * (T + 1) // 2)
    np.testing.assert_allclose(got[:, d:].numpy(),
                               d * np.ones((B, T * (T + 1) // 2)))


# -------------------------------------------------------------- row 2
def _store(rng, T, S, R, d, pad_rows=0.0):
    """fast (T, S+1, d) hot rows + miss slot S, bulk (T, R+1, d) + hit slot
    R; the pad slots hold ``pad_rows`` (zeros as the store builds them)."""
    fast = rng.uniform(-1, 1, (T, S + 1, d)).astype(np.float32)
    bulk = rng.uniform(-1, 1, (T, R + 1, d)).astype(np.float32)
    fast[:, S] = pad_rows
    bulk[:, R] = pad_rows
    return fast, bulk


def _tier_ids(rng, B, T, L, S, R, hot_frac):
    hot = rng.uniform(size=(B, T, L)) < hot_frac
    fi = np.where(hot, rng.integers(0, S, (B, T, L)), S).astype(np.int32)
    bi = np.where(hot, R, rng.integers(0, R, (B, T, L))).astype(np.int32)
    return fi, bi


def _cached_both(fast, bulk, fi, bi, bot, dtype):
    """(JAX reference output, port plain output) as numpy fp32."""
    jdt = _jdt(dtype)
    want = jax_ref.fused_cached_bag_interactions_ref(
        jnp.asarray(fast, jdt), jnp.asarray(bulk, jdt), jnp.asarray(fi),
        jnp.asarray(bi), jnp.asarray(bot))
    got = ref.fused_cached_bag_interactions_ref(
        torch.from_numpy(fast).to(dtype), torch.from_numpy(bulk).to(dtype),
        torch.from_numpy(fi), torch.from_numpy(bi), torch.from_numpy(bot))
    assert got.dtype == torch.float32
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hot_frac", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("B,T,L,d,S,R", [(3, 2, 4, 32, 4, 16),
                                         (2, 5, 3, 128, 2, 8),
                                         (1, 1, 1, 8, 1, 1)])
def test_fused_cached_ref_matches_jax(B, T, L, d, S, R, hot_frac, dtype):
    rng = np.random.default_rng(B * 10 + T)
    fast, bulk = _store(rng, T, S, R, d)
    fi, bi = _tier_ids(rng, B, T, L, S, R, hot_frac)
    bot = rng.uniform(-1, 1, (B, d)).astype(np.float32)
    want, got = _cached_both(fast, bulk, fi, bi, bot, dtype)
    assert got.shape == (B, d + (T + 1) * T // 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_cached_reads_and_sums_nonzero_pad_rows():
    """Both rows of every lookup are read and summed: a non-zero pad slot
    counts, as in the reference (nothing assumes it is zero)."""
    rng = np.random.default_rng(5)
    B, T, L, d, S, R = 4, 3, 5, 32, 3, 10
    fast, bulk = _store(rng, T, S, R, d, pad_rows=0.25)
    fi, bi = _tier_ids(rng, B, T, L, S, R, 0.5)
    bot = rng.uniform(-1, 1, (B, d)).astype(np.float32)
    want, got = _cached_both(fast, bulk, fi, bi, bot, torch.float32)
    np.testing.assert_allclose(got, want, **TOL)
    zeroed = fast.copy(), bulk.copy()
    zeroed[0][:, S], zeroed[1][:, R] = 0.0, 0.0
    _, without = _cached_both(*zeroed, fi, bi, bot, torch.float32)
    assert not np.allclose(got, without, **TOL)


def test_fused_cached_out_of_range_ids_follow_jnp_take():
    rng = np.random.default_rng(6)
    B, T, L, d, S, R = 3, 2, 3, 16, 2, 6
    fast, bulk = _store(rng, T, S, R, d)
    fi, bi = _tier_ids(rng, B, T, L, S, R, 0.5)
    fi[0, 0, 0], bi[1, 1, 1], bi[2, 0, 2] = -1, R + 1, -(R + 2)
    want, got = _cached_both(fast, bulk, fi, bi, np.ones((B, d), np.float32),
                             torch.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).any() and np.isnan(got[2]).any()
    np.testing.assert_allclose(got[0], want[0], **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_cached_rare_slot_pairs(dtype):
    """Hand-made (fast, bulk) slot pairs for every branch of the card's
    two-tier pool, on non-zero pad rows: one real row beside the other
    tier's pad (both ways), both pads, both rows real, slots counted from
    the end (pads and real rows), and in samples 1-3 a slot out of range
    in either tier, which makes the reference's pool NaN."""
    rng = np.random.default_rng(9)
    B, T, d, S, R = 4, 3, 16, 3, 10
    fast, bulk = _store(rng, T, S, R, d, pad_rows=0.5)
    pairs = [(1, R), (S, 5), (S, R), (2, 7), (-1, -1), (-2, -(R + 1)),
             (-(S + 1), R), (0, R - 1)]
    L = len(pairs)
    fi = np.tile(np.array([f for f, _ in pairs], np.int32), (B, T, 1))
    bi = np.tile(np.array([b for _, b in pairs], np.int32), (B, T, 1))
    fi[1, 0, 3], bi[2, 2, 1], fi[3, 1, 0] = S + 1, -(R + 2), -(S + 2)
    bot = rng.uniform(-1, 1, (B, d)).astype(np.float32)
    want, got = _cached_both(fast, bulk, fi, bi, bot, dtype)
    assert got.shape == (B, d + (T + 1) * T // 2)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert not np.isnan(got[0]).any() and np.isnan(got[1:]).any(axis=1).all()
    np.testing.assert_allclose(got[~np.isnan(want)], want[~np.isnan(want)],
                               **TOL)


def test_store_from_tables_equals_fused_bag():
    """A store built from the tables by the tiered runtime and looked up
    through the two-tier op gives the single-tier op's answer on the
    tables themselves: the store is exact."""
    rng = np.random.default_rng(7)
    B, T, L, d, R = 5, 4, 6, 32, 64
    tables = rng.uniform(-1, 1, (T, R, d)).astype(np.float32) / np.sqrt(R)
    idx = rng.integers(0, R, (B, T, L)).astype(np.int32)
    bot = rng.uniform(-1, 1, (B, d)).astype(np.float32)
    freq = rng.integers(0, 5, (T, R))
    store = te.build_tiered_tables(torch.from_numpy(tables),
                                   torch.from_numpy(freq), 16)
    fi, bi = te.translate_indices(store, torch.from_numpy(idx))
    assert 0 < int((fi < 16).sum()) < fi.numel()       # both tiers are read
    got = ref.fused_cached_bag_interactions_ref(store.fast, store.bulk, fi,
                                                bi, torch.from_numpy(bot))
    want = jax_ref.fused_bag_interactions_ref(
        jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(bot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jax_cached = jax_ops.fused_cached_bag_interactions(
        *(jnp.asarray(x.numpy()) for x in (store.fast, store.bulk, fi, bi)),
        jnp.asarray(bot))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_cached), **TOL)


# -------------------------------------------------------------- dispatch
def test_ops_on_cpu_take_plain_versions_and_count_nothing():
    rng = np.random.default_rng(8)
    bot, pooled = _pair_inputs(4, 3, 16, seed=8)
    fast, bulk = _store(rng, 3, 2, 5, 16)
    fi, bi = _tier_ids(rng, 4, 3, 2, 2, 5, 0.5)
    ops.reset_launch_counts()
    got = ops.interactions(torch.from_numpy(bot), torch.from_numpy(pooled))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ops.interactions(
        jnp.asarray(bot), jnp.asarray(pooled))), **TOL)
    got = ops.fused_cached_bag_interactions(
        *(torch.from_numpy(x) for x in (fast, bulk, fi, bi, bot)))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ops.fused_cached_bag_interactions(
            *(jnp.asarray(x) for x in (fast, bulk, fi, bi, bot)))), **TOL)
    assert ops.launch_counts["interactions"] == 0
    assert ops.launch_counts["fused_cached_bag_interactions"] == 0
    assert all(v == 0 for v in ops.launch_counts.values())


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: a CPU tensor raises
    rather than running anything."""
    bot, pooled = (torch.from_numpy(a) for a in _pair_inputs(2, 2, 8, 0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        feature_interactions.interactions(bot, pooled)
    rng = np.random.default_rng(0)
    fast, bulk = (torch.from_numpy(a) for a in _store(rng, 2, 2, 3, 8))
    fi, bi = (torch.from_numpy(a) for a in _tier_ids(rng, 2, 2, 2, 2, 3, .5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_serve.fused_cached_bag_interactions(fast, bulk, fi, bi, bot)
