"""The port's tiered embedding runtime against repro.core.tiered_embedding.

Both run on the same numpy arrays. The index structures (row counts,
row_map, hot_rows, translated ids) must be EXACTLY equal; pools and
updated rows fp32 allclose at rtol = atol = 1e-5. The reference's lookups
reach its Pallas kernels, which run in interpret mode here, so the sizes
are tiny.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiered_embedding as jte
from repro.core.planner import TablePlacement as JaxPlacement
from repro_torch.configs import get_dlrm
from repro_torch.core import tiered_embedding as te
from repro_torch.core.planner import TablePlacement
from repro_torch.kernels import ref

TOL = dict(rtol=1e-5, atol=1e-5)
T, R, D, B, L = 3, 16, 32, 3, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    tables = rng.uniform(-1, 1, (T, R, D)).astype(np.float32)
    freq = rng.integers(0, 4, (T, R)).astype(np.int32)   # many ties
    idx = rng.integers(0, R, (B, T, L)).astype(np.int32)
    idx[0, 0, :] = idx[0, 0, 0]                          # repeated ids
    return tables, freq, idx


def _stores(hot, placed, seed=0, dtype=torch.float32):
    tables, freq, idx = _arrays(seed)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = [JaxPlacement(1, "fast", "table_wise", 0)] if placed else None
    tp = [TablePlacement(1, "fast", "table_wise", 0)] if placed else None
    want = jte.build_tiered_tables(jnp.asarray(tables, jdt),
                                   jnp.asarray(freq), hot, jp)
    got = te.build_tiered_tables(torch.from_numpy(tables).to(dtype),
                                 torch.from_numpy(freq), hot, tp)
    return want, got, tables, freq, idx


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def test_accumulate_row_freq_counts_exactly():
    _, _, idx = _arrays()
    want = jte.accumulate_row_freq(jnp.zeros((T, R), jnp.int32),
                                   jnp.asarray(idx))
    counts = torch.zeros((T, R), dtype=torch.int32)
    got = te.accumulate_row_freq(counts, torch.from_numpy(idx))
    assert got is counts
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_measure_row_freq_counts_every_lookup():
    cfg = get_dlrm("dlrm-rm2-small-unsharded").reduced()
    counts = te.measure_row_freq(cfg, alpha=1.05, n_batches=3,
                                 device="cpu")
    assert counts.dtype == torch.int32
    assert counts.shape == (cfg.num_tables, cfg.rows_per_table)
    per_table = 3 * cfg.batch_size * cfg.lookups_per_table
    assert counts.sum(dim=1).tolist() == [per_table] * cfg.num_tables


@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("hot", [0, 3, 16])
def test_build_and_translate_equal_reference(hot, placed):
    want, got, _, _, idx = _stores(hot, placed)
    for name in ("fast", "bulk", "row_map", "hot_rows"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(want, name)), err_msg=name)
    assert (got.hot_slots, got.rows_per_table, got.num_tables) == \
        (want.hot_slots, want.rows_per_table, want.num_tables)
    ti = torch.from_numpy(idx)
    for a, b in zip(te.translate_indices(got, ti),
                    jte.translate_indices(want, jnp.asarray(idx))):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        te.translate_indices_packed(got, ti).numpy(),
        np.asarray(jte.translate_indices_packed(want, jnp.asarray(idx))))
    np.testing.assert_array_equal(
        te.hit_mask(got, ti).numpy(),
        np.asarray(jte.hit_mask(want, jnp.asarray(idx))))
    np.testing.assert_array_equal(_np(te.packed_tables(got)),
                                  _np(jte.packed_tables(want)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("hot", [0, 5, 16])
def test_tiered_pools_match_reference(hot, placed, dtype):
    want, got, tables, _, idx = _stores(hot, placed, seed=hot, dtype=dtype)
    ti, ji = torch.from_numpy(idx), jnp.asarray(idx)
    exact = ref.embedding_bag_ref(torch.from_numpy(tables).to(dtype), ti)
    pooled = te.tiered_embedding_bag(got, ti)
    assert pooled.dtype == torch.float32 and pooled.shape == (B, T, D)
    np.testing.assert_allclose(pooled.numpy(),
                               np.asarray(jte.tiered_embedding_bag(want, ji)),
                               **TOL)
    np.testing.assert_allclose(pooled.numpy(), exact.numpy(), **TOL)
    packed = te.tiered_embedding_bag_packed(te.packed_tables(got), got, ti)
    np.testing.assert_allclose(
        packed.numpy(), np.asarray(jte.tiered_embedding_bag_packed(
            jte.packed_tables(want), want, ji)), **TOL)
    np.testing.assert_allclose(packed.numpy(), exact.numpy(), **TOL)


@pytest.mark.parametrize("hot", [0, 4, 16])
def test_expected_hit_ratio_equals_reference(hot):
    want, got, _, freq, _ = _stores(hot, placed=False)
    assert te.expected_hit_ratio(torch.from_numpy(freq), got) == \
        pytest.approx(jte.expected_hit_ratio(jnp.asarray(freq), want),
                      rel=1e-12)


@pytest.mark.parametrize("placed", [False, True])
def test_row_update_flush_and_refresh_match_reference(placed):
    want, got, _, freq, idx = _stores(4, placed, seed=7)
    g = np.random.default_rng(8).standard_normal(
        (B, T, L, D)).astype(np.float32)
    want2 = jte.tiered_row_update(want, jnp.asarray(idx), jnp.asarray(g), 0.1)
    got2 = te.tiered_row_update(got, torch.from_numpy(idx),
                                torch.from_numpy(g), 0.1)
    np.testing.assert_array_equal(got.fast.numpy(), np.asarray(want.fast))
    for name in ("fast", "bulk"):
        np.testing.assert_allclose(getattr(got2, name).numpy(),
                                   np.asarray(getattr(want2, name)), **TOL)
    np.testing.assert_allclose(te.flush_to_bulk(got2).numpy(),
                               np.asarray(jte.flush_to_bulk(want2)), **TOL)
    new_freq = freq[:, ::-1].copy() + 1
    want3 = jte.lfu_refresh(want2, jnp.asarray(new_freq))
    got3 = te.lfu_refresh(got2, torch.from_numpy(new_freq))
    for name in ("row_map", "hot_rows"):
        np.testing.assert_array_equal(getattr(got3, name).numpy(),
                                      np.asarray(getattr(want3, name)))
    for name in ("fast", "bulk"):
        np.testing.assert_allclose(getattr(got3, name).numpy(),
                                   np.asarray(getattr(want3, name)), **TOL)
