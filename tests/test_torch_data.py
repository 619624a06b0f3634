"""repro_torch.data.recsys against repro.data.recsys.

``zipf_from_uniform`` is fed the very uniforms the reference draws
(``jax.random.uniform(key, shape, minval=1e-9)``, as in
``repro/data/recsys.py``). At alpha 0 the ids must be identical. On the
power-law branches float32 ``pow``/``exp`` may differ by an ulp between
the two libraries, and which vectorised path each library takes depends on
the host's CPU, so the share of ids that move is not fixed. There the hash
is undone on both sides (its odd multiplier has an inverse mod the
power-of-two row count), every rank must lie within 1 of the reference's,
and every rank that differs must be one whose exact (float64) value lies
within 2 float32 ulps of an integer: only rounding can move it. The uint32
row hash is exact.
"""
import math

import jax
import numpy as np
import pytest
import torch

import repro.data as jax_data
import repro_torch.data as data
from repro.configs.registry import get_dlrm as jax_get_dlrm
from repro.data import recsys as jax_recsys
from repro_torch.configs import get_dlrm
from repro_torch.data import recsys

N_ROWS = 4_194_304                 # the full-width table: the hash wraps


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unhash(ids: np.ndarray, n_rows: int) -> np.ndarray:
    """row id -> rank: the inverse of ``row_hash`` for a power-of-two
    ``n_rows`` (the multiplier is odd, so it is invertible mod n_rows)."""
    assert n_rows & (n_rows - 1) == 0
    inv = pow(2654435761, -1, n_rows)
    return (ids.astype(np.int64) * inv) % n_rows


def _exact_rank_value(u: np.ndarray, n_rows: int, alpha: float):
    """The value whose truncation is the rank (plus 1 on the alpha 1
    branch, whose -1 follows the truncation): the float32 products and
    sums both libraries round alike, then ``exp``/``pow`` in float64."""
    f32 = np.float32
    a1 = 1.0 - alpha
    if abs(a1) < 1e-6:
        x = u.astype(f32) * f32(math.log(n_rows))
        return np.exp(x.astype(np.float64))
    hi = float(n_rows) ** a1
    base = u.astype(f32) * f32(hi - 1.0) + f32(1.0)
    return np.power(base.astype(np.float64),
                    np.float64(f32(1.0 / a1))) - 1.0


@pytest.mark.parametrize("n_rows", [128, N_ROWS])
@pytest.mark.parametrize("alpha", [0.0, 1.0, 1.05])
def test_zipf_matches_reference(alpha, n_rows):
    key = jax.random.PRNGKey(11)
    shape = (64, 8, 16)
    u = np.asarray(jax.random.uniform(key, shape, minval=1e-9))
    want = np.asarray(jax_recsys._zipf_indices(key, shape, n_rows, alpha))
    got = recsys.zipf_from_uniform(torch.from_numpy(u), n_rows, alpha)
    assert got.dtype == torch.int32
    if alpha == 0.0:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    r_got, r_want = _unhash(got.numpy(), n_rows), _unhash(want, n_rows)
    assert np.abs(r_got - r_want).max() <= 1
    moved = r_got != r_want
    v = _exact_rank_value(u[moved], n_rows, alpha)
    ulp = np.spacing(np.abs(v).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(v - np.round(v)) <= 2 * ulp), v[
        np.abs(v - np.round(v)) > 2 * ulp]


def test_row_hash_is_uint32_exact():
    ranks = np.array([0, 1, 2, 1617, N_ROWS - 1, 2**31 - 1], np.int64)
    want = ((ranks.astype(np.uint32) * np.uint32(2654435761))
            % np.uint32(N_ROWS)).astype(np.int32)
    got = recsys.row_hash(torch.from_numpy(ranks), N_ROWS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_is_a_pure_function_of_seed_and_step():
    cfg = get_dlrm("dlrm-rm2-small-unsharded").reduced()
    a = recsys.make_recsys_batch(cfg, 3, seed=1, alpha=1.05, device="cpu")
    b = recsys.make_recsys_batch(cfg, 3, seed=1, alpha=1.05, device="cpu")
    c = recsys.make_recsys_batch(cfg, 4, seed=1, alpha=1.05, device="cpu")
    for k in ("dense", "indices", "labels"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["indices"], c["indices"])
    B, T, L = cfg.batch_size, cfg.num_tables, cfg.lookups_per_table
    assert a["dense"].shape == (B, cfg.num_dense)
    assert a["dense"].dtype == torch.float32
    assert a["indices"].shape == (B, T, L)
    assert a["indices"].dtype == torch.int32
    assert 0 <= a["indices"].min() and a["indices"].max() < cfg.rows_per_table
    assert set(a["labels"].unique().tolist()) <= {0.0, 1.0}


def test_teacher_follows_reference_formula():
    """The sparse term of the teacher is the reference's, given the ids."""
    cfg = get_dlrm("dlrm-rm2-small-unsharded").reduced()
    batch = recsys.make_recsys_batch(cfg, 0, device="cpu")
    zero = torch.zeros_like(batch["dense"])
    p = recsys.teacher_click_probs(cfg, zero, batch["indices"])
    ids = batch["indices"][:, :, 0].numpy()
    sig = recsys.SPARSE_SIGNAL * ((ids % 7).astype(np.float32) - 3.0).mean(1)
    np.testing.assert_allclose(p.numpy(), 1 / (1 + np.exp(-2 * sig)),
                               rtol=1e-6)
    assert recsys.SPARSE_SIGNAL == jax_recsys.SPARSE_SIGNAL


def test_data_exports_the_reference_names():
    for name in ("RecSysBatch", "make_recsys_batch", "recsys_batch_iterator"):
        assert getattr(data, name) is getattr(recsys, name)
        assert hasattr(jax_data, name)
    assert data.RecSysBatch.__origin__ is jax_data.RecSysBatch.__origin__


@pytest.mark.parametrize("start", [0, 5])
def test_batch_iterator_follows_the_reference(start):
    """Both iterators yield ``make_recsys_batch`` at start_step, +1, ...:
    the same keys, shapes and dtypes (through numpy), each batch its own
    package's batch of that step."""
    name = "dlrm-rm2-small-unsharded"
    cfg, jcfg = get_dlrm(name).reduced(), jax_get_dlrm(name).reduced()
    it = data.recsys_batch_iterator(cfg, 2, 1.05, start, 8, device="cpu")
    jit = jax_data.recsys_batch_iterator(jcfg, 2, 1.05, start, 8)
    for k in range(3):
        got, want = next(it), next(jit)
        assert sorted(got) == sorted(want)
        for key in want:
            g, w = got[key].numpy(), np.asarray(want[key])
            assert g.shape == w.shape and g.dtype == w.dtype, key
        again = recsys.make_recsys_batch(cfg, start + k, 2, 1.05, 8, "cpu")
        jagain = jax_recsys.make_recsys_batch(jcfg, start + k, 2, 1.05, 8)
        for key in want:
            assert torch.equal(got[key], again[key])
            np.testing.assert_array_equal(np.asarray(want[key]),
                                          np.asarray(jagain[key]))
