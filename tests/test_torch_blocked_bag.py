"""The blocked embedding bag's plain version against the JAX reference.

``ref.embedding_bag_blocked_ref`` and ``ref.blocked_stream_aligned`` are
held against ``repro.kernels.embedding_bag.embedding_bag_pallas_blocked``
in interpret mode and its ``blocked_stream_aligned`` on aligned,
unsorted, shuffled-within-a-block and mixed streams. A block that passes
the reference's predicate but reaches past the table is held against
``repro.kernels.ref.embedding_bag_ref`` (the port counts it as not
aligned). Inputs are numpy arrays from a seed. Tolerance: fp32 allclose
at rtol = atol = 1e-5 (tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.embedding_bag import (blocked_stream_aligned,
                                         embedding_bag_pallas_blocked)
from repro_torch.kernels import embedding_bags as bag_kernels
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)
T, R, d, B, L = 2, 64, 32, 3, 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (T, R, d)).astype(np.float32)


def _aligned(seed, lblk):
    """Every L-block the rows [k*lblk, (k+1)*lblk) of a random block k."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, R // lblk, (B, T, L // lblk))
    return (blk[..., None] * lblk + np.arange(lblk)).reshape(
        B, T, L).astype(np.int32)


def _unsorted(ids, lblk):
    rng = np.random.default_rng(1)
    return rng.permutation(ids.reshape(-1)).reshape(ids.shape)


def _shuffled_in_block(ids, lblk):
    out = ids.copy()
    out[1, 0, lblk:2 * lblk] = out[1, 0, lblk:2 * lblk][::-1]
    return out


def _mixed(ids, lblk):
    """One misaligned block (base off by one) in an aligned batch."""
    out = ids.copy()
    out[2, 1, :lblk] = (out[2, 1, :lblk] + 1) % R
    return out


STREAMS = {"aligned": lambda ids, lblk: ids, "unsorted": _unsorted,
           "shuffled_in_block": _shuffled_in_block, "mixed": _mixed}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lblk", [4, 8])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_blocked_ref_matches_pallas_blocked(stream, lblk, dtype):
    tables = _tables(lblk)
    ids = STREAMS[stream](_aligned(lblk + 10, lblk), lblk)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(embedding_bag_pallas_blocked(
        jnp.asarray(tables, jdt), jnp.asarray(ids), lblk=lblk,
        interpret=True))
    t_ids = torch.from_numpy(ids)
    got = ref.embedding_bag_blocked_ref(torch.from_numpy(tables).to(dtype),
                                        t_ids, lblk)
    assert got.dtype == torch.float32 and got.shape == (B, T, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    aligned = bool(blocked_stream_aligned(jnp.asarray(ids), lblk))
    assert aligned == (stream == "aligned")
    assert bool(ref.blocked_stream_aligned(t_ids, lblk)) == aligned
    assert bool(ref.blocked_stream_aligned(t_ids, lblk, R)) == aligned


def test_blocked_ref_aligned_branch_is_block_sums():
    """On an aligned stream the plain version is the sum of each block's
    rows, then the block sums in L order; it agrees with the per-row bag."""
    tables = torch.from_numpy(_tables(3))
    ids = torch.from_numpy(_aligned(4, 8))
    blocks = ids.reshape(B, T, L // 8, 8)[..., 0].long()
    want = torch.zeros((B, T, d))
    for b in range(B):
        for t in range(T):
            for base in blocks[b, t].tolist():
                want[b, t] += tables[t, base:base + 8].sum(dim=0)
    got = ref.embedding_bag_blocked_ref(tables, ids, 8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               ref.embedding_bag_ref(tables, ids).numpy(),
                               **TOL)


def test_block_past_the_table_is_not_aligned():
    """Base a multiple of lblk, consecutive ids past R: the reference's
    predicate passes it, the port's (given R) does not, and the answer is
    embedding_bag_ref's (NaN where an id is past the table)."""
    tables = _tables(5)
    ids = _aligned(6, 4)
    ids[0, 1, 4:8] = np.arange(R, R + 4)
    assert bool(blocked_stream_aligned(jnp.asarray(ids), 4))
    t_ids = torch.from_numpy(ids)
    assert bool(ref.blocked_stream_aligned(t_ids, 4))
    assert not bool(ref.blocked_stream_aligned(t_ids, 4, R))
    want = np.asarray(jax_ref.embedding_bag_ref(jnp.asarray(tables),
                                                jnp.asarray(ids)))
    got = ref.embedding_bag_blocked_ref(torch.from_numpy(tables), t_ids, 4)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want[0, 1]).all()
    keep = ~np.isnan(want)
    np.testing.assert_allclose(got.numpy()[keep], want[keep], **TOL)


def test_negative_aligned_block_takes_the_per_row_branch():
    """-lblk .. -1 pass the reference's predicate (-4 % 4 == 0); the port
    pools them row by row, as jnp.take reads them (from the table's end)."""
    tables = torch.from_numpy(_tables(7))
    ids = torch.from_numpy(_aligned(8, 4))
    ids[1, 0, :4] = torch.arange(-4, 0)
    assert bool(ref.blocked_stream_aligned(ids, 4))
    assert not bool(ref.blocked_stream_aligned(ids, 4, R))
    got = ref.embedding_bag_blocked_ref(tables, ids, 4)
    np.testing.assert_allclose(got.numpy(),
                               ref.embedding_bag_ref(tables, ids).numpy(),
                               **TOL)
    np.testing.assert_allclose(got[1, 0].numpy(),
                               (tables[0, R - 4:].sum(0)
                                + tables[0, ids[1, 0, 4:].long()].sum(0))
                               .numpy(), **TOL)


@pytest.mark.parametrize("lblk", [3, 0])
def test_lookups_not_a_multiple_of_lblk_raise(lblk):
    tables = torch.from_numpy(_tables(9))
    ids = torch.from_numpy(_aligned(9, 4))
    with pytest.raises(ValueError, match="lblk"):
        ref.embedding_bag_blocked_ref(tables, ids, lblk)
    with pytest.raises(ValueError, match="lblk"):
        ops.embedding_bag_blocked(tables, ids, lblk=lblk)
    with pytest.raises(ValueError, match="lblk"):
        bag_kernels.check_lblk("embedding_bag_blocked", L, lblk)


def test_ops_on_cpu_take_the_plain_version_and_count_nothing():
    tables = torch.from_numpy(_tables(11))
    ops.reset_launch_counts()
    for ids in (_aligned(12, 8), _mixed(_aligned(12, 8), 8)):
        t_ids = torch.from_numpy(ids)
        np.testing.assert_allclose(
            ops.embedding_bag_blocked(tables, t_ids, lblk=8).numpy(),
            ref.embedding_bag_blocked_ref(tables, t_ids, 8).numpy(), **TOL)
    assert ops.launch_counts["embedding_bag_blocked"] == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    tables = torch.from_numpy(_tables(13))
    ids = torch.from_numpy(_aligned(13, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bag_kernels.embedding_bag_blocked(tables, ids, lblk=8)
