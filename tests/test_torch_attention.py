"""The port's attention ops (row 8, flash attention; row 9, flash decode)
against the JAX reference.

Inputs are drawn with numpy from a seed and fed to both packages. The
port's plain versions are held against the reference's Pallas kernels in
interpret mode, as tests/test_kernels.py runs them (same
parametrisations), and against `repro.kernels.ref`. Where the two JAX
functions differ -- a row whose every key is masked, a cache length of 0
-- the port follows `ref`, and the answer is pinned here. Tolerance: fp32
2e-4 and bf16 3e-2, the contract of tests/test_kernels.py; the output is
in q's dtype.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_decode import flash_decode_pallas
from repro_torch.kernels import attention, ops, ref

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jdt(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _as(dtype, *arrays):
    """The same numpy values as torch tensors and JAX arrays of ``dtype``."""
    return ([torch.from_numpy(a).to(dtype) for a in arrays],
            [jnp.asarray(a, _jdt(dtype)) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


# ------------------------------------------------------------ row 8
def _attention(B, T, S, Hq, Hkv, hd, seed, dtype):
    return _as(dtype, *_normal(seed, (B, T, Hq, hd), (B, S, Hkv, hd),
                               (B, S, Hkv, hd)))


@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd,causal,win", [
    (2, 16, 16, 4, 2, 16, True, None),
    (1, 24, 24, 4, 4, 8, True, 8),
    (2, 8, 8, 2, 1, 16, False, None),
    (1, 33, 33, 8, 2, 32, True, None),    # non-multiple of block
    (2, 16, 16, 4, 2, 16, True, 4),       # tight window
    (1, 12, 20, 4, 2, 16, True, None),    # T < S: causal is top-left
    (1, 16, 16, 4, 2, 8, False, 5),       # window without causal
    (1, 9, 9, 2, 1, 120, True, None),     # hd = 120 (h2o-danube-3-4b)
    # the edges of the card's 128-row query and key tiles
    (1, 127, 127, 2, 1, 32, True, None),
    (1, 128, 128, 2, 2, 64, True, None),
    (1, 129, 129, 2, 1, 128, False, None),
    (1, 100, 200, 2, 1, 16, True, None),  # T not a multiple, S larger
    (1, 130, 130, 2, 1, 16, True, 1),     # a window of 1
    (1, 140, 140, 2, 1, 16, True, 127),   # a window of 127
    (2, 40, 40, 4, 1, 16, True, 8),       # B = 2, Hq / Hkv = 4
    (2, 40, 40, 2, 2, 16, False, None),   # B = 2, Hq / Hkv = 1
])
def test_flash_attention_ref_matches_pallas_and_ref(B, T, S, Hq, Hkv, hd,
                                                    causal, win):
    (q, k, v), jargs = _attention(B, T, S, Hq, Hkv, hd, T + Hq,
                                  torch.float32)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=win)
    assert got.shape == (B, T, Hq, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(flash_attention_pallas(
        *jargs, causal=causal, window=win, block_q=8, block_k=8)),
        **TOL[torch.float32])
    np.testing.assert_allclose(_np(got), _np(jax_ref.flash_attention_ref(
        *jargs, causal=causal, window=win)), **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_dtypes(dtype):
    (q, k, v), jargs = _attention(1, 16, 16, 4, 2, 16, 0, dtype)
    got = ref.flash_attention_ref(q, k, v)
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), _np(flash_attention_pallas(
        *jargs, block_q=8, block_k=8)), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(jax_ref.flash_attention_ref(
        *jargs)), **TOL[dtype])


@pytest.mark.parametrize("hd", [32, 64, 120, 128])
def test_flash_attention_bf16_head_widths(hd):
    """bf16 at the head widths the card's tensor-core path pads to its 64-
    and 128-column tiles, at T = S = 129 (one row past a query tile)."""
    (q, k, v), jargs = _attention(1, 129, 129, 2, 1, hd, hd, torch.bfloat16)
    got = ref.flash_attention_ref(q, k, v, causal=True, window=100)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(flash_attention_pallas(
        *jargs, causal=True, window=100, block_q=8, block_k=8)),
        **TOL[torch.bfloat16])
    np.testing.assert_allclose(_np(got), _np(jax_ref.flash_attention_ref(
        *jargs, causal=True, window=100)), **TOL[torch.bfloat16])


@pytest.mark.parametrize("causal,Hq,Hkv", [(True, 4, 1), (False, 2, 2)])
def test_fully_masked_rows_at_tile_edges(causal, Hq, Hkv):
    """T > S across the card's 128-row tiles: with S = 129 and a window of
    4, rows t >= 132 see no key, so the reference gives them the mean of v
    over all S keys; the port gives the same, for both batch rows."""
    B, T, S, hd, win = 2, 260, 129, 16, 4
    (q, k, v), jargs = _attention(B, T, S, Hq, Hkv, hd, 12, torch.float32)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=win)
    want = jax_ref.flash_attention_ref(*jargs, causal=causal, window=win)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[torch.float32])
    mean = v.mean(dim=1).repeat_interleave(Hq // Hkv, dim=1)  # (B, Hq, hd)
    dead = got[:, S - 1 + win:]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(dead), _np(mean[:, None].expand_as(dead)),
                               **TOL[torch.float32])


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_rows_weigh_all_keys_equally(causal):
    """T > S with a window: rows t >= S - 1 + window see no key. The
    reference masks at -1e30, so they get the mean of v over all S keys,
    never NaN; the port gives the same."""
    B, T, S, Hq, Hkv, hd, win = 1, 20, 8, 4, 2, 8, 4
    (q, k, v), jargs = _attention(B, T, S, Hq, Hkv, hd, 11, torch.float32)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=win)
    want = jax_ref.flash_attention_ref(*jargs, causal=causal, window=win)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[torch.float32])
    dead = got[0, S - 1 + win:]                                # (T', Hq, hd)
    mean = v[0].mean(dim=0).repeat_interleave(Hq // Hkv, dim=0)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(dead), _np(mean.expand_as(dead)),
                               **TOL[torch.float32])


# ------------------------------------------------------------ row 9
def _decode(B, S, Hq, Hkv, hd, seed, dtype):
    return _as(dtype, *_normal(seed, (B, Hq, hd), (B, S, Hkv, hd),
                               (B, S, Hkv, hd)))


@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [
    (2, 32, 4, 2, 16),
    (3, 64, 8, 8, 8),
    (1, 48, 8, 2, 32),
    (2, 100, 4, 1, 16),            # ragged S vs block
])
def test_flash_decode_ref_matches_pallas_and_ref(B, S, Hq, Hkv, hd):
    (q, kc, vc), jargs = _decode(B, S, Hq, Hkv, hd, S, torch.float32)
    lens = np.random.default_rng(S).integers(1, S + 1, B)
    got = ref.flash_decode_ref(q, kc, vc, torch.from_numpy(lens))
    assert got.shape == (B, Hq, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(flash_decode_pallas(
        *jargs, jnp.asarray(lens), block_k=16)), **TOL[torch.float32])
    np.testing.assert_allclose(_np(got), _np(jax_ref.flash_decode_ref(
        *jargs, jnp.asarray(lens))), **TOL[torch.float32])


def test_flash_decode_bf16_keeps_q_dtype():
    (q, kc, vc), jargs = _decode(2, 40, 8, 2, 16, 1, torch.bfloat16)
    lens = np.array([17, 40])
    got = ref.flash_decode_ref(q, kc, vc, torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(flash_decode_pallas(
        *jargs, jnp.asarray(lens), block_k=8)), **TOL[torch.bfloat16])


def test_flash_decode_respects_lengths():
    """Entries beyond `lengths` must not influence the result."""
    (q, kc, vc), _ = _decode(1, 32, 2, 2, 8, 7, torch.float32)
    lens = torch.tensor([10])
    out1 = ref.flash_decode_ref(q, kc, vc, lens)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, 10:], vc2[:, 10:] = 1e9, -1e9
    np.testing.assert_allclose(_np(ref.flash_decode_ref(q, kc2, vc2, lens)),
                               _np(out1), rtol=1e-6)


def test_flash_decode_length_zero_and_above_cache():
    """A length of 0 masks every key, so the reference answers the mean of
    v over all S rows (its Pallas kernel answers 0); a length above S acts
    as S. The port follows the reference."""
    B, S, Hq, Hkv, hd = 3, 24, 4, 2, 8
    (q, kc, vc), jargs = _decode(B, S, Hq, Hkv, hd, 3, torch.float32)
    lens = np.array([0, S + 5, S])
    got = ref.flash_decode_ref(q, kc, vc, torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), _np(jax_ref.flash_decode_ref(
        *jargs, jnp.asarray(lens))), **TOL[torch.float32])
    mean = vc[0].mean(dim=0).repeat_interleave(Hq // Hkv, dim=0)
    np.testing.assert_allclose(_np(got[0]), _np(mean), **TOL[torch.float32])
    assert np.abs(_np(got[0])).max() > 0.05
    at_s = ref.flash_decode_ref(q, kc, vc, torch.tensor([0, S, S]))
    np.testing.assert_allclose(_np(got[1]), _np(at_s[1]), rtol=1e-6)


# ------------------------------------------------------------ dispatch
def test_ops_on_cpu_take_plain_versions_and_count_nothing():
    (q, k, v), jargs = _attention(1, 12, 12, 4, 2, 16, 5, torch.float32)
    (dq, kc, vc), jdec = _decode(2, 20, 4, 2, 16, 5, torch.float32)
    lens = np.array([7, 20])
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True, window=5)
    np.testing.assert_allclose(_np(got), _np(jax_ops.flash_attention(
        *jargs, causal=True, window=5, block_q=4, block_k=4)),
        **TOL[torch.float32])
    got = ops.flash_decode(dq, kc, vc, torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), _np(jax_ops.flash_decode(
        *jdec, jnp.asarray(lens), block_k=4)), **TOL[torch.float32])
    assert ops.launch_counts["flash_attention"] == 0
    assert ops.launch_counts["flash_decode"] == 0
    assert all(n == 0 for n in ops.launch_counts.values())


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: a CPU tensor raises
    rather than running anything."""
    (q, k, v), _ = _attention(1, 4, 4, 2, 1, 8, 0, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.flash_attention(q, k, v)
    (q, kc, vc), _ = _decode(1, 4, 2, 1, 8, 0, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.flash_decode(q, kc, vc, torch.tensor([3]))
