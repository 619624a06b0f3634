"""The port's LM layers (``repro_torch.models.layers``) against the JAX
reference's (``repro.models.layers``) on the same numpy inputs.

Tolerances. Modules fed fp32 inputs: rtol = atol = 1e-5 (fp32 summation
order moves results by ~1e-7 at these widths). Attention, which the port
computes through row 8 / row 9 (their plain versions here) and the
reference in jnp (``blockwise_attention``'s online softmax,
``decode_attention``): 2e-4, the flash contract of ROADMAP.md. The configs
are the architectures' ``reduced()`` ones, h2o-danube-3-4b's (sliding
window 16) among them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import layers as JL
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)
ATTN = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    jc, tc = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    if kw:
        jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    return jc, tc


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """A numpy tree as (JAX tree, torch tree)."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def _attn_params(rng, cfg, bias=False):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {"wq": _normal(rng, d, cfg.n_heads * hd, scale=d ** -0.5),
         "wk": _normal(rng, d, cfg.n_kv_heads * hd, scale=d ** -0.5),
         "wv": _normal(rng, d, cfg.n_kv_heads * hd, scale=d ** -0.5),
         "wo": _normal(rng, cfg.n_heads * hd, d, scale=0.1)}
    if bias:
        for n, h in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                     ("bv", cfg.n_kv_heads)):
            p[n] = _normal(rng, h * hd, scale=0.1)
    return p


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------------- norm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    """fp32 variance, the cast back before the weight: bf16 inputs give the
    reference's bf16 values."""
    rng = np.random.default_rng(0)
    x, w = _normal(rng, 3, 5, 64), _normal(rng, 64)
    got = L.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(w), 1e-5)
    want = JL.rms_norm(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w),
                       1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -8, atol=2 ** -8)
    _close(got, np.asarray(want.astype(jnp.float32)), tol)


# ------------------------------------------------------------------- rope
@pytest.mark.parametrize("theta", [10_000.0, 0.0])
def test_apply_rope_interleaved_pairs(theta):
    """Pairs (even, odd), positions past the sequence, no rotation at
    theta <= 0 (whisper)."""
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 7, 4, 16)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want)
    if theta > 0:   # a half-split rotation would differ
        assert not np.allclose(got[..., 1].numpy(), x[..., 1])


# -------------------------------------------------------------- attention
ATTN_ARCHS = ["internlm2-1.8b", "h2o-danube-3-4b", "deepseek-7b",
              "mixtral-8x7b", "whisper-base"]


@pytest.mark.parametrize("arch", ATTN_ARCHS)
@pytest.mark.parametrize("causal", [True, False])
def test_self_attention_block_matches_reference(arch, causal):
    """Self-attention (train / prefill) through row 8's plain version, and
    the collected post-RoPE K/V; T = 37 > the reduced window of 16."""
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(2)
    jp, tp = _both(_attn_params(rng, tc, bias=True))
    x = _normal(rng, 2, 37, tc.d_model)
    pos = np.arange(37, dtype=np.int32)
    ops.reset_launch_counts()
    got, kv = L.attention_block(tp, torch.from_numpy(x),
                                torch.from_numpy(pos), tc, causal=causal,
                                collect_kv=True)
    want, jkv = JL.attention_block(jp, jnp.asarray(x), jnp.asarray(pos), jc,
                                   causal=causal, collect_kv=True)
    _close(got, want, ATTN)
    _close(kv["k"], jkv["k"])
    _close(kv["v"], jkv["v"])
    # the plain path on the CPU counts no launch
    assert ops.launch_counts["flash_attention"] == 0


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-base"])
def test_cross_attention_block_matches_reference(arch):
    """kv_override (cross-attention): non-causal, T != S, no RoPE on q."""
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(3)
    jp, tp = _both(_attn_params(rng, tc))
    hd = tc.resolved_head_dim
    x = _normal(rng, 2, 5, tc.d_model)
    mk, mv = (_normal(rng, 2, 23, tc.n_kv_heads, hd) for _ in range(2))
    pos = np.arange(5, dtype=np.int32)
    got, _ = L.attention_block(
        tp, torch.from_numpy(x), torch.from_numpy(pos), tc,
        kv_override=(torch.from_numpy(mk), torch.from_numpy(mv)),
        causal=False)
    want, _ = JL.attention_block(
        jp, jnp.asarray(x), jnp.asarray(pos), jc,
        kv_override=(jnp.asarray(mk), jnp.asarray(mv)), causal=False)
    _close(got, want, ATTN)


@pytest.mark.parametrize("arch,max_len,steps", [
    ("internlm2-1.8b", 24, 20),          # linear cache, partly filled
    ("h2o-danube-3-4b", 64, 40),         # ring of 16 (the window), wrapped
    ("h2o-danube-3-4b", 10, 25),         # ring of max_len < window, wrapped
    ("mixtral-8x7b", 40, 37)])
def test_cached_decode_matches_reference_on_wrapped_rings(arch, max_len,
                                                         steps):
    """Decode through row 9 over the valid prefix (lengths = pos >= 0)
    equals the reference's position-masked ``decode_attention``, step for
    step, also after a ring has wrapped; the caches stay equal too."""
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(4)
    jp, tp = _both(_attn_params(rng, tc))
    jcache = JL.init_attention_cache(jc, 2, max_len, jnp.float32)
    tcache = L.init_attention_cache(tc, 2, max_len, torch.float32)
    S = tcache["k"].shape[1]
    assert S == (min(max_len, tc.sliding_window) if tc.sliding_window
                 else max_len)
    step = jax.jit(JL.attention_block, static_argnums=(3,))
    for t in range(steps):
        x = _normal(rng, 2, 1, tc.d_model)
        pos = np.asarray([t], np.int32)
        got, tcache = L.attention_block(tp, torch.from_numpy(x),
                                        torch.from_numpy(pos), tc,
                                        cache=tcache, cache_pos=t)
        want, jcache = step(jp, jnp.asarray(x), jnp.asarray(pos), jc,
                            cache=jcache, cache_pos=jnp.asarray(t))
        _close(got, want, ATTN)
        valid = tcache["pos"].numpy() >= 0
        n = valid.sum(-1)
        # the valid slots are a prefix, and they lie inside the window
        assert (valid == (np.arange(S)[None] < n[:, None])).all()
        if tc.sliding_window:
            assert (t - tcache["pos"].numpy()[valid] < tc.sliding_window).all()
    for name in ("k", "v", "pos"):
        _close(tcache[name], jcache[name])


def test_init_attention_cache_ring_size_and_empty_slots():
    for arch, max_len, S in (("h2o-danube-3-4b", 100, 16),
                             ("h2o-danube-3-4b", 8, 8),
                             ("internlm2-1.8b", 100, 100)):
        jc, tc = _cfgs(arch)
        got = L.init_attention_cache(tc, 3, max_len, lead=(2,))
        want = JL.init_attention_cache(jc, 3, max_len)
        assert tuple(got["k"].shape) == (2,) + want["k"].shape
        assert got["k"].shape[-3] == S and got["k"].dtype == torch.bfloat16
        assert (got["pos"] == -1).all() and got["pos"].dtype == torch.int32


# ---------------------------------------------------- attention gradient
@pytest.mark.parametrize("B,T,S,Hq,Hkv,causal,window", [
    (2, 37, 37, 4, 2, True, 16),         # danube's reduced SWA, GQA
    (1, 40, 40, 4, 4, True, None),       # MHA
    (2, 5, 23, 4, 2, False, None)])      # cross-attention, T != S
def test_attention_gradient_matches_jax_grad(B, T, S, Hq, Hkv, causal,
                                             window, monkeypatch):
    """``FlashAttention``'s plain backward (the softmax recomputed a query
    block at a time) against ``jax.vjp`` of the reference's
    ``blockwise_attention``: dq, dk and dv, each summed over its GQA group;
    the blocks forced small so several are taken."""
    monkeypatch.setattr(L, "_backward_block", lambda *a: 7)
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, B, T, Hq, 16), _normal(rng, B, S, Hkv, 16),
               _normal(rng, B, S, Hkv, 16))
    dout = _normal(rng, B, T, Hq, 16)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = L.attend(tq, tk, tv, causal=causal, window=window)
    out.backward(torch.from_numpy(dout))

    def f(q, k, v):
        return JL.blockwise_attention(q, k, v, jnp.arange(T), jnp.arange(S),
                                      causal=causal, window=window)
    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(out.detach(), want, ATTN)
    for got, w in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(dout))):
        _close(got, w, ATTN)


# -------------------------------------------------------------------- MLP
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-base"])
def test_mlp_block_matches_reference(arch):
    """SwiGLU, and whisper's gelu: ``jax.nn.gelu`` is the tanh
    approximation."""
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(6)
    d, ff = tc.d_model, tc.d_ff
    jp, tp = _both({"w_gate": _normal(rng, d, ff, scale=d ** -0.5),
                    "w_up": _normal(rng, d, ff, scale=d ** -0.5),
                    "w_down": _normal(rng, ff, d, scale=ff ** -0.5)})
    x = _normal(rng, 2, 9, d)
    _close(L.mlp_block(tp, torch.from_numpy(x), tc),
           JL.mlp_block(jp, jnp.asarray(x), jc))


# -------------------------------------------------------------------- MoE
def _moe_params(rng, cfg):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {"router": _normal(rng, d, E, scale=d ** -0.5),
            "w_gate": _normal(rng, E, d, ff, scale=d ** -0.5),
            "w_up": _normal(rng, E, d, ff, scale=d ** -0.5),
            "w_down": _normal(rng, E, ff, d, scale=ff ** -0.5)}


@pytest.mark.parametrize("arch,cf,B,T", [
    ("mixtral-8x7b", 1.25, 2, 16),       # top-2, capacity 20 -> 24
    ("mixtral-8x7b", 0.25, 1, 33),       # drops
    ("llama4-maverick-400b-a17b", 1.25, 3, 8),   # top-1
    ("llama4-maverick-400b-a17b", 0.1, 2, 40)])  # top-1, drops
def test_moe_block_matches_reference(arch, cf, B, T):
    """The global sort-based capacity formulation: stable sort by expert,
    C = ceil(cf N K / E / 8) 8, copies past C dropped, gates renormalised,
    accumulated on the scatter."""
    jc, tc = _cfgs(arch)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=cf))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=cf))
    rng = np.random.default_rng(7)
    jp, tp = _both(_moe_params(rng, tc))
    x = _normal(rng, B, T, tc.d_model)
    got = L.moe_block(tp, torch.from_numpy(x), tc)
    want = JL.moe_block(jp, jnp.asarray(x), jc)
    _close(got, want)
    N, K, E = B * T, tc.moe.top_k, tc.moe.num_experts
    C = L.moe_capacity(tc, N)
    assert C == max(1, int(np.ceil(cf * N * K / E / 8.0)) * 8)
    dropped = (got.norm(dim=-1) == 0).sum().item()
    assert (dropped > 0) == (cf < 0.5), dropped


def test_moe_block_bf16_matches_reference():
    """bf16 activations, as the model runs them: within 2 bf16 ulps of the
    output's scale."""
    jc, tc = _cfgs("mixtral-8x7b")
    rng = np.random.default_rng(8)
    jp, tp = _both(_moe_params(rng, tc))
    x = _normal(rng, 2, 12, tc.d_model)
    got = L.moe_block(tp, torch.from_numpy(x).bfloat16(), tc)
    want = np.asarray(JL.moe_block(jp, jnp.asarray(x, jnp.bfloat16), jc)
                      .astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    tol = 2 * 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
