"""The port's LM stacks (``repro_torch.models.transformer`` / ``lm``) against
the JAX reference, for each of the ten architectures at ``reduced()`` (the
eight attention ones, rwkv6's RWKV6 stack and jamba's Mamba + attention
hybrid), on the reference's params carried across through
``repro_torch.convert``; the counterparts of tests/test_models.py and
tests/test_decode_equivalence.py.

Tolerance (bf16 paths). Both packages compute in bf16 from fp32 master
weights, and round at other places (XLA may keep an elementwise chain in
fp32; the port's attention is row 8 / row 9's plain version, fp32 inside,
rounded once). So a bf16 result is held to ``BF16_ULPS`` bf16 ulps
(2^-8 relative) of its scale (its largest magnitude) elementwise and to
``BF16_REL`` of its norm as a whole; two reduced layers measured 2-4.4 ulps
of the scale elementwise and up to 1.05% of the norm (whisper: 2 encoder
layers, then self- and cross-attention). The same forwards computed in
fp32 (``COMPUTE_DTYPE`` patched in both packages) agree to ~6e-7 of the
norm and are held at 1e-4: what differs in bf16 is rounding. A greedy
token must equal the reference's wherever the reference's top-2 logit
margin exceeds the logits' tolerance. Cache slots' positions are exact.

The SSM archs in bf16. rwkv6 (2 RWKV6 layers) and jamba (16 layers, 14
Mamba, MoE on 8) are worse conditioned at ``reduced()``: the reference's
own bf16 forward lies 14-18 bf16 ulps of the scale and 2.2-3.5% of the
norm from its fp32 forward (rwkv6), 37-100 ulps and 8.7-16% (jamba: a
top-2 routing near-tie flips, and each layer amplifies what differs), so
the attention archs' 8 ulps and 2% sit below the reference's own rounding.
The port's bf16 forward of these archs is held to the fp32 forward
instead: no further from it than ``TRUTH_FACTOR`` times the reference's
bf16 forward is (measured 0.92-1.32x elementwise, 0.99-1.15x in norm,
with the Mamba gate in fp32 as XLA runs it: ``test_torch_lm_train``'s
module doc); the algorithm is held in fp32 at 1e-4, as for every arch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import lm as JLM
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import params_from_jax_numpy
from repro_torch.models import lm as LM
from repro_torch.models import transformer as T
from repro_torch.models.common import count_params

ATTN_ARCHS = ["command-r-plus-104b", "deepseek-7b", "h2o-danube-3-4b",
              "internlm2-1.8b", "internvl2-26b",
              "llama4-maverick-400b-a17b", "mixtral-8x7b", "whisper-base"]
SSM_ARCHS = ["jamba-1.5-large-398b", "rwkv6-3b"]
LM_ARCHS = ATTN_ARCHS + SSM_ARCHS
TRUTH_FACTOR = 2.0
BF16_ULPS = 8
BF16_REL = 2e-2
F32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ helpers
def no_drop(cfg):
    """Raise MoE capacity so a full forward and decode route the same
    tokens (capacity dropping depends on the token count)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))


def cfgs(arch, drop=True):
    jc, tc = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    return (jc, tc) if drop else (no_drop(jc), no_drop(tc))


_PARAMS = {}


def shared_params(arch, seed=0):
    """(JAX params, numpy params, port params): the reference's init,
    carried across. Cached per arch (the tests only read them)."""
    if (arch, seed) not in _PARAMS:
        jc = JAX_ARCHS[arch].reduced()
        jp = JT.init_model(jax.random.PRNGKey(seed), jc)
        npp = jax.tree_util.tree_map(np.asarray, jp)
        _PARAMS[arch, seed] = (jp, npp, params_from_jax_numpy(npp, "cpu"))
    return _PARAMS[arch, seed]


def batch_inputs(cfg, B, Tn, seed=0):
    """Tokens and labels (numpy), and the frontend / encoder embeddings the
    arch needs, as (JAX kwargs, port kwargs)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, Tn)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, Tn)).astype(np.int32)
    jkw, tkw = {}, {}
    if cfg.frontend and not cfg.is_encoder_decoder:
        fe = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model))
        jkw["frontend_embeds"] = jnp.asarray(fe, jnp.float32)
        tkw["frontend_embeds"] = torch.from_numpy(fe.astype(np.float32))
    if cfg.is_encoder_decoder:
        ee = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model))
        jkw["encoder_embeds"] = jnp.asarray(ee, jnp.float32)
        tkw["encoder_embeds"] = torch.from_numpy(ee.astype(np.float32))
    return toks, labels, jkw, tkw


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_tol(want, ulps=BF16_ULPS):
    return ulps * 2.0 ** -8 * float(np.abs(want).max())


def close_bf16(got, want, what, ulps=BF16_ULPS, rel=BF16_REL):
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max()
    assert err <= bf16_tol(w, ulps), (what, err, np.abs(w).max())
    assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w), what


def greedy_agrees(got_tokens, ref_logits, vocab, tol):
    """Tokens equal the reference's argmax wherever its top-2 margin over
    the real vocab exceeds ``tol``."""
    lg = f32(ref_logits)[..., :vocab]
    top2 = np.sort(lg, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > tol
    want = lg.argmax(-1)
    got = np.asarray(got_tokens)
    assert (got[sure] == want[sure]).all(), (got, want, sure)
    return int(sure.sum())


def close_caches(got, want, what):
    """Decode caches a position of the unit: slot positions exact, K/V and
    recurrent states at the bf16 tolerance."""
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert set(g) == set(w), (what, set(g), set(w))
        for n in g:
            if n == "pos":
                np.testing.assert_array_equal(f32(g[n]), f32(w[n]))
            else:
                close_bf16(g[n], w[n], f"{what} {n}")


def tree_shapes(tree, path=""):
    """{key path: shape} in JAX's keystr form."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in tree_shapes(tree[key], f"{path}['{key}']").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in tree_shapes(x, f"{path}[{i}]").items()}
    return {path: tuple(tree.shape)}


# ------------------------------------------------------------ params
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_tree_names_and_shapes_match_reference(arch):
    """``init_model``'s tree (stacked units, encoder, cross-attention,
    frontend) has the reference's key paths and shapes, fp32, and the
    converted reference params fit it."""
    jc, tc = cfgs(arch)
    jp, _, conv = shared_params(arch)
    port = T.init_model(tc, torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert tree_shapes(port) == want
    assert tree_shapes(conv) == want
    assert count_params(port) == sum(int(np.prod(s)) for s in want.values())
    assert all(x.dtype == torch.float32 for x in
               jax.tree_util.tree_leaves(port))


def test_param_counts_of_the_full_configs():
    """The full configs' counts: internlm2-1.8b's 1.896 B (the phase 9e
    cell) and the reference's counts for every arch; the shape cells and
    their skip rule as the reference's."""
    for name, cfg in ARCHS.items():
        assert cfg.param_count() == JAX_ARCHS[name].param_count()
        assert cfg.param_count(True) == JAX_ARCHS[name].param_count(True)
    assert round(get_arch("internlm2-1.8b").param_count() / 1e9, 3) == 1.896
    from repro.configs import registry as jax_registry
    from repro_torch.configs import registry
    assert registry.list_cells() == jax_registry.list_cells()
    assert [(a.name, s.name, ok, why) for a, s, ok, why in
            registry.iter_cells(include_skipped=True)] == [
        (a.name, s.name, ok, why) for a, s, ok, why in
        jax_registry.iter_cells(include_skipped=True)]
    assert registry.get_shape("decode_32k") == registry.SHAPES["decode_32k"]


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_hidden_and_logits_match_reference(arch):
    """Full-sequence forward (row 8 a layer) and the head: hidden and
    logits at the bf16 tolerance (tied embeddings: command-r)."""
    jc, tc = cfgs(arch)
    jp, _, tp = shared_params(arch)
    toks, _, jkw, tkw = batch_inputs(tc, 2, 16)
    hj = JT.forward(jp, jc, jnp.asarray(toks), **jkw)
    ht = T.forward(tp, tc, torch.from_numpy(toks), **tkw)
    fe = tc.n_frontend_tokens if tc.frontend and not tc.is_encoder_decoder else 0
    assert ht.shape == (2, 16 + fe, tc.d_model) and ht.dtype == torch.bfloat16
    close_bf16(ht, hj, "hidden")
    # the head on the reference's hidden, so only the head differs
    lj = JT.logits_from_hidden(jp, jc, hj)
    lt = T.logits_from_hidden(tp, tc,
                              torch.from_numpy(f32(hj).copy()).bfloat16())
    assert lt.shape[-1] == tc.padded_vocab
    close_bf16(lt, lj, "logits", ulps=2)


def as_close_to_fp32(got, want, truth, what, factor=TRUTH_FACTOR):
    """bf16 ``got`` (the port) no further from the fp32 ``truth`` than
    ``factor`` times the reference's bf16 ``want`` is: elementwise (max)
    and in norm."""
    g, w, t = f32(got), f32(want), f32(truth)
    assert g.shape == w.shape == t.shape, what
    assert np.abs(g - t).max() <= factor * np.abs(w - t).max(), (
        what, np.abs(g - t).max(), np.abs(w - t).max())
    assert (np.linalg.norm(g - t) <= factor * np.linalg.norm(w - t)), what


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_forward_in_bf16_is_as_close_to_fp32_as_the_reference(
        arch, monkeypatch):
    """rwkv6 and jamba in bf16: hidden and logits no further from the
    reference's fp32 forward than twice the reference's bf16 forward is
    (module doc); the head on the reference's hidden at the bf16
    tolerance, as for the attention archs."""
    jc, tc = cfgs(arch)
    jp, _, tp = shared_params(arch)
    toks, _, _, _ = batch_inputs(tc, 2, 16)
    hj = JT.forward(jp, jc, jnp.asarray(toks))
    ht = T.forward(tp, tc, torch.from_numpy(toks))
    assert ht.shape == (2, 16, tc.d_model) and ht.dtype == torch.bfloat16
    lj = JT.logits_from_hidden(jp, jc, hj)
    lt = T.logits_from_hidden(tp, tc, ht)
    monkeypatch.setattr(JT, "COMPUTE_DTYPE", jnp.float32)
    h32 = JT.forward(jp, jc, jnp.asarray(toks))
    as_close_to_fp32(ht, hj, h32, "hidden")
    as_close_to_fp32(lt, lj, JT.logits_from_hidden(jp, jc, h32), "logits")
    lt = T.logits_from_hidden(tp, tc,
                              torch.from_numpy(f32(hj).copy()).bfloat16())
    close_bf16(lt, lj, "logits on the reference's hidden", ulps=2)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_in_fp32_matches_reference(arch, monkeypatch):
    """The same forward with the compute dtype fp32 in both packages: the
    algorithm (RoPE pairs, masks, GQA grouping, MoE routing, enc-dec
    wiring, frontend) agrees to fp32 round-off."""
    monkeypatch.setattr(JT, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(T, "COMPUTE_DTYPE", torch.float32)
    jc, tc = cfgs(arch)
    jp, _, tp = shared_params(arch)
    toks, _, jkw, tkw = batch_inputs(tc, 2, 16)
    ht = T.forward(tp, tc, torch.from_numpy(toks), **tkw)
    assert ht.dtype == torch.float32
    np.testing.assert_allclose(
        f32(ht), f32(JT.forward(jp, jc, jnp.asarray(toks), **jkw)), **F32)


# ------------------------------------------------------- prefill, decode
@pytest.mark.parametrize("arch", ATTN_ARCHS + ["rwkv6-3b"])
def test_prefill_and_decode_match_reference(arch):
    """The parallel prefill's caches (pos exact, K/V at the bf16
    tolerance) and next token, then decode steps (row 9 a layer) fed the
    same tokens in both packages: hidden and greedy tokens."""
    jc, tc = cfgs(arch, drop=False)
    jp, _, tp = shared_params(arch)
    toks, _, jkw, tkw = batch_inputs(tc, 2, 12, seed=1)
    max_len = 24 + (tc.n_frontend_tokens if tc.frontend else 0)
    jcaches, jnext = jax.jit(JLM.make_prefill_step(jc, max_len))(
        jp, {"tokens": jnp.asarray(toks), **jkw})
    tcaches, tnext = LM.make_prefill_step(tc, max_len)(
        tp, {"tokens": torch.from_numpy(toks), **tkw})
    close_caches(tcaches, jcaches, "prefill cache")
    hj = jax.jit(JT.forward, static_argnums=(1,))(jp, jc, jnp.asarray(toks),
                                                   **jkw)
    lj = JT.logits_from_hidden(jp, jc, hj[:, -1:])
    tol = bf16_tol(f32(lj))
    greedy_agrees(tnext.numpy(), lj[:, 0], tc.vocab_size, tol)

    memory = (None, None)
    if tc.is_encoder_decoder:
        memory = (JT._project_kv_memory(
            jc, jp["cross_attn"], JT.encode(jp, jc, jkw["encoder_embeds"])),
            T._project_kv_memory(tc, tp["cross_attn"], T.encode(
                tp, tc, tkw["encoder_embeds"])))
    start = toks.shape[1] + (tc.n_frontend_tokens
                             if tc.frontend and not tc.is_encoder_decoder
                             else 0)
    tok = np.asarray(jnext)
    step = jax.jit(JT.forward_with_state, static_argnums=(1,))
    for i in range(3):
        hj, jcaches = step(
            jp, jc, jnp.asarray(tok)[:, None], jcaches,
            jnp.asarray(start + i), memory_kv=memory[0])
        ht, tcaches = T.forward_with_state(
            tp, tc, torch.from_numpy(tok.copy())[:, None], tcaches, start + i,
            memory_kv=memory[1])
        close_bf16(ht, hj, f"decode step {i}")
        lj = JT.logits_from_hidden(jp, jc, hj)
        lt = T.logits_from_hidden(tp, tc, ht)
        greedy_agrees(lt[:, 0, :tc.vocab_size].argmax(-1).numpy(), lj[:, 0],
                      tc.vocab_size, bf16_tol(f32(lj)))
        tok = np.asarray(jnp.argmax(lj[:, 0, :jc.vocab_size], -1))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_prefill_and_decode_in_fp32_match_reference(arch, monkeypatch):
    """rwkv6's and jamba's prefill (the SSM states are the caches; jamba's
    attention K/V scattered into fp32 caches) and its last logits, then
    decode steps fed the same tokens, with the compute dtype fp32 in both
    packages: caches, hidden and logits at 1e-4."""
    monkeypatch.setattr(JT, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(T, "COMPUTE_DTYPE", torch.float32)
    jc, tc = cfgs(arch, drop=False)
    jp, _, tp = shared_params(arch)
    toks = batch_inputs(tc, 2, 12, seed=1)[0]
    hj, ej = JT.forward(jp, jc, jnp.asarray(toks), collect=True)
    ht, et = T.forward(tp, tc, torch.from_numpy(toks), collect=True)
    jcaches = JT.caches_from_prefill(jc, ej, 12, 24, dtype=jnp.float32)
    tcaches = T.caches_from_prefill(tc, et, 12, 24, dtype=torch.float32)
    lj = JT.logits_from_hidden(jp, jc, hj[:, -1:])
    np.testing.assert_allclose(
        f32(T.logits_from_hidden(tp, tc, ht[:, -1:])), f32(lj), **F32)
    tok = np.asarray(jnp.argmax(lj[:, 0, :jc.vocab_size], -1))
    for i in range(4):
        for jc_, tc_ in zip(jcaches, tcaches):
            assert set(jc_) == set(tc_)
            for n in tc_:
                np.testing.assert_allclose(f32(tc_[n]), f32(jc_[n]),
                                           err_msg=f"step {i} {n}", **F32)
        if i == 3:
            break
        hj, jcaches = JT.forward_with_state(
            jp, jc, jnp.asarray(tok)[:, None], jcaches, jnp.asarray(12 + i))
        ht, tcaches = T.forward_with_state(
            tp, tc, torch.from_numpy(tok.copy())[:, None], tcaches, 12 + i)
        np.testing.assert_allclose(f32(ht), f32(hj), **F32)
        tok = np.asarray(jnp.argmax(
            JT.logits_from_hidden(jp, jc, hj)[:, 0, :jc.vocab_size], -1))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-3-4b",
                                  "deepseek-7b", "mixtral-8x7b",
                                  "whisper-base", *SSM_ARCHS])
def test_token_by_token_decode_matches_forward(arch):
    """decode == full forward within the port: each position's hidden from
    the cached path (row 9) against the full forward's (row 8), T = 20 past
    danube's reduced window of 16 (the ring wraps); whisper's
    cross-attention reads the projected encoder memory."""
    _, tc = cfgs(arch, drop=False)
    _, _, tp = shared_params(arch)
    toks, _, _, tkw = batch_inputs(tc, 2, 20, seed=2)
    toks = torch.from_numpy(toks)
    memory = None
    if tc.is_encoder_decoder:
        memory = T._project_kv_memory(tc, tp["cross_attn"], T.encode(
            tp, tc, tkw["encoder_embeds"]))
    h_full = T.forward(tp, tc, toks, **tkw)
    caches = T.init_cache(tc, 2, 32)
    hs = []
    for t in range(toks.shape[1]):
        hid, caches = T.forward_with_state(tp, tc, toks[:, t:t + 1], caches,
                                           t, memory_kv=memory)
        hs.append(hid[:, 0])
    close_bf16(torch.stack(hs, 1), h_full, "decode vs forward")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-3-4b",
                                  "mixtral-8x7b", *SSM_ARCHS])
def test_parallel_prefill_then_decode_greedy(arch):
    """Greedy continuation from the parallel prefill equals greedy from the
    full forward at every generated position (where the margin is clear);
    the prefill's next token equals a serial prefill's
    (``prefill_into_cache``)."""
    _, tc = cfgs(arch, drop=False)
    _, _, tp = shared_params(arch)
    toks = torch.from_numpy(batch_inputs(tc, 2, 12, seed=3)[0])
    caches, cur = LM.make_prefill_step(tc, max_len=24)(tp, {"tokens": toks})
    hid, serial = LM.prefill_into_cache(tp, tc, toks,
                                        T.init_cache(tc, 2, 24))
    close_caches(caches, serial, "serial prefill")
    decode = LM.make_decode_step(tc)
    seq = toks
    sure = 0
    for i in range(4):
        h = T.forward(tp, tc, seq)
        ref = T.logits_from_hidden(tp, tc, h[:, -1:])[:, 0]
        sure += greedy_agrees(cur.numpy(), ref, tc.vocab_size,
                              bf16_tol(f32(ref)))
        seq = torch.cat([seq, cur[:, None]], dim=1)
        caches, cur = decode(tp, caches, cur, 12 + i)
    assert sure >= 4


def test_sliding_window_ring_cache_eviction():
    """The SWA ring holds exactly the last ``window`` positions, in the
    order the slots filled; row 9 reads all of them."""
    _, tc = cfgs("h2o-danube-3-4b")
    assert tc.sliding_window == 16
    _, _, tp = shared_params("h2o-danube-3-4b")
    toks = torch.from_numpy(batch_inputs(tc, 1, 20, seed=4)[0])
    caches = T.init_cache(tc, 1, 32)
    for t in range(20):
        _, caches = T.forward_with_state(tp, tc, toks[:, t:t + 1], caches, t)
    pos = caches[0]["pos"].numpy()                 # (U, B, S=16)
    assert pos.shape[-1] == 16
    assert set(pos.reshape(-1).tolist()) == set(range(4, 20))
    assert (pos[..., :4] == np.arange(16, 20)).all()   # wrapped slots
