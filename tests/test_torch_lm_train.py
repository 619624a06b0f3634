"""The port's LM training path against the JAX reference: chunked
cross-entropy, loss and grads of one train step for each of the ten archs
(with and without ``forward(remat=True)``), rwkv6's AdamW steps at full
width, the optimizers and the cosine schedule, the LM batch's chain rule, the
carried-across optimizer state, then (within the port) the session, its
checkpoint-resume, ``Engine``'s LM errors and the launcher.

Tolerances, each set beforehand from the dtype:
  * fp32 module inputs (chunked CE with the compute dtype fp32): 1e-5;
  * the optimizers on numpy trees, fp32: 1e-6 (the same expressions; the
    power and rsqrt may round differently by an ulp);
  * loss and grads with the compute dtype patched to fp32 in both
    packages: 1e-5 on the loss, 1e-4 on every grad (measured ~1e-6 of
    each leaf's norm): the algorithm, row 8's plain backward included;
  * the bf16 train step as the model runs it: loss within 1e-2 absolute
    (measured 1.2e-3 at most), each grad within ``GRAD_ULPS`` bf16 ulps of
    its leaf's scale and ``GRAD_REL`` of its norm (measured 7.6 ulps and
    1.9%: a grad goes through the forward's roundings and the backward's,
    twice the forward's 8 ulps and 2%). A leaf whose gradient is below
    1e-7 of the global grad norm is round-off in both packages and is held
    to that floor instead: llama4's top-1 router, whose gate renormalises
    to exactly 1. The SSM archs in bf16 are held to the fp32 grads instead
    (``test_torch_lm_models``' module doc): no further from them than
    ``TRUTH_FACTOR`` times the reference's bf16 grads are, over the whole
    grad (every leaf flattened: its largest element and its norm) and,
    for rwkv6, each leaf (measured 0.6-0.93x). jamba's leaves one by one
    are chaotic at ``reduced()`` (a top-2 near-tie, 16 layers): over batch
    seeds 5-8 its worst leaf lies 1.06-3.81x the reference's distance
    while the whole grad lies 0.76-1.10x, so jamba holds the whole grad
    and its median leaf (seed 5: 0.95x and 0.96x). XLA keeps fp32 where
    it drops a round trip through bf16: with
    ``--xla_allow_excess_precision=false`` the reference's own bf16 grads
    lie further from fp32. The Mamba gate rounded apart (y, silu(z) and
    their product each in bf16) left jamba's median leaf at 2.3x the
    reference's distance, so the port computes the gate in fp32 and
    rounds once, as XLA runs the reference's.
Params are not compared after an AdamW step: at step 1 m^/sqrt(v^) is +-1
per element, so the sign of a near-zero bf16 grad decides it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.data import lm as jax_data
from repro.models import lm as JLM
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro_torch.configs import ARCHS, get_arch, get_dlrm
from repro_torch.convert import params_from_jax_numpy
from repro_torch.data import lm as data
from repro_torch.engine import Engine
from repro_torch.engine.training import LMTrainSession, TrainSession
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm as LM
from repro_torch.models import transformer as T
from repro_torch.models.common import tree_leaves
from repro_torch.optim import optimizers as O

from test_torch_lm_models import (ATTN_ARCHS, LM_ARCHS, SSM_ARCHS,
                                  TRUTH_FACTOR, batch_inputs, cfgs,
                                  shared_params)

GRAD_ULPS = 16
GRAD_REL = 4e-2
ROUND_OFF = 1e-7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fp32_compute(monkeypatch):
    """The compute dtype fp32 in both packages' model modules."""
    for mod in (JT, JLM):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (T, LM):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


# ---------------------------------------------------------- chunked CE
@pytest.mark.parametrize("arch,chunk", [("internlm2-1.8b", 16),
                                        ("command-r-plus-104b", 512),
                                        ("whisper-base", 5)])
def test_chunked_cross_entropy_matches_reference(arch, chunk, fp32_compute):
    """logsumexp over the PADDED vocab; labels >= vocab_size and < 0
    masked; T = 37 not a multiple of the chunk; tied head (command-r)."""
    jc, tc = cfgs(arch)
    jp, _, tp = shared_params(arch)
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((2, 37, tc.d_model)).astype(np.float32)
    labels = rng.integers(0, tc.vocab_size, (2, 37)).astype(np.int32)
    labels[0, :3] = (tc.vocab_size, tc.padded_vocab - 1, -1)
    got = LM.chunked_cross_entropy(tp, tc, torch.from_numpy(hidden),
                                   torch.from_numpy(labels), chunk=chunk)
    want = JLM.chunked_cross_entropy(jp, jc, jnp.asarray(hidden),
                                     jnp.asarray(labels), chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    # the masked positions do not count: all masked is 0, not NaN
    none = LM.chunked_cross_entropy(tp, tc, torch.from_numpy(hidden),
                                    torch.full((2, 37), tc.vocab_size))
    assert float(none) == 0.0


# ---------------------------------------------------- loss and grads
def _remat_loss_fn(cfg, remat):
    """``make_loss_fn``'s loss over ``forward(remat=remat)``, in the
    package of ``T_`` / ``LM_``."""
    def make(T_, LM_):
        def loss_fn(params, batch):
            hidden = T_.forward(params, cfg, batch["tokens"],
                                encoder_embeds=batch.get("encoder_embeds"),
                                remat=remat)
            return LM_.chunked_cross_entropy(params, cfg, hidden,
                                             batch["labels"])
        return loss_fn
    return make


def _grads_both(arch, remat=None):
    """(reference loss, port loss, leaf paths, reference grads, port grads,
    the port's global grad norm); with ``remat`` set, both through
    ``forward(remat=remat)``."""
    jc, tc = cfgs(arch)
    jp, _, tp = shared_params(arch)
    toks, labels, jkw, tkw = batch_inputs(tc, 2, 17, seed=5)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), **jkw}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels), **tkw}
    if remat is None:
        jloss, tloss = JLM.make_loss_fn(jc), LM.make_loss_fn(tc)
    else:
        jloss = _remat_loss_fn(jc, remat)(JT, JLM)
        tloss = _remat_loss_fn(tc, remat)(T, LM)
    lj, gj = jax.jit(jax.value_and_grad(jloss))(jp, jb)
    lt, gt = LM.value_and_grad(tloss, tp, tb)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gj)[0]]
    return (float(lj), float(lt), paths,
            [np.asarray(x) for x in jax.tree_util.tree_leaves(gj)],
            [x.numpy() for x in tree_leaves(gt)], float(LM.global_norm(gt)))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_in_fp32_match_jax_value_and_grad(arch,
                                                         fp32_compute):
    lj, lt, paths, gj, gt, gnorm = _grads_both(arch)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for path, w, g in zip(paths, gj, gt):
        floor = ROUND_OFF * gnorm
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=max(1e-4 * np.abs(
            w).max(), floor), err_msg=path)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_loss_and_grads_of_the_bf16_step_match_jax_value_and_grad(arch):
    lj, lt, paths, gj, gt, gnorm = _grads_both(arch)
    assert abs(lt - lj) <= 1e-2, (lt, lj)
    for path, w, g in zip(paths, gj, gt):
        floor = ROUND_OFF * gnorm
        err = np.abs(g - w).max()
        assert err <= max(GRAD_ULPS * 2 ** -8 * np.abs(w).max(), floor), (
            path, err, np.abs(w).max())
        assert (np.linalg.norm(g - w)
                <= GRAD_REL * np.linalg.norm(w) + floor), path


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_bf16_grads_are_as_close_to_fp32_as_the_reference(arch,
                                                              monkeypatch,
                                                              capsys):
    """rwkv6 and jamba, the bf16 step as the model runs it: the loss and
    the grads no further from the reference's fp32 ones than twice the
    reference's bf16 ones are (module doc): the whole grad's largest
    element and norm; then each leaf for rwkv6 (elementwise max and norm;
    a leaf below the round-off floor of the global norm is held to the
    floor), the median leaf's norm for jamba. The loss is held to one bf16
    ulp of it if the reference's bf16 loss is closer."""
    lj, lt, paths, gj, gt, gnorm = _grads_both(arch)
    for mod, dt in ((JT, jnp.float32), (JLM, jnp.float32)):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", dt)
    l32, _, _, g32, _, _ = _grads_both(arch)
    # a scalar: the reference's own error, floored at one bf16 ulp of it
    assert abs(lt - l32) <= TRUTH_FACTOR * max(abs(lj - l32),
                                               2 ** -8 * abs(l32)), (
        lt, lj, l32)

    def flat(leaves):
        return np.concatenate([x.ravel() for x in leaves])
    g, w, t = flat(gt), flat(gj), flat(g32)
    assert np.abs(g - t).max() <= TRUTH_FACTOR * np.abs(w - t).max(), (
        np.abs(g - t).max(), np.abs(w - t).max())
    assert np.linalg.norm(g - t) <= TRUTH_FACTOR * np.linalg.norm(w - t), (
        np.linalg.norm(g - t), np.linalg.norm(w - t))
    floor = ROUND_OFF * gnorm
    ratios = [np.linalg.norm(g - t) / (np.linalg.norm(w - t) + floor)
              for w, g, t in zip(gj, gt, g32)]
    whole = np.linalg.norm(g - t) / np.linalg.norm(w - t)
    largest = np.abs(g - t).max() / np.abs(w - t).max()
    with capsys.disabled():
        print(f"\n[{arch} bf16 grads] distance from fp32 over the "
              f"reference's: whole grad {whole:.2f}x (largest element "
              f"{largest:.2f}x), median leaf {np.median(ratios):.2f}x, "
              f"worst leaf {max(ratios):.2f}x")
    if arch == "jamba-1.5-large-398b":
        assert np.median(ratios) <= TRUTH_FACTOR, np.median(ratios)
        return
    for path, w, g, t in zip(paths, gj, gt, g32):
        assert (np.abs(g - t).max()
                <= TRUTH_FACTOR * np.abs(w - t).max() + floor), path
        assert (np.linalg.norm(g - t)
                <= TRUTH_FACTOR * np.linalg.norm(w - t) + floor), path


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-base",
                                  *SSM_ARCHS])
def test_remat_grads_equal_plain_and_reference(arch, fp32_compute):
    """``forward(remat=True)`` (each layer under ``torch.utils.checkpoint``;
    whisper's cross-attention and jamba's attention recompute row 8): the
    loss and grads equal ``remat=False``'s bitwise, and the reference's
    ``forward(remat=True)``'s at the fp32 tolerances."""
    lj, lt, paths, gj, gt, gnorm = _grads_both(arch, remat=True)
    _, lt0, _, _, gt0, _ = _grads_both(arch, remat=False)
    assert lt == lt0
    for path, a, b in zip(paths, gt, gt0):
        np.testing.assert_array_equal(a, b, err_msg=path)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for path, w, g in zip(paths, gj, gt):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=max(
            1e-4 * np.abs(w).max(), ROUND_OFF * gnorm), err_msg=path)


def test_train_step_updates_in_place_and_reports_the_grad_norm():
    """One step of ``make_train_step``: the loss and global grad norm are
    the value_and_grad ones; params and moments move in place."""
    _, tc = cfgs("internlm2-1.8b")
    _, npp, _ = shared_params("internlm2-1.8b")
    params = params_from_jax_numpy(npp, "cpu")
    opt = O.adamw(1e-3)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    toks, labels, _, _ = batch_inputs(tc, 2, 17)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    loss, grads = LM.value_and_grad(LM.make_loss_fn(tc), params, batch)
    gnorm = LM.global_norm(grads)
    wq = params["units"][0]["attn"]["wq"]
    before = wq.clone()
    new, metrics = LM.make_train_step(tc, opt)(state, batch)
    assert float(metrics["loss"]) == float(loss)
    assert float(metrics["grad_norm"]) == float(gnorm)
    assert new["params"]["units"][0]["attn"]["wq"] is wq
    assert not torch.equal(wq, before) and int(new["step"]) == 1
    assert int(new["opt"]["count"]) == 1


def test_rwkv6_adamw_steps_at_full_width_match_reference(fp32_compute,
                                                         capsys):
    """rwkv6-3b at its full width (d 2,560, 40 heads of 64, ff 8,960, the
    decay LoRA of 160), the depth cut to 1 and the vocab to 512: four
    ``make_train_step`` AdamW steps at a constant 3e-4 on the reference's
    params and batches, each step's loss within 1e-5 and global grad norm
    within 1e-4 of the reference's (measured 2e-6 and 3.1e-5). At this
    width both losses rise step after step on fresh batches (8.2026 ->
    9.4799), as the port's full-depth loss does on the card once the
    warmup brings the lr near 3e-4."""
    jc = dataclasses.replace(JAX_ARCHS["rwkv6-3b"], n_layers=1,
                             vocab_size=512)
    tc = dataclasses.replace(ARCHS["rwkv6-3b"], n_layers=1, vocab_size=512)
    jp = JT.init_model(jax.random.PRNGKey(0), jc)
    tp = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jopt, topt = JO.adamw(3e-4), O.adamw(3e-4)
    js = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    ts = {"params": tp, "opt": topt.init(tp),
          "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(JLM.make_train_step(jc, jopt), donate_argnums=(0,))
    tstep = LM.make_train_step(tc, topt)
    curve = []
    for s in range(4):
        jb = jax_data.make_lm_batch(jc, s, 0, 1, 17, 0.8)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, {k: torch.from_numpy(np.array(v))
                            for k, v in jb.items()})
        want, got = float(jm["loss"]), float(tm["loss"])
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=str(s))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=str(s))
        curve.append((want, got))
    with capsys.disabled():
        print(f"\n[rwkv6 full width, depth 1] losses (reference, port): "
              f"{curve}")


# ---------------------------------------------------------- optimizers
def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32),
                  rng.standard_normal((2, 2, 2)).astype(np.float32)]}


@pytest.mark.parametrize("name,make", [
    ("sgd", lambda M: M.sgd(0.1)),
    ("sgd_momentum", lambda M: M.sgd(0.1, momentum=0.9)),
    ("adagrad", lambda M: M.adagrad(0.1)),
    ("adamw", lambda M: M.adamw(0.01)),
    ("adamw_cosine", lambda M: M.adamw(
        0.01, lr_schedule=M.cosine_schedule(2, 5)))])
def test_optimizers_match_reference_over_steps(name, make):
    """Five updates on numpy params and grads, each step's updates and the
    params (p + u) at 1e-6; AdamW's state carried across through
    ``params_from_jax_numpy`` (its NamedTuple becomes the port's dict)
    continues identically."""
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    jopt, topt = make(JO), make(O)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = jax.tree_util.tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _tree(rng)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(jax.tree_util.tree_map(torch.from_numpy, g),
                             ts, tp)
        for a, b in zip(jax.tree_util.tree_leaves(ju), tree_leaves(tu)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {step}")
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = jax.tree_util.tree_map(lambda p, u: p + u, tp, tu)
        if step == 2 and name.startswith("adamw"):
            ts = params_from_jax_numpy(
                jax.tree_util.tree_map(np.asarray, js), "cpu")
            assert set(ts) == {"mu", "nu", "count"} and int(ts["count"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def test_cosine_schedule_matches_reference():
    js, ts = JO.cosine_schedule(10, 100), O.cosine_schedule(10, 100)
    steps = np.asarray([0, 1, 5, 9, 10, 11, 50, 99, 100, 150], np.int32)
    np.testing.assert_allclose(ts(torch.from_numpy(steps)).numpy(),
                               np.asarray(js(jnp.asarray(steps))),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- data
def test_chain_step_wraps_as_the_reference_uint32():
    """``(tok * 1103515245 + 12345) mod 2^32 mod V`` in int64 equals the
    reference's uint32 arithmetic, for tokens whose product wraps."""
    for V in (256, 32000, 92544, 256000):
        tok = np.unique(np.concatenate([
            np.arange(0, min(V, 4096)), np.arange(V - 4096, V)]))
        want = ((jnp.asarray(tok).astype(jnp.uint32) * jnp.uint32(1103515245)
                 + 12345) % jnp.uint32(V)).astype(jnp.int32)
        got = data.chain_step(torch.from_numpy(tok), V)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chain_tokens_follow_the_reference_scan():
    """``chain_tokens`` on given draws equals the reference's scan body
    (``make_lm_batch``'s ``step_fn``) run over the same draws."""
    rng = np.random.default_rng(2)
    V, B, S = 92544, 3, 40
    first = rng.integers(0, V, B).astype(np.int32)
    use = rng.random((B, S)) < 0.8
    unif = rng.integers(0, V, (B, S)).astype(np.int32)

    def step_fn(tok, inp):
        chain, u = inp
        nxt = ((tok.astype(jnp.uint32) * jnp.uint32(1103515245) + 12345)
               % jnp.uint32(V)).astype(jnp.int32)
        tok = jnp.where(chain, nxt, u)
        return tok, tok
    _, toks = jax.lax.scan(step_fn, jnp.asarray(first),
                           (jnp.asarray(use).T, jnp.asarray(unif).T))
    got = data.chain_tokens(torch.from_numpy(first), torch.from_numpy(use),
                            torch.from_numpy(unif), V)
    np.testing.assert_array_equal(got.numpy(), np.asarray(toks).T)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "internvl2-26b",
                                  "whisper-base"])
def test_lm_batch_contract(arch):
    """Labels are the next tokens; a pure function of (seed, step); steps
    differ; ~chain_prob of the tokens follow the chain; the stub
    embeddings the reference adds, with its shapes."""
    cfg = ARCHS[arch].reduced()
    jb = jax_data.make_lm_batch(JAX_ARCHS[arch].reduced(), 0, batch=4,
                                seq=33)
    b = data.make_lm_batch(cfg, 0, batch=4, seq=33, device="cpu")
    assert {k: tuple(v.shape) for k, v in b.items()} == {
        k: tuple(v.shape) for k, v in jb.items()}
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert torch.equal(b["tokens"], data.make_lm_batch(
        cfg, 0, batch=4, seq=33, device="cpu")["tokens"])
    assert not torch.equal(b["tokens"], data.make_lm_batch(
        cfg, 1, batch=4, seq=33, device="cpu")["tokens"])
    big = data.make_lm_batch(cfg, 3, batch=64, seq=65, device="cpu")
    follows = (data.chain_step(big["tokens"], cfg.vocab_size)
               == big["labels"]).float().mean().item()
    assert 0.75 < follows < 0.86, follows
    assert int(big["tokens"].max()) < cfg.vocab_size


# ------------------------------------------------------------ session
def test_lm_session_loss_decreases():
    """The reference's test_loss_decreases (tests/test_models.py) through
    the session: AdamW at 3e-3, batch 4 x 33, the windowed means of the
    first and last 3 of 12 steps."""
    cfg = get_arch("internlm2-1.8b").reduced()
    sess = Engine(cfg, lr=3e-3, device="cpu").train_session(
        batch=4, seq=33, schedule_steps=12)
    assert isinstance(sess, LMTrainSession)
    rep = sess.run(12)
    losses = [h["loss"] for h in rep.history]
    assert rep.workload == "lm" and rep.steps_run == 12
    assert np.isfinite(losses).all() and all(
        np.isfinite(h["grad_norm"]) for h in rep.history)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_lm_session_resume_is_bitwise(tmp_path):
    """A session checkpointed at step 4 and resumed for 2 more equals an
    uninterrupted 6-step session, bit for bit on the CPU: params, AdamW
    moments and count, the step, the losses."""
    cfg = get_arch("mixtral-8x7b").reduced()
    kw = dict(device="cpu", lr=3e-3, batch=2, seq=9, schedule_steps=6)
    ref = LMTrainSession(cfg, **kw)
    ref_losses = [h["loss"] for h in ref.run(6).history]
    first = LMTrainSession(cfg, ckpt_dir=str(tmp_path), ckpt_every=4, **kw)
    first.run(4)
    resumed = LMTrainSession(cfg, ckpt_dir=str(tmp_path), ckpt_every=4,
                             **kw)
    assert resumed.resume_step == 4
    rep = resumed.run(2)
    assert [h["loss"] for h in rep.history] == ref_losses[4:]
    got, want = tree_leaves(resumed.state), tree_leaves(ref.state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(resumed.state["step"]) == 6
    assert int(resumed.state["opt"]["count"]) == 6


# ------------------------------------------------------------- engine
@pytest.mark.parametrize("kw,msg", [
    ({"plan": "auto"}, "plan placement is DLRM-only"),
    ({"pipeline_depth": 2}, "pipeline_depth/compress_grads are DLRM-only"),
    ({"compress_grads": True}, "pipeline_depth/compress_grads"),
    ({"dp_axes": ("pod",)}, "dp_axes is DLRM-only"),
    ({"host_capacity_mb": 64}, "host_capacity_mb .* is DLRM-only")])
def test_engine_refuses_dlrm_only_options_for_an_lm(kw, msg):
    with pytest.raises(ValueError, match=msg):
        Engine(get_arch("internlm2-1.8b").reduced(), device="cpu", **kw)


def test_engine_lm_serving_and_fleet_are_dlrm_only():
    eng = Engine(get_arch("internlm2-1.8b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="serve_session is DLRM-only"):
        eng.serve_session()
    with pytest.raises(ValueError, match="sharded_fleet is DLRM-only"):
        eng.sharded_fleet()
    # pipeline_depth=1 is accepted, as in the reference
    Engine(get_arch("internlm2-1.8b").reduced(), device="cpu",
           pipeline_depth=1)


def test_engine_dlrm_session_ignores_the_lm_options():
    sess = Engine(get_dlrm("dlrm-rm2-small-unsharded").reduced(),
                  device="cpu").train_session(batch=3, seq=5,
                                              chain_prob=0.1,
                                              schedule_steps=7)
    assert isinstance(sess, TrainSession)


# ------------------------------------------------------------ launcher
def test_train_launcher_lm_smoke(capsys):
    rc = train_launcher.main(["--workload", "lm", "--arch", "whisper-base",
                              "--smoke", "--device", "cpu", "--steps", "3",
                              "--batch", "2", "--seq", "9", "--plan", "auto",
                              "--pipeline-depth", "2",
                              "--host-capacity-mb", "8"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "--plan is DLRM-only; ignoring it" in out
    assert "--pipeline-depth/--compress-grads are DLRM-only" in out
    assert "--host-capacity-mb is DLRM-only; ignoring it" in out
    assert "[train] lm whisper-base-smoke: steps=3 (from 0)" in out
    assert "first_loss=" in out and "last_loss=" in out


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_lm_session_trains_the_ssm_archs(arch):
    """rwkv6 and jamba at ``reduced()`` take two AdamW steps through
    ``Engine`` / ``LMTrainSession``: finite losses and grad norms, every
    mixer's params moved."""
    cfg = get_arch(arch).reduced()
    sess = Engine(cfg, lr=3e-3, device="cpu").train_session(
        batch=2, seq=9, schedule_steps=2)
    assert isinstance(sess, LMTrainSession)
    before = [x.clone() for x in tree_leaves(sess.params["units"])]
    rep = sess.run(2)
    assert rep.steps_run == 2 and int(sess.state["step"]) == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in rep.history)
    mixer = "mamba" if arch.startswith("jamba") else "rwkv"
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_leaves(sess.params["units"]), before)]
    assert all(moved), sum(moved)
    assert mixer in sess.params["units"][0]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_train_launcher_trains_the_ssm_archs(arch, capsys):
    rc = train_launcher.main(["--workload", "lm", "--arch", arch, "--smoke",
                              "--device", "cpu", "--steps", "2", "--batch",
                              "2", "--seq", "9"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"[train] lm {arch}-smoke: steps=2 (from 0)" in out
    assert "first_loss=" in out and "last_loss=" in out


def test_train_launcher_lm_cli_runs_and_needs_a_card_by_default(capsys):
    """``--workload lm --arch internlm2-1.8b --smoke --device cpu --steps
    8`` prints the first and last loss; without ``--device cpu`` on a
    host with no card it raises."""
    argv = ["--workload", "lm", "--arch", "internlm2-1.8b", "--smoke",
            "--steps", "8"]
    assert train_launcher.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[train] lm internlm2-1.8b-smoke: steps=8 (from 0)" in out
    assert "first_loss=" in out and "last_loss=" in out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_launcher.main(argv)


def test_convert_carries_the_stacked_lm_tree_and_optimizer_state():
    """``params_from_jax_numpy`` on ``init_model``'s stacked tree and on
    the reference's AdamW state: the same leaves, values and dtypes; the
    state's NamedTuple as the port's dict, its count a 0-d int32 tensor."""
    jp, npp, tp = shared_params("whisper-base")
    state = JO.adamw(1e-3).init(jp)
    conv = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, state),
                                 "cpu")
    assert set(conv) == {"mu", "nu", "count"}
    assert conv["count"].shape == () and conv["count"].dtype == torch.int32
    for want, got in ((jax.tree_util.tree_leaves(npp), tree_leaves(tp)),
                      (jax.tree_util.tree_leaves(state.mu),
                       tree_leaves(conv["mu"]))):
        assert len(want) == len(got)
        for a, b in zip(want, got):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
