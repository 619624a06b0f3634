"""The port's SSM mixers (``repro_torch.models.ssm``) against the JAX
reference (``repro.models.ssm``); the counterpart of tests/test_ssm.py.

Params are the reference's init, carried across through
``repro_torch.convert``; inputs and states are numpy draws from a seed. The
reference's ``REPRO_SSM_CHUNK`` stays at its default of 64, so its scans
chunk (and ``jax.checkpoint`` their chunks) at T = 128, as the port's do.

Tolerances, set beforehand from the dtype (fp32 throughout): outputs and
states against the reference's at 1e-5; the scan against the fold of its
steps at tests/test_ssm.py's 2e-4 (the projections run at other shapes);
the chunked scan against the unchunked one bitwise (the same ops on the
same values; grads within 1e-6: a chunk sums its part of a param's grad);
grads through the chunked scans against ``jax.vjp`` at 1e-4
of each leaf's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import ssm as JS
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.convert import params_from_jax_numpy
from repro_torch.models import ssm as S

F32 = dict(rtol=1e-5, atol=1e-5)
WIDTHS = (32, 64)
KINDS = ("mamba", "rwkv6")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(kind, d=32):
    """(reference config, port config): d_state 8, d_conv 4, expand 2 for
    mamba; heads of 16 for rwkv6."""
    kw = dict(name="t", n_layers=2, d_model=d, d_ff=2 * d, vocab_size=64)
    if kind == "mamba":
        kw.update(family="hybrid", n_heads=4, n_kv_heads=4)
        ssm = dict(kind="mamba", d_state=8, d_conv=4, expand=2)
    else:
        kw.update(family="ssm", n_heads=d // 16, n_kv_heads=d // 16)
        ssm = dict(kind="rwkv6", head_dim=16)
    return (JModelConfig(**kw, ssm=JSSMConfig(**ssm)),
            ModelConfig(**kw, ssm=SSMConfig(**ssm)))


INIT = {"mamba": (JS.init_mamba, S.init_mamba),
        "rwkv6": (JS.init_rwkv6, S.init_rwkv6),
        "cmix": (JS.init_rwkv6_channel_mix, S.init_rwkv6_channel_mix)}
SCAN = {"mamba": (JS.mamba_scan, S.mamba_scan),
        "rwkv6": (JS.rwkv6_scan, S.rwkv6_scan)}
STEP = {"mamba": (JS.mamba_step, S.mamba_step),
        "rwkv6": (JS.rwkv6_step, S.rwkv6_step)}
STATE = {"mamba": (JS.init_mamba_state, S.init_mamba_state),
         "rwkv6": (JS.init_rwkv6_state, S.init_rwkv6_state)}


def shared(kind, d=32, which=None, seed=0):
    """(reference params, port params) of the reference's init."""
    jc, _ = cfgs(kind, d)
    jp = INIT[which or kind][0](jax.random.PRNGKey(seed), jc)
    return jp, params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     "cpu")


def draw(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def random_state(kind, cfg, B, seed):
    """A nonzero numpy state of the reference's layout."""
    one = STATE[kind][0](cfg, B)
    return {k: draw(v.shape, seed + i, 0.5)
            for i, (k, v) in enumerate(sorted(one.items()))}


def both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **(tol or F32))


def close_states(got, want, what, **tol):
    assert set(got) == set(want), (what, set(got), set(want))
    for k in want:
        close(got[k], want[k], f"{what} {k}", **tol)


# -------------------------------------------------------------- params
@pytest.mark.parametrize("which", ["mamba", "rwkv6", "cmix"])
@pytest.mark.parametrize("d", WIDTHS)
def test_init_has_the_reference_tree_and_values(which, d):
    """``init_*``: the reference's keys, shapes and fp32 dtype, stacked over
    ``lead``; the deterministic leaves equal the reference's, and the drawn
    ones have its scales (dt_bias the inverse softplus of dt in [1e-3,
    0.1])."""
    kind = "rwkv6" if which == "cmix" else which
    jc, tc = cfgs(kind, d)
    jp, _ = shared(kind, d, which)
    tp = INIT[which][1](torch.Generator().manual_seed(0), tc, lead=(3,))
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (3,) + v.shape, k
        assert tp[k].dtype == torch.float32, k
    for k in ("a_log", "d_skip", "conv_b", "mix_r", "mix_k", "mix_v",
              "mix_g", "mix_w", "decay_base", "ln_w", "ln_b"):
        if k in jp:    # a_log = log(1..d_state): the logs may differ an ulp
            for i in range(3):
                np.testing.assert_allclose(tp[k][i].numpy(),
                                           np.asarray(jp[k]), rtol=1e-6,
                                           atol=0, err_msg=k)
    if which == "mamba":
        dt = torch.nn.functional.softplus(tp["dt_bias"].double())
        assert float(dt.min()) >= 1e-3 * (1 - 1e-6)
        assert float(dt.max()) <= 0.1 * (1 + 1e-6)
        assert abs(float(tp["conv_w"].std()) - 0.5) < 0.1   # 1/sqrt(d_conv)
    if which == "rwkv6":
        assert abs(float(tp["bonus"].std()) - 0.05) < 0.02
    w = tp["w_in" if which == "mamba" else "w_k"]     # N(0, 1/d_in)
    assert abs(float(w.std()) * w.shape[-2] ** 0.5 - 1.0) < 0.1


# ------------------------------------------------------------ mixers
@pytest.mark.parametrize("given_state", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_scan_matches_reference(kind, d, given_state):
    """``mamba_scan`` / ``rwkv6_scan`` over T = 19 (no chunking) from a
    zero or a drawn state: outputs and final states at 1e-5."""
    jc, tc = cfgs(kind, d)
    jp, tp = shared(kind, d)
    jx, tx = both(draw((2, 19, d), 1))
    state = random_state(kind, jc, 2, 7) if given_state else None
    jst = None if state is None else {k: jnp.asarray(v)
                                      for k, v in state.items()}
    tst = None if state is None else {k: torch.from_numpy(v.copy())
                                      for k, v in state.items()}
    yj, sj = SCAN[kind][0](jp, jx, jc, jst)
    yt, st = SCAN[kind][1](tp, tx, tc, tst)
    close(yt, yj, "out")
    close_states(st, sj, "state")


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_step_matches_reference(kind, d):
    """Three ``*_step`` calls from a drawn state, each token's output and
    the state after it at 1e-5."""
    jc, tc = cfgs(kind, d)
    jp, tp = shared(kind, d)
    state = random_state(kind, jc, 3, 11)
    jst = {k: jnp.asarray(v) for k, v in state.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    x = draw((3, 3, d), 2)
    for t in range(3):
        jx, tx = both(x[:, t:t + 1])
        yj, jst = STEP[kind][0](jp, jx, jc, jst)
        yt, tst = STEP[kind][1](tp, tx, tc, tst)
        close(yt, yj, f"step {t}")
        close_states(tst, jst, f"step {t}")


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_channel_mix_matches_reference(d, with_prev):
    jp, tp = shared("rwkv6", d, "cmix")
    jx, tx = both(draw((2, 9, d), 3))
    prev = draw((2, d), 4) if with_prev else None
    jprev, tprev = both(prev) if with_prev else (None, None)
    oj, lj = JS.rwkv6_channel_mix(jp, jx, jprev)
    ot, lt = S.rwkv6_channel_mix(tp, tx, tprev)
    close(ot, oj, "out")
    close(lt, lj, "x_prev_last")


def test_group_norm_uses_the_population_variance():
    """``_rwkv_group_norm`` per head of 16 at 1e-5, heads of a few distinct
    values (where an unbiased variance would differ most)."""
    x = draw((2, 5, 64), 5)
    x[:, :, :16] = np.round(x[:, :, :16])
    w, b = draw((64,), 6), draw((64,), 7)
    want = JS._rwkv_group_norm(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), 4)
    got = S._rwkv_group_norm(*(torch.from_numpy(a) for a in (x, w, b)), 4)
    close(got, want, "group norm")


def test_softplus_has_no_linear_branch():
    """``_softplus`` is ``jax.nn.softplus`` (logaddexp(x, 0)) on both sides
    of ``F.softplus``'s threshold of 20, and never overflows."""
    x = np.concatenate([np.linspace(-30, 40, 141), [80.0, 100.0, 1e4]]
                       ).astype(np.float32)
    got = S._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_state_dtypes_match_reference(kind):
    """On bf16 inputs: ``conv`` and ``x_prev`` take the compute dtype,
    ``ssm`` and ``wkv`` stay fp32, as the reference's."""
    jc, tc = cfgs(kind)
    jp, tp = shared(kind)
    x = draw((2, 4, 32), 8)
    _, sj = SCAN[kind][0](jp, jnp.asarray(x, jnp.bfloat16), jc)
    _, st = SCAN[kind][1](tp, torch.from_numpy(x).bfloat16(), tc)
    want = {k: str(v.dtype) for k, v in sj.items()}
    got = {k: str(v.dtype).replace("torch.", "") for k, v in st.items()}
    assert got == want
    init = STATE[kind][1](tc, 2, torch.bfloat16)
    assert {k: str(v.dtype).replace("torch.", "") for k, v in
            init.items()} == want


# ---------------------------------------------- scan = fold, chunking
@pytest.mark.parametrize("kind", KINDS)
def test_scan_equals_token_fold(kind):
    """tests/test_ssm.py's property in the port: the scan over 12 tokens
    equals 12 single-token steps, outputs and states."""
    jc, tc = cfgs(kind)
    _, tp = shared(kind)
    x = torch.from_numpy(draw((2, 12, 32), 1))
    y_full, s_full = SCAN[kind][1](tp, x, tc)
    state = STATE[kind][1](tc, 2)
    ys = []
    for t in range(12):
        y, state = STEP[kind][1](tp, x[:, t:t + 1], tc, state)
        ys.append(y)
    tol = dict(rtol=2e-4, atol=2e-4)
    close(torch.cat(ys, 1), y_full.numpy(), "fold", **tol)
    close_states(state, {k: v.numpy() for k, v in s_full.items()}, "fold",
                 **tol)


@pytest.mark.parametrize("kind", KINDS)
def test_scan_carries_its_state_across_calls(kind):
    """scan(x) == scan(x[7:] from the state after x[:7])."""
    _, tc = cfgs(kind)
    _, tp = shared(kind)
    x = torch.from_numpy(draw((2, 16, 32), 1))
    y_full, _ = SCAN[kind][1](tp, x, tc)
    y1, st = SCAN[kind][1](tp, x[:, :7], tc)
    y2, _ = SCAN[kind][1](tp, x[:, 7:], tc, st)
    close(torch.cat([y1, y2], 1), y_full.numpy(), "split",
          rtol=2e-4, atol=2e-4)


def _scan_loss(kind, tp, tc, x, cot, chunk):
    """sum(out * cot) of the scan under autograd, its grads w.r.t. the
    params and x, and the final state."""
    live = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    xl = x.detach().requires_grad_(True)
    y, st = SCAN[kind][1](live, xl, tc, chunk=chunk)
    loss = (y * cot).sum()
    grads = torch.autograd.grad(loss, [xl, *live.values()])
    return loss, dict(zip(["x", *live], grads)), st


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_scan_equals_unchunked(kind):
    """T = 128 under autograd, chunk 64 (two rematerialized chunks) against
    0 (no chunking): outputs and final states bitwise (the same ops on the
    same values), grads within 1e-6 of each leaf's scale (mamba's a_log
    enters every step's discretization, which a chunk computes in bulk, so
    its grad is summed a chunk at a time)."""
    _, tc = cfgs(kind)
    _, tp = shared(kind)
    x = torch.from_numpy(draw((2, 128, 32), 1))
    cot = torch.from_numpy(draw((2, 128, 32), 2))
    l64, g64, s64 = _scan_loss(kind, tp, tc, x, cot, 64)
    l0, g0, s0 = _scan_loss(kind, tp, tc, x, cot, 0)
    assert torch.equal(l64, l0)
    for k in s0:
        assert torch.equal(s64[k], s0[k]), k
    for k in g0:
        np.testing.assert_allclose(g64[k].numpy(), g0[k].numpy(), rtol=0,
                                   atol=1e-6 * float(g0[k].abs().max()),
                                   err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_scan_saves_only_chunk_boundaries(kind):
    """What autograd holds for the backward (bytes of saved tensors, each
    storage counted once): chunk 64 at T = 128 holds at least one state a
    step fewer than no chunking (it keeps the chunks' boundary states, not
    the time loop's per-step ones); T = 127 (not a multiple of 64) and
    T <= 64 do not chunk, as the reference's rule."""
    _, tc = cfgs(kind)
    _, tp = shared(kind)
    live = {k: v.detach().requires_grad_(True) for k, v in tp.items()}

    def saved_bytes(T, chunk):
        seen = {}

        def pack(t):
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t
        x = torch.from_numpy(draw((2, T, 32), 1)).requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            SCAN[kind][1](live, x, tc, chunk=chunk)
        return sum(seen.values())

    state = STATE[kind][1](tc, 2)["ssm" if kind == "mamba" else "wkv"]
    state_bytes = state.numel() * state.element_size()
    assert (saved_bytes(128, 0) - saved_bytes(128, 64)
            >= 126 * state_bytes)
    assert saved_bytes(127, 64) == saved_bytes(127, 0)
    assert saved_bytes(64, 64) == saved_bytes(64, 0)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_grads_through_the_chunked_scan_match_jax_vjp(kind, d):
    """T = 128 from a drawn state: the vjp of (out, final state) with drawn
    cotangents w.r.t. x, the params and the initial state, against
    ``jax.vjp`` of the reference's scan (chunked at its default 64), at
    1e-4 of each leaf's scale."""
    jc, tc = cfgs(kind, d)
    jp, tp = shared(kind, d)
    x = draw((2, 128, d), 1)
    state = random_state(kind, jc, 2, 3)
    cot_y = draw((2, 128, d), 2)
    cot_s = {k: draw(v.shape, 20 + i) for i, (k, v) in
             enumerate(sorted(state.items()))}

    def jfun(p, x, st):
        return SCAN[kind][0](p, x, jc, st)
    (_, _), vjp = jax.vjp(jfun, jp, jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in state.items()})
    gp, gx, gs = vjp((jnp.asarray(cot_y),
                      {k: jnp.asarray(v) for k, v in cot_s.items()}))

    live = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    xl = torch.from_numpy(x).requires_grad_(True)
    stl = {k: torch.from_numpy(v.copy()).requires_grad_(True)
           for k, v in state.items()}
    y, st = SCAN[kind][1](live, xl, tc, stl)
    loss = (y * torch.from_numpy(cot_y)).sum() + sum(
        (st[k].float() * torch.from_numpy(cot_s[k])).sum() for k in st)
    names = ["x", *live, *(f"state {k}" for k in stl)]
    got = torch.autograd.grad(loss, [xl, *live.values(), *stl.values()],
                              allow_unused=True)
    want = [gx, *(gp[k] for k in live), *(gs[k] for k in stl)]
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)


# ---------------------------------------------------------- properties
def test_mamba_state_decays():
    """A negative real: with zero input the SSM state shrinks."""
    _, tc = cfgs("mamba")
    _, tp = shared("mamba")
    state = S.init_mamba_state(tc, 1)
    state["ssm"] = torch.ones_like(state["ssm"])
    _, new = S.mamba_scan(tp, torch.zeros((1, 8, 32)), tc, state)
    assert float(new["ssm"].abs().sum()) < float(state["ssm"].abs().sum())


@pytest.mark.parametrize("decay_base", [-6.0, 30.0, -30.0])
def test_rwkv_decay_in_unit_interval(decay_base):
    """The clip before the double exp keeps w in (0, 1): a huge or tiny
    decay_base gives finite outputs and a state that neither blows up nor
    stays put (w = exp(-e^8) and exp(-e^-20))."""
    _, tc = cfgs("rwkv6")
    _, tp = shared("rwkv6")
    tp = dict(tp, decay_base=torch.full_like(tp["decay_base"], decay_base))
    x = torch.from_numpy(draw((1, 4, 32), 1))
    y, st = S.rwkv6_scan(tp, x, tc)
    assert torch.isfinite(y).all() and torch.isfinite(st["wkv"]).all()
    jc, _ = cfgs("rwkv6")
    jp, _ = shared("rwkv6")
    jp = dict(jp, decay_base=jnp.full_like(jp["decay_base"], decay_base))
    yj, sj = JS.rwkv6_scan(jp, jnp.asarray(x.numpy()), jc)
    close(y, yj, "out")
    close_states(st, sj, "state")
