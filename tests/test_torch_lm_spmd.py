"""The spec-driven LM executor (``models.sharding_rules``,
``parallel.spmd``, the ``Sharder``'s spec-driven mode in
``models.{common,layers,transformer,lm}``, the LM cells of
``launch.steps``) held to values, and row 9's log-sum-exp.

Values: the train, prefill and decode cells of four archs at
``reduced()`` run on a real gloo world of (2, 2) ranks over ("data",
"model"), each rank on its shards (``spmd.shard_numpy`` of the
reference's init) and rows, and are held against

  * the reference's ``build_lm_cell`` of the same cell, jitted with its
    own in and out shardings on concrete arrays over 4 host devices (a
    subprocess; ``Auto`` axes, ROADMAP §C), and
  * the port's 1-rank step (``steps.make_lm_train_step``, the prefill and
    decode steps with no sharder) on the whole tree.

Compute is fp32 in both packages (the compute dtype patched inside each
process, as ``tests/test_torch_lm_ranks.py`` does; the prefill caches'
default dtype too). Held: the loss and the next tokens exactly or at
rtol = atol = 1e-5; every param, AdamW's mu (0.1 x the grads) and nu
after one step, the prefill caches and the decode logits at 1e-4 of
each leaf's scale. The archs: internlm2-1.8b with one KV head (its
Hkv * hd = 16 columns split 8 a rank, a mid-head split, as Hkv = 8 on 16
ranks splits the full config's), h2o-danube-3-4b (a window: its decode
cache is a 16-slot ring), internvl2-26b (a vision front end) and
whisper-base (encoder memory; the decode cell's ``memory_kv`` split
along S over "model").

The same cells of two archs on (1, 3) ranks, where no split over
"model" divides and every leaf stays whole over it (the path of a
vocabulary that does not divide), against the port's 1 rank.

Row 9's ``lse``: the plain version (``ref.flash_decode_ref``) over a
cache cut into 1, 2 and 4 slices along S, combined as the executor
combines the ranks' slices (``layers.combine_slices``), against a
float64 softmax over the whole cache.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import test_torch_ranks as ranks_mod
from test_torch_lm_ranks import flatten, unflatten

ARCHS = ("internlm2-1.8b", "h2o-danube-3-4b", "internvl2-26b",
         "whisper-base")
MESH = (2, 2)
WHOLE_MESH = (1, 3)
WHOLE_ARCHS = ("internlm2-1.8b", "whisper-base")
B, SEQ = 8, 32
SCALAR_TOL = dict(rtol=1e-5, atol=1e-5)
LEAF_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).reduced()
    if arch == "internlm2-1.8b":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    return cfg


def _slot_positions(S_full, pos):
    slot = np.arange(S_full)
    p = slot + S_full * np.floor_divide(pos - 1 - slot, S_full)
    return np.where(slot <= pos - 1, p, -1).astype(np.int32)


def _inputs(path):
    """The reference's init of each arch (numpy), and each cell's inputs:
    a train batch (row 0's first 5 labels masked), a prefill batch, and
    decode caches after SEQ - 1 tokens with the new token's id."""
    import jax
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.models import transformer as JT
    out = {}
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        jcfg = JAX_ARCHS[arch].reduced()
        if arch == "internlm2-1.8b":
            jcfg = dataclasses.replace(jcfg, n_kv_heads=1)
        out.update(flatten(jax.tree_util.tree_map(
            np.asarray, JT.init_model(jax.random.PRNGKey(0), jcfg)),
            f"{arch}/params"))
        cfg = _cfg(arch)
        fe = cfg.n_frontend_tokens if (cfg.frontend and
                                       not cfg.is_encoder_decoder) else 0
        for kind in ("train", "prefill"):
            tag = f"{arch}/{kind}"
            out[f"{tag}/tokens"] = rng.integers(
                0, cfg.vocab_size, (B, SEQ - fe)).astype(np.int32)
            if kind == "train":
                labels = rng.integers(0, cfg.vocab_size,
                                      (B, SEQ - fe)).astype(np.int32)
                labels[0, :5] = -1
                out[f"{tag}/labels"] = labels
            if fe:
                out[f"{tag}/frontend_embeds"] = (0.02 * rng.standard_normal(
                    (B, fe, cfg.d_model))).astype(np.float32)
            if cfg.is_encoder_decoder:
                out[f"{tag}/encoder_embeds"] = (0.02 * rng.standard_normal(
                    (B, cfg.encoder_seq_len, cfg.d_model))).astype(
                        np.float32)
        S = SEQ if cfg.sliding_window is None else min(SEQ,
                                                       cfg.sliding_window)
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        out[f"{arch}/decode/caches/0/k"] = rng.standard_normal(shape) \
            .astype(np.float32)
        out[f"{arch}/decode/caches/0/v"] = rng.standard_normal(shape) \
            .astype(np.float32)
        out[f"{arch}/decode/caches/0/pos"] = np.broadcast_to(
            _slot_positions(S, SEQ - 1), shape[:3]).copy()
        out[f"{arch}/decode/token"] = rng.integers(
            0, cfg.vocab_size, (B,)).astype(np.int32)
        if cfg.is_encoder_decoder:
            mshape = (cfg.n_layers, B, cfg.encoder_seq_len, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
            for i in (0, 1):
                out[f"{arch}/decode/memory/{i}"] = rng.standard_normal(
                    mshape).astype(np.float32)
    np.savez(path, **out)


def _fp32():
    """The compute dtype (and the prefill caches' default) fp32."""
    from repro_torch.models import lm as LM
    from repro_torch.models import transformer as T
    T.COMPUTE_DTYPE = LM.COMPUTE_DTYPE = torch.float32
    T.caches_from_prefill_spmd.__defaults__ = (torch.float32,)
    T.caches_from_prefill.__defaults__ = (torch.float32,)


def _np_tree(tree):
    return {k: v.detach().numpy() for k, v in flatten(tree, "").items()}


def _cell_inputs(inp, arch):
    return {kind: unflatten(inp, f"{arch}/{kind}")
            for kind in ("train", "prefill", "decode")}


def _torch(tree):
    return torch.utils._pytree.tree_map(
        lambda x: torch.from_numpy(np.array(x)), tree)


# ------------------------------------------------------------- the ranks
def _job_cells(rank, world, out_dir):
    """Every arch's three cells on (2, 2) gloo ranks, each rank on its
    shards; the results gathered whole."""
    return _cells_on(out_dir, MESH, ARCHS)


def _job_cells_whole(rank, world, out_dir):
    """Two archs' cells on (1, 3) gloo ranks: no dim of the reduced
    configs divides 3, so every leaf, the caches and the residual stream
    stay whole over "model" (every rank computes alike)."""
    return _cells_on(out_dir, WHOLE_MESH, WHOLE_ARCHS)


def _cells_on(out_dir, mesh_shape, archs):
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    from repro_torch.models import sharding_rules as rules
    from repro_torch.models import transformer as T
    from repro_torch.parallel import spmd
    _fp32()
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    mesh = make_mesh(mesh_shape, ("data", "model"))
    out = {}
    for arch in archs:
        cfg = _cfg(arch)
        params_np = unflatten(inp, f"{arch}/params")
        cells = _cell_inputs(inp, arch)
        # train
        sh = steps.lm_sharder(cfg, mesh)
        params = spmd.shard_numpy(params_np, sh.specs, mesh, "cpu")
        step, opt = steps.make_lm_train_step(cfg, sh)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        batch = spmd.shard_numpy(cells["train"], rules.batch_specs(
            cells["train"], mesh), mesh, "cpu")
        state, metrics = step(state, batch)
        out[f"{arch}/train/loss"] = metrics["loss"].numpy()
        for name in ("params", "mu", "nu"):
            tree = state["params"] if name == "params" else \
                state["opt"][name]
            for k, v in _np_tree(spmd.gather_tree(
                    tree, sh.specs, mesh)).items():
                out[f"{arch}/train/{name}{k}"] = v
        # prefill
        sh = steps.lm_sharder(cfg, mesh, B, SEQ)
        params = spmd.shard_numpy(params_np, sh.specs, mesh, "cpu")
        batch = spmd.shard_numpy(cells["prefill"], rules.batch_specs(
            cells["prefill"], mesh), mesh, "cpu")
        caches, tok = LM.make_prefill_step(cfg, SEQ, sh)(params, batch)
        for k, v in _np_tree(spmd.gather_tree(
                caches, sh.cache_specs, mesh)).items():
            out[f"{arch}/prefill/caches{k}"] = v
        out[f"{arch}/prefill/token"] = spmd.gather(
            tok, rules.P(("data",)), mesh).numpy()
        # decode
        dec = cells["decode"]
        caches = spmd.shard_numpy(dec["caches"], sh.cache_specs, mesh,
                                  "cpu")
        token = spmd.shard_numpy(dec["token"], rules.P(("data",)), mesh,
                                 "cpu")
        memory = None
        if cfg.is_encoder_decoder:
            memory = tuple(spmd.shard_numpy(m, sh.memory_spec, mesh, "cpu")
                           for m in dec["memory"])
        hid, _ = T.forward_with_state(params, cfg, token[:, None],
                                      _clone(caches), SEQ - 1, memory, sh)
        logits = T.logits_from_hidden(params, cfg, hid, sh)[:, 0]
        split = logits.shape[-1] < cfg.padded_vocab
        out[f"{arch}/decode/logits"] = spmd.gather(
            logits, rules.P(("data",), "model" if split else None),
            mesh).numpy()
        _, tok = LM.make_decode_step(cfg, sh)(params, caches, token,
                                              SEQ - 1, memory)
        out[f"{arch}/decode/next"] = spmd.gather(
            tok, rules.P(("data",)), mesh).numpy()
        out[f"{arch}/mesh/model_size"] = np.asarray(sh.model_size)
    return out


def _clone(tree):
    return torch.utils._pytree.tree_map(lambda x: x.clone(), tree)


def _one_rank(inp):
    """The port's 1-rank steps on the whole tree (no sharder)."""
    from repro_torch.convert import params_from_jax_numpy
    from repro_torch.launch import steps
    from repro_torch.models import lm as LM
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw  # noqa: F401
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        cells = _cell_inputs(inp, arch)
        params = params_from_jax_numpy(unflatten(inp, f"{arch}/params"),
                                       "cpu")
        step, opt = steps.make_lm_train_step(cfg)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        state, metrics = step(state, _torch(cells["train"]))
        out[f"{arch}/train/loss"] = metrics["loss"].numpy()
        for name in ("params", "mu", "nu"):
            tree = state["params"] if name == "params" else \
                state["opt"][name]
            for k, v in _np_tree(tree).items():
                out[f"{arch}/train/{name}{k}"] = v
        params = params_from_jax_numpy(unflatten(inp, f"{arch}/params"),
                                       "cpu")
        caches, tok = LM.make_prefill_step(cfg, SEQ)(
            params, _torch(cells["prefill"]))
        for k, v in _np_tree(caches).items():
            out[f"{arch}/prefill/caches{k}"] = v
        out[f"{arch}/prefill/token"] = tok.numpy()
        dec = _torch(cells["decode"])
        memory = tuple(dec["memory"]) if cfg.is_encoder_decoder else None
        hid, _ = T.forward_with_state(params, cfg, dec["token"][:, None],
                                      _clone(dec["caches"]), SEQ - 1,
                                      memory)
        out[f"{arch}/decode/logits"] = T.logits_from_hidden(
            params, cfg, hid)[:, 0].numpy()
        _, tok = LM.make_decode_step(cfg)(params, dec["caches"],
                                          dec["token"], SEQ - 1, memory)
        out[f"{arch}/decode/next"] = tok.numpy()
    return out


# --------------------------------------------------------- the reference
REFERENCE = """
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
assert len(jax.devices()) == 4, jax.devices()
from repro.configs.base import ShapeConfig
from repro.configs.registry import ARCHS
from repro.launch import steps
from repro.models import lm, transformer as JT
from repro.optim import adamw
JT.COMPUTE_DTYPE = lm.COMPUTE_DTYPE = jnp.float32
JT.caches_from_prefill.__defaults__ = (jnp.float32,)

d = {out_dir!r}
inp = dict(np.load(d + "/inputs.npz"))
out = {{}}

def unflatten(prefix):
    root = {{}}
    for key in sorted(k for k in inp if k.startswith(prefix + "/")):
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for a in parts[:-1]:
            node = node.setdefault(a, {{}})
        node[parts[-1]] = jnp.asarray(inp[key])
    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {{k: lists(v) for k, v in node.items()}}
    return lists(root)

def flatten(tree, prefix):
    if isinstance(tree, dict):
        return {{k2: v2 for k in sorted(tree)
                 for k2, v2 in flatten(tree[k], f"{{prefix}}/{{k}}").items()}}
    if isinstance(tree, (list, tuple)):
        return {{k2: v2 for i, v in enumerate(tree)
                 for k2, v2 in flatten(v, f"{{prefix}}/{{i}}").items()}}
    return {{prefix: np.asarray(tree)}}

mesh = jax.make_mesh({mesh}, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
for arch in {archs}:
    cfg = ARCHS[arch].reduced()
    if arch == "internlm2-1.8b":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    params = unflatten(f"{{arch}}/params")
    shapes = {{k: ShapeConfig(f"{{k}}_t", {seq}, {b}, k)
              for k in ("train", "prefill", "decode")}}
    with mesh:
        cell = steps.build_lm_cell(cfg, shapes["train"], mesh)
        state = {{"params": params, "opt": adamw(1e-4).init(params),
                  "step": jnp.zeros((), jnp.int32)}}
        new, metrics = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                               out_shardings=cell.out_shardings)(
            state, unflatten(f"{{arch}}/train"))
        out[f"{{arch}}/train/loss"] = np.asarray(metrics["loss"])
        out.update(flatten(new["params"], f"{{arch}}/train/params"))
        out.update(flatten(new["opt"].mu, f"{{arch}}/train/mu"))
        out.update(flatten(new["opt"].nu, f"{{arch}}/train/nu"))
        cell = steps.build_lm_cell(cfg, shapes["prefill"], mesh)
        caches, tok = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                              out_shardings=cell.out_shardings)(
            params, unflatten(f"{{arch}}/prefill"))
        out.update(flatten(caches, f"{{arch}}/prefill/caches"))
        out[f"{{arch}}/prefill/token"] = np.asarray(tok)
        cell = steps.build_lm_cell(cfg, shapes["decode"], mesh)
        dec = unflatten(f"{{arch}}/decode")
        args = [params, dec["caches"], dec["token"], jnp.int32({seq} - 1)]
        if cfg.is_encoder_decoder:
            args.append(tuple(dec["memory"]))
        sharder = steps._sharder(mesh)

        def logits_of(params, caches, token, pos, *mem):
            hid, _ = JT.forward_with_state(
                params, cfg, token[:, None], caches, pos, sharder,
                memory_kv=mem[0] if mem else None)
            return JT.logits_from_hidden(params, cfg, hid, sharder)[:, 0]

        out[f"{{arch}}/decode/logits"] = np.asarray(jax.jit(
            logits_of, in_shardings=cell.in_shardings)(*args))
        _, tok = jax.jit(cell.fn, in_shardings=cell.in_shardings)(*args)
        out[f"{{arch}}/decode/next"] = np.asarray(tok)
np.savez(d + "/ref.npz", **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    """The inputs, the reference's results, the (2, 2) ranks' and the
    port's 1-rank ones; the reference's subprocess runs while the ranks
    do."""
    d = tmp_path_factory.mktemp("lm_spmd")
    _inputs(d / "inputs.npz")
    code = REFERENCE.format(out_dir=str(d), archs=ARCHS, mesh=MESH,
                            seq=SEQ, b=B)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(subproc, code, 4, ranks_mod.SPAWN_TIMEOUT_S)
        k4 = ranks_mod.spawn(_job_cells, 4, d)
        k3 = ranks_mod.spawn(_job_cells_whole, 3, d)
        proc = ref.result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    inp = dict(np.load(d / "inputs.npz"))
    _fp32_here = _fp32_scope()
    with _fp32_here:
        one = _one_rank(inp)
    return {"ref": dict(np.load(d / "ref.npz")), "ranks": k4, "one": one,
            "whole": k3}


class _fp32_scope:
    """``_fp32`` inside this process, undone on exit (the xdist worker
    runs other files after this one)."""

    def __enter__(self):
        from repro_torch.models import lm as LM
        from repro_torch.models import transformer as T
        self.saved = (T.COMPUTE_DTYPE, LM.COMPUTE_DTYPE,
                      T.caches_from_prefill_spmd.__defaults__,
                      T.caches_from_prefill.__defaults__)
        _fp32()

    def __exit__(self, *exc):
        from repro_torch.models import lm as LM
        from repro_torch.models import transformer as T
        (T.COMPUTE_DTYPE, LM.COMPUTE_DTYPE,
         T.caches_from_prefill_spmd.__defaults__,
         T.caches_from_prefill.__defaults__) = self.saved


def _leaves_close(got, want, keys):
    for k in keys:
        w = want[k]
        np.testing.assert_allclose(
            got[k], w, rtol=LEAF_RTOL,
            atol=LEAF_RTOL * max(float(np.abs(w).max()), 1e-30),
            err_msg=k)


def _keys(res, prefix):
    return sorted(k for k in res if k.startswith(prefix))


@pytest.mark.parametrize("against", ["ref", "one"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_matches(runs, arch, against):
    """One AdamW step of the train cell on (2, 2) ranks (FSDP over
    "data", TP over "model", the grads reduce-scattered and summed as
    the specs say): the loss on every rank at 1e-5, and every param,
    mu and nu, gathered whole, at 1e-4 of each leaf's scale, against the
    reference's cell and against the port's 1-rank step."""
    want = runs[against]
    tag = f"{arch}/train/"
    keys = _keys(want, tag + "params") + _keys(want, tag + "mu") \
        + _keys(want, tag + "nu")
    assert len(keys) > 3
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[tag + "loss"], want[tag + "loss"],
                                   **SCALAR_TOL)
        assert _keys(r, tag + "params") == _keys(want, tag + "params")
        _leaves_close(r, want, keys)


@pytest.mark.parametrize("against", ["ref", "one"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cell_matches(runs, arch, against):
    """The prefill cell's caches (each rank's block of S, every KV head,
    gathered whole; positions exactly) and its next tokens."""
    want = runs[against]
    tag = f"{arch}/prefill/"
    keys = _keys(want, tag + "caches")
    assert len(keys) == 3
    for r in runs["ranks"]:
        for k in keys:
            if k.endswith("pos"):
                np.testing.assert_array_equal(r[k], want[k], err_msg=k)
        _leaves_close(r, want, [k for k in keys if not k.endswith("pos")])
        np.testing.assert_array_equal(r[tag + "token"], want[tag + "token"])


@pytest.mark.parametrize("against", ["ref", "one"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cell_matches(runs, arch, against):
    """The decode step over a cache split along S over "model" (each
    rank's slice combined through row 9's lse): the logits of the
    whole vocabulary at 1e-4 of their scale and the next tokens."""
    want = runs[against]
    tag = f"{arch}/decode/"
    for r in runs["ranks"]:
        _leaves_close(r, want, [tag + "logits"])
        np.testing.assert_array_equal(r[tag + "next"], want[tag + "next"])


def test_cells_ran_over_two_model_ranks(runs):
    for r in runs["ranks"]:
        for arch in ARCHS:
            assert int(r[f"{arch}/mesh/model_size"]) == 2


@pytest.mark.parametrize("arch", WHOLE_ARCHS)
def test_cells_whole_over_model_match_one_rank(runs, arch):
    """On (1, 3) no split over "model" divides, so the specs keep every
    leaf whole over it (the embedding and head too, the path of a
    vocabulary that does not divide), the residual stream and the caches
    whole: every rank computes alike, the grads of each leaf are counted
    once (``first_rank_grad``, ``replicate_in``) and summed over
    "model". The train, prefill and decode cells against the port's 1
    rank at the tolerances above."""
    one = runs["one"]
    keys = [k for k in one if k.startswith(f"{arch}/")]
    for r in runs["whole"]:
        assert int(r[f"{arch}/mesh/model_size"]) == 3
        for k in keys:
            if k.endswith("loss"):
                np.testing.assert_allclose(r[k], one[k], **SCALAR_TOL)
            elif k.endswith(("pos", "token", "next")):
                np.testing.assert_array_equal(r[k], one[k], err_msg=k)
            else:
                _leaves_close(r, one, [k])


# ------------------------------------------------------- row 9's lse
class _Stacked:
    """A stub group of ``size`` ranks whose tensors lie stacked along dim
    0: its psum and pmax reduce over that dim, each rank receiving the
    result."""

    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("slices", [1, 2, 4])
def test_flash_decode_lse_slices_combine_to_float64_softmax(slices,
                                                            monkeypatch):
    """``ref.flash_decode_ref(return_lse=True)`` over a cache cut into
    ``slices`` along S, each slice's lengths clipped to it, combined by
    the executor's ``layers.combine_slices`` (over a stub group that
    stacks the slices, its pmax and psum reducing over them): the output
    against a float64 softmax over the whole cache at 1e-5, the slices'
    log-sum-exps combined against float64's at 1e-5; a slice with no
    valid row weighs nothing."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.parallel import primitives as P
    for name, reduce in (("pmax", lambda x: x.amax(0, keepdim=True)),
                         ("psum", lambda x: x.sum(0, keepdim=True))):
        def stub(x, group, orig=getattr(P, name), reduce=reduce):
            if isinstance(group, _Stacked):
                return reduce(x).expand_as(x).clone()
            return orig(x, group)
        monkeypatch.setattr(P, name, stub)
    size = P.group_size
    monkeypatch.setattr(P, "group_size", lambda g: g.size if isinstance(
        g, _Stacked) else size(g))
    B, S, Hq, Hkv, hd = 3, 64, 8, 2, 16
    gen = torch.Generator().manual_seed(slices)
    q = torch.randn((B, Hq, hd), generator=gen)
    k = torch.randn((B, S, Hkv, hd), generator=gen)
    v = torch.randn((B, S, Hkv, hd), generator=gen)
    lengths = torch.tensor([S, 37, 5])
    n = S // slices
    outs, lses = [], []
    for i in range(slices):
        ln = (lengths - i * n).clamp(0, n)
        o, lse = ops.flash_decode(q, k[:, i * n:(i + 1) * n].contiguous(),
                                  v[:, i * n:(i + 1) * n].contiguous(), ln,
                                  return_lse=True)
        assert lse.shape == (B, Hq) and lse.dtype == torch.float32
        outs.append(o)
        lses.append(lse)
    got = layers.combine_slices(torch.stack(outs), torch.stack(lses),
                                _Stacked(slices))
    assert got.shape == (slices, B, Hq, hd) and got.dtype == q.dtype
    lse_all = torch.stack(lses).double()              # (slices, B, Hq)
    m = lse_all.max(dim=0).values
    got_lse = m + torch.log(torch.exp(lse_all - m).sum(0))
    G = Hq // Hkv
    s = torch.einsum("bhgd,bshd->bhgs", q.double().reshape(B, Hkv, G, hd),
                     k.double()) / math.sqrt(hd)
    ok = torch.arange(S)[None, :] < lengths[:, None]
    s = s.masked_fill(~ok[:, None, None, :], -math.inf)
    want = torch.einsum("bhgs,bshd->bhgd", torch.softmax(s, -1),
                        v.double()).reshape(B, Hq, hd)
    want_lse = torch.logsumexp(s, -1).reshape(B, Hq)
    for r in range(slices):         # every rank holds the whole answer
        np.testing.assert_allclose(got[r].double().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(),
                               rtol=1e-5, atol=1e-5)
    # the default call is unchanged
    assert torch.equal(ops.flash_decode(q, k, v, lengths),
                       ops.flash_decode(q, k, v, lengths, True)[0])


def test_combine_slices_on_one_rank_is_the_identity():
    from repro_torch.models.layers import combine_slices
    out = torch.randn(2, 4, 8)
    assert combine_slices(out, torch.randn(2, 4), None) is out
