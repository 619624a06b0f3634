"""The LM over k ranks (ROADMAP A6b-ii, its first item) against the
reference's train step over a mesh.

The reference runs ``lm.make_train_step(cfg, adamw(3e-4), Sharder(mesh))``
and ``jax.grad(lm.make_loss_fn(cfg, Sharder(mesh)))`` under one
``jax.jit`` in a subprocess with 4 virtual devices
(``conftest.run_with_devices``), on a mesh built there with ``Auto``
axes: ``launch.mesh.make_mesh`` makes ``Explicit`` ones on this jax, on
which the reference's ``Sharder`` fails (ROADMAP §C). The port runs 4
gloo ranks, spawned as ``tests/test_torch_ranks.py`` spawns them, each
on its rows of the batch (``lm.shard_batch``) and its shard of the
reference's init (``convert.params_from_jax_numpy`` then
``local_lm_params``). The compute dtype is fp32 in both packages (as in
``tests/test_torch_lm_train.py``; patched inside each rank), the configs
``reduced()`` at their own capacity factor (1.25, with its drops), a batch
of 8 x 32 with the labels of the first 5 positions of row 0 masked, so
the data shards count different valid labels. Held: the loss and the grad
norm at rtol = atol = 1e-5, every grad (summed over "data", the expert
weights gathered over "model") at 1e-4 of its leaf's scale, as
``test_torch_lm_train.py`` holds fp32 grads; on mixtral-8x7b at (2, 2)
(ep over 2) and (1, 4) (ep over 4), internlm2-1.8b, jamba-1.5-large-398b
(Mamba, attention and 4-expert MoE layers) and whisper-base (its
``encoder_embeds`` sliced by data rank) at (2, 2).

Within the port, over 2 ranks: an ``Engine(cfg, model_axis=2)`` session
of mixtral-8x7b's reduced config at capacity factor 4 (ep over 2 drops
nothing at E = 4, top 2, and at that factor neither does the 1-rank
global formulation) against the 1-rank session at ``test_torch_lm_train.py``'s bf16
tolerances; what raises (a batch that does not split over "data",
``dp_axes``) and a ``ckpt_dir``, which it takes; and ``torch.distributed.run`` of the train launcher
with ``--workload lm --model-axis 2`` printing, from rank 0, the
session's losses. JAX is imported only inside fixtures and the
reference's subprocess, so the spawned ranks do not load it.
"""
from __future__ import annotations

import concurrent.futures
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_ranks as ranks_mod

CASES = [("mixtral-8x7b", (2, 2)), ("mixtral-8x7b", (1, 4)),
         ("internlm2-1.8b", (2, 2)), ("jamba-1.5-large-398b", (2, 2)),
         ("whisper-base", (2, 2))]
ARCHS = sorted({a for a, _ in CASES})
B, TLEN = 8, 32
LR = 3e-4
SCALAR_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
ROUND_OFF = 1e-7
# the bf16 session against the 1-rank one (test_torch_lm_train.py's)
LOSS_ATOL = 1e-2
GRAD_REL = 4e-2
SESSION = dict(batch=4, seq=17, schedule_steps=10)
SESSION_STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- trees
def flatten(tree, prefix):
    """A tree of dicts and lists -> {"prefix/a/0/b": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def unflatten(arrays, prefix):
    """The inverse of ``flatten`` (a numeric key is a list index)."""
    root: dict = {}
    for key in sorted(k for k in arrays if k.startswith(prefix + "/")):
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for a, b in zip(parts, parts[1:]):
            node = node.setdefault(a, {})
        node[parts[-1]] = arrays[key]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def _cfg(arch):
    from repro_torch.configs import get_arch
    return get_arch(arch).reduced()


def _inputs(path):
    """The reference's init of each arch (numpy) and each case's batch."""
    import jax
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.models import transformer as JT
    out = {}
    for arch in ARCHS:
        params = JT.init_model(jax.random.PRNGKey(0),
                               JAX_ARCHS[arch].reduced())
        out.update(flatten(jax.tree_util.tree_map(np.asarray, params),
                           f"{arch}/params"))
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        cfg = _cfg(arch)
        labels = rng.integers(0, cfg.vocab_size, (B, TLEN)).astype(np.int32)
        labels[0, :5] = -1
        out[f"{arch}/batch/tokens"] = rng.integers(
            0, cfg.vocab_size, (B, TLEN)).astype(np.int32)
        out[f"{arch}/batch/labels"] = labels
        if cfg.is_encoder_decoder:
            out[f"{arch}/batch/encoder_embeds"] = (0.02 * rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    np.savez(path, **out)


# ------------------------------------------------------------- the ranks
def _job_reference_cases(rank, world, out_dir):
    """Every case on 4 ranks, compute in fp32: the train step's loss and
    grad norm, and the grads summed over "data", gathered over "model"."""
    from repro_torch.convert import (gather_lm_params, local_lm_params,
                                     params_from_jax_numpy)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Sharder
    from repro_torch.optim import adamw
    T.COMPUTE_DTYPE = LM.COMPUTE_DTYPE = torch.float32
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    out = {}
    for arch, shape in CASES:
        cfg = _cfg(arch)
        sharder = Sharder(make_mesh(shape, ("data", "model")))
        tag = f"{arch}/{shape[0]}x{shape[1]}"
        batch = LM.shard_batch({k: torch.from_numpy(v) for k, v in unflatten(
            inp, f"{arch}/batch").items()}, sharder)
        whole = params_from_jax_numpy(unflatten(inp, f"{arch}/params"),
                                      "cpu")
        params = local_lm_params(whole, cfg, sharder)
        loss, grads = LM.loss_and_grads(LM.make_loss_fn(cfg, sharder),
                                        params, batch, sharder)
        out[f"{tag}/loss_and_grads_loss"] = loss.numpy()
        for k, v in flatten(gather_lm_params(grads, cfg, sharder),
                            f"{tag}/grads").items():
            out[k] = v.numpy()
        if cfg.moe is None:
            # this shard's own mean, as one rank would compute it
            out[f"{tag}/local_mean"] = LM.make_loss_fn(cfg)(
                whole, batch).detach().numpy()
        opt = adamw(LR)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        _, metrics = LM.make_train_step(cfg, opt, sharder)(state, batch)
        out[f"{tag}/loss"] = metrics["loss"].numpy()
        out[f"{tag}/grad_norm"] = metrics["grad_norm"].numpy()
    return out


def _session_cfg():
    """mixtral-8x7b's reduced config at capacity factor E = 4, where the
    1-rank global formulation drops nothing either."""
    import dataclasses
    cfg = _cfg("mixtral-8x7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _job_sessions(rank, world, out_dir):
    """Over 2 ranks: the Engine session on (1, 2) (its losses and grad
    norms), the launcher's summary line of the same session, and what the
    Engine refuses."""
    from repro_torch.configs import get_arch
    from repro_torch.engine import Engine
    from repro_torch.launch.mesh import make_mesh
    cfg = _session_cfg()
    eng = Engine(cfg, device="cpu", model_axis=2, lr=LR)
    sess = eng.train_session(**SESSION)
    rep = sess.run(SESSION_STEPS)
    out = {"losses": np.asarray([h["loss"] for h in rep.history]),
           "gnorms": np.asarray([h["grad_norm"] for h in rep.history]),
           "layout": np.asarray(sess.params["units"][0]["moe"][
               "w_gate"].shape),
           "summary": np.frombuffer(Engine(
               get_arch("mixtral-8x7b").reduced(), device="cpu",
               model_axis=2).train_session().run(4).summary().encode(),
               np.uint8)}
    lm = get_arch("internlm2-1.8b").reduced()
    cases = {
        "ckpt": lambda: "ok: resume_step=%d" % Engine(
            lm, device="cpu", model_axis=2).train_session(
                ckpt_dir=os.path.join(out_dir, "unused")).resume_step,
        "batch": lambda: Engine(lm, device="cpu",
                                mesh=make_mesh((2, 1), ("data", "model")))
        .train_session(batch=3),
        "dp_axes": lambda: Engine(lm, device="cpu", dp_axes=("data",)),
    }
    for name, fn in cases.items():
        try:
            msg = fn() or "no error"
        except (ValueError, NotImplementedError) as err:
            msg = f"{type(err).__name__}: {err}"
        out[f"error/{name}"] = np.frombuffer(msg.encode(), np.uint8)
    return out


# --------------------------------------------------------- the reference
REFERENCE = """
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
assert len(jax.devices()) == 4, jax.devices()
from repro.configs.registry import ARCHS
from repro.models import lm, transformer as JT
from repro.models.common import Sharder
from repro.optim import adamw
JT.COMPUTE_DTYPE = lm.COMPUTE_DTYPE = jnp.float32

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

for arch, shape in {cases}:
    cfg = ARCHS[arch].reduced()
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    sharder = Sharder(mesh)
    params = unflatten(f"{{arch}}/params")
    batch = unflatten(f"{{arch}}/batch")
    opt = adamw({lr})
    state = {{"params": params, "opt": opt.init(params),
              "step": jnp.zeros((), jnp.int32)}}
    step = lm.make_train_step(cfg, opt, sharder)
    loss_fn = lm.make_loss_fn(cfg, sharder)
    metrics, grads = jax.jit(lambda st, b: (
        step(st, b)[1], jax.grad(loss_fn)(st["params"], b)))(state, batch)
    tag = f"{{arch}}/{{shape[0]}}x{{shape[1]}}"
    out[tag + "/loss"] = np.asarray(metrics["loss"])
    out[tag + "/grad_norm"] = np.asarray(metrics["grad_norm"])
    out.update(flatten(grads, tag + "/grads"))
np.savez(d + "/ref.npz", **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    """The inputs, the reference's results, the 4 ranks' and the 2
    ranks'; the reference's subprocess runs while the ranks do."""
    d = tmp_path_factory.mktemp("lm_ranks")
    _inputs(d / "inputs.npz")
    code = REFERENCE.format(out_dir=str(d), cases=CASES, lr=LR)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(subproc, code, 4, ranks_mod.SPAWN_TIMEOUT_S)
        k4 = ranks_mod.spawn(_job_reference_cases, 4, d)
        k2 = ranks_mod.spawn(_job_sessions, 2, d)
        proc = ref.result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {"ref": dict(np.load(d / "ref.npz")), 4: k4, 2: k2}


def _tag(arch, shape):
    return f"{arch}/{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("arch,shape", CASES, ids=lambda c: str(c))
def test_train_step_loss_and_grad_norm_match_reference(runs, arch, shape):
    """The train step's metrics on every rank: the global batch's loss
    (each rank's NLL over the global count of valid labels, summed over
    "data") and grad norm (sharded leaves' shards once, replicated leaves
    once), against the reference's at 1e-5."""
    tag, ref = _tag(arch, shape), runs["ref"]
    for r in runs[4]:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r[f"{tag}/{k}"], ref[f"{tag}/{k}"],
                                       err_msg=k, **SCALAR_TOL)
        np.testing.assert_array_equal(r[f"{tag}/loss_and_grads_loss"],
                                      r[f"{tag}/loss"])


@pytest.mark.parametrize("arch,shape", CASES, ids=lambda c: str(c))
def test_grads_match_reference(runs, arch, shape):
    """Every leaf's grad, summed over "data" and gathered whole over
    "model", on every rank, against ``jax.grad`` of the reference's loss
    over the mesh."""
    tag, ref = _tag(arch, shape), runs["ref"]
    keys = sorted(k for k in ref if k.startswith(tag + "/grads/"))
    assert keys
    gnorm = float(ref[f"{tag}/grad_norm"])
    for r in runs[4]:
        assert sorted(k for k in r if k.startswith(tag + "/grads/")) == keys
        for k in keys:
            w = ref[k]
            np.testing.assert_allclose(
                r[k], w, rtol=GRAD_RTOL,
                atol=max(GRAD_RTOL * np.abs(w).max(), ROUND_OFF * gnorm),
                err_msg=k)


def test_loss_is_not_the_mean_of_the_ranks_means(runs):
    """The data shards count different valid labels (row 0 has 5 masked),
    so the mean of the two shards' own means lies off the reference's
    loss by more than the tolerance, while every rank reports the
    reference's."""
    ref = float(runs["ref"]["internlm2-1.8b/2x2/loss"])
    ranks = runs[4]                       # (2, 2): ranks 0 and 2 differ
    means = [float(ranks[r]["internlm2-1.8b/2x2/local_mean"])
             for r in (0, 2)]
    assert abs(np.mean(means) - ref) > 10 * SCALAR_TOL["atol"], means
    for r in ranks:
        assert float(r["internlm2-1.8b/2x2/loss"]) == pytest.approx(
            ref, rel=1e-5)


def test_engine_session_over_2_ranks_matches_one_rank(runs):
    """``Engine(cfg, model_axis=2)`` of mixtral-8x7b's reduced config at
    capacity factor 4 (the ep body over 2 ranks; each holds 2 of its 4
    experts; no copy drops on either side) trains as the 1-rank session, in bf16 as the model runs: every step's loss
    within 1e-2 and grad norm within 4% (``test_torch_lm_train.py``'s
    bf16 tolerances)."""
    from repro_torch.engine import Engine
    cfg = _session_cfg()
    rep = Engine(cfg, device="cpu", lr=LR).train_session(**SESSION).run(
        SESSION_STEPS)
    losses = [h["loss"] for h in rep.history]
    gnorms = [h["grad_norm"] for h in rep.history]
    E, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    for r in runs[2]:
        assert tuple(r["layout"]) == (cfg.n_layers, E // 2, d, ff)
        np.testing.assert_allclose(r["losses"], losses, rtol=0,
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(r["gnorms"], gnorms, rtol=GRAD_REL)
    np.testing.assert_array_equal(runs[2][0]["losses"],
                                  runs[2][1]["losses"])


ERRORS = {
    # checkpoints over k ranks are ported (ROADMAP A6b-ii)
    "ckpt": ("ok", "resume_step=0"),
    "batch": ("ValueError", "batch of 3 does not split over the 2 ranks"),
    "dp_axes": ("ValueError", "dp_axes is DLRM-only"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_lm_over_2_ranks_refuses(runs, case):
    """A batch that does not split over "data" (naming both sizes) and
    dp_axes for an LM (the reference's ``_check_lm``) raise on every
    rank; a ckpt_dir over 2 ranks is taken (checkpoints over k ranks,
    ROADMAP A6b-ii)."""
    kind, text = ERRORS[case]
    for r in runs[2]:
        msg = bytes(r[f"error/{case}"]).decode()
        assert msg.startswith(kind + ":") and text in msg, msg


def test_lm_launcher_over_2_ranks_prints_the_session_losses(runs):
    """``torch.distributed.run --nproc-per-node 2`` of the train launcher
    with ``--workload lm --arch mixtral-8x7b --smoke --model-axis 2``
    prints, from rank 0 alone, the summary of the Engine session on the
    same (1, 2) mesh."""
    env = dict(os.environ, PYTHONPATH=str(ranks_mod.REPO / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--workload", "lm", "--arch", "mixtral-8x7b", "--device", "cpu",
         "--smoke", "--steps", "4", "--model-axis", "2"],
        capture_output=True, text=True, env=env,
        timeout=ranks_mod.SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    lines = [l for l in proc.stdout.splitlines()
             if l.startswith("[train] lm")]
    want = bytes(runs[2][0]["summary"]).decode()
    assert lines == [want], proc.stdout
