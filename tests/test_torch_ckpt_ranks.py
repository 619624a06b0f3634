"""Checkpoints over k ranks (ROADMAP A6b-ii) against the reference's
k-device checkpoints.

The port runs gloo ranks on the CPU, spawned as ``tests/test_torch_ranks.
py`` spawns them; the reference runs in a subprocess with 4 virtual
devices (``conftest.run_with_devices``). Both packages train on the same
weights (the reference's ``init_dlrm`` / ``init_model`` patched to return
the port's seed-0 init) and the same numpy batches (each session
module's ``make_recsys_batch`` / ``make_lm_batch`` patched), the LM at
fp32 compute in both, as ``tests/test_torch_lm_ranks.py`` runs it.

Held:

  * DLRM plan none with SGD on (2,), the auto plan with AdaGrad on (2,),
    and ``dp_axes=("data",)`` with ``compress_grads`` on (2, 2): a
    checkpoint at step 4, resumed for 4 more steps, equals the
    uninterrupted 8-step run at the same k bitwise, and the k-rank
    checkpoint at step 4 holds, leaf for leaf by path and at full width,
    the values of the reference's k-device checkpoint (rtol = atol =
    2e-5, the reference's k-device train tolerance);
  * the plan-none SGD checkpoint written by 2 ranks resumes on 1 rank and
    on 4 and continues within that tolerance of the 2-rank run, while a
    layout that depends on k raises ValueError: the error-feedback
    residuals of (2, 2) restored on 1 rank, and a placed plan whose
    fast/bulk groups differ at another k;
  * the LM, mixtral-8x7b at ``reduced()`` over (1, 2) with the ep body and
    internlm2-1.8b at ``reduced()`` over (2, 2): a checkpoint at step 2
    resumed for 2 more equals the uninterrupted run bitwise, and its
    params and AdamW moments equal the reference's (lr 2e-5, so that an
    element whose grad is near zero, whose first Adam step is its sign,
    cannot move past the tolerance);
  * ``torch.distributed.run`` of the train launcher with ``--ckpt-dir``
    over 2 ranks writes a checkpoint, and a second run resumes from it.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import inspect
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_ranks as ranks_mod

NAME = "dlrm-rm2-small-unsharded"
TRAIN_TOL = dict(rtol=2e-5, atol=2e-5)
LR, LM_LR = 0.05, 2e-5
DLRM_CASES = {
    # name: (mesh shape, axes, embedding axis, dp_axes, optimizer, plan,
    #        compress_grads)
    "none_sgd": ((2,), ("model",), "model", (), "sgd", False, False),
    "auto_adagrad": ((2,), ("model",), "model", (), "adagrad", True, False),
    "dp_compress": ((2, 2), ("data", "model"), "model", ("data",), "sgd",
                    False, True),
}
LM_CASES = {"mixtral-8x7b": (1, 2), "internlm2-1.8b": (2, 2)}
LM_SESSION = dict(batch=4, seq=17, schedule_steps=10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    from repro_torch.configs import get_dlrm
    return get_dlrm(NAME).reduced()


def _lm_cfg(arch):
    from repro_torch.configs import get_arch
    return get_arch(arch).reduced()


# ---------------------------------------------------- the shared batches
def _recsys_np(cfg, step, seed=0):
    rng = np.random.default_rng([seed, step, 7])
    b = cfg.batch_size
    return {"dense": rng.standard_normal((b, cfg.num_dense)).astype(
                np.float32),
            "indices": rng.integers(0, cfg.rows_per_table, (
                b, cfg.num_tables, cfg.lookups_per_table)).astype(np.int32),
            "labels": rng.integers(0, 2, b).astype(np.float32)}


def _lm_np(vocab, step, seed, batch, seq):
    rng = np.random.default_rng([seed, step, 11])
    tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int64)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _patch_port():
    """The port's sessions on the shared batches, the LM at fp32."""
    from repro_torch.engine import training
    from repro_torch.models import lm as LM
    from repro_torch.models import transformer as T

    def recsys(cfg, step, seed=0, alpha=0.0, device=None):
        return {k: torch.from_numpy(v).to(device)
                for k, v in _recsys_np(cfg, step, seed).items()}

    def lm_batch(cfg, step, seed=0, batch=8, seq=128, chain_prob=0.8,
                 device=None):
        return {k: torch.from_numpy(v).to(device) for k, v in _lm_np(
            cfg.vocab_size, step, seed, batch, seq).items()}

    training.make_recsys_batch = recsys
    training.make_lm_batch = lm_batch
    T.COMPUTE_DTYPE = LM.COMPUTE_DTYPE = torch.float32


@pytest.fixture
def port_patched(monkeypatch):
    """``_patch_port`` in this process, undone after the test: the batch
    functions and the compute dtype are module state that later tests of
    the same worker read."""
    from repro_torch.engine import training
    from repro_torch.models import lm as LM
    from repro_torch.models import transformer as T
    for mod, name in ((training, "make_recsys_batch"),
                      (training, "make_lm_batch"), (T, "COMPUTE_DTYPE"),
                      (LM, "COMPUTE_DTYPE")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    _patch_port()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _flat(tree, prefix=""):
    """{"a/0/b": leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _make_inputs(d):
    """The port's seed-0 DLRM and LM inits (the reference trains from
    them) and the auto plan at 2 ranks, with a variant of 3 fast tables
    whose groups differ at 1 rank and 2."""
    from repro_torch.core import dlrm
    from repro_torch.engine.planning import build_auto_plan
    from repro_torch.models import transformer as T
    cfg = _cfg()
    out = {f"dlrm/{k}": v for k, v in _flat(_numpy_tree(dlrm.init_dlrm(
        cfg, torch.Generator().manual_seed(0)))).items()}
    for arch in LM_CASES:
        out.update({f"lm/{arch}/{k}": v for k, v in _flat(_numpy_tree(
            T.init_model(_lm_cfg(arch), torch.Generator().manual_seed(
                0)))).items()})
    plan = build_auto_plan(cfg, 2, alpha=1.05, device="cpu").plan
    fast = sorted(p.table_id for p in plan.placements if p.tier == "fast")
    assert len(fast) % 2 == 0, fast
    odd = dataclasses.replace(plan, placements=tuple(
        dataclasses.replace(p, tier="bulk") if p.table_id == fast[-1] else p
        for p in plan.placements))
    for tag, p in (("plan", plan), ("plan_odd", odd)):
        out[tag] = np.frombuffer(json.dumps(dataclasses.asdict(p)).encode(),
                                 np.uint8)
    np.savez(d / "inputs.npz", **out)


def _plan(d, tag="plan"):
    from repro_torch.core.planner import ShardingPlan, TablePlacement
    blob = np.load(os.path.join(d, "inputs.npz"))[tag]
    return ranks_mod._plan(ShardingPlan, TablePlacement, blob)


def _dlrm_session(d, name, mesh, ckpt_dir, **kw):
    from repro_torch.engine.training import TrainSession
    shape, axes, axis, dp, opt, planned, compress = DLRM_CASES[name]
    return TrainSession(
        _cfg(), device="cpu", plan=_plan(d) if planned else None,
        optimizer=opt, lr=LR, alpha=1.05, ckpt_dir=ckpt_dir, ckpt_every=4,
        mesh=mesh, axis=axis, dp_axes=dp, compress_grads=compress, **kw)


def _resume_pair(make, ckpt, steps):
    """An uninterrupted run of 2 x ``steps`` into ``ckpt``/full, and a run
    of ``steps`` into ``ckpt``/cut resumed by a new session for
    ``steps`` more; the resumed session's start step."""
    make(str(ckpt / "full")).run(2 * steps)
    make(str(ckpt / "cut")).run(steps)
    resumed = make(str(ckpt / "cut"))
    start = resumed.resume_step
    resumed.run(steps)
    return start


# -------------------------------------------------------------- the ranks
def _job_k2(rank, world, out_dir):
    """On 2 ranks: the (2,) DLRM cases, the odd plan's checkpoint, the
    mixtral (1, 2) LM case."""
    from repro_torch.engine.training import LMTrainSession
    from repro_torch.launch.mesh import make_mesh
    _patch_port()
    d = Path(out_dir)
    out = {}
    for name in ("none_sgd", "auto_adagrad"):
        shape, axes = DLRM_CASES[name][:2]
        mesh = make_mesh(shape, axes)
        out[f"{name}/start"] = np.array([_resume_pair(
            lambda c: _dlrm_session(d, name, mesh, c), d / "port" / name,
            4)])
    from repro_torch.engine.training import TrainSession
    TrainSession(_cfg(), device="cpu", plan=_plan(d, "plan_odd"),
                 optimizer="adagrad", lr=LR, alpha=1.05,
                 ckpt_dir=str(d / "port" / "plan_odd"), ckpt_every=1,
                 mesh=make_mesh((2,), ("model",)), axis="model").run(1)
    arch = "mixtral-8x7b"
    mesh = make_mesh(LM_CASES[arch], ("data", "model"))
    out[f"{arch}/start"] = np.array([_resume_pair(
        lambda c: LMTrainSession(_lm_cfg(arch), device="cpu", lr=LM_LR,
                                 ckpt_dir=c, ckpt_every=2, mesh=mesh,
                                 moe_impl="ep", **LM_SESSION),
        d / "port" / arch, 2)])
    if rank == 0:
        for dst in ("cross4", "cross1"):
            shutil.copytree(d / "port" / "none_sgd" / "full" /
                            "step_00000004",
                            d / "port" / dst / "step_00000004")
    return out


def _job_k4(rank, world, out_dir):
    """On 4 ranks: the (2, 2) DLRM case, the internlm (2, 2) LM case, and
    the 2-rank plan-none checkpoint resumed on 4."""
    from repro_torch.engine.training import LMTrainSession, TrainSession
    from repro_torch.launch.mesh import make_mesh
    _patch_port()
    d = Path(out_dir)
    out = {}
    name = "dp_compress"
    mesh = make_mesh(*DLRM_CASES[name][:2])
    out[f"{name}/start"] = np.array([_resume_pair(
        lambda c: _dlrm_session(d, name, mesh, c), d / "port" / name, 4)])
    arch = "internlm2-1.8b"
    mesh = make_mesh(LM_CASES[arch], ("data", "model"))
    out[f"{arch}/start"] = np.array([_resume_pair(
        lambda c: LMTrainSession(_lm_cfg(arch), device="cpu", lr=LM_LR,
                                 ckpt_dir=c, ckpt_every=2, mesh=mesh,
                                 **LM_SESSION), d / "port" / arch, 2)])
    sess = TrainSession(_cfg(), device="cpu", lr=LR, alpha=1.05,
                        ckpt_dir=str(d / "port" / "cross4"), ckpt_every=4,
                        mesh=make_mesh((4,), ("model",)), axis="model")
    out["cross4/start"] = np.array([sess.resume_step])
    sess.run(4)
    return out


# --------------------------------------------------------- the reference
REFERENCE = """
import dataclasses, json, os
os.environ["REPRO_MOE_IMPL"] = "ep"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
assert len(jax.devices()) == 4, jax.devices()
import repro.core.dlrm as jdlrm
import repro.engine.training as jtraining
from repro.configs.registry import ARCHS, get_dlrm
from repro.core.planner import ShardingPlan, TablePlacement
from repro.engine.training import LMTrainSession, TrainSession
from repro.models import lm, transformer as JT
JT.COMPUTE_DTYPE = lm.COMPUTE_DTYPE = jnp.float32
{helpers}

d = {out_dir!r}
inp = dict(np.load(d + "/inputs.npz"))
out = {{}}

def tree(prefix):
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

def path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                    for k in kp)

def keep(tag, sess, step):
    with np.load(f"{{d}}/ref/{{tag}}/step_{{step:08d}}/arrays.npz") as z:
        leaves = jax.tree_util.tree_flatten_with_path(sess.state)[0]
        for i, (kp, _) in enumerate(leaves):
            out[f"{{tag}}/{{path(kp)}}"] = z[f"leaf_{{i}}"]

jdlrm.init_dlrm = lambda key, cfg: tree("dlrm")
jtraining.make_recsys_batch = lambda cfg, s, seed=0, alpha=0.0: {{
    k: jnp.asarray(v) for k, v in _recsys_np(cfg, s, seed).items()}}
jtraining.make_lm_batch = lambda cfg, s, seed=0, batch=8, seq=128, \\
    chain_prob=0.8: {{k: jnp.asarray(v.astype(np.int32)) for k, v in
                     _lm_np(cfg.vocab_size, s, seed, batch, seq).items()}}
d_plan = json.loads(bytes(inp["plan"]).decode())
d_plan["placements"] = tuple(TablePlacement(**p)
                             for p in d_plan["placements"])
plan = ShardingPlan(**d_plan)
cfg = get_dlrm("{name}").reduced()
devs = np.array(jax.devices())
for tag, (shape, axes, axis, dp, opt, planned, compress) in {dlrm_cases}:
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
    sess = TrainSession(cfg, mesh, axis, plan=plan if planned else None,
                        optimizer=opt, lr={lr}, alpha=1.05,
                        ckpt_dir=f"{{d}}/ref/{{tag}}", ckpt_every=4,
                        dp_axes=dp, compress_grads=compress)
    sess.run(4)
    keep(tag, sess, 4)
for arch, shape in {lm_cases}:
    JT.init_model = lambda key, cfg, arch=arch: tree(f"lm/{{arch}}")
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=list(devs[:int(np.prod(shape))]),
                         axis_types=(AxisType.Auto,) * 2)
    sess = LMTrainSession(ARCHS[arch].reduced(), mesh, lr={lm_lr},
                          ckpt_dir=f"{{d}}/ref/{{arch}}", ckpt_every=2,
                          **{lm_session})
    sess.run(2)
    keep(arch, sess, 2)
np.savez(d + "/ref.npz", **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    """The inputs, the reference's checkpoints and the ranks' runs: 2
    ranks, then 4 (which resume a checkpoint of the 2); the reference's
    subprocess runs while the ranks do."""
    d = tmp_path_factory.mktemp("ckpt_ranks")
    _make_inputs(d)
    helpers = (inspect.getsource(_recsys_np) + "\n\n"
               + inspect.getsource(_lm_np)).replace("{", "{{").replace(
                   "}", "}}")
    code = REFERENCE.replace("{helpers}", helpers).format(
        out_dir=str(d), name=NAME, lr=LR, lm_lr=LM_LR,
        dlrm_cases=list(DLRM_CASES.items()),
        lm_cases=list(LM_CASES.items()), lm_session=LM_SESSION)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(subproc, code, 4, ranks_mod.SPAWN_TIMEOUT_S)
        k2 = ranks_mod.spawn(_job_k2, 2, d)
        k4 = ranks_mod.spawn(_job_k4, 4, d)
        proc = ref.result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {"ref": dict(np.load(d / "ref.npz")), 2: k2, 4: k4, "dir": d}


def _ckpt(d, step):
    """{path: full-width array} of a checkpoint."""
    root = Path(d) / f"step_{step:08d}"
    manifest = json.loads((root / "manifest.json").read_text())
    with np.load(root / "arrays.npz") as z:
        return {m["path"]: z[f"leaf_{i}"]
                for i, m in enumerate(manifest["leaves"])}


def _port(runs, tag, part, step):
    return _ckpt(runs["dir"] / "port" / tag / part, step)


def _k(name):
    return int(np.prod(DLRM_CASES[name][0]))


# ------------------------------------------------------------------ DLRM
@pytest.mark.parametrize("name", sorted(DLRM_CASES))
def test_dlrm_checkpoint_resumes_to_the_uninterrupted_run(runs, name):
    """A checkpoint at step 4, resumed by a new session on every rank for
    4 more steps, equals the uninterrupted 8 steps bitwise."""
    for r in runs[_k(name)]:
        assert r[f"{name}/start"][0] == 4
    full, cut = (_port(runs, name, p, 8) for p in ("full", "cut"))
    assert sorted(full) == sorted(cut)
    for path, a in full.items():
        assert cut[path].shape == a.shape, path
        np.testing.assert_array_equal(cut[path], a, err_msg=path)
    np.testing.assert_equal(_port(runs, name, "cut", 4),
                            _port(runs, name, "full", 4))


@pytest.mark.parametrize("name", sorted(DLRM_CASES))
def test_dlrm_checkpoint_holds_the_reference_checkpoint(runs, name):
    """The k-rank checkpoint at step 4 holds, leaf for leaf by path and at
    full width, the reference's k-device checkpoint."""
    got = _port(runs, name, "full", 4)
    ref = {k[len(name) + 1:]: v for k, v in runs["ref"].items()
           if k.startswith(name + "/")}
    assert sorted(got) == sorted(ref)
    for path, want in ref.items():
        assert got[path].shape == want.shape, path
        np.testing.assert_allclose(got[path], want, err_msg=path,
                                   **TRAIN_TOL)
    if name == "dp_compress":
        assert got["1/ef/top_mlp/0/w"].shape[0] == 4


@pytest.mark.parametrize("k", [1, 4])
def test_a_2_rank_checkpoint_resumes_on_1_and_4_ranks(runs, k,
                                                      port_patched):
    """Plan none with SGD, written by 2 ranks at step 4: resumed on 1 rank
    (here) and on 4 (the 4-rank spawn), 4 more steps within the
    tolerance of the uninterrupted 2-rank run."""
    from repro_torch.engine.training import TrainSession
    want = _port(runs, "none_sgd", "full", 8)
    d = runs["dir"] / "port" / f"cross{k}"
    if k == 1:
        sess = TrainSession(_cfg(), device="cpu", lr=LR, alpha=1.05,
                            ckpt_dir=str(d), ckpt_every=4)
        assert sess.resume_step == 4
        sess.run(4)
    else:
        assert all(r["cross4/start"][0] == 4 for r in runs[4])
    got = _ckpt(d, 8)
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        np.testing.assert_allclose(got[path], a, err_msg=path, **TRAIN_TOL)


@pytest.mark.parametrize("case", ["residuals", "plan_groups"])
def test_a_layout_that_depends_on_k_raises(runs, case, port_patched):
    """The (2, 2) error-feedback residuals (one per rank) do not restore
    on 1 rank, nor a placed plan's checkpoint whose fast/bulk groups
    differ at 1 rank: ValueError naming what differs."""
    from repro_torch.engine.training import TrainSession
    d = runs["dir"] / "port"
    if case == "residuals":
        with pytest.raises(ValueError, match="leaf '1/ef/bot_mlp/0/b'"):
            TrainSession(_cfg(), device="cpu", lr=LR, compress_grads=True,
                         ckpt_dir=str(d / "dp_compress" / "full"))
    else:
        with pytest.raises(ValueError, match="saved under the layout"):
            TrainSession(_cfg(), device="cpu", plan=_plan(runs["dir"],
                                                          "plan_odd"),
                         optimizer="adagrad", lr=LR,
                         ckpt_dir=str(d / "plan_odd"))


# -------------------------------------------------------------------- LM
@pytest.mark.parametrize("arch", sorted(LM_CASES))
def test_lm_checkpoint_resumes_to_the_uninterrupted_run(runs, arch):
    """A checkpoint at step 2, resumed for 2 more steps, equals the
    uninterrupted 4 steps bitwise: params, AdamW moments and counts."""
    k = int(np.prod(LM_CASES[arch]))
    assert all(r[f"{arch}/start"][0] == 2 for r in runs[k])
    full, cut = (_port(runs, arch, p, 4) for p in ("full", "cut"))
    assert sorted(full) == sorted(cut)
    for path, a in full.items():
        assert cut[path].shape == a.shape, path
        np.testing.assert_array_equal(cut[path], a, err_msg=path)


@pytest.mark.parametrize("arch", sorted(LM_CASES))
def test_lm_checkpoint_holds_the_reference_checkpoint(runs, arch):
    """The k-rank checkpoint at step 2 (the expert weights and their
    moments gathered over "model") holds the reference's k-device
    checkpoint, leaf for leaf by path."""
    got = _port(runs, arch, "full", 2)
    ref = {k[len(arch) + 1:]: v for k, v in runs["ref"].items()
           if k.startswith(arch + "/")}
    assert sorted(got) == sorted(ref)
    for path, want in ref.items():
        assert got[path].shape == want.shape, path
        np.testing.assert_allclose(got[path], want, err_msg=path,
                                   **TRAIN_TOL)


# --------------------------------------------------------------- launcher
def test_train_launcher_resumes_a_checkpoint_over_2_ranks(tmp_path):
    """``torch.distributed.run --nproc-per-node 2`` of the train launcher
    with --ckpt-dir writes a checkpoint at step 4; a second run resumes
    from it, rank 0 printing the step."""
    ckpt = tmp_path / "ck"
    outs = []
    for i in range(2):
        logs = tmp_path / f"logs{i}"
        proc = ranks_mod.launch(
            2, ["repro_torch.launch.train", "--device", "cpu", "--smoke",
                "--steps", "4", "--model-axis", "2", "--ckpt-dir", str(ckpt),
                "--ckpt-every", "4"], logs)
        assert proc.returncode == 0, ranks_mod.launch_failure(proc, logs)
        outs.append([l for l in proc.stdout.splitlines()
                     if "resume_step=" in l or l.startswith("[train] dlrm")])
    assert [len(o) for o in outs] == [2, 2], outs
    assert outs[0][0].endswith("resume_step=0")
    assert outs[1][0].endswith("resume_step=4")
    assert "steps=4 (from 4)" in outs[1][1]
    assert sorted(os.listdir(ckpt)) == ["step_00000004", "step_00000008"]
