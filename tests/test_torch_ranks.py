"""The port over k ranks (ROADMAP A6b-i) against the reference's mesh.

The port runs k gloo ranks on the CPU, spawned with
``torch.multiprocessing`` over a ``FileStore`` under ``tmp_path`` (no TCP
port, so pytest-xdist workers never collide), one thread a rank. The
reference runs in a subprocess with 4 virtual devices
(``conftest.run_with_devices``), on meshes (2,), (4,) and (2, 2). Both
read one set of numpy inputs; the ranks write npz files and the parent
holds them against the reference's, at the reference's own k-device
tolerances: train-step params rtol = atol = 2e-5
(``tests/test_dlrm_distributed.py``), serve probs rtol 2e-5, atol 2e-6;
ids the ranks exchange, bitwise.

One spawn of 4 ranks and one of 2 (module-scoped fixtures) run every
case: each primitive of ``parallel.primitives`` at k = 2 and 4, the serve
step under plan none, the sharded config in both wire modes and an auto
plan, the five train cases of ``tests/test_dlrm_distributed.py``, depth 2
against depth 1, ``dp_axes`` on (2, 2), the Engine's validation, the
paths that boards of k ranks and checkpoints over k ranks opened (ROADMAP
A6b-ii: a ``ckpt_dir``, the sharded fleet, the serve launcher's fleet),
and Engine sessions at k = 2 against the port's own 1-rank sessions. One ``torch.distributed.run`` of the train
launcher over 2 ranks prints the losses of an Engine session at k = 2.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 300
B, T, R, L = 16, 8, 128, 4            # the primitives' inputs
LR = 0.05
TRAIN_TOL = dict(rtol=2e-5, atol=2e-5)
SERVE_TOL = dict(rtol=2e-5, atol=2e-6)
UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_CASES = [
    ("dlrm-rm2-small-unsharded", "unpooled", "sgd"),
    ("dlrm-rm2-small-sharded", "unpooled", "sgd"),
    ("dlrm-rm2-small-sharded", "partial_pool", "sgd"),
    ("dlrm-rm2-large-unsharded", "unpooled", "adagrad"),
    ("dlrm-rm2-large-sharded", "partial_pool", "adagrad"),
]
SERVE_CASES = [("none", "dlrm-rm2-small-unsharded", "partial_pool"),
               ("none", "dlrm-rm2-small-sharded", "partial_pool"),
               ("none", "dlrm-rm2-small-sharded", "unpooled"),
               ("auto", "dlrm-rm2-small-unsharded", "unpooled")]
CHUNKS = (4, 4096)
MODES = ("partial_pool", "unpooled")


# ---------------------------------------------------------------- inputs
def _cfg(name):
    from repro_torch.configs import get_dlrm
    return dataclasses.replace(get_dlrm(name).reduced(), batch_size=32,
                               rows_per_table=128, num_tables=8)


def _flatten(tree, prefix):
    out = {}
    for k in ("bot_mlp", "top_mlp"):
        for i, layer in enumerate(tree[k]):
            for n, p in layer.items():
                out[f"{prefix}/{k}/{i}/{n}"] = np.asarray(p)
    for k in tree:
        if k.startswith("tables"):
            out[f"{prefix}/{k}"] = np.asarray(tree[k])
    return out


def _unflatten(arrays, prefix, wrap=lambda x: x):
    tree = {"bot_mlp": [], "top_mlp": []}
    for key in sorted(k for k in arrays if k.startswith(prefix + "/")):
        parts = key[len(prefix) + 1:].split("/")
        if len(parts) == 1:
            tree[parts[0]] = wrap(arrays[key])
            continue
        layers = tree[parts[0]]
        while len(layers) <= int(parts[1]):
            layers.append({})
        layers[int(parts[1])][parts[2]] = wrap(arrays[key])
    for k in ("bot_mlp", "top_mlp"):
        tree[k] = [{"w": l["w"], "b": l["b"]} for l in tree[k]]
    return tree


def _batches(cfg, rng, n):
    return [{"dense": rng.standard_normal(
                (cfg.batch_size, cfg.num_dense)).astype(np.float32),
             "indices": rng.integers(0, cfg.rows_per_table, (
                 cfg.batch_size, cfg.num_tables, cfg.lookups_per_table),
                 dtype=np.int32),
             "labels": rng.integers(0, 2, cfg.batch_size).astype(
                 np.float32)} for _ in range(n)]


def _make_inputs(path):
    """Every case's inputs, one npz both packages read."""
    from repro_torch.core import dlrm
    from repro_torch.engine.planning import build_auto_plan
    rng = np.random.default_rng(0)
    out = {"p_tables": rng.standard_normal((T, R, 32)).astype(np.float32),
           "p_idx": rng.integers(0, R, (B, T, L), dtype=np.int32),
           "p_g": rng.standard_normal((B, T, 32)).astype(np.float32)}
    for name in {c for c, _, _ in TRAIN_CASES}:
        cfg = _cfg(name)
        params = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0))
        out.update(_flatten({k: (v.numpy() if torch.is_tensor(v) else
                                 [{n: p.numpy() for n, p in l.items()}
                                  for l in v]) for k, v in params.items()},
                            f"params/{name}"))
        for s, b in enumerate(_batches(cfg, rng, 3)):
            for k, v in b.items():
                out[f"batch/{name}/{s}/{k}"] = v
    cfg = _cfg("dlrm-rm2-small-unsharded")
    plan = build_auto_plan(cfg, 4, alpha=1.05, device="cpu").plan
    out["auto_plan"] = np.frombuffer(json.dumps(
        dataclasses.asdict(plan)).encode(), np.uint8)
    np.savez(path, **out)


def _plan(cls_plan, cls_placement, blob):
    d = json.loads(bytes(blob).decode())
    d["placements"] = tuple(cls_placement(**p) for p in d["placements"])
    return cls_plan(**d)


# ------------------------------------------------------------- the ranks
def _rank_main(rank, world, store, out_dir, fn):
    torch.set_num_threads(1)
    import torch.distributed as dist
    job = fn.__name__
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        res = fn(rank, world, out_dir)
        np.savez(os.path.join(out_dir, f"{job}-{rank}.npz"), **res)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        Path(out_dir, f"{job}-{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def spawn(fn, world, out_dir):
    """Run ``fn(rank, world, out_dir)`` (a module-level function, so that
    the spawned ranks can import it) on ``world`` gloo ranks; their npz
    results, rank by rank. Fails on a rank's error, exit or the spawn
    timeout."""
    job = fn.__name__
    ctx = torch.multiprocessing.get_context("spawn")
    store = os.path.join(out_dir, f"{job}.store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, str(out_dir), fn))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = "".join(Path(out_dir, f"{job}-{r}.err").read_text()
                   for r in range(world)
                   if Path(out_dir, f"{job}-{r}.err").exists())
    assert not hung, f"{job}: {len(hung)} ranks hung past " \
                     f"{SPAWN_TIMEOUT_S} s\n{errs}"
    assert all(p.exitcode == 0 for p in procs), \
        f"{job}: exit codes {[p.exitcode for p in procs]}\n{errs}"
    return [dict(np.load(os.path.join(out_dir, f"{job}-{r}.npz")))
            for r in range(world)]


def _inputs(out_dir):
    return dict(np.load(os.path.join(out_dir, "inputs.npz")))


def _torch_params(inp, name):
    """A fresh copy: the steps update their params in place."""
    return _unflatten(inp, f"params/{name}",
                      lambda x: torch.from_numpy(x.copy()))


def _batch(inp, name, s):
    return {k: torch.from_numpy(inp[f"batch/{name}/{s}/{k}"])
            for k in ("dense", "indices", "labels")}


def _primitives(world, group):
    """Every primitive on this rank's shards of the primitives' inputs."""
    from repro_torch.parallel import primitives as prim
    from repro_torch.parallel.updates import sgd_row_update
    rank = prim.group_rank(group)
    inp = _PRIM_INPUTS
    tables, idx, g = (torch.from_numpy(inp[k]) for k in
                      ("p_tables", "p_idx", "p_g"))
    tn, rn, bn = T // world, R // world, B // world
    t_loc = tables[rank * tn:(rank + 1) * tn].clone()
    r_loc = tables[:, rank * rn:(rank + 1) * rn].clone()
    i_loc, g_loc = idx[rank * bn:(rank + 1) * bn], g[rank * bn:(rank + 1)
                                                    * bn]
    sgd = sgd_row_update(LR)
    out = {}
    pooled, owner = prim.table_wise_forward(t_loc, i_loc, group)
    out["tw_fwd_pooled"], out["tw_fwd_owner"] = pooled, owner
    fi, fg = prim.table_wise_expand_grads(owner, g_loc, group)
    out["tw_exp_idx"], out["tw_exp_g"] = fi, fg
    out["tw_bwd"] = prim.table_wise_backward_update(t_loc.clone(), owner,
                                                    g_loc, group, sgd)
    for mode in MODES:
        for chunk in CHUNKS:
            pooled, idx_all = prim.row_wise_forward(r_loc, i_loc, mode, chunk,
                                                    group)
            out[f"rw_fwd_{mode}_{chunk}"] = pooled
            out["rw_fwd_ids"] = idx_all
    fi, fg = prim.row_wise_expand_grads(rn, idx_all, g_loc, group=group)
    out["rw_exp_idx"], out["rw_exp_g"] = fi, fg
    for chunk in CHUNKS:
        out[f"rw_bwd_{chunk}"] = prim.row_wise_backward_update(
            r_loc.clone(), idx_all, g_loc, sgd, chunk, group)
    return {k: v.numpy() for k, v in out.items()}


_PRIM_INPUTS: dict = {}


def _job_k4(rank, world, out_dir):
    """Primitives at k=4; serve, train, depth and dp_axes steps; the
    Engine's validation."""
    import torch.distributed as dist

    from repro_torch.core.planner import ShardingPlan, TablePlacement
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import (build_step, init_dlrm_opt_state,
                                      make_exchange, shard_dlrm_params)
    inp = _inputs(out_dir)
    _PRIM_INPUTS.update(inp)
    out = {f"prim/{k}": v for k, v in _primitives(
        world, dist.group.WORLD).items()}
    mesh = make_mesh((2, 2), ("data", "model"))
    axis = ("data", "model")

    def sharded(name, exch):
        return shard_dlrm_params(_torch_params(inp, name), None, exch)

    def save(prefix, params):
        for k, v in _flatten({k: (v if k.startswith("tables") else
                                  [{n: p.detach() for n, p in l.items()}
                                   for l in v])
                              for k, v in params.items()}, prefix).items():
            out[k] = np.array(v)            # a copy, not a view

    # serve: plan none (both configs, both wires), an auto plan on (4,)
    for plan_arg, name, wire in SERVE_CASES:
        cfg = _cfg(name)
        if plan_arg == "auto":
            m, ax = make_mesh((4,), ("x",)), "x"
            plan = _plan(ShardingPlan, TablePlacement, inp["auto_plan"])
        else:
            m, ax, plan = mesh, axis, None
        exch = make_exchange(cfg, 4, plan=plan, row_wise_exchange=wire,
                             device="cpu", group=m.group(ax))
        params = sharded(name, exch)
        b = _batch(inp, name, 0)
        for depth in (1, 2):
            serve = build_step(cfg, m, mode="serve", axis=ax, exchange=exch,
                               pipeline_depth=depth)
            out[f"serve/{plan_arg}/{name}/{wire}/{depth}"] = serve(
                params, b["dense"], b["indices"]).numpy()
    # train: the five reference cases, 3 steps, on (2, 2)
    for name, wire, opt in TRAIN_CASES:
        cfg = _cfg(name)
        for depth in ((1, 2) if name == TRAIN_CASES[0][0] else (1,)):
            exch = make_exchange(cfg, 4, row_wise_exchange=wire,
                                 device="cpu", group=mesh.group(axis))
            step = build_step(cfg, mesh, mode="train", axis=axis,
                              exchange=exch, optimizer=opt, lr=LR,
                              pipeline_depth=depth)
            params = sharded(name, exch)
            state = init_dlrm_opt_state(cfg, opt, n=4, device="cpu")
            losses = []
            for s in range(3):
                b = _batch(inp, name, s)
                params, state, loss = step(params, state, b["dense"],
                                           b["indices"], b["labels"])
                losses.append(float(loss))
            tag = f"train/{name}/{wire}/{opt}/{depth}"
            save(tag, params)
            out[f"{tag}/losses"] = np.asarray(losses)
    # dp_axes: tables table-wise over "model", replicated over "data"
    name = "dlrm-rm2-small-unsharded"
    cfg = _cfg(name)
    for opt in ("sgd", "adagrad"):
        exch = make_exchange(cfg, 2, device="cpu", group=mesh.group("model"))
        step = build_step(cfg, mesh, mode="train", axis=("model",),
                          dp_axes=("data",), exchange=exch, optimizer=opt,
                          lr=LR)
        params = sharded(name, exch)
        state = init_dlrm_opt_state(cfg, opt, n=2, device="cpu")
        losses = []
        for s in range(3):
            b = _batch(inp, name, s)
            params, state, loss = step(params, state, b["dense"],
                                       b["indices"], b["labels"])
            losses.append(float(loss))
        save(f"dp/{opt}", params)
        out[f"dp/{opt}/losses"] = np.asarray(losses)
    out.update(_engine_errors())
    return out


def _engine_errors():
    """What the Engine and the launchers refuse on 4 ranks, each message
    by case; and what they run there since boards of k ranks and
    checkpoints over k ranks came (ROADMAP A6b-ii), each an "ok: ..."
    line."""
    from repro_torch.configs import get_arch, get_dlrm
    from repro_torch.engine import Engine
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch.mesh import make_mesh
    cfg = get_dlrm("dlrm-rm2-small-unsharded").reduced()
    mesh = make_mesh((2, 2), ("data", "model"))
    mesh3 = make_mesh((2, 1, 2), ("pod", "data", "model"))
    cases = {
        "missing": lambda: Engine(cfg, device="cpu", mesh=mesh,
                                  dp_axes=("pod",)),
        "overlap": lambda: Engine(cfg, device="cpu", mesh=mesh,
                                  dp_axes=("data",)),
        "cover": lambda: Engine(cfg, device="cpu", mesh=mesh3,
                                axis=("model",), dp_axes=("data",)),
        "host_tier": lambda: Engine(cfg, device="cpu", mesh=mesh,
                                    host_capacity_mb=1.0),
        "lm": lambda: "ok: resume_step=%d" % Engine(
            get_arch("internlm2-1.8b").reduced(), device="cpu",
            mesh=mesh).train_session(ckpt_dir="unused").resume_step,
        "fleet": lambda: "ok: boards %s" % [b.devices for b in Engine(
            cfg, device="cpu").sharded_fleet(n_boards=1).boards],
        "ckpt": lambda: "ok: resume_step=%d" % Engine(
            cfg, device="cpu").train_session(ckpt_dir="unused").resume_step,
        "launcher_fleet": lambda: "ok: rc=%d" % serve_launcher.main(
            ["--smoke", "--device", "cpu", "--replicas", "2", "--queries",
             "8", "--sla-ms", "5000"]),
    }
    out = {}
    for name, fn in cases.items():
        try:
            msg = fn() or "no error"
        except (ValueError, NotImplementedError) as err:
            msg = f"{type(err).__name__}: {err}"
        out[f"error/{name}"] = np.frombuffer(msg.encode(), np.uint8)
    return out


def _job_k2(rank, world, out_dir):
    """Primitives at k=2; Engine sessions over 2 ranks."""
    import torch.distributed as dist
    inp = _inputs(out_dir)
    _PRIM_INPUTS.update(inp)
    out = {f"prim/{k}": v for k, v in _primitives(
        world, dist.group.WORLD).items()}
    out.update(_engine_sessions())
    return out


def _engine_sessions():
    """Engine sessions of the reduced configs: served probs of 3 queries,
    3 training steps (losses, MLPs, this rank's tables), the launcher's
    summary of a 4-step run."""
    from repro_torch.configs import get_dlrm
    from repro_torch.engine import Engine
    out = {}
    for name, opt in (("dlrm-rm2-small-unsharded", "sgd"),
                      ("dlrm-rm2-small-sharded", "adagrad")):
        cfg = get_dlrm(name).reduced()
        eng = Engine(cfg, device="cpu", optimizer=opt, lr=LR, alpha=1.05)
        sess = eng.serve_session(max_batch_queries=1)
        out[f"session/{name}/probs"] = np.concatenate(
            [sess._execute([sess._make_query(q)])[0] for q in range(3)])
        train = eng.train_session()
        rep = train.run(3)
        out[f"session/{name}/losses"] = np.asarray(
            [h["loss"] for h in rep.history])
        out[f"session/{name}/tables"] = train.params["tables"].numpy()
        out[f"session/{name}/top_w"] = \
            train.params["top_mlp"][-1]["w"].numpy()
    summary = Engine(get_dlrm("dlrm-rm2-small-unsharded").reduced(),
                     device="cpu").train_session().run(4).summary()
    out["session/summary"] = np.frombuffer(summary.encode(), np.uint8)
    return out


# --------------------------------------------------------- the reference
REFERENCE = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
assert len(jax.devices()) == 4, jax.devices()
from repro import parallel
from repro.configs.registry import get_dlrm
from repro.core import sharding as dsh
from repro.core.planner import ShardingPlan, TablePlacement
from repro.launch.mesh import make_mesh
from repro.parallel import primitives as prim
from repro.parallel.updates import sgd_row_update

d = {out_dir!r}
inp = dict(np.load(d + "/inputs.npz"))
out = {{}}
LR = {lr}

def cfg_of(name):
    return dataclasses.replace(get_dlrm(name).reduced(), batch_size=32,
                               rows_per_table=128, num_tables=8)

def tree(prefix):
    t = {{"bot_mlp": [], "top_mlp": []}}
    for key in sorted(k for k in inp if k.startswith(prefix + "/")):
        parts = key[len(prefix) + 1:].split("/")
        if len(parts) == 1:
            t[parts[0]] = jnp.asarray(inp[key])
            continue
        while len(t[parts[0]]) <= int(parts[1]):
            t[parts[0]].append({{}})
        t[parts[0]][int(parts[1])][parts[2]] = jnp.asarray(inp[key])
    return t

def save(prefix, t):
    for k in ("bot_mlp", "top_mlp"):
        for i, layer in enumerate(t[k]):
            for n, p in layer.items():
                out[f"{{prefix}}/{{k}}/{{i}}/{{n}}"] = np.asarray(p)
    for k in t:
        if k.startswith("tables"):
            out[f"{{prefix}}/{{k}}"] = np.asarray(t[k])

def batch(name, s):
    return [jnp.asarray(inp[f"batch/{{name}}/{{s}}/{{k}}"])
            for k in ("dense", "indices", "labels")]

def on(mesh, f, ins, outs):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=ins, out_specs=outs,
                             check_rep=False))

tables, idx, g = (jnp.asarray(inp[k]) for k in ("p_tables", "p_idx", "p_g"))
sgd = sgd_row_update(LR)
for k in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:k]), ("x",))
    pooled, owner = on(mesh, lambda t, i: prim.table_wise_forward(t, i, "x"),
                       (P("x"), P("x")), (P("x"), P(None, "x")))(tables, idx)
    out[f"{{k}}/tw_fwd_pooled"], out[f"{{k}}/tw_fwd_owner"] = pooled, owner
    fi, fg = on(mesh, lambda c, gp: prim.table_wise_expand_grads(c, gp, "x"),
                (P(None, "x"), P("x")), (P("x"), P("x")))(owner, g)
    out[f"{{k}}/tw_exp_idx"], out[f"{{k}}/tw_exp_g"] = fi, fg
    out[f"{{k}}/tw_bwd"] = on(
        mesh, lambda t, c, gp: prim.table_wise_backward_update(
            t, c, gp, "x", sgd),
        (P("x"), P(None, "x"), P("x")), P("x"))(tables, owner, g)
    for mode in ("partial_pool", "unpooled"):
        for chunk in (4, 4096):
            f = (lambda m, c: lambda t, i: prim.row_wise_forward(
                t, i, "x", k, m, c))(mode, chunk)
            pooled, ids = on(mesh, f, (P(None, "x"), P("x")),
                             (P("x"), P()))(tables, idx)
            out[f"{{k}}/rw_fwd_{{mode}}_{{chunk}}"] = pooled
            out[f"{{k}}/rw_fwd_ids"] = ids
    fi, fg = on(mesh, lambda t, c, gp: tuple(a[None] for a in
                                             prim.row_wise_expand_grads(
                                                 t, c, gp, "x")),
                (P(None, "x"), P(), P("x")), (P("x"), P("x")))(
        tables, ids, g)
    out[f"{{k}}/rw_exp_idx"], out[f"{{k}}/rw_exp_g"] = fi, fg
    for chunk in (4, 4096):
        f = (lambda c: lambda t, i, gp: prim.row_wise_backward_update(
            t, i, gp, "x", sgd, c))(chunk)
        out[f"{{k}}/rw_bwd_{{chunk}}"] = on(
            mesh, f, (P(None, "x"), P(), P("x")), P(None, "x"))(
            tables, ids, g)

mesh = make_mesh((2, 2), ("data", "model"))
axis = ("data", "model")
blob = json.loads(bytes(inp["auto_plan"]).decode())
blob["placements"] = tuple(TablePlacement(**p) for p in blob["placements"])
auto_plan = ShardingPlan(**blob)
for plan_arg, name, wire in {serve_cases}:
    cfg = cfg_of(name)
    m, ax, plan = ((make_mesh((4,), ("x",)), "x", auto_plan)
                   if plan_arg == "auto" else (mesh, axis, None))
    sp = parallel.shard_dlrm_params(tree(f"params/{{name}}"), cfg, m, ax,
                                    plan=plan)
    serve = parallel.build_step(cfg, m, mode="serve", axis=ax, plan=plan,
                                exchange=wire)
    dense, ids, _ = batch(name, 0)
    out[f"serve/{{plan_arg}}/{{name}}/{{wire}}"] = np.asarray(
        serve(sp, dense, ids))

for name, wire, opt in {train_cases}:
    cfg = cfg_of(name)
    step = dsh.make_dlrm_train_step(cfg, mesh, axis, lr=LR,
                                    row_wise_exchange=wire, optimizer=opt)
    state = ({{"table_acc": jnp.zeros((cfg.num_tables, cfg.rows_per_table),
                                      jnp.float32)}}
             if opt == "adagrad" else None)
    sp = dsh.shard_dlrm_params(tree(f"params/{{name}}"), cfg, mesh, axis)
    losses = []
    for s in range(3):
        sp, state, loss = step(sp, state, *batch(name, s))
        losses.append(float(loss))
    tag = f"train/{{name}}/{{wire}}/{{opt}}"
    save(tag, jax.device_get(sp))
    out[tag + "/losses"] = np.asarray(losses)

name = "dlrm-rm2-small-unsharded"
cfg = cfg_of(name)
for opt in ("sgd", "adagrad"):
    step = parallel.build_step(cfg, mesh, mode="train", axis=("model",),
                               dp_axes=("data",), optimizer=opt, lr=LR)
    state = parallel.init_dlrm_opt_state(cfg, opt, None, 2) \\
        if opt == "adagrad" else None
    sp = parallel.shard_dlrm_params(tree(f"params/{{name}}"), cfg, mesh,
                                    ("model",))
    losses = []
    for s in range(3):
        sp, state, loss = step(sp, state, *batch(name, s))
        losses.append(float(loss))
    save(f"dp/{{opt}}", jax.device_get(sp))
    out[f"dp/{{opt}}/losses"] = np.asarray(losses)
np.savez(d + "/ref.npz", **out)
print("DONE")
"""


# -------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    """The inputs, the reference's results and both spawns' results; the
    reference's subprocess (``run_with_devices``, 4 devices) runs while
    the ranks do."""
    d = tmp_path_factory.mktemp("ranks")
    _make_inputs(d / "inputs.npz")
    code = REFERENCE.format(lr=LR, serve_cases=SERVE_CASES,
                            train_cases=TRAIN_CASES, out_dir=str(d))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(subproc, code, 4, SPAWN_TIMEOUT_S)
        k4, k2 = spawn(_job_k4, 4, d), spawn(_job_k2, 2, d)
        proc = ref.result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {"ref": dict(np.load(d / "ref.npz")), 4: k4, 2: k2}


def _joined(ranks, key, axis=0):
    return np.concatenate([r[key] for r in ranks], axis=axis)


# ------------------------------------------------------------ primitives
@pytest.mark.parametrize("k", [2, 4])
def test_table_wise_forward_matches_reference(runs, k):
    ranks, ref = runs[k], runs["ref"]
    np.testing.assert_allclose(_joined(ranks, "prim/tw_fwd_pooled"),
                               ref[f"{k}/tw_fwd_pooled"], **UPDATE_TOL)
    # the ids each owner gathered: bitwise the reference's owner_idx
    np.testing.assert_array_equal(_joined(ranks, "prim/tw_fwd_owner", 1),
                                  ref[f"{k}/tw_fwd_owner"])


@pytest.mark.parametrize("k", [2, 4])
def test_table_wise_expand_and_update_match_reference(runs, k):
    ranks, ref = runs[k], runs["ref"]
    np.testing.assert_array_equal(_joined(ranks, "prim/tw_exp_idx"),
                                  ref[f"{k}/tw_exp_idx"])
    np.testing.assert_array_equal(_joined(ranks, "prim/tw_exp_g"),
                                  ref[f"{k}/tw_exp_g"])
    np.testing.assert_allclose(_joined(ranks, "prim/tw_bwd"),
                               ref[f"{k}/tw_bwd"], **UPDATE_TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [2, 4])
def test_row_wise_forward_matches_reference(runs, k, mode, chunk):
    ranks, ref = runs[k], runs["ref"]
    np.testing.assert_allclose(_joined(ranks, f"prim/rw_fwd_{mode}_{chunk}"),
                               ref[f"{k}/rw_fwd_{mode}_{chunk}"],
                               **UPDATE_TOL)
    for r in ranks:                     # the all_gathered ids, bitwise
        np.testing.assert_array_equal(r["prim/rw_fwd_ids"],
                                      ref[f"{k}/rw_fwd_ids"])


@pytest.mark.parametrize("k", [2, 4])
def test_row_wise_expand_grads_matches_reference(runs, k):
    ranks, ref = runs[k], runs["ref"]
    np.testing.assert_array_equal(
        np.stack([r["prim/rw_exp_idx"] for r in ranks]),
        ref[f"{k}/rw_exp_idx"])
    np.testing.assert_array_equal(
        np.stack([r["prim/rw_exp_g"] for r in ranks]), ref[f"{k}/rw_exp_g"])


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("k", [2, 4])
def test_row_wise_backward_update_matches_reference(runs, k, chunk):
    ranks, ref = runs[k], runs["ref"]
    np.testing.assert_allclose(_joined(ranks, f"prim/rw_bwd_{chunk}", 1),
                               ref[f"{k}/rw_bwd_{chunk}"], **UPDATE_TOL)


# ---------------------------------------------------------------- steps
@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: "-".join(c))
def test_serve_step_over_4_ranks_matches_reference(runs, case):
    """The gathered global probs, on every rank, at depth 1 and 2."""
    plan_arg, name, wire = case
    want = runs["ref"][f"serve/{plan_arg}/{name}/{wire}"]
    for r in runs[4]:
        for depth in (1, 2):
            np.testing.assert_allclose(
                r[f"serve/{plan_arg}/{name}/{wire}/{depth}"], want,
                **SERVE_TOL)


def _tree_keys(arrays, prefix):
    return sorted(k[len(prefix):] for k in arrays if k.startswith(prefix)
                  and not k.endswith("losses"))


def _check_params(ranks, ref_arrays, tag, ref_tag, n_embed, sharding):
    """The ranks' params against the reference's global ones. Rank r holds
    shard r % n_embed of the tables (table-wise: whole tables, row-wise:
    rows); ranks that differ only along dp_axes hold it bitwise alike,
    and every rank the same MLPs."""
    for key in _tree_keys(ref_arrays, ref_tag + "/"):
        want = ref_arrays[f"{ref_tag}/{key}"]
        for j, r in enumerate(ranks):
            np.testing.assert_array_equal(
                r[f"{tag}/{key}"],
                ranks[j % n_embed if key.startswith("tables") else 0][
                    f"{tag}/{key}"])
        if key.startswith("tables"):
            got = _joined(ranks[:n_embed], f"{tag}/{key}",
                          0 if sharding == "table_wise" else 1)
        else:
            got = ranks[0][f"{tag}/{key}"]
        np.testing.assert_allclose(got, want, err_msg=key, **TRAIN_TOL)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: "-".join(c))
def test_train_over_4_ranks_matches_reference(runs, case):
    """tests/test_dlrm_distributed.py's five cases on (2, 2), 3 steps."""
    name, wire, opt = case
    tag = f"train/{name}/{wire}/{opt}"
    sharding = "table_wise" if "unsharded" in name else "row_wise"
    _check_params(runs[4], runs["ref"], f"{tag}/1", tag, 4, sharding)
    for r in runs[4]:
        np.testing.assert_allclose(r[f"{tag}/1/losses"],
                                   runs["ref"][f"{tag}/losses"], **TRAIN_TOL)


def test_depth_2_matches_depth_1(runs):
    """tests/test_parallel.py's pipelined-vs-serial contract over 4 ranks:
    depth 2 trains as depth 1 (and as the reference's serial step)."""
    name, wire, opt = TRAIN_CASES[0]
    tag = f"train/{name}/{wire}/{opt}"
    _check_params(runs[4], runs["ref"], f"{tag}/2", tag, 4, "table_wise")
    for key in _tree_keys(runs[4][0], f"{tag}/1/"):
        np.testing.assert_allclose(runs[4][0][f"{tag}/2/{key}"],
                                   runs[4][0][f"{tag}/1/{key}"], rtol=3e-5,
                                   atol=3e-5)


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_dp_axes_on_2x2_match_reference(runs, opt):
    """axis=("model",), dp_axes=("data",): tables table-wise over 2 ranks,
    replicated (bitwise) over the other 2, the deltas summed."""
    _check_params(runs[4], runs["ref"], f"dp/{opt}", f"dp/{opt}", 2,
                  "table_wise")
    for r in runs[4]:
        np.testing.assert_allclose(r[f"dp/{opt}/losses"],
                                   runs["ref"][f"dp/{opt}/losses"],
                                   **TRAIN_TOL)


# --------------------------------------------------------------- engine
ERRORS = {
    "missing": ("ValueError", "not in mesh"),
    "overlap": ("ValueError", "overlap the embedding axis"),
    "cover": ("ValueError", "cover 2 devices but the mesh has 4"),
    "host_tier": ("ValueError", "single-board"),
    # ported with boards of k ranks and checkpoints over k ranks
    # (ROADMAP A6b-ii): each runs
    "lm": ("ok", "resume_step=0"),
    "fleet": ("ok", "boards [[0, 1, 2, 3]]"),
    "ckpt": ("ok", "resume_step=0"),
    "launcher_fleet": ("ok", "rc=0"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_engine_refuses_over_4_ranks(runs, case):
    """What the Engine refuses on 4 ranks; the LM and DLRM sessions with a
    ckpt_dir, the sharded fleet (one board of the 4 ranks) and the serve
    launcher's fleet (2 boards of 2 ranks) run there."""
    kind, text = ERRORS[case]
    for r in runs[4]:
        msg = bytes(r[f"error/{case}"]).decode()
        assert msg.startswith(kind + ":") and text in msg, msg


@pytest.mark.parametrize("name,opt", [("dlrm-rm2-small-unsharded", "sgd"),
                                      ("dlrm-rm2-small-sharded", "adagrad")])
def test_engine_sessions_over_2_ranks_match_one_rank(runs, name, opt):
    """Engine sessions on 2 ranks against the port's own 1-rank sessions:
    served probs, training losses, MLPs and tables. Not bitwise: the
    dense grads' sum over the ranks rounds in another order."""
    from repro_torch.configs import get_dlrm
    from repro_torch.engine import Engine
    torch.set_num_threads(1)
    cfg = get_dlrm(name).reduced()
    eng = Engine(cfg, device="cpu", optimizer=opt, lr=LR, alpha=1.05)
    sess = eng.serve_session(max_batch_queries=1)
    probs = np.concatenate([sess._execute([sess._make_query(q)])[0]
                            for q in range(3)])
    train = eng.train_session()
    losses = [h["loss"] for h in train.run(3).history]
    ranks = runs[2]
    for r in ranks:
        np.testing.assert_allclose(r[f"session/{name}/probs"], probs,
                                   **SERVE_TOL)
        np.testing.assert_allclose(r[f"session/{name}/losses"], losses,
                                   **TRAIN_TOL)
        np.testing.assert_allclose(r[f"session/{name}/top_w"],
                                   train.params["top_mlp"][-1]["w"].numpy(),
                                   **TRAIN_TOL)
    axis = 0 if cfg.sharding == "table_wise" else 1
    np.testing.assert_allclose(_joined(ranks, f"session/{name}/tables", axis),
                               train.params["tables"].numpy(), **TRAIN_TOL)


def test_train_launcher_over_2_ranks_prints_the_engine_losses(runs):
    """``torch.distributed.run --nproc-per-node 2`` of the train launcher
    (--model-axis 2: mesh (1, 2)) prints, from rank 0 alone, the summary
    of an Engine session on 2 ranks (mesh (2, 1))."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--smoke", "--steps", "4", "--model-axis", "2"],
        capture_output=True, text=True, env=env, timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    lines = [l for l in proc.stdout.splitlines()
             if l.startswith("[train] dlrm")]
    want = bytes(runs[2][0]["session/summary"]).decode()
    assert lines == [want], proc.stdout
