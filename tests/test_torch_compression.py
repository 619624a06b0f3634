"""The int8 error-feedback all-reduce of the dense grads (ROADMAP A6b-i),
the counterpart of ``src/repro/optim/compression.py`` and of
``tests/test_parallel.py``'s compressed-training tests.

``int8_compress`` / ``int8_decompress`` are held bitwise against the
reference's on random blocks, zero blocks, exact .5 ties (both packages
round half to even) and a length that is not a multiple of the block;
the compressed all-reduce over 4 gloo ranks (spawned as in
``test_torch_ranks``) against the reference's inside ``shard_map`` over 4
virtual devices; a compressed train step on one device against the
reference's ``build_step(compress_grads=True)``; and, as the reference's
tests do, compressed training still descending and tracking the
uncompressed losses. JAX is imported inside the tests, so that the
spawned ranks, which import this module, do not load it.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_dlrm
from repro_torch.engine import Engine
from repro_torch.optim.compression import (BLOCK, int8_compress,
                                           int8_decompress,
                                           make_compressed_allreduce)
import test_torch_ranks as ranks_mod

NAME = "dlrm-rm2-small-unsharded"
SHAPES = ((33, 17), (300,), (256,))
ITERS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    rng = np.random.default_rng(7)
    if name == "random":
        return (rng.standard_normal((3, 2 * BLOCK)) * 3).astype(np.float32)
    if name == "zeros":
        x = rng.standard_normal(3 * BLOCK).astype(np.float32)
        x[BLOCK:2 * BLOCK] = 0.0          # one all-zero block: scale 1
        return x
    if name == "ties":
        # absmax 127 makes the scale exactly 1: every k + 0.5 is a tie
        ties = np.arange(-127, 127, dtype=np.float32) + 0.5
        block = np.concatenate([[127.0, -127.0], ties]).astype(np.float32)
        return np.concatenate([block, -block[::-1]])
    return rng.standard_normal(1000).astype(np.float32)   # 1000 % 256 != 0


@pytest.mark.parametrize("name", ["random", "zeros", "ties", "ragged"])
def test_int8_compress_bitwise_matches_reference(name):
    import jax.numpy as jnp
    from repro.optim import compression as jax_comp
    x = _case(name)
    jq, js = jax_comp.int8_compress(jnp.asarray(x))
    q, s = int8_compress(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        int8_decompress(q, s, x.shape).numpy(),
        np.asarray(jax_comp.int8_decompress(jq, js, x.shape)))
    if name == "ties":
        # round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -1.5 -> -2
        flat = q.numpy().reshape(-1)
        np.testing.assert_array_equal(flat, np.round(x).astype(np.int8))
        got = {v: int(flat[np.flatnonzero(x == v)[0]])
               for v in (0.5, 1.5, 2.5, -1.5, -2.5, 126.5)}
        assert got == {0.5: 0, 1.5: 2, 2.5: 2, -1.5: -2, -2.5: -2,
                       126.5: 126}, got


def _grads(it, rank):
    rng = np.random.default_rng(100 * it + rank)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _job_allreduce(rank, world, out_dir):
    import torch.distributed as dist
    car = make_compressed_allreduce(dist.group.WORLD)
    ef = [torch.zeros(s) for s in SHAPES]
    out = {}
    for it in range(ITERS):
        mean, ef = car([torch.from_numpy(g) for g in _grads(it, rank)], ef)
        for i, (m, e) in enumerate(zip(mean, ef)):
            out[f"{it}/mean/{i}"] = m.numpy().copy()
            out[f"{it}/ef/{i}"] = e.numpy().copy()
    return out


REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.compression import make_compressed_allreduce
assert len(jax.devices()) == 4
mesh = Mesh(np.array(jax.devices()), ("x",))
car, init_ef = make_compressed_allreduce("x")
SHAPES = {shapes}

def grads(it, rank):
    rng = np.random.default_rng(100 * it + rank)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]

def body(gs, es):
    mean, ef = car([g[0] for g in gs], [e[0] for e in es])
    return mean, [e[None] for e in ef]

f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x"), P("x")),
                      out_specs=(P(), P("x")), check_rep=False))
ef = [jnp.zeros((4,) + s, jnp.float32) for s in SHAPES]
out = {{}}
for it in range({iters}):
    gs = [jnp.asarray(np.stack([grads(it, r)[i] for r in range(4)]))
          for i in range(len(SHAPES))]
    mean, ef = f(gs, ef)
    for i in range(len(SHAPES)):
        out[f"{{it}}/mean/{{i}}"] = np.asarray(mean[i])
        out[f"{{it}}/ef/{{i}}"] = np.asarray(ef[i])
np.savez({path!r}, **out)
print("DONE")
"""


def test_compressed_allreduce_over_4_ranks_matches_reference(tmp_path,
                                                             subproc):
    """The means to 1e-5 (the 4-way sum's rounding, and the residuals'
    below, carried in); each rank's residuals
    (which never cross the wire) to 1e-6, a 3e-5 part of a quantum: XLA
    contracts the residual's ``g - q * scale`` into one fused multiply-add,
    the port rounds ``q * scale`` first, as written, and each residual is
    carried into the next iteration's grads."""
    code = REFERENCE.format(shapes=SHAPES, iters=ITERS,
                            path=str(tmp_path / "ref.npz"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(subproc, code, 4, ranks_mod.SPAWN_TIMEOUT_S)
        got = ranks_mod.spawn(_job_allreduce, 4, tmp_path)
        proc = ref.result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = dict(np.load(tmp_path / "ref.npz"))
    for it in range(ITERS):
        for i in range(len(SHAPES)):
            for r, res in enumerate(got):
                np.testing.assert_allclose(res[f"{it}/mean/{i}"],
                                           want[f"{it}/mean/{i}"],
                                           rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(res[f"{it}/ef/{i}"],
                                           want[f"{it}/ef/{i}"][r], rtol=0,
                                           atol=1e-6)


def _cfgs(batch_size=8):
    from repro.configs.registry import get_dlrm as jax_get_dlrm
    return (dataclasses.replace(jax_get_dlrm(NAME).reduced(),
                                batch_size=batch_size),
            dataclasses.replace(get_dlrm(NAME).reduced(),
                                batch_size=batch_size))


def _residuals_agree(got, want):
    """Residuals of grads that agree to fp32 rounding: equal within 1e-5,
    but for the odd element whose ``g / scale`` sat on a rounding tie in
    one package and not the other, whose residual then lies on the other
    side of it (-want, half a quantum away either way)."""
    off = np.abs(got - want) > 1e-5
    assert off.mean() < 1e-3, off.sum()
    np.testing.assert_allclose(got[off], -want[off], rtol=1e-2)


@pytest.mark.parametrize("depth", [1, 2])
def test_compressed_train_step_on_one_device_matches_reference(depth):
    """build_step(compress_grads=True) on a 1-device mesh in both packages,
    3 steps on the same params and batches: params, residuals, losses."""
    import jax
    import jax.numpy as jnp
    from repro import parallel as jax_parallel
    from repro.core import dlrm as jax_dlrm
    from repro.data import make_recsys_batch
    from repro.launch.mesh import make_host_mesh
    from repro_torch import convert
    from repro_torch.parallel import build_step, init_dlrm_opt_state
    jcfg, cfg = _cfgs()
    mesh = make_host_mesh(model=1)
    p0 = jax.tree_util.tree_map(np.asarray, jax_dlrm.init_dlrm(
        jax.random.PRNGKey(3), jcfg))
    jstep = jax_parallel.build_step(jcfg, mesh, mode="train", lr=0.05,
                                    pipeline_depth=depth, compress_grads=True)
    jp = jax_parallel.shard_dlrm_params(jax.tree_util.tree_map(
        jnp.array, p0), jcfg, mesh, ("data", "model"))
    jo = jax_parallel.init_dlrm_opt_state(jcfg, "sgd", None, n=1,
                                          compress_grads=True)
    tstep = build_step(cfg, mode="train", lr=0.05, pipeline_depth=depth,
                       compress_grads=True, device="cpu")
    tp = convert.params_from_jax_numpy(p0, "cpu")
    to = init_dlrm_opt_state(cfg, "sgd", compress_grads=True, device="cpu")
    for s in range(3):
        b = {k: np.asarray(v) for k, v in make_recsys_batch(jcfg, s).items()}
        jp, jo, jl = jstep(jp, jo, *(jnp.asarray(b[k]) for k in
                                     ("dense", "indices", "labels")))
        tp, to, tl = tstep(tp, to, *(torch.from_numpy(b[k].copy()) for k in
                                     ("dense", "indices", "labels")))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp["tables"].numpy(), np.asarray(jp["tables"]),
                               **tol)
    for k in ("bot_mlp", "top_mlp"):
        for tl_, jl_, te, je in zip(tp[k], jp[k], to["ef"][k], jo["ef"][k]):
            for n in ("w", "b"):
                np.testing.assert_allclose(tl_[n].numpy(),
                                           np.asarray(jl_[n]), **tol)
                _residuals_agree(te[n].numpy(), np.asarray(je[n])[0])


def test_compressed_grads_training_decreases_loss():
    """tests/test_parallel.py's check at n=1: int8 + error feedback does not
    break learning, and the residuals are live. The port's stream is
    drawn by torch.Generator, so its descent starts later than the
    reference's (tests/test_torch_train.py): 150 steps instead of 100."""
    _, cfg = _cfgs(batch_size=128)
    sess = Engine(cfg, lr=1.0, compress_grads=True,
                  device="cpu").train_session()
    losses = [h["loss"] for h in sess.run(150).history]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.02, losses
    ef = [p for k in ("bot_mlp", "top_mlp") for layer in sess.opt_state[
        "ef"][k] for p in layer.values()]
    assert max(float(e.abs().max()) for e in ef) > 0.0


def test_compressed_pipelined_matches_uncompressed_closely():
    """tests/test_parallel.py's check: compression tracks the uncompressed
    trajectory within 5e-3 over 5 steps at depth 2."""
    _, cfg = _cfgs()
    losses = {}
    for compress in (False, True):
        eng = Engine(cfg, lr=0.05, compress_grads=compress, pipeline_depth=2,
                     device="cpu")
        losses[compress] = [h["loss"] for h in
                            eng.train_session().run(5).history]
    np.testing.assert_allclose(losses[True], losses[False], atol=5e-3)
