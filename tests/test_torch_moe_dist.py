"""The port's distributed MoE (``repro_torch.models.moe_dist``) against the
reference's ``src/repro/models/moe_dist.py`` and its global ``moe_block``.

The reference runs in a subprocess with 4 virtual devices
(``conftest.run_with_devices``) on meshes built there with ``Auto`` axes
(``jax.make_mesh(..., axis_types=(AxisType.Auto,) * 2)``), its body
chosen by ``REPRO_MOE_IMPL`` through ``layers.moe_block``; the port runs
4 gloo ranks spawned as ``tests/test_torch_ranks.py`` spawns them, its
body chosen by ``Sharder(moe_impl=)``. Both read the same numpy inputs,
the shapes of ``tests/test_perf_paths.py``'s distributed-MoE cases: d 32,
d_ff 64, B 4, T 8, top 2.

Cases: ep at (2, 2) and (1, 4) with E = 8, local dispatch at (1, 4) with
E = 6 (E does not split over 4), ``moe_impl="local"`` at (2, 2) with
E = 8, and the odd-shape global fallback at (1, 4) with T = 6 and at
(2, 2) with T = 7 (x gathered over "data" there). Each runs at capacity
factor 64, against the reference's body and its global ``moe_block``
(nothing drops), and at 1.25, against the reference's body with its
drops. At these shapes the distributed bodies' capacities (floor 8, and
ep's, which ignore the capacity factor) drop nothing even at 1.25, so
two more cases skew the routing (a shared direction in x that router
column 0 reads) at T = 32: ep at (1, 4) drops at the send and the
receive buffers, local dispatch at (1, 4) with E = 6 at its experts',
and both are held against the reference's body with those drops. A rank's x is its rows of the batch, replicated over "model"; its
expert weights its shard (``convert.local_lm_params``). Held, in fp32:
the output at rtol = atol = 1e-5, the grads of x and of every param
(summed over the batch axes, the expert weights gathered over "model")
at 1e-4, under a fixed random cotangent. Then the autograd collectives
of ``parallel.primitives`` against their numpy meanings over 4 ranks,
and the ``moe_impl`` selector (the counterpart of
``test_moe_impl_env_selector``). JAX is imported only in the reference's
subprocess and inside tests, so the spawned ranks do not load it.
"""
from __future__ import annotations

import concurrent.futures
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_torch_ranks as ranks_mod

D, FF, B, K = 32, 64, 4, 2
# (id, mesh (data, model), E, moe_impl, T)
CASES = [("ep-2x2", (2, 2), 8, "auto", 8),
         ("ep-1x4", (1, 4), 8, "auto", 8),
         ("local-1x4-E6", (1, 4), 6, "auto", 8),
         ("local-forced-2x2", (2, 2), 8, "local", 8),
         ("fallback-1x4-T6", (1, 4), 8, "auto", 6),
         ("fallback-2x2-T7", (2, 2), 8, "auto", 7),
         ("skewed-ep-1x4", (1, 4), 8, "auto", 32),
         ("skewed-local-1x4-E6", (1, 4), 6, "auto", 32)]
UNSKEWED = [c[0] for c in CASES if not c[0].startswith("skewed")]
CFS = (64.0, 1.25)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
PARAMS = ("router", "w_gate", "w_up", "w_down")
# the body each case runs, by the reference's dispatch (layers.py:326-333
# and the fallbacks of moe_dist.py:129, :202)
BODIES = {"ep-2x2": "ep", "ep-1x4": "ep", "local-1x4-E6": "local",
          "local-forced-2x2": "local", "fallback-1x4-T6": "global",
          "fallback-2x2-T7": "global", "skewed-ep-1x4": "ep",
          "skewed-local-1x4-E6": "local"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(path):
    """Every case's params, x and cotangent, one npz both packages read."""
    rng = np.random.default_rng(0)
    out = {}
    for cid, _, E, _, T in CASES:
        out[f"{cid}/router"] = rng.standard_normal((D, E)) / np.sqrt(D)
        out[f"{cid}/w_gate"] = rng.standard_normal((E, D, FF)) / np.sqrt(D)
        out[f"{cid}/w_up"] = rng.standard_normal((E, D, FF)) / np.sqrt(D)
        out[f"{cid}/w_down"] = rng.standard_normal((E, FF, D)) / np.sqrt(FF)
        out[f"{cid}/x"] = rng.standard_normal((B, T, D))
        out[f"{cid}/ct"] = rng.standard_normal((B, T, D))
        if cid.startswith("skewed"):
            u = rng.standard_normal(D)
            u /= np.linalg.norm(u)
            out[f"{cid}/x"] += 2.0 * u
            out[f"{cid}/router"][:, 0] += 3.0 * u
    np.savez(path, **{k: v.astype(np.float32) for k, v in out.items()})


def _cfg(E, cf):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    return ModelConfig(name="t", family="moe", n_layers=2, d_model=D,
                       n_heads=4, n_kv_heads=4, d_ff=FF, vocab_size=64,
                       moe=MoEConfig(num_experts=E, top_k=K,
                                     capacity_factor=cf))


# ------------------------------------------------------------- the ranks
def _job_moe(rank, world, out_dir):
    """Every case at both capacity factors on this rank: its rows of the
    output, its rows of x's grad, the param grads summed over the batch
    axes and gathered whole, the dropped copies; then the autograd
    collectives."""
    from repro_torch.convert import gather_lm_params, local_lm_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.common import Sharder
    from repro_torch.parallel import primitives as P
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    out = {}
    for cid, shape, E, impl, T in CASES:
        mesh = make_mesh(shape, ("data", "model"))
        sharder = Sharder(mesh, moe_impl=impl)
        n, r = sharder.batch_size, sharder.batch_rank
        rows = slice(r * B // n, (r + 1) * B // n)
        for cf in CFS:
            cfg = _cfg(E, cf)
            whole = {"units": [{"moe": {k: torch.from_numpy(
                inp[f"{cid}/{k}"])[None] for k in PARAMS}}]}
            p = {k: v[0].clone().requires_grad_(True) for k, v in
                 local_lm_params(whole, cfg, sharder)["units"][0][
                     "moe"].items()}
            x = torch.from_numpy(inp[f"{cid}/x"][rows]).requires_grad_(True)
            L.DROPS = {}
            y = L.moe_block(p, x, cfg, sharder)
            (y * torch.from_numpy(inp[f"{cid}/ct"][rows])).sum().backward()
            grads = {k: P.psum(v.grad, sharder.batch_group)[None]
                     for k, v in p.items()}
            grads = gather_lm_params({"units": [{"moe": grads}]}, cfg,
                                     sharder)["units"][0]["moe"]
            tag = f"{cid}/{cf}"
            out[f"{tag}/y"] = y.detach().numpy()
            out[f"{tag}/x"] = x.grad.numpy()
            for k in PARAMS:
                out[f"{tag}/{k}"] = grads[k][0].numpy()
            out[f"{tag}/dropped"] = np.asarray(
                int(sum(L.DROPS.values())))
            L.DROPS = None
            out[f"{tag}/local_shape"] = np.asarray(p["w_gate"].shape)
    out.update(_collectives(rank))
    return out


def _collectives(rank):
    """Each autograd collective over the world along dims 0 and 1 of a
    (4, 8, 3) input: forward and the backward of a random cotangent."""
    import torch.distributed as dist
    from repro_torch.parallel import primitives as P
    g = dist.group.WORLD
    rng = np.random.default_rng(100 + rank)
    x = rng.standard_normal((4, 8, 3)).astype(np.float32)
    cts = {s: rng.standard_normal(s).astype(np.float32)
           for s in ((4, 8, 3), (16, 8, 3), (4, 32, 3), (1, 8, 3),
                     (4, 2, 3), (1, 32, 3), (16, 2, 3))}
    fns = {"ad_all_gather": lambda t, d: P.ad_all_gather(t, d, g),
           "ad_psum_scatter": lambda t, d: P.ad_psum_scatter(t, d, g),
           "ad_all_to_all": lambda t, d: P.ad_all_to_all(t, d, 1 - d, g),
           "shard_in": lambda t, d: P.shard_in(t, d, g),
           "replicate_in": lambda t, d: P.replicate_in(t, g),
           "gather_out": lambda t, d: P.gather_out(t, d, g)}
    out = {"coll/x": x}
    for name, fn in fns.items():
        for dim in (0, 1):
            t = torch.from_numpy(x).requires_grad_(True)
            y = fn(t, dim)
            ct = cts[tuple(y.shape)]
            (y * torch.from_numpy(ct)).sum().backward()
            out[f"coll/{name}/{dim}/y"] = y.detach().numpy()
            out[f"coll/{name}/{dim}/ct"] = ct
            out[f"coll/{name}/{dim}/grad"] = t.grad.numpy()
    return out


# --------------------------------------------------------- the reference
REFERENCE = """
import os
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
assert len(jax.devices()) == 4, jax.devices()
from repro.configs.base import ModelConfig, MoEConfig
from repro.models.common import Sharder
from repro.models.layers import moe_block

d = {out_dir!r}
inp = dict(np.load(d + "/inputs.npz"))
out = {{}}
for cid, shape, E, impl, T in {cases}:
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    sharder = Sharder(mesh)
    p = {{k: jnp.asarray(inp[f"{{cid}}/{{k}}"]) for k in {params}}}
    x = jnp.asarray(inp[f"{{cid}}/x"])
    ct = jnp.asarray(inp[f"{{cid}}/ct"])
    for cf in {cfs}:
        cfg = ModelConfig(name="t", family="moe", n_layers=2,
                          d_model={d_model}, n_heads=4, n_kv_heads=4,
                          d_ff={d_ff}, vocab_size=64,
                          moe=MoEConfig(num_experts=E, top_k={k},
                                        capacity_factor=cf))
        os.environ["REPRO_MOE_IMPL"] = impl
        body = jax.jit(lambda p, x: moe_block(p, x, cfg, sharder))
        y, vjp = jax.vjp(body, p, x)
        gp, gx = vjp(ct)
        os.environ.pop("REPRO_MOE_IMPL")
        tag = f"{{cid}}/{{cf}}"
        out[tag + "/y"], out[tag + "/x"] = np.asarray(y), np.asarray(gx)
        for k in gp:
            out[f"{{tag}}/{{k}}"] = np.asarray(gp[k])
        yg, vjp = jax.vjp(lambda p, x: moe_block(p, x, cfg), p, x)
        gp, gx = vjp(ct)
        out[tag + "/global/y"] = np.asarray(yg)
        out[tag + "/global/x"] = np.asarray(gx)
        for k in gp:
            out[f"{{tag}}/global/{{k}}"] = np.asarray(gp[k])
np.savez(d + "/ref.npz", **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    """The inputs, the reference's results and the 4 ranks'; the
    reference's subprocess runs while the ranks do."""
    d = tmp_path_factory.mktemp("moe_dist")
    _inputs(d / "inputs.npz")
    code = REFERENCE.format(out_dir=str(d), cases=CASES, cfs=CFS,
                            params=PARAMS, d_model=D, d_ff=FF, k=K)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(subproc, code, 4, ranks_mod.SPAWN_TIMEOUT_S)
        ranks = ranks_mod.spawn(_job_moe, 4, d)
        proc = ref.result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {"ref": dict(np.load(d / "ref.npz")), "ranks": ranks,
            "inputs": dict(np.load(d / "inputs.npz"))}


def _mesh_coords(shape):
    """(data, model) coordinates of ranks 0..3, row-major."""
    return [(r // shape[1], r % shape[1]) for r in range(4)]


def _held(runs, cid, cf, want_prefix):
    """The ranks' results against ``want_prefix`` of the reference's: the
    rows of y and of x's grad joined over "data" (every "model" rank's
    alike, bitwise), each param grad on every rank."""
    shape = next(c[1] for c in CASES if c[0] == cid)
    ranks, ref = runs["ranks"], runs["ref"]
    tag = f"{cid}/{cf}"
    coords = _mesh_coords(shape)
    for key, tol in (("y", OUT_TOL), ("x", GRAD_TOL)):
        for r, (dc, mc) in enumerate(coords):
            np.testing.assert_array_equal(
                ranks[r][f"{tag}/{key}"],
                ranks[coords.index((dc, 0))][f"{tag}/{key}"])
        got = np.concatenate([ranks[coords.index((dc, 0))][f"{tag}/{key}"]
                              for dc in range(shape[0])])
        np.testing.assert_allclose(got, ref[f"{want_prefix}/{key}"],
                                   err_msg=f"{tag} {key}", **tol)
    for k in PARAMS:
        for r in ranks:
            np.testing.assert_allclose(r[f"{tag}/{k}"],
                                       ref[f"{want_prefix}/{k}"],
                                       err_msg=f"{tag} {k}", **GRAD_TOL)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_body_matches_reference_body(runs, cid, cf):
    """The port's body (picked by ``Sharder(moe_impl=)``) against the
    reference's (picked by ``REPRO_MOE_IMPL``), drops included."""
    _held(runs, cid, cf, f"{cid}/{cf}")


@pytest.mark.parametrize("cid", UNSKEWED)
def test_body_matches_global_moe_block_when_nothing_drops(runs, cid):
    """At capacity factor 64 no body drops a copy, so each equals the
    reference's global ``moe_block`` on one device."""
    for r in runs["ranks"]:
        assert int(r[f"{cid}/64.0/dropped"]) == 0, cid
    _held(runs, cid, 64.0, f"{cid}/64.0/global")


@pytest.mark.parametrize("cid,cf", [("skewed-ep-1x4", 64.0),
                                    ("skewed-ep-1x4", 1.25),
                                    ("skewed-local-1x4-E6", 1.25)])
def test_skewed_routing_drops_in_the_distributed_bodies(runs, cid, cf):
    """The skewed cases drop copies (ep at both factors: its buffers
    ignore the config's; here at the owner of expert 0's receive buffer),
    so the drop paths the cases above hold against the reference's body
    ran. ep's buffers drop other copies than the global formulation, so
    there the reference's body and its global ``moe_block`` differ; local
    dispatch on one data shard sees every token, and drops the global
    formulation's copies."""
    dropped = [int(r[f"{cid}/{cf}/dropped"]) for r in runs["ranks"]]
    assert sum(dropped) > 0, dropped
    ref = runs["ref"]
    same = np.allclose(ref[f"{cid}/{cf}/y"], ref[f"{cid}/{cf}/global/y"],
                       **OUT_TOL)
    assert same == (BODIES[cid] == "local"), cid


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_expert_weights_are_held_as_the_body_reads_them(runs, cid):
    """ep: E / |model| whole experts a rank; local: all E at d_ff /
    |model|; the global fallback reads the layout the body it fell back
    from stores (ep's for both fallback cases: E = 8 splits)."""
    _, shape, E, _, _ = next(c for c in CASES if c[0] == cid)
    M = shape[1]
    body = BODIES[cid]
    want = ((E // M, D, FF) if body in ("ep", "global")
            else (E, D, FF // M))
    for r in runs["ranks"]:
        assert tuple(r[f"{cid}/64.0/local_shape"]) == want, cid


# ------------------------------------------------- autograd collectives
def _coll_want(name, dim, xs, cts, rank):
    """(forward, x's grad) on ``rank`` by their meanings over 4 ranks, from
    every rank's x and cotangent."""
    n = 4
    if name in ("ad_all_gather", "gather_out"):
        y = np.concatenate(xs, axis=dim)
        s = y.shape[dim] // n
        if name == "gather_out":
            g = np.take(cts[rank], range(rank * s, (rank + 1) * s),
                        axis=dim)
        else:
            g = np.take(sum(cts), range(rank * s, (rank + 1) * s), axis=dim)
        return y, g
    if name == "ad_psum_scatter":
        s = xs[0].shape[dim] // n
        y = np.take(sum(xs), range(rank * s, (rank + 1) * s), axis=dim)
        return y, np.concatenate(cts, axis=dim)
    if name == "shard_in":
        s = xs[rank].shape[dim] // n
        y = np.take(xs[rank], range(rank * s, (rank + 1) * s), axis=dim)
        return y, np.concatenate(cts, axis=dim)
    if name == "replicate_in":
        return xs[rank], sum(cts)
    # all-to-all: split along dim, chunk j to rank j, concat along 1 - dim
    c = 1 - dim
    s = xs[0].shape[dim] // n
    y = np.concatenate([np.take(xs[j], range(rank * s, (rank + 1) * s),
                                axis=dim) for j in range(n)], axis=c)
    sc = cts[0].shape[c] // n
    g = np.concatenate([np.take(cts[j], range(rank * sc, (rank + 1) * sc),
                                axis=c) for j in range(n)], axis=dim)
    return y, g


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("name", ["ad_all_gather", "ad_psum_scatter",
                                  "ad_all_to_all", "shard_in",
                                  "replicate_in", "gather_out"])
def test_autograd_collectives(runs, name, dim):
    """Forward and backward of each collective under autograd: the
    transposes the reference's ``shard_map`` differentiates through
    (all_gather <-> psum_scatter, the inverse all-to-all, and the
    boundaries: a replicated value's cotangent whole on every rank)."""
    ranks = runs["ranks"]
    xs = [r["coll/x"] for r in ranks]
    cts = [r[f"coll/{name}/{dim}/ct"] for r in ranks]
    for rank, r in enumerate(ranks):
        y, g = _coll_want(name, dim, xs, cts, rank)
        np.testing.assert_allclose(r[f"coll/{name}/{dim}/y"], y, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r[f"coll/{name}/{dim}/grad"], g,
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- selector
@pytest.mark.parametrize("M,E,impl,want", [
    (1, 8, "auto", "local"), (2, 8, "auto", "ep"), (4, 6, "auto", "local"),
    (4, 8, "local", "local"), (4, 6, "ep", "ep"), (4, 8, "global", None)])
def test_moe_body_follows_the_reference_dispatch(M, E, impl, want):
    """``Sharder.moe_body`` is ``layers.moe_block``'s choice (reference
    :326-333): ep when forced or E % M == 0 with M > 1, else local; the
    global formulation under "global". A forced ep with E % M != 0 then
    falls back to local dispatch inside the body, which reads its
    weights d_ff-sharded (``weight_layout``)."""
    from repro_torch.models import moe_dist
    from repro_torch.models.common import Sharder
    mesh = SimpleNamespace(shape={"data": 1, "model": M})
    sharder = Sharder(mesh, moe_impl=impl)
    assert sharder.moe_body(E) == want
    layout = moe_dist.weight_layout(_cfg(E, 1.25), sharder)
    assert layout == {None: None, "local": "ff",
                      "ep": "experts" if E % M == 0 and M > 1
                      else "ff"}[want]


def test_moe_impl_selector():
    """The counterpart of ``test_moe_impl_env_selector``:
    ``moe_impl="global"`` forces the global formulation even with a mesh
    (here a world of one rank), bitwise the sharder-less output; an
    unknown impl raises, in the Sharder and in the Engine, and the Engine
    takes it for an LM only."""
    from repro_torch.configs import get_arch, get_dlrm
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.common import Sharder
    cfg = ModelConfig(name="t", family="moe", n_layers=2, d_model=16,
                      n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=64,
                      moe=MoEConfig(num_experts=4, top_k=2))
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.ones((2, 3, 16))
    out = L.moe_block(p, x, cfg, Sharder(make_host_mesh(),
                                         moe_impl="global"))
    assert out.shape == x.shape
    assert torch.equal(out, L.moe_block(p, x, cfg))
    with pytest.raises(ValueError, match="moe_impl"):
        Sharder(None, moe_impl="scatter")
    with pytest.raises(ValueError, match="moe_impl"):
        Engine(get_arch("mixtral-8x7b").reduced(), device="cpu",
               moe_impl="scatter")
    with pytest.raises(ValueError, match="LM-only"):
        Engine(get_dlrm("dlrm-rm2-small-unsharded").reduced(),
               device="cpu", moe_impl="ep")


@pytest.mark.parametrize("layout", ["experts", "ff"])
def test_sharded_init_is_the_whole_init_sliced(layout):
    """``init_moe(shard=)`` draws the whole init's numbers: each rank's
    part of the expert weights equals the 1-rank init sliced, bitwise, at
    every rank of 4 (the router alike)."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe_dist
    cfg = _cfg(8, 1.25)
    whole = L.init_moe(torch.Generator().manual_seed(3), cfg, (2,))
    dims = moe_dist.SHARD_DIMS[layout]
    for rank in range(4):
        part = L.init_moe(torch.Generator().manual_seed(3), cfg, (2,),
                          shard=(layout, rank, 4))
        assert torch.equal(part["router"], whole["router"])
        for k, dim in dims.items():
            n = whole[k].shape[dim + 1] // 4
            torch.testing.assert_close(
                part[k], whole[k].narrow(dim + 1, rank * n, n),
                rtol=0, atol=0)
