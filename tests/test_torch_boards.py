"""Fleet boards of k ranks (ROADMAP A6b-ii) against the reference's
sub-mesh fleets.

The port runs 4 gloo ranks on the CPU, spawned as
``tests/test_torch_ranks.py`` spawns them (``FileStore`` under
``tmp_path``, one thread a rank); the reference runs in a subprocess with 4
virtual devices (``conftest.run_with_devices``). Both read one npz of
inputs: the port's seed-0 DLRM init of the reduced RM2-small config at
batch 8 (the reference's ``init_dlrm`` is patched to return it, and both
sharded fleets take it as ``params``), and both packages materialize the
same numpy query for an event and profile the same numpy row counts
(``tests/test_torch_fabric.py``'s stream).

Held, at the reference's k-device serve tolerances (rtol 2e-5, atol
2e-6), ids and fabric probs bitwise:

  * a sub-mesh over 2 of 4 ranks builds its groups on every rank, and a
    rank outside it has none; ``remesh_tree`` over ranks reproduces
    ``tests/test_system.py``'s round trip and replication fallback with
    the reference's reports, across disjoint rank sets, from 2 ranks onto
    4, and onto the same ranks as a copy, never an alias;
  * the reference's ``test_autoscaler_scales_and_preserves_results``
    (boards of 2 of 4 ranks, 1 -> 3 with the third board wrapped onto
    ranks 0-1, and 2 -> 1): every query's probs against the reference
    cluster's and the port's 1-rank ``serve_direct``, the scale events
    and remesh reports against the reference's, and every rank's
    completed queries identical;
  * the reference's ``test_fabric_equivalence_sharded_vs_full_board``
    (4 boards of 2 of 4 ranks, cache on and off, zipf_drift, each
    board's device work on fixed times, as in
    ``tests/test_torch_fabric.py``): probs
    bitwise equal to one board of 2 ranks, within tolerance of the
    reference fleet's, and at least one cache refresh;
  * online updates into a board of 2 ranks raise, naming ROADMAP A6b-ii
    (what is left of it on the fleets);
  * ``torch.distributed.run`` of the serve launcher over 4 ranks with 2
    boards of 2 ranks prints one ``ClusterReport``, rank 0's.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_torch_ranks as ranks_mod

REPO = Path(__file__).resolve().parents[1]
NAME = "dlrm-rm2-small-unsharded"
SERVE_TOL = dict(rtol=2e-5, atol=2e-6)
CLUSTER_ALPHA, FABRIC_ALPHA = 1.05, 1.2
# seconds a fabric board's device work takes, a fixed function of its
# shape (tests/test_torch_fabric.py's SERVICE)
FABRIC_SERVICE = {"lookup": lambda idx: 1e-3 + 2e-4 * idx.shape[1],
                  "gather_rows": lambda idx: 4e-4,
                  "pool_rows": lambda idx: 3e-4 + 1e-4 * idx.shape[1],
                  "dense_forward": lambda idx: 2e-3}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    from repro_torch.configs import get_dlrm
    return dataclasses.replace(get_dlrm(NAME).reduced(), batch_size=8)


# ------------------------------------------------------- the shared stream
def _query_np(cfg, ev, q):
    rng = np.random.default_rng([ev.seed, ev.step])
    dense = rng.standard_normal((q, cfg.num_dense)).astype(np.float32)
    u = rng.random((q, cfg.num_tables, cfg.lookups_per_table))
    ranks = np.floor(cfg.rows_per_table * u ** 4).astype(np.int64)
    idx = (ranks * 37 + ev.perm_salt) % cfg.rows_per_table
    return dense, idx.astype(np.int32)


def _freq_np(cfg, n_batches=4):
    counts = np.zeros((cfg.num_tables, cfg.rows_per_table), np.int32)
    t_ix = np.arange(cfg.num_tables)[None, :, None]
    for step in range(n_batches):
        ev = SimpleNamespace(seed=0, step=step, perm_salt=0)
        _, idx = _query_np(cfg, ev, cfg.batch_size)
        np.add.at(counts, (np.broadcast_to(t_ix, idx.shape), idx), 1)
    return counts


def _port_query(cfg, ev, q=None, device=None):
    d, i = _query_np(cfg, ev, q or cfg.batch_size)
    return {"dense": torch.from_numpy(d).to(device),
            "indices": torch.from_numpy(i).to(device)}


def _events():
    from repro_torch.traffic import make_scenario
    return (make_scenario("stationary", alpha=CLUSTER_ALPHA).events(
                40, qps=2000.0, seed=2),
            make_scenario("zipf_drift", alpha=FABRIC_ALPHA,
                          rotate_every_s=0.02, salt_stride=37).events(
                120, qps=2000.0, seed=3))


def _make_inputs(path):
    from repro_torch.core import dlrm
    cfg = _cfg()
    params = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0))
    np.savez(path, **ranks_mod._flatten(
        {k: (v.numpy() if torch.is_tensor(v) else
             [{n: p.numpy() for n, p in l.items()} for l in v])
         for k, v in params.items()}, "params"))


def _params(out_dir):
    return ranks_mod._unflatten(
        dict(np.load(os.path.join(out_dir, "inputs.npz"))), "params",
        lambda x: torch.from_numpy(x.copy()))


def _text(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), np.uint8)


def _json(arr):
    return json.loads(bytes(arr).decode())


# -------------------------------------------------------------- the ranks
def _job_boards(rank, world, out_dir):
    """On 4 ranks: the sub-mesh, remesh_tree, the replicated fleet up and
    down, the sharded fleet."""
    import repro_torch.cluster.cluster as pcluster
    import repro_torch.core.tiered_embedding as pte
    import repro_torch.fabric.fleet as pfleet
    from repro_torch.cluster import Cluster, SLAAutoscaler
    from repro_torch.fabric import ShardedFleet
    from repro_torch.launch.mesh import make_host_mesh, sub_mesh
    from repro_torch.runtime.elastic import Spec, gather_tree, remesh_tree
    out = {}
    # -- a sub-mesh over 2 of the 4 ranks
    m = sub_mesh([1, 3])
    out["mesh/member"] = np.array([m.member, m.group("data") is None,
                                   m.group(("data", "model")) is None])
    out["mesh/coords"] = np.array([m.coords.get("data", -1)])
    # -- remesh_tree: tests/test_system.py's round trip and fallback
    specs = {"w": Spec("data"), "b": None}
    tree = {"w": torch.arange(16.0).reshape(4, 4), "b": torch.ones(3)}
    world_mesh = make_host_mesh()
    got, rep = remesh_tree(tree, specs, world_mesh, device="cpu")
    out["remesh/host"] = _text(rep)
    out["remesh/host_w"] = got["w"].numpy()
    tree2 = {"w": torch.ones((3, 3)), "b": torch.ones(3)}
    got2, rep2 = remesh_tree(tree2, specs, world_mesh, device="cpu")
    out["remesh/fallback"] = _text(rep2)
    out["remesh/fallback_w"] = got2["w"].numpy()
    a, b = sub_mesh([0, 1]), sub_mesh([2, 3])
    on_a, _ = remesh_tree(tree, specs, a, device="cpu")
    on_b, rep_b = remesh_tree(on_a, specs, b, src_mesh=a, device="cpu")
    out["remesh/disjoint"] = _text(rep_b)
    again, rep_again = remesh_tree(on_a, specs, a, src_mesh=a, device="cpu")
    out["remesh/same"] = _text(rep_again)
    on_all, rep_all = remesh_tree(on_a, specs, world_mesh, src_mesh=a,
                                  device="cpu")
    out["remesh/widen"] = _text(rep_all)
    out["remesh/widen_w"] = on_all["w"].numpy()
    # gathered into rank 0's host memory, one row of a leaf a chunk
    import repro_torch.runtime.elastic as pelastic
    chunk, pelastic.CHUNK_ELEMS = pelastic.CHUNK_ELEMS, 1
    full = gather_tree({**on_all, "e": torch.full((2,), float(rank))},
                       {**specs, "e": Spec(stack="data")}, world_mesh)
    pelastic.CHUNK_ELEMS = chunk
    out["remesh/gathered"] = np.array([full is not None])
    if full is not None:
        out["remesh/gathered_w"] = full["w"].numpy()
        out["remesh/gathered_e"] = full["e"].numpy()
    if on_b is not None:
        out["remesh/on_b_w"] = on_b["w"].numpy()
    if again is not None:
        before = on_a["w"].clone()
        aliased = any(x.data_ptr() == y.data_ptr() for x, y in
                      ((again["w"], on_a["w"]), (again["b"], on_a["b"])))
        again["w"].add_(1.0)
        out["remesh/copy"] = np.array([not aliased,
                                       torch.equal(on_a["w"], before)])
        out["remesh/same_w"] = (again["w"] - 1.0).numpy()
    # -- the replicated fleet: up 1 -> 3, down 2 -> 1
    pcluster.materialize_query = _port_query
    pfleet.materialize_query = _port_query
    pte.measure_row_freq = lambda cfg, *a, device=None, **kw: \
        torch.from_numpy(_freq_np(cfg)).to(device)
    cfg = _cfg()
    stationary, drift = _events()
    for tag, n, auto in (
            ("up", 1, SLAAutoscaler(sla_ms=1e-3, max_replicas=3, window=8,
                                    patience=1)),
            ("down", 2, SLAAutoscaler(sla_ms=1e6, min_replicas=1,
                                      max_replicas=3, window=8,
                                      patience=1))):
        cl = Cluster(cfg, n_replicas=n, devices_per_replica=2,
                     alpha=CLUSTER_ALPHA, router="jsq", max_batch_queries=2,
                     autoscaler=auto, device="cpu")
        report = cl.run(stationary, sla_ms=1e6)
        out[f"{tag}/probs"] = np.stack([cl.completed[e.qid].probs
                                        for e in stationary])
        out[f"{tag}/latency"] = np.array([cl.completed[e.qid].latency_ms
                                          for e in stationary])
        out[f"{tag}/events"] = _text([(e.action, e.n_replicas, e.remesh)
                                      for e in report.scale_events])
        out[f"{tag}/boards"] = _text([r.devices for r in cl.replicas])
        out[f"{tag}/end"] = np.array([report.n_replicas_end])
    # -- the sharded fleet: 4 boards of 2 ranks against 1 board of 2, on
    # fixed device times (tests/test_torch_fabric.py's SERVICE), so that
    # its batching, routing and cache re-elections do not depend on the
    # host's load
    for name, fixed in FABRIC_SERVICE.items():
        def wrapped(self, *args, _orig=getattr(pfleet.FabricBoard, name),
                    _fixed=fixed):
            out, _ = _orig(self, *args)
            return out, _fixed(args[-1])
        setattr(pfleet.FabricBoard, name, wrapped)
    params = _params(out_dir)
    full = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    one = ShardedFleet(cfg, n_boards=1, devices_per_board=2,
                       alpha=FABRIC_ALPHA, board_capacity_bytes=full,
                       max_batch_queries=2, params=params, device="cpu")
    one.run(drift, sla_ms=1e6)
    out["fabric/one"] = np.stack([one.completed[e.qid].probs for e in drift])
    for cache_on in (True, False):
        fleet = ShardedFleet(cfg, n_boards=4, devices_per_board=2,
                             alpha=FABRIC_ALPHA, max_batch_queries=2,
                             cache_enabled=cache_on, cache_window=6,
                             cache_refresh_threshold=0.7, cache_cooldown=6,
                             router="jsq", params=params, device="cpu")
        r = fleet.run(drift, sla_ms=1e6, scenario="zipf_drift")
        tag = f"fabric/cache_{int(cache_on)}"
        out[f"{tag}/probs"] = np.stack([fleet.completed[e.qid].probs
                                        for e in drift])
        out[f"{tag}/refreshes"] = np.array([r.cache_refreshes])
        out[f"{tag}/boards"] = _text([b.devices for b in fleet.boards])
        out[f"{tag}/members"] = np.array([b.member for b in fleet.boards])
    # -- what is left of A6b-ii: online updates into a board of 2 ranks
    from repro_torch.online import DeltaBatch, DeltaChannel, RowDelta
    batch = DeltaBatch(version=1, t_emit_s=0.0, step=1, deltas=(RowDelta(
        1, np.array([3]), np.ones((1, cfg.embed_dim), np.float32)),))
    cl = Cluster(cfg, n_replicas=1, devices_per_replica=2, device="cpu",
                 max_batch_queries=2)
    fleet = ShardedFleet(cfg, n_boards=1, devices_per_board=2,
                         params=params, device="cpu")
    for name, fn in {
            "cluster": lambda: cl.run(stationary[:2], online=DeltaChannel()),
            "replica": lambda: cl.replicas[0].apply_row_updates(batch),
            "fabric": lambda: fleet.run(drift[:2], online=DeltaChannel())
    }.items():
        try:
            fn()
            msg = "no error"
        except NotImplementedError as err:
            msg = f"NotImplementedError: {err}"
        out[f"online/{name}"] = np.frombuffer(msg.encode(), np.uint8)
    return out


# --------------------------------------------------------- the reference
REFERENCE = """
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
assert len(jax.devices()) == 4, jax.devices()
import repro.cluster.cluster as jcluster
import repro.core.dlrm as jdlrm
import repro.core.tiered_embedding as jte
import repro.fabric.fleet as jfleet
from repro.cluster import Cluster, SLAAutoscaler
from repro.configs.registry import get_dlrm
from repro.fabric import ShardedFleet
from repro.launch.mesh import make_host_mesh
from repro.runtime import remesh_tree
from repro.traffic import make_scenario
from types import SimpleNamespace
{stream}

d = {out_dir!r}
inp = dict(np.load(d + "/inputs.npz"))
out = {{}}

def text(obj):
    return np.frombuffer(json.dumps(obj).encode(), np.uint8)

mesh1 = make_host_mesh()
specs = {{"w": P("data"), "b": P()}}
tree = {{"w": jnp.arange(16.0).reshape(4, 4), "b": jnp.ones(3)}}
_, rep = remesh_tree(tree, specs, mesh1)
out["remesh/host"] = text(rep)
_, rep2 = remesh_tree({{"w": jnp.ones((3, 3)), "b": jnp.ones(3)}}, specs,
                      mesh1)
out["remesh/fallback"] = text(rep2)

cfg = dataclasses.replace(get_dlrm("{name}").reduced(), batch_size=8)
params = {{"tables": jnp.asarray(inp["params/tables"])}}
for k in ("bot_mlp", "top_mlp"):
    n = len([x for x in inp if x.startswith(f"params/{{k}}/") and
             x.endswith("/w")])
    params[k] = [{{"w": jnp.asarray(inp[f"params/{{k}}/{{i}}/w"]),
                   "b": jnp.asarray(inp[f"params/{{k}}/{{i}}/b"])}}
                 for i in range(n)]
jdlrm.init_dlrm = lambda key, cfg: params

def query(cfg, ev, q=None):
    dn, ix = _query_np(cfg, ev, q or cfg.batch_size)
    return {{"dense": jnp.asarray(dn), "indices": jnp.asarray(ix)}}

jcluster.materialize_query = query
jfleet.materialize_query = query
jte.measure_row_freq = lambda cfg, *a, **kw: jnp.asarray(_freq_np(cfg))
stationary = make_scenario("stationary", alpha={calpha}).events(
    40, qps=2000.0, seed=2)
drift = make_scenario("zipf_drift", alpha={falpha}, rotate_every_s=0.02,
                      salt_stride=37).events(120, qps=2000.0, seed=3)
for tag, n, auto in (
        ("up", 1, SLAAutoscaler(sla_ms=1e-3, max_replicas=3, window=8,
                                patience=1)),
        ("down", 2, SLAAutoscaler(sla_ms=1e6, min_replicas=1,
                                  max_replicas=3, window=8, patience=1))):
    cl = Cluster(cfg, n_replicas=n, devices_per_replica=2, alpha={calpha},
                 router="jsq", max_batch_queries=2, autoscaler=auto)
    report = cl.run(stationary, sla_ms=1e6)
    out[tag + "/probs"] = np.stack([np.asarray(cl.completed[e.qid].probs)
                                    for e in stationary])
    out[tag + "/events"] = text([(e.action, e.n_replicas, e.remesh)
                                 for e in report.scale_events])
    out[tag + "/boards"] = text([[int(x.id) for x in r.devices]
                                 for r in cl.replicas])
fleet = ShardedFleet(cfg, n_boards=4, devices_per_board=2, alpha={falpha},
                     max_batch_queries=2, cache_window=6,
                     cache_refresh_threshold=0.7, cache_cooldown=6,
                     router="jsq", params=params)
fleet.run(drift, sla_ms=1e6, scenario="zipf_drift")
out["fabric/probs"] = np.stack([np.asarray(fleet.completed[e.qid].probs)
                                for e in drift])
np.savez(d + "/ref.npz", **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    """The inputs, the reference's results and the 4 ranks'; the
    reference's subprocess runs while the ranks do."""
    d = tmp_path_factory.mktemp("boards")
    _make_inputs(d / "inputs.npz")
    stream = (inspect.getsource(_query_np) + "\n\n"
              + inspect.getsource(_freq_np)).replace("{", "{{").replace(
                  "}", "}}")
    code = REFERENCE.replace("{stream}", stream).format(
        out_dir=str(d), name=NAME, calpha=CLUSTER_ALPHA, falpha=FABRIC_ALPHA)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(subproc, code, 4, ranks_mod.SPAWN_TIMEOUT_S)
        k4 = ranks_mod.spawn(_job_boards, 4, d)
        proc = ref.result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {"ref": dict(np.load(d / "ref.npz")), 4: k4, "dir": d}


# ---------------------------------------------------------------- meshes
def test_a_sub_mesh_builds_its_groups_on_every_rank(runs):
    """ranks 1 and 3 are members with groups and coordinates 0 and 1;
    ranks 0 and 2 have no groups and no coordinates."""
    for rank, r in enumerate(runs[4]):
        member, data_none, all_none = r["mesh/member"]
        assert member == (rank in (1, 3))
        assert data_none == all_none == (rank not in (1, 3))
        assert r["mesh/coords"][0] == {1: 0, 3: 1}.get(rank, -1)


@pytest.mark.parametrize("case", ["host", "fallback"])
def test_remesh_reports_match_the_reference(runs, case):
    """tests/test_system.py's round trip (4 x 4 over "data" of 4 ranks)
    and its replication fallback (3 x 3), the same reports."""
    want = _json(runs["ref"][f"remesh/{case}"])
    w = np.arange(16.0).reshape(4, 4)
    for rank, r in enumerate(runs[4]):
        assert _json(r[f"remesh/{case}"]) == want
        if case == "host":
            np.testing.assert_array_equal(r["remesh/host_w"],
                                          w[rank:rank + 1])
        else:
            np.testing.assert_array_equal(r["remesh/fallback_w"],
                                          np.ones((3, 3)))


def test_remesh_across_ranks_and_onto_the_same_ranks(runs):
    """From ranks 0-1 onto 2-3 (a broadcast a block), onto 0-1 again (a
    copy, not an alias), and onto all 4 (each block cut from one of the
    source's), then gathered back whole into rank 0's host memory, a
    row a chunk, with a leaf stacked one slice a rank."""
    w = np.arange(16.0).reshape(4, 4)
    want = {"resharded": 2, "replicated_fallback": 0}
    for rank, r in enumerate(runs[4]):
        for case in ("disjoint", "same", "widen"):
            assert _json(r[f"remesh/{case}"]) == want
        np.testing.assert_array_equal(r["remesh/widen_w"], w[rank:rank + 1])
        assert r["remesh/gathered"][0] == (rank == 0)
        if rank == 0:
            np.testing.assert_array_equal(r["remesh/gathered_w"], w)
            np.testing.assert_array_equal(
                r["remesh/gathered_e"], np.repeat(np.arange(4.0), 2)
                .reshape(4, 2))
        else:
            assert "remesh/gathered_w" not in r
        if rank in (2, 3):
            j = rank - 2
            np.testing.assert_array_equal(r["remesh/on_b_w"],
                                          w[2 * j:2 * j + 2])
            assert "remesh/same_w" not in r
        else:
            assert "remesh/on_b_w" not in r
            assert r["remesh/copy"].all()
            np.testing.assert_array_equal(r["remesh/same_w"],
                                          w[2 * rank:2 * rank + 2])


# -------------------------------------------------------- replicated fleet
def _serve_direct(cfg, events):
    """The port's 1-rank ``serve_direct`` of every event's query."""
    from repro_torch.engine import Engine
    sess = Engine(cfg, alpha=CLUSTER_ALPHA, device="cpu").serve_session(
        max_batch_queries=2)
    return np.stack([sess.serve_direct(**_port_query(cfg, ev))
                     for ev in events])


@pytest.mark.parametrize("tag", ["up", "down"])
def test_boards_of_2_ranks_scale_and_serve_as_the_reference(runs, tag):
    """1 -> 3 boards (the third wrapped onto ranks 0-1) and 2 -> 1: the
    reference's scale events and remesh reports, every query's probs
    against the reference cluster's and the port's 1-rank serve_direct,
    and the same completed queries on every rank."""
    cfg = _cfg()
    stationary, _ = _events()
    direct = _serve_direct(cfg, stationary)
    ref = runs["ref"]
    events = _json(ref[f"{tag}/events"])
    if tag == "up":
        assert [e[:2] for e in events] == [["up", 2], ["up", 3]]
        assert all(e[2]["resharded"] > 0 and e[2]["replicated_fallback"]
                   == 0 for e in events)
    else:
        assert [e[:2] for e in events] == [["down", 1]]
    first = runs[4][0]
    for r in runs[4]:
        assert _json(r[f"{tag}/events"]) == events
        # the board retired is the emptiest at the decision, which
        # follows the measured service times: which one stays is timing
        assert _json(r[f"{tag}/boards"]) == _json(first[f"{tag}/boards"])
        np.testing.assert_array_equal(r[f"{tag}/probs"], first[f"{tag}/probs"])
        np.testing.assert_array_equal(r[f"{tag}/latency"],
                                      first[f"{tag}/latency"])
        np.testing.assert_allclose(r[f"{tag}/probs"], ref[f"{tag}/probs"],
                                   **SERVE_TOL)
        np.testing.assert_allclose(r[f"{tag}/probs"], direct, **SERVE_TOL)
    if tag == "up":
        assert _json(first["up/boards"]) == _json(ref["up/boards"]) == [
            [0, 1], [2, 3], [0, 1]]
    else:
        assert _json(first["down/boards"]) in ([[0, 1]], [[2, 3]])


# ----------------------------------------------------------- sharded fleet
@pytest.mark.parametrize("cache_on", [True, False])
def test_4_boards_of_2_ranks_equal_one_board_bitwise(runs, cache_on):
    """4 boards of 2 of the 4 ranks (boards 2 and 3 wrapped) serve every
    query bitwise as one board of 2 ranks holding every table, within
    the tolerance of the reference's 4-board fleet; the drift re-elects
    a cache."""
    tag = f"fabric/cache_{int(cache_on)}"
    ref = runs["ref"]["fabric/probs"]
    for rank, r in enumerate(runs[4]):
        np.testing.assert_array_equal(r[f"{tag}/probs"], r["fabric/one"])
        np.testing.assert_allclose(r[f"{tag}/probs"], ref, **SERVE_TOL)
        assert _json(r[f"{tag}/boards"]) == [[0, 1], [2, 3], [0, 1], [2, 3]]
        assert list(r[f"{tag}/members"]) == (
            [True, False, True, False] if rank < 2
            else [False, True, False, True])
        if cache_on:
            assert r[f"{tag}/refreshes"][0] > 0
        else:
            assert r[f"{tag}/refreshes"][0] == 0


@pytest.mark.parametrize("case", ["cluster", "replica", "fabric"])
def test_online_updates_into_a_board_of_2_ranks_raise(runs, case):
    """What is left of ROADMAP A6b-ii on the fleets: a delta channel into
    a fleet of boards of 2 ranks, and a row update into such a replica,
    raise on every rank, naming the item."""
    for r in runs[4]:
        msg = bytes(r[f"online/{case}"]).decode()
        assert msg.startswith("NotImplementedError:") and \
            "ROADMAP A6b-ii" in msg and "more than one rank" in msg, msg


# --------------------------------------------------------------- launcher
def test_serve_launcher_runs_boards_of_2_ranks_over_4(runs):
    """``torch.distributed.run --nproc-per-node 4`` of the serve launcher
    with 2 replicas of --model-axis 2 prints one ClusterReport, from rank
    0 alone."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
         "--smoke", "--device", "cpu", "--replicas", "2", "--model-axis",
         "2", "--queries", "12", "--sla-ms", "5000"],
        capture_output=True, text=True, env=env,
        timeout=ranks_mod.SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert sum(l.startswith("[cluster] stationary x round_robin: 12 "
                            "queries over 2->2 replicas") for l in lines) \
        == 1, proc.stdout
    assert sum(l.startswith("[serve] fleet of 2 replicas on cpu: "
                            "serve_kernel=composed") for l in lines) == 1, \
        proc.stdout
