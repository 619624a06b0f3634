"""The DLRM half of the dry-run (``repro_torch.op_stream``,
``repro_torch.launch.{mesh,steps,op_analysis,dryrun}``,
``benchmarks_torch.{roofline,render_experiments}``)
held against the reference's (``repro.launch.{mesh,steps,hlo_analysis,
dryrun}``, ``benchmarks.{roofline,render_experiments}``).

The reference's dry-run code runs only in subprocesses, one a case group:
importing ``repro.launch.dryrun`` writes ``XLA_FLAGS`` into the importing
process, which would leak into every later subprocess of a worker. Its
renderers import no JAX and are imported here.

Cell parity: the reference compiles ``build_dlrm_cell`` for 8 host
devices on meshes (2, 4) and (2, 2, 2) and analyses its HLO
(``hlo_analysis.analyze``); the port runs ``build_dlrm_cell`` on
placeholder meshes of the same shapes, on the meta device and on the CPU,
under an op stream. The configs are RM2 at ``reduced()`` with narrow
MLPs (``_small``). XLA:CPU prints these meshes' replica groups as
explicit lists, which the reference's ``_REPLICA_GROUPS_RE`` (the iota
form ``[G,n]``) does not read, leaving its factor (n-1)/n at 1; the
subprocess rewrites each list of equal groups into its iota form before
``analyze``, so both sides count (n-1)/n. Tolerances, each difference
named in PERF.md:

- flops within 2%: XLA strength-reduces the top MLP's last (N = 1) dot,
  and its backward, into a multiply and a reduce, which count no flops;
- collective bytes by kind within 2% (equal, in fact) with fp32 tables.
  With bf16 tables (the dry-run's default) XLA:CPU's float normalization
  runs the row-wise reduce-scatter and the grads' all-gather in f32, so
  the port's float bytes are half the reference's there (held exactly);
- collective count: equal for serving; the train step's loss psum is an
  all-reduce of its own in the port, which XLA's all-reduce combiner
  merges with the dense grads' (one more in the port, exactly);
- traffic: each cell's port / reference ratio is pinned to its reading
  (``TRAFFIC_RATIO``) within ``TRAFFIC_RTOL``, so a count that moves
  fails. The ratios themselves lie in 0.83-1.45 table-wise and 1.16-6.49
  row-wise: eager torch writes each op's result to memory where XLA
  fuses (the row-wise masked gather's (B, T, L, d) rows, which
  partial_pool's fusion never writes at all, and its int64 id masks, the
  L-fold expanded grads, psum's clone, the all-to-all's contiguous
  copies), while XLA counts every operand of each fusion whole, once per
  fusion that reads it (which puts table-wise serving below 1).

The bf16 SGD row update (the cells' tables) equals the reference's
bitwise on distinct rows; a row updated k > 1 times is within k bf16
ulps (at the scale of its largest term) of it: the two scatter-adds sum a
row's updates in another order and precision.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmarks import render_experiments as ref_render  # noqa: E402
from benchmarks import roofline as ref_roofline  # noqa: E402
from benchmarks_torch import render_experiments, roofline  # noqa: E402
from repro_torch.configs.registry import DLRM_CONFIGS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch import op_stream  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, steps  # noqa: E402
from repro_torch.launch.mesh import (PlaceholderMesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.op_stream import PlaceholderGroup  # noqa: E402
from repro_torch.parallel import build_step  # noqa: E402
from repro_torch.parallel import primitives as prim  # noqa: E402
from repro_torch.parallel.updates import sgd_row_update  # noqa: E402
import test_torch_ranks as ranks_mod  # noqa: E402

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
MESHES = ((2, 4), (2, 2, 2))
# (config, mode, row-wise wire mode)
CELLS = (("dlrm-rm2-small-unsharded", "serve", "unpooled"),
         ("dlrm-rm2-small-unsharded", "train", "unpooled"),
         ("dlrm-rm2-small-sharded", "serve", "unpooled"),
         ("dlrm-rm2-small-sharded", "serve", "partial_pool"),
         ("dlrm-rm2-small-sharded", "train", "unpooled"),
         ("dlrm-rm2-small-sharded", "train", "partial_pool"))
FLOPS_RTOL = BYTES_RTOL = 0.02
# each cell's port / reference traffic, as read on jax 0.9.0's XLA:CPU
# (``python tests/test_torch_dryrun.py`` prints them), by (mesh, table
# dtype, cell)
TRAFFIC_RTOL = 0.03
_TRAFFIC = {
    "float32": {(2, 4): (0.833, 1.274, 2.027, 6.487, 2.678, 3.844),
                (2, 2, 2): (0.963, 1.446, 2.027, 6.487, 2.678, 3.844)},
    "bfloat16": {(2, 4): (0.828, 1.245, 1.157, 3.704, 1.543, 2.205)}}
TRAFFIC_RATIO = {(shape, dtype) + cell: r
                 for dtype, by_mesh in _TRAFFIC.items()
                 for shape, ratios in by_mesh.items()
                 for cell, r in zip(CELLS, ratios)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(code: str, n_devices: int) -> dict:
    """Run ``code`` (which prints one JSON line last) in a fresh
    interpreter over ``n_devices`` host devices."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _small(cfg):
    return dataclasses.replace(cfg.reduced(), bot_mlp=(16,), top_mlp=(16, 1),
                               num_dense=8)


REF_STATIC = """
    import json
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs.registry import DLRM_CONFIGS
    from repro.launch import dryrun, hlo_analysis, steps
    from repro.launch.mesh import make_production_mesh
    out = {"ids": dryrun.all_cell_ids(), "meshes": {}, "cfgs": {},
           "flops": {}}
    for kind in ("single", "multi"):
        m = make_production_mesh(multi_pod=kind == "multi")
        out["meshes"][kind] = [list(m.axis_names), list(m.devices.shape)]
    devs = np.array(jax.devices())
    for shape in ((2, 4), (2, 2, 2), (16, 16), (2, 16, 16)):
        axes = ("data", "model") if len(shape) == 2 else (
            "pod", "data", "model")
        mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
        for name, cfg in DLRM_CONFIGS.items():
            c = steps.dlrm_dryrun_config(cfg, mesh)
            out["cfgs"][f"{shape}:{name}"] = [
                steps.dlrm_queries_per_step(mesh), c.name, c.num_tables]
    for name, cfg in DLRM_CONFIGS.items():
        for mode in ("train", "serve"):
            for b in (256, 51200, 153600, 307200):
                out["flops"][f"{name}:{mode}:{b}"] = \\
                    dryrun.model_flops_estimate(mode, cfg, b)
    out["consts"] = [hlo_analysis.PEAK_FLOPS_BF16, hlo_analysis.HBM_BW,
                     hlo_analysis.LINK_BW, hlo_analysis.CC_LATENCY]
    print(json.dumps(out))
"""

REF_CELLS = """
    import dataclasses, json, re
    import jax.numpy as jnp
    from repro.configs.registry import DLRM_CONFIGS
    from repro.launch import hlo_analysis, steps
    from repro.launch.mesh import make_mesh
    GROUPS = re.compile(r"replica_groups=\\{((?:\\{[\\d,]*\\},?)+)\\}")

    def iota(m):
        groups = re.findall(r"\\{([\\d,]*)\\}", m.group(1))
        sizes = {len(g.split(",")) for g in groups}
        assert len(sizes) == 1, m.group(0)
        n = sizes.pop()
        return f"replica_groups=[{len(groups)},{n}]<=[{len(groups) * n}]"

    out = {}
    for shape, dtype in %s:
        axes = ("data", "model") if len(shape) == 2 else (
            "pod", "data", "model")
        mesh = make_mesh(shape, axes)
        for name, mode, ex in %s:
            cfg = dataclasses.replace(DLRM_CONFIGS[name].reduced(),
                                      bot_mlp=(16,), top_mlp=(16, 1),
                                      num_dense=8)
            with mesh:
                cell = steps.build_dlrm_cell(
                    cfg, mode, mesh, row_wise_exchange=ex,
                    table_dtype=getattr(jnp, dtype))
                hlo = cell.lower().compile().as_text()
            out[f"{shape}:{dtype}:{name}:{mode}:{ex}"] = \\
                hlo_analysis.analyze(GROUPS.sub(iota, hlo))
    print(json.dumps(out))
"""
REF_RUNS = [(m, "float32") for m in MESHES] + [((2, 4), "bfloat16")]


@pytest.fixture(scope="module")
def ref_static():
    return _reference(REF_STATIC, 512)


@pytest.fixture(scope="module")
def ref_cells():
    return _reference(REF_CELLS % (REF_RUNS, list(CELLS)), 8)


def _port_cell(shape, dtype, name, mode, ex, device):
    mesh = PlaceholderMesh(shape, AXES[len(shape)])
    cell = steps.build_dlrm_cell(_small(DLRM_CONFIGS[name]), mode, mesh,
                                 row_wise_exchange=ex,
                                 table_dtype=getattr(torch, dtype))
    return dryrun.measure(cell, mesh, torch.device(device), 0.0)


# ---------------------------------------------------------------------------
# pure parity
# ---------------------------------------------------------------------------
def test_all_cell_ids_are_the_references(ref_static):
    assert dryrun.all_cell_ids() == ref_static["ids"]
    assert sum(c.startswith("dlrm:") for c in ref_static["ids"]) == 16


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_production_mesh_is_the_references(ref_static, kind):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    axes, shape = ref_static["meshes"][kind]
    assert list(mesh.axis_names) == axes
    assert [mesh.shape[a] for a in axes] == shape
    assert mesh.size() == int(np.prod(shape)) and mesh.rank == 0
    assert mesh.coords == {a: 0 for a in axes}
    # every set of axes of more than one rank has a placeholder group
    for sub in (("model",), tuple(axes[:-1]), tuple(axes)):
        g = mesh.group(sub)
        assert isinstance(g, PlaceholderGroup)
        assert (g.size, g.rank) == (mesh.size(sub), 0)
        assert prim.group_size(g) == g.size and prim.group_rank(g) == 0


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 2), (16, 16),
                                   (2, 16, 16)])
def test_queries_and_dryrun_config_are_the_references(ref_static, shape):
    mesh = PlaceholderMesh(shape, AXES[len(shape)])
    for name, cfg in DLRM_CONFIGS.items():
        c = steps.dlrm_dryrun_config(cfg, mesh)
        assert [steps.dlrm_queries_per_step(mesh), c.name, c.num_tables] \
            == ref_static["cfgs"][f"{shape}:{name}"], name


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("name", sorted(DLRM_CONFIGS))
def test_model_flops_estimate_is_the_references(ref_static, name, mode):
    for b in (256, 51200, 153600, 307200):
        assert dryrun.model_flops_estimate(mode, DLRM_CONFIGS[name], b) \
            == ref_static["flops"][f"{name}:{mode}:{b}"]


def test_roofline_terms_follow_the_reference_formula(ref_static):
    from repro.launch import hlo_analysis   # imports no JAX
    peak, hbm, link, lat = ref_static["consts"]
    for args in ((1e12, 3e9, 2e8, 5.0), (0.0, 1e6, 0.0, 0.0),
                 (5e14, 1e8, 4e10, 300.0)):
        assert op_analysis.roofline_terms(
            *args, peak_flops=peak, hbm_bw=hbm, link_bw=link,
            cc_latency=lat) == hlo_analysis.roofline_terms(*args)
    # the port's own constants are the H100's and the paper's 1 µs
    assert (op_analysis.HBM_BW, op_analysis.LINK_BW,
            op_analysis.CC_LATENCY) == (3.35e12, 450e9, 1e-6)
    assert op_analysis.PEAK_FLOPS[torch.float32] == 67e12
    assert op_analysis.PEAK_FLOPS[torch.bfloat16] == 989e12


def _records():
    recs = [dict(_port_cell(s, "float32", n, m, e, "meta"),
                 cell=f"dlrm:{n}:{m}:{'single' if len(s) == 2 else 'multi'}",
                 status="ok")
            for s, (n, m, e) in zip(MESHES, CELLS[:2])]
    recs.append({"cell": "dlrm:dlrm-rm2-large-sharded:train:single",
                 "status": "fail", "error": "x"})
    return recs


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_renderers_print_the_references_rows(mesh, capsys):
    recs = _records()
    assert roofline.render(recs, mesh) == ref_roofline.render(recs, mesh)
    base = {r["cell"]: r for r in recs}
    opt = {r["cell"]: r for r in recs[:1]}
    ref_render.table(base, opt, mesh)
    want = capsys.readouterr().out
    render_experiments.table(base, opt, mesh)
    assert capsys.readouterr().out == want


# ---------------------------------------------------------------------------
# the analysis on a synthetic op stream
# ---------------------------------------------------------------------------
def test_op_stream_counts_a_synthetic_stream():
    meta = torch.device("meta")
    a = torch.empty((8, 16), device=meta)
    b = torch.empty((16, 32), device=meta)
    g4 = PlaceholderGroup(("model",), 4, 1)
    with op_stream.OpStream() as s:
        s.track((a, b))
        c = a @ b                                   # a matmul
        assert s.flops == 2 * 8 * 32 * 16
        assert s.traffic_bytes == (8 * 16 + 16 * 32 + 8 * 32) * 4
        t0 = s.traffic_bytes
        c.view(-1).t()                              # views: nothing
        torch.empty((1000,), device=meta)           # a factory op
        assert s.traffic_bytes == t0
        for name, op, res in (("psum", 4096, 4096),
                              ("all_gather", 1024, 4096),
                              ("psum_scatter", 4096, 1024),
                              ("all_to_all", 4096, 4096),
                              ("broadcast", 512, 512)):
            inp = torch.empty((op // 4,), device=meta)
            out = inp if name in ("psum", "broadcast") else torch.empty(
                (res // 4,), device=meta)
            g4.fake(name, out, inp)
        coll = s.summary()["collective_by_kind"]
        assert coll == {"all-reduce": 2 * 4096 * 3 / 4,
                        "all-gather": 3072.0, "reduce-scatter": 3072.0,
                        "all-to-all": 3072.0, "broadcast": 512.0}
        assert s.traffic_bytes == t0 + 8192 + 5120 + 5120 + 8192 + 1024
        # a kernel op on meta: one op, its operands and result, its flops
        t1, f1 = s.traffic_bytes, s.flops
        tables = torch.empty((3, 100, 32), dtype=torch.bfloat16,
                             device=meta)
        ids = torch.empty((5, 3, 7), dtype=torch.int32, device=meta)
        pooled = ops.embedding_bag(tables, ids)
        assert (pooled.shape, pooled.dtype) == ((5, 3, 32), torch.float32)
        assert s.traffic_bytes - t1 == 3 * 100 * 32 * 2 + 5 * 3 * 7 * 4 \
            + 5 * 3 * 32 * 4
        feats = ops.interactions(torch.empty((5, 32), device=meta), pooled)
        assert feats.shape == (5, 32 + 4 * 3 // 2)
        assert s.flops - f1 == 2 * 5 * 4 * 4 * 32
        assert s.kernels == {"embedding_bag": 1, "interactions": 1}
    assert ops.launch_counts["embedding_bag"] == 0   # no card launch


def test_op_stream_peak_counts_live_storages():
    with op_stream.OpStream() as s:
        x = torch.ones(1000)                         # 4,000 B
        s.track(x)
        y = x * 2                                    # +4,000
        del y
        z = x + 1                                    # freed y's room
        assert s.peak_bytes == 8000 and s.live_bytes == 8000
        x.add_(z)                                    # in place: nothing
        assert s.live_bytes == 8000


def test_placeholder_collectives_make_this_ranks_result():
    g = PlaceholderGroup(("data", "model"), 4, 0)
    x = torch.arange(24, dtype=torch.float32).reshape(4, 3, 2)
    before = dict(prim.call_counts)
    with op_stream.OpStream() as s:
        assert torch.equal(prim.all_gather(x, g), x.repeat(4, 1, 1))
        assert s.coll_by_kind == {"all-gather": 384 - 96}
        assert torch.equal(prim.psum(x, g), x)
        assert torch.equal(prim.psum_scatter(x, g), x[:1])
        ids = torch.arange(2 * 8 * 3, dtype=torch.int32).reshape(2, 8, 3)
        owner = prim.all_to_all(ids, 1, 0, g)      # (8, 2, 3): own chunks
    assert owner.shape == (8, 2, 3)
    assert torch.equal(owner, torch.cat(ids.split(2, dim=1)))
    assert s.coll_count_by_kind == {"all-gather": 1, "all-reduce": 1,
                                    "reduce-scatter": 1, "all-to-all": 1}
    assert prim.call_counts["all_gather_cpu"] == \
        before["all_gather_cpu"] + 1
    m = torch.empty((4, 3), device="meta")
    assert prim.psum_scatter(m, g).shape == (1, 3)
    assert prim.call_counts["psum_scatter_meta"] == \
        before["psum_scatter_meta"] + 1


# ---------------------------------------------------------------------------
# cell parity
# ---------------------------------------------------------------------------
def _held(port, ref, mode, key, float_scale=1.0, ids_bytes=0.0):
    """``port``'s analysis against the reference's (see the module doc)
    for the cell ``key`` of ``TRAFFIC_RATIO``; ``float_scale`` scales the
    reference's float bytes of the row-wise reduce-scatter and all-gather
    (``ids_bytes`` of the latter are ids)."""
    assert port["flops_per_chip"] == pytest.approx(ref["flops_per_chip"],
                                                   rel=FLOPS_RTOL)
    want = dict(ref["collective_by_kind"])
    if float_scale != 1.0:
        if "reduce-scatter" in want:
            want["reduce-scatter"] *= float_scale
        if "all-gather" in want:
            want["all-gather"] = ids_bytes + (want["all-gather"] - ids_bytes
                                              ) * float_scale
    assert set(port["collective_by_kind"]) == set(want)
    for kind, v in want.items():
        assert port["collective_by_kind"][kind] == pytest.approx(
            v, rel=BYTES_RTOL), kind
    assert port["collective_count"] == ref["collective_count"] + (
        1 if mode == "train" else 0)
    ratio = port["traffic_bytes_per_chip"] / ref["traffic_bytes_per_chip"]
    assert ratio == pytest.approx(TRAFFIC_RATIO[key], rel=TRAFFIC_RTOL), \
        ratio


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c[1:]) + (
    "-tw" if "unsharded" in c[0] else "-rw"))
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_cell_counts_match_the_reference(ref_cells, shape, cell):
    name, mode, ex = cell
    meta = _port_cell(shape, "float32", name, mode, ex, "meta")
    cpu = _port_cell(shape, "float32", name, mode, ex, "cpu")
    assert meta["op_analysis"] == cpu["op_analysis"]
    assert meta["memory"]["peak_per_device_bytes"] == \
        cpu["memory"]["peak_per_device_bytes"]
    assert meta["global_batch"] == 256 and meta["n_chips"] == 8
    _held(meta["op_analysis"],
          ref_cells[f"{shape}:float32:{name}:{mode}:{ex}"], mode,
          (shape, "float32") + cell)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c[1:]) + (
    "-tw" if "unsharded" in c[0] else "-rw"))
def test_bf16_cell_counts_match_the_reference(ref_cells, cell):
    name, mode, ex = cell
    shape = (2, 4)
    port = _port_cell(shape, "bfloat16", name, mode, ex, "meta")
    ref = ref_cells[f"{shape}:bfloat16:{name}:{mode}:{ex}"]
    key = (shape, "bfloat16") + cell
    if "unsharded" in name:
        _held(port["op_analysis"], ref, mode, key)
        return
    cfg = _small(DLRM_CONFIGS[name])
    b_local = 256 // 8
    ids = 7 * b_local * cfg.num_tables * cfg.lookups_per_table * 4
    _held(port["op_analysis"], ref, mode, key, float_scale=0.5,
          ids_bytes=ids)


def test_table_wise_cell_launches_row_4_and_keeps_ids_in_range():
    mesh = PlaceholderMesh((2, 4), AXES[2])
    cfg = _small(DLRM_CONFIGS["dlrm-rm2-small-unsharded"])
    cell = steps.build_dlrm_cell(cfg, "serve", mesh)
    with op_stream.OpStream() as s:
        probs, args = cell.run("cpu")
    assert s.kernels == {"embedding_bag": 1}
    assert probs.shape == (32,) and torch.isfinite(probs).all()
    assert args[0]["tables"].shape == (2, 128, 32)   # rank 0's 2 tables
    assert args[0]["tables"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# behaviour
# ---------------------------------------------------------------------------
def test_lm_cell_raises_naming_a8c_ii():
    """A MoE or SSM arch's LM cell is ROADMAP A8c-ii-b: the dry-run's
    cell and ``build_lm_cell`` raise naming it."""
    with pytest.raises(NotImplementedError, match="A8c-ii-b"):
        dryrun.run_cell("lm:mixtral-8x7b:train_4k:single", device="meta")
    from repro_torch.configs import get_arch
    with pytest.raises(NotImplementedError, match="A8c-ii-b"):
        steps.build_lm_cell(get_arch("rwkv6-3b"), dryrun.LM_SHAPES[0],
                            make_production_mesh())


def test_main_on_meta_runs_every_dlrm_cell(tmp_path):
    """``main --device meta``, filtered by ``--arch`` to each RM2 config
    (the LM archs' cells run in ``tests/test_torch_dryrun_lm.py``): every
    DLRM cell ``ok``; and an A8c-ii-b arch's cells ``not_ported``."""
    out = io.StringIO()
    names = sorted(DLRM_CONFIGS) + ["mixtral-8x7b"]
    with contextlib.redirect_stdout(out):
        for name in names:
            assert dryrun.main(["--device", "meta", "--arch", name, "--out",
                                str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert sorted(r["cell"] for r in recs) == sorted(
        c for c in dryrun.all_cell_ids() if c.split(":")[1] in names)
    ok = [r for r in recs if r["status"] == "ok"]
    assert sorted(r["cell"] for r in ok) == sorted(
        c for c in dryrun.all_cell_ids() if c.startswith("dlrm:"))
    for r in recs:
        if r["cell"].startswith("lm:"):
            assert r["status"] == "not_ported" and "A8c-ii-b" in r["error"]
    for r in ok:
        assert r["n_chips"] in (256, 512) and r["device"] == "meta"
        assert r["roofline"]["bottleneck"] in ("memory", "collective")
        assert r["memory"]["peak_per_device_bytes"] > \
            r["memory"]["argument_bytes"] > 0
    assert out.getvalue().count("4/4 cells passed, 0 not ported") == 4
    n_later = sum(c.split(":")[1] == "mixtral-8x7b"
                  for c in dryrun.all_cell_ids())
    assert f"0/0 cells passed, {n_later} not ported" in out.getvalue()


@pytest.mark.parametrize("repeats", [False, True])
def test_sgd_row_update_on_bf16_tables_matches_the_reference(repeats):
    import jax.numpy as jnp
    from repro.parallel.updates import sgd_row_update as ref_sgd
    rng = np.random.default_rng(0)
    tab = rng.standard_normal((3, 64, 8)).astype(np.float32)
    idx = (rng.integers(0, 64, (3, 40)) if repeats else np.stack(
        [rng.permutation(64)[:40] for _ in range(3)])).astype(np.int32)
    g = rng.standard_normal((3, 40, 8)).astype(np.float32) * 10
    want = np.asarray(ref_sgd(0.1)(jnp.asarray(tab, jnp.bfloat16),
                                   jnp.asarray(idx), jnp.asarray(g))
                      .astype(jnp.float32))
    got = sgd_row_update(0.1)(torch.from_numpy(tab).to(torch.bfloat16),
                              torch.from_numpy(idx), torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    moved = got != tab.astype(jnp.bfloat16).astype(np.float32)
    assert moved.any()
    if not repeats:
        np.testing.assert_array_equal(got, want)
        return
    # each of a row's k updates rounds once: k bf16 ulps (8 bits of
    # mantissa) at the scale of the row's largest term
    upd = np.abs(-0.1 * g)
    scale = np.abs(tab.astype(jnp.bfloat16).astype(np.float32))
    k = np.zeros(tab.shape[:2])
    for t in range(3):
        for j, r in enumerate(idx[t]):
            scale[t, r] = np.maximum(scale[t, r], upd[t, j])
            k[t, r] += 1
    ulp = 2.0 ** (np.floor(np.log2(scale.max(-1, keepdims=True))) - 7)
    assert (np.abs(got - want) <= k[..., None] * ulp).all()
    assert k.max() > 1


# ---------------------------------------------------------------------------
# the step's two options the cells use, on real gloo ranks
# ---------------------------------------------------------------------------
def _job_dp_sync(rank, world, out_dir):
    """2 gloo ranks on (2, 1) over ("data", "model"): table-wise tables
    replicated over "data"; two SGD steps with each ``dp_sync``, and the
    serve step with and without ``local_batch``."""
    from repro_torch.core import dlrm as dlrm_lib
    from repro_torch.launch.mesh import make_mesh
    cfg = DLRM_CONFIGS["dlrm-rm2-small-unsharded"].reduced()
    mesh = make_mesh((2, 1), ("data", "model"))
    gen = torch.Generator().manual_seed(3)
    B = 2 * cfg.batch_size
    dense = torch.randn((2, B, cfg.num_dense), generator=gen)
    ids = torch.randint(0, cfg.rows_per_table, (2, B, cfg.num_tables,
                                                cfg.lookups_per_table),
                        generator=gen, dtype=torch.int32)
    labels = torch.randint(0, 2, (2, B), generator=gen).float()
    out = {"init": dlrm_lib.init_dlrm(
        cfg, torch.Generator().manual_seed(0))["tables"].numpy()}
    for sync in ("sparse", "dense"):
        params = dlrm_lib.init_dlrm(cfg, torch.Generator().manual_seed(0))
        step = build_step(cfg, mesh, mode="train", axis="model",
                          dp_axes=("data",), lr=0.5, dp_sync=sync,
                          device="cpu")
        for s in range(2):
            params, _, loss = step(params, None, dense[s], ids[s], labels[s])
        out[f"{sync}_tables"] = params["tables"].numpy()
        out[f"{sync}_loss"] = loss.numpy()
    serve = {lb: build_step(cfg, mesh, mode="serve", axis="model",
                            dp_axes=("data",), local_batch=lb, fused=False,
                            device="cpu") for lb in (False, True)}
    m = B // 2
    out["global"] = serve[False](params, dense[0], ids[0]).numpy()
    out["local"] = serve[True](params, dense[0][rank * m:(rank + 1) * m],
                               ids[0][rank * m:(rank + 1) * m]).numpy()
    return out


def test_dense_dp_sync_and_local_batch_on_two_ranks(tmp_path):
    r0, r1 = ranks_mod.spawn(_job_dp_sync, 2, tmp_path)
    for r in (r0, r1):
        np.testing.assert_allclose(r["dense_tables"], r["sparse_tables"],
                                   rtol=1e-6, atol=1e-7)
        assert r["dense_loss"] == r["sparse_loss"]
    # the replicas agree, and both steps moved the tables
    np.testing.assert_array_equal(r0["dense_tables"], r1["dense_tables"])
    np.testing.assert_array_equal(r0["sparse_tables"], r1["sparse_tables"])
    assert (r0["dense_tables"] != r0["init"]).any()
    # each rank's local probs are its slice of the gathered ones
    m = r0["local"].shape[0]
    np.testing.assert_array_equal(np.concatenate([r0["local"], r1["local"]]),
                                  r0["global"])
    assert r0["global"].shape == (2 * m,)


if __name__ == "__main__":
    # each parity cell's port / reference ratios (PERF.md quotes them):
    # PYTHONPATH=src python tests/test_torch_dryrun.py
    ref = _reference(REF_CELLS % (REF_RUNS, list(CELLS)), 8)
    for shape, dtype in REF_RUNS:
        for name, mode, ex in CELLS:
            p = _port_cell(shape, dtype, name, mode, ex,
                           "meta")["op_analysis"]
            r = ref[f"{shape}:{dtype}:{name}:{mode}:{ex}"]
            print(shape, dtype, name, mode, ex, "flops",
                  round(p["flops_per_chip"] / r["flops_per_chip"], 4),
                  "traffic", round(p["traffic_bytes_per_chip"]
                                   / r["traffic_bytes_per_chip"], 3),
                  "collective bytes", p["collective_bytes_per_chip"],
                  r["collective_bytes_per_chip"], "count",
                  p["collective_count"], r["collective_count"])
