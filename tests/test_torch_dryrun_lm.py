"""The LM half of the dry-run (``launch.steps.build_lm_cell``,
``launch.dryrun``'s LM branch, ``models.sharding_rules``,
``parallel.spmd``) held against the reference's compiled cells.

The reference compiles ``build_lm_cell`` for 8 host devices on meshes
(2, 4) and (2, 2, 2) with ``Auto`` axes (a subprocess; its dry-run code
sets ``XLA_FLAGS`` on import) and analyses its HLO
(``hlo_analysis.analyze``, the replica groups rewritten into their iota
form as ``tests/test_torch_dryrun.py`` does). The port runs the same
cell on placeholder meshes of the same shapes, on the meta device and
on the CPU, under an op stream. The configs are the six attention archs
at ``reduced()``; the shapes are the production ones cut to 32 tokens
and a batch of 8 (``long``: 64 tokens, a batch of 1, h2o-danube's
16-slot ring).

Held:

- the counts on meta equal the CPU's, key for key, and so do the peaks;
- flops: each cell's port / reference ratio within 3% of its reading
  (``READINGS``). They lie in 1.000-1.016 but for ``long``, where
  XLA turns the batch of 1's matrix-vector dots into multiplies and
  reduces, which count no flops (PERF.md §6);
- collective bytes: each cell's wire bytes by kind equal their reading
  (``READINGS``), and the port / reference ratio of the totals within 3% of
  its reading. The kinds differ by design (PERF.md §6): the port
  reduce-scatters the residual stream and the FSDP grads where XLA
  all-reduces, and issues no collective-permute or all-to-all but the
  prefill's cache reshard;
- the FSDP gathers ("all-gather" over "data") equal, exactly, a count
  from the filtered specs alone: every leaf split over "data" gathered
  once a use in bf16, (n - 1) times its shard's bytes, the units' leaves
  twice in training (the remat's recompute gathers again), a tied
  embedding twice (the lookup and the head), the front end and the
  encoder not at all in decode;
- the specs themselves: ``param_specs``, ``filter_specs``,
  ``cache_specs`` and ``batch_specs`` equal the reference's on every
  arch's full and reduced params at the production meshes.
"""
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS as PORT_ARCHS  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import PlaceholderMesh  # noqa: E402
from repro_torch.models import sharding_rules as rules  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from test_torch_dryrun import _reference  # noqa: E402

ARCHS = ("command-r-plus-104b", "deepseek-7b", "h2o-danube-3-4b",
         "internlm2-1.8b", "internvl2-26b", "whisper-base")
LATER = ("jamba-1.5-large-398b", "llama4-maverick-400b-a17b",
         "mixtral-8x7b", "rwkv6-3b")
MESHES = ((2, 4), (2, 2, 2))
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
SHAPES = (ShapeConfig("train", 32, 8, "train"),
          ShapeConfig("prefill", 32, 8, "prefill"),
          ShapeConfig("decode", 32, 8, "decode"),
          ShapeConfig("long", 64, 1, "decode"))
RTOL = 0.03


def _cells():
    out = []
    for mesh in MESHES:
        for arch in ARCHS:
            cfg = get_arch(arch)
            for shape in SHAPES:
                if shape.name == "long" and not cfg.sub_quadratic:
                    continue
                out.append((mesh, arch, shape.name))
    return out


CELLS = _cells()

# readings on jax 0.9.0's XLA:CPU (``python tests/test_torch_dryrun_lm.py``
# prints them): each cell's (flops ratio, total collective bytes ratio)
# and the port's wire bytes by kind
READINGS = {
    ((2, 4), 'command-r-plus-104b', 'train'): (
        1.0058, 0.2792,
        {'all-gather': 323584.0,
         'all-reduce': 15308.0,
         'reduce-scatter': 256000.0}),
    ((2, 4), 'command-r-plus-104b', 'prefill'): (
        1.0, 0.4487,
        {'all-gather': 170080.0,
         'all-reduce': 3840.0,
         'reduce-scatter': 61440.0}),
    ((2, 4), 'command-r-plus-104b', 'decode'): (
        1.0, 0.8111,
        {'all-gather': 87520.0,
         'all-reduce': 3576.0,
         'reduce-scatter': 1920.0}),
    ((2, 4), 'deepseek-7b', 'train'): (
        1.0056, 0.2564,
        {'all-gather': 278528.0,
         'all-reduce': 15308.0,
         'reduce-scatter': 233472.0}),
    ((2, 4), 'deepseek-7b', 'prefill'): (
        1.0, 0.4578,
        {'all-gather': 147552.0,
         'all-reduce': 3840.0,
         'all-to-all': 12288.0,
         'reduce-scatter': 61440.0}),
    ((2, 4), 'deepseek-7b', 'decode'): (
        1.0, 0.7965,
        {'all-gather': 90336.0,
         'all-reduce': 3576.0,
         'reduce-scatter': 1920.0}),
    ((2, 4), 'h2o-danube-3-4b', 'train'): (
        1.0058, 0.2792,
        {'all-gather': 323584.0,
         'all-reduce': 15308.0,
         'reduce-scatter': 256000.0}),
    ((2, 4), 'h2o-danube-3-4b', 'prefill'): (
        1.0, 0.4651,
        {'all-gather': 170080.0,
         'all-reduce': 3840.0,
         'reduce-scatter': 61440.0}),
    ((2, 4), 'h2o-danube-3-4b', 'decode'): (
        1.0, 0.8111,
        {'all-gather': 87520.0,
         'all-reduce': 3576.0,
         'reduce-scatter': 1920.0}),
    ((2, 4), 'h2o-danube-3-4b', 'long'): (
        51.0, 12.809,
        {'all-gather': 84856.0, 'all-reduce': 894.0, 'reduce-scatter': 480.0}),
    ((2, 4), 'internlm2-1.8b', 'train'): (
        1.0058, 0.2792,
        {'all-gather': 323584.0,
         'all-reduce': 15308.0,
         'reduce-scatter': 256000.0}),
    ((2, 4), 'internlm2-1.8b', 'prefill'): (
        1.0, 0.4487,
        {'all-gather': 170080.0,
         'all-reduce': 3840.0,
         'reduce-scatter': 61440.0}),
    ((2, 4), 'internlm2-1.8b', 'decode'): (
        1.0, 0.8111,
        {'all-gather': 87520.0,
         'all-reduce': 3576.0,
         'reduce-scatter': 1920.0}),
    ((2, 4), 'internvl2-26b', 'train'): (
        1.0067, 0.2831,
        {'all-gather': 321536.0,
         'all-reduce': 14732.0,
         'reduce-scatter': 253952.0}),
    ((2, 4), 'internvl2-26b', 'prefill'): (
        1.0, 0.4555,
        {'all-gather': 171104.0,
         'all-reduce': 3840.0,
         'reduce-scatter': 58368.0}),
    ((2, 4), 'internvl2-26b', 'decode'): (
        1.0, 0.8111,
        {'all-gather': 87520.0,
         'all-reduce': 3576.0,
         'reduce-scatter': 1920.0}),
    ((2, 4), 'whisper-base', 'train'): (
        1.0157, 0.2504,
        {'all-gather': 445440.0,
         'all-reduce': 26892.0,
         'reduce-scatter': 392192.0}),
    ((2, 4), 'whisper-base', 'prefill'): (
        1.0, 0.4209,
        {'all-gather': 232544.0,
         'all-reduce': 7296.0,
         'all-to-all': 12288.0,
         'reduce-scatter': 110592.0}),
    ((2, 4), 'whisper-base', 'decode'): (
        1.0, 0.819,
        {'all-gather': 100064.0,
         'all-reduce': 7080.0,
         'reduce-scatter': 2688.0}),
    ((2, 2, 2), 'command-r-plus-104b', 'train'): (
        1.0058, 0.3588,
        {'all-gather': 262144.0,
         'all-reduce': 211410.0,
         'reduce-scatter': 217088.0}),
    ((2, 2, 2), 'command-r-plus-104b', 'prefill'): (
        1.0, 0.5765,
        {'all-gather': 188432.0,
         'all-reduce': 1280.0,
         'all-to-all': 4096.0,
         'reduce-scatter': 20480.0}),
    ((2, 2, 2), 'command-r-plus-104b', 'decode'): (
        1.0, 0.9052,
        {'all-gather': 169104.0,
         'all-reduce': 1192.0,
         'reduce-scatter': 640.0}),
    ((2, 2, 2), 'deepseek-7b', 'train'): (
        1.0056, 0.4339,
        {'all-gather': 270336.0,
         'all-reduce': 350674.0,
         'reduce-scatter': 221184.0}),
    ((2, 2, 2), 'deepseek-7b', 'prefill'): (
        1.0, 0.5985,
        {'all-gather': 192528.0,
         'all-reduce': 1280.0,
         'all-to-all': 8192.0,
         'reduce-scatter': 20480.0}),
    ((2, 2, 2), 'deepseek-7b', 'decode'): (
        1.0, 0.8874,
        {'all-gather': 173456.0,
         'all-reduce': 1192.0,
         'reduce-scatter': 640.0}),
    ((2, 2, 2), 'h2o-danube-3-4b', 'train'): (
        1.0058, 0.4269,
        {'all-gather': 262144.0,
         'all-reduce': 342482.0,
         'reduce-scatter': 217088.0}),
    ((2, 2, 2), 'h2o-danube-3-4b', 'prefill'): (
        1.0, 0.5773,
        {'all-gather': 188432.0,
         'all-reduce': 1280.0,
         'all-to-all': 2048.0,
         'reduce-scatter': 20480.0}),
    ((2, 2, 2), 'h2o-danube-3-4b', 'decode'): (
        1.0, 0.9052,
        {'all-gather': 169104.0,
         'all-reduce': 1192.0,
         'reduce-scatter': 640.0}),
    ((2, 2, 2), 'h2o-danube-3-4b', 'long'): (
        68.0, 18.4571,
        {'all-gather': 168520.0,
         'all-reduce': 596.0,
         'reduce-scatter': 320.0}),
    ((2, 2, 2), 'internlm2-1.8b', 'train'): (
        1.0058, 0.4269,
        {'all-gather': 262144.0,
         'all-reduce': 342482.0,
         'reduce-scatter': 217088.0}),
    ((2, 2, 2), 'internlm2-1.8b', 'prefill'): (
        1.0, 0.5765,
        {'all-gather': 188432.0,
         'all-reduce': 1280.0,
         'all-to-all': 4096.0,
         'reduce-scatter': 20480.0}),
    ((2, 2, 2), 'internlm2-1.8b', 'decode'): (
        1.0, 0.9052,
        {'all-gather': 169104.0,
         'all-reduce': 1192.0,
         'reduce-scatter': 640.0}),
    ((2, 2, 2), 'internvl2-26b', 'train'): (
        1.0067, 0.4347,
        {'all-gather': 263168.0,
         'all-reduce': 346386.0,
         'reduce-scatter': 218112.0}),
    ((2, 2, 2), 'internvl2-26b', 'prefill'): (
        1.0, 0.6096,
        {'all-gather': 190480.0,
         'all-reduce': 1280.0,
         'all-to-all': 4096.0,
         'reduce-scatter': 19456.0}),
    ((2, 2, 2), 'internvl2-26b', 'decode'): (
        1.0, 0.9052,
        {'all-gather': 169104.0,
         'all-reduce': 1192.0,
         'reduce-scatter': 640.0}),
    ((2, 2, 2), 'whisper-base', 'train'): (
        1.0157, 0.3981,
        {'all-gather': 389120.0,
         'all-reduce': 475410.0,
         'reduce-scatter': 323584.0}),
    ((2, 2, 2), 'whisper-base', 'prefill'): (
        1.0, 0.5138,
        {'all-gather': 270352.0,
         'all-reduce': 2432.0,
         'all-to-all': 8192.0,
         'reduce-scatter': 36864.0}),
    ((2, 2, 2), 'whisper-base', 'decode'): (
        1.0, 0.9243,
        {'all-gather': 190352.0,
         'all-reduce': 2360.0,
         'reduce-scatter': 896.0}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF_CELLS = """
    import json, re
    import jax
    from jax.sharding import AxisType
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import ARCHS
    from repro.launch import hlo_analysis, steps
    GROUPS = re.compile(r"replica_groups=\\{((?:\\{[\\d,]*\\},?)+)\\}")

    def iota(m):
        groups = re.findall(r"\\{([\\d,]*)\\}", m.group(1))
        sizes = {len(g.split(",")) for g in groups}
        assert len(sizes) == 1, m.group(0)
        n = sizes.pop()
        return f"replica_groups=[{len(groups)},{n}]<=[{len(groups) * n}]"

    shapes = {s[0]: ShapeConfig(*s) for s in %s}
    out = {}
    meshes = {}
    for mesh_shape, arch, kind in %s:
        if mesh_shape not in meshes:
            axes = ("data", "model") if len(mesh_shape) == 2 else (
                "pod", "data", "model")
            meshes[mesh_shape] = jax.make_mesh(
                mesh_shape, axes, axis_types=(AxisType.Auto,) * len(axes))
        mesh = meshes[mesh_shape]
        with mesh:
            cell = steps.build_lm_cell(ARCHS[arch].reduced(), shapes[kind],
                                       mesh)
            hlo = cell.lower().compile().as_text()
        out[f"{mesh_shape}:{arch}:{kind}"] = hlo_analysis.analyze(
            GROUPS.sub(iota, hlo))
    print(json.dumps(out))
"""

REF_SPECS = """
    import json
    import jax
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs.registry import ARCHS
    from repro.launch import steps
    from repro.models import sharding_rules as rules

    def flat(tree):
        out = {}
        def walk(path, leaf):
            out[rules._path_str(path)] = [
                list(e) if isinstance(e, tuple) else e for e in leaf]
        jax.tree_util.tree_map_with_path(
            walk, tree, is_leaf=lambda x: isinstance(x, P))
        return out

    devs = np.array(jax.devices())
    out = {}
    for shape in ((16, 16), (2, 16, 16)):
        axes = ("data", "model") if len(shape) == 2 else (
            "pod", "data", "model")
        mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
        for name, cfg in ARCHS.items():
            for red in (False, True):
                c = cfg.reduced() if red else cfg
                params = steps.abstract_params(c)
                raw = rules.param_specs(c, params)
                key = f"{shape}:{name}:{red}"
                out[key + ":raw"] = flat(raw)
                out[key + ":filtered"] = flat(
                    rules.filter_specs(raw, params, mesh))
                caches = steps.abstract_caches(c, 128, 4096)
                out[key + ":caches"] = flat(rules.cache_specs(c, caches,
                                                              mesh))
                out[key + ":batch"] = flat(rules.batch_specs(
                    {"tokens": jax.ShapeDtypeStruct((256, 8), np.int32),
                     "odd": jax.ShapeDtypeStruct((3, 8), np.int32)}, mesh))
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_cells():
    shapes = [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES]
    return _reference(REF_CELLS % (shapes, CELLS), 8)


@pytest.fixture(scope="module")
def ref_specs():
    return _reference(REF_SPECS, 512)


def _shape(kind):
    return next(s for s in SHAPES if s.name == kind)


def _port(mesh_shape, arch, kind, device):
    mesh = PlaceholderMesh(mesh_shape, AXES[len(mesh_shape)])
    cell = steps.build_lm_cell(get_arch(arch).reduced(), _shape(kind), mesh)
    return dryrun.measure(cell, mesh, torch.device(device), 0.0)


def _flat_specs(tree):
    out = {}
    rules.tree_map_with_path(lambda path, s: out.__setitem__(
        path, [list(e) if isinstance(e, tuple) else e for e in s]), tree)
    return out


def fsdp_gather_bytes(arch, kind, mesh_shape) -> float:
    """The FSDP gathers' wire bytes from the filtered specs alone: every
    leaf split over "data", (n - 1) times its shard's bytes in the
    compute dtype (bf16, cast before the gather) a gather;
    gathered once a use, the units' leaves (and whisper's cross-attention)
    twice in training (the recompute), a tied embedding twice (the lookup
    and the head); decode gathers neither the front end nor the
    encoder."""
    cfg = get_arch(arch).reduced()
    mesh = PlaceholderMesh(mesh_shape, AXES[len(mesh_shape)])
    params = steps.abstract_params(cfg)
    specs = rules.named_shardings(cfg, params, mesh)
    n = mesh.shape["data"]
    total = 0.0

    def add(path, leaf):
        nonlocal total
        spec = rules.spec_of(specs, path)
        if "data" not in spec:
            return
        shard = 2 * int(np.prod(spmd.local_shape(tuple(leaf.shape), spec,
                                                 mesh)))
        uses = 1
        top = path.split("/")[0]
        if kind == "train" and top in ("units", "cross_attn"):
            uses = 2
        if top == "embed" and cfg.tie_embeddings:
            uses = 2
        if top in ("frontend_proj", "encoder") and \
                _shape(kind).kind == "decode":
            uses = 0          # decode runs neither front end nor encoder
        total += uses * (n - 1) * shard

    rules.tree_map_with_path(add, params)
    return total


# ---------------------------------------------------------------------------
# the specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("mesh_shape", [(16, 16), (2, 16, 16)], ids=str)
def test_specs_are_the_references(ref_specs, mesh_shape, reduced):
    mesh = PlaceholderMesh(mesh_shape, AXES[len(mesh_shape)])
    for name, cfg in PORT_ARCHS.items():
        c = cfg.reduced() if reduced else cfg
        params = steps.abstract_params(c)
        raw = rules.param_specs(c, params)
        key = f"{mesh_shape}:{name}:{reduced}"
        assert _flat_specs(raw) == ref_specs[key + ":raw"], name
        assert _flat_specs(rules.filter_specs(raw, params, mesh)) == \
            ref_specs[key + ":filtered"], name
        assert _flat_specs(rules.cache_specs(
            c, steps.abstract_caches(c, 128, 4096), mesh)) == \
            ref_specs[key + ":caches"], name
        batch = {"tokens": torch.empty((256, 8), device="meta"),
                 "odd": torch.empty((3, 8), device="meta")}
        assert _flat_specs(rules.batch_specs(batch, mesh)) == \
            ref_specs[key + ":batch"], name


def test_train_state_shardings_mirror_the_params():
    """``train_state_shardings``: AdamW's mu and nu take the params' specs,
    the counts are whole; ``abstract_train_state`` is meta tensors of the
    params' shapes; ``input_specs`` the reference's stand-ins."""
    mesh = PlaceholderMesh((16, 16), AXES[2])
    for arch in ARCHS:
        cfg = get_arch(arch)
        sh = steps.train_state_shardings(cfg, mesh)
        p_specs = _flat_specs(steps.param_shardings(cfg, mesh))
        assert _flat_specs(sh["params"]) == p_specs
        assert _flat_specs(sh["opt"]["mu"]) == _flat_specs(sh["opt"]["nu"]) \
            == p_specs
        assert sh["opt"]["count"] == sh["step"] == rules.P()
        state = steps.abstract_train_state(cfg)
        shapes = {}
        rules.tree_map_with_path(lambda path, x: shapes.__setitem__(
            path, (tuple(x.shape), x.device.type)), state["opt"]["mu"])
        rules.tree_map_with_path(lambda path, x: (
            shapes[path] == (tuple(x.shape), "meta")) or pytest.fail(path),
            state["params"])
        batch = steps.input_specs(cfg, dryrun.LM_SHAPES[0])
        fe = cfg.n_frontend_tokens if (cfg.frontend and not
                                       cfg.is_encoder_decoder) else 0
        assert tuple(batch["tokens"].shape) == (256, 4096 - fe)
        assert set(batch) == {"tokens", "labels"} | (
            {"frontend_embeds"} if fe else set()) | (
            {"encoder_embeds"} if cfg.is_encoder_decoder else set())


def test_shard_and_gather_round_trip_on_a_placeholder_mesh():
    """Rank 0's block of a leaf under its spec is the block at
    coordinate 0 along each split dim; local shapes follow the spec."""
    mesh = PlaceholderMesh((2, 2, 4), AXES[3])
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    spec = rules.P(("pod", "data"), "model")
    assert spmd.local_shape((8, 12), spec, mesh) == (2, 3)
    assert torch.equal(spmd.shard(x, spec, mesh), x[:2, :3])
    assert spmd.shard(x.numpy(), rules.P(None, "model"), mesh).shape == \
        (8, 3)
    assert torch.equal(spmd.gather(x, rules.P(), mesh), x)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------
def _ids(c):
    return f"{c[1]}-{c[2]}-{'x'.join(map(str, c[0]))}"


@pytest.mark.parametrize("cell", CELLS, ids=_ids)
def test_lm_cell_counts_match_the_reference(ref_cells, cell):
    mesh_shape, arch, kind = cell
    meta = _port(mesh_shape, arch, kind, "meta")
    cpu = _port(mesh_shape, arch, kind, "cpu")
    assert meta["op_analysis"] == cpu["op_analysis"]
    assert meta["memory"]["peak_per_device_bytes"] == \
        cpu["memory"]["peak_per_device_bytes"]
    a = meta["op_analysis"]
    ref = ref_cells[f"{mesh_shape}:{arch}:{kind}"]
    flops_r, coll_r, coll = READINGS[cell]
    assert a["flops_per_chip"] / ref["flops_per_chip"] == pytest.approx(
        flops_r, rel=RTOL)
    assert a["collective_bytes_per_chip"] / ref[
        "collective_bytes_per_chip"] == pytest.approx(coll_r, rel=RTOL)
    assert a["collective_by_kind"] == coll
    # the FSDP gathers, from the specs alone
    assert a["collective_by_group"].get("all-gather@data", 0.0) == \
        fsdp_gather_bytes(arch, kind, mesh_shape)
    launches = a["kernel_launches"]
    cfg = get_arch(arch).reduced()
    if _shape(kind).kind == "decode":
        n_attn = cfg.n_layers * (2 if cfg.is_encoder_decoder else 1)
        assert launches == {"flash_decode": n_attn}
    else:
        n_attn = cfg.n_layers * (2 if cfg.is_encoder_decoder else 1) \
            + cfg.n_encoder_layers
        # training runs each unit's row 8 again in the recompute
        units = cfg.n_layers * (2 if cfg.is_encoder_decoder else 1)
        want = n_attn + (units if kind == "train" else 0)
        assert launches == {"flash_attention": want}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_renderers_print_the_references_lm_rows(mesh, capsys):
    """``benchmarks_torch.{roofline,render_experiments}`` print the
    reference's rows for LM records (two reduced cells traced on meta),
    and a ``NOT PORTED`` row for an A8c-ii-b cell (a status the
    reference's renderers do not know)."""
    from benchmarks import render_experiments as ref_render
    from benchmarks import roofline as ref_roofline
    from benchmarks_torch import render_experiments, roofline
    recs = []
    for (mesh_shape, arch, kind), name in zip(
            [((2, 4), "internlm2-1.8b", "train"),
             ((2, 2, 2), "whisper-base", "decode")], ["single", "multi"]):
        recs.append(dict(_port(mesh_shape, arch, kind, "meta"),
                         cell=f"lm:{arch}:{kind}:{name}", status="ok"))
    assert roofline.render(recs, mesh) == ref_roofline.render(recs, mesh)
    base = {r["cell"]: r for r in recs}
    ref_render.table(base, {}, mesh)
    want = capsys.readouterr().out
    render_experiments.table(base, {}, mesh)
    assert capsys.readouterr().out == want
    assert "lm:" in want
    later = {"cell": f"lm:mixtral-8x7b:train_4k:{mesh}",
             "status": "not_ported", "error": "A8c-ii-b"}
    assert (later["cell"], "NOT PORTED", "", "", "", "", "", "") in \
        roofline.render(recs + [later], mesh)


def test_long_cell_flops_are_the_dots_xla_keeps(ref_cells):
    """At a batch of 1 XLA lowers the decode's matrix-vector dots to
    multiplies and reduces, which count no flops: the reference's long
    cell counts only what its row-9 einsums keep, far below the port's
    dots (the readings 51x and 68x)."""
    for mesh_shape in MESHES:
        ref = ref_cells[f"{mesh_shape}:h2o-danube-3-4b:long"]
        dec = ref_cells[f"{mesh_shape}:h2o-danube-3-4b:decode"]
        assert ref["flops_per_chip"] < dec["flops_per_chip"] / 100


# ---------------------------------------------------------------------------
# the dry-run's LM cells at production size, on meta
# ---------------------------------------------------------------------------
def test_lm_cell_of_a_later_arch_raises_naming_a8c_ii_b():
    for arch in LATER:
        with pytest.raises(NotImplementedError, match="A8c-ii-b"):
            steps.build_lm_cell(get_arch(arch), _shape("train"),
                                PlaceholderMesh((2, 4), AXES[2]))


@pytest.mark.parametrize("arch", ARCHS)
def test_main_on_meta_runs_every_cell_of_an_arch(tmp_path, arch):
    """``python -m repro_torch.launch.dryrun --device meta --arch <a>``
    writes ``ok`` for each of the arch's cells at production size (rank 0
    of 256 or 512 ranks); the memory fits the op stream's peak."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dryrun.main(["--device", "meta", "--arch", arch, "--out",
                          str(tmp_path)])
    assert rc == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    want = sorted(c for c in dryrun.all_cell_ids()
                  if c.split(":")[1] == arch)
    assert sorted(r["cell"] for r in recs) == want
    n = len(want)
    assert f"{n}/{n} cells passed, 0 not ported" in out.getvalue()
    for r in recs:
        assert r["status"] == "ok" and r["device"] == "meta"
        assert r["n_chips"] in (256, 512)
        assert r["memory"]["peak_per_device_bytes"] > \
            r["memory"]["argument_bytes"] > 0
        assert r["roofline"]["model_flops"] > 0
        kind = r["cell"].split(":")[2]
        assert r["global_batch"] == next(
            s.global_batch for s in dryrun.LM_SHAPES if s.name == kind)


if __name__ == "__main__":
    # each cell's readings (paste into READINGS):
    # PYTHONPATH=src python tests/test_torch_dryrun_lm.py
    shapes = [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES]
    ref = _reference(REF_CELLS % (shapes, CELLS), 8)
    for cell in CELLS:
        a = _port(*cell, "meta")["op_analysis"]
        r = ref[f"{cell[0]}:{cell[1]}:{cell[2]}"]
        coll = a["collective_bytes_per_chip"] / r["collective_bytes_per_chip"]
        print(f"    {cell!r}: ({a['flops_per_chip'] / r['flops_per_chip']:.4f}"
              f", {coll:.4f}"
              f", {dict(sorted(a['collective_by_kind'].items()))!r}),")
        print("    #   ref", {k: v for k, v in sorted(
            r["collective_by_kind"].items())})
