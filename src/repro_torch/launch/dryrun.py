"""The dry-run of the production cells (the reference's
``src/repro/launch/dryrun.py``): every (arch x shape x mesh) and (RM2
config x mode x mesh) cell, run as rank 0 of a placeholder production
mesh, with its memory, an op-stream analysis (flops, HBM traffic,
collective wire bytes) and the three roofline terms.

Usage:
  python -m repro_torch.launch.dryrun --list            # the cell ids
  python -m repro_torch.launch.dryrun --cell <id>       # one cell
  python -m repro_torch.launch.dryrun                   # every cell
  python -m repro_torch.launch.dryrun --mesh single     # one mesh only
  ... --device meta                                     # no allocation
  ... --device cpu                                      # tiny configs

Cell ids:  lm:<arch>:<shape>:<single|multi>
           dlrm:<config>:<train|serve>:<single|multi>

The reference lowers and compiles each cell for 512 placeholder host
devices and reads XLA's memory and cost analyses and its HLO. The port
runs rank 0's step (``launch.steps``) on a device: the card by default,
where ``torch.cuda.max_memory_allocated`` over the step, less what the
card held before its arguments were made, is the peak; ``meta``, where
nothing is allocated and the op stream's high-water mark of live bytes is
the peak; or ``cpu``. Collectives over the placeholder mesh send nothing
and report themselves to the op stream (``repro_torch.op_stream``). The
reference's ``--skip-hlo`` has no counterpart: the op stream is the only
analysis, and it always runs. The LM cells of the archs whose layers are
attention and dense MLP run through the spec-driven executor
(``launch.steps.build_lm_cell``); a MoE or SSM arch's cell is ROADMAP
A8c-ii-b and is written as ``not_ported``, which is not a failure.

Outputs: ``reports/torch/dryrun/<cell-id>.json`` (``:`` as ``__``),
never the reference's ``reports/dryrun``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import DLRMConfig, shape_applicable
from repro_torch.configs.registry import ARCHS, DLRM_CONFIGS, LM_SHAPES
from repro_torch.device import resolve_device
from repro_torch import op_stream
from repro_torch.launch import op_analysis, steps
from repro_torch.launch.mesh import Mesh, make_production_mesh

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
REPORT_DIR = os.path.join(REPO, "reports", "torch", "dryrun")

# DLRM dry-run rows a table, the reference's: the full-sharded model holds
# ~1.4 TB over 512 ranks.
DLRM_DRYRUN_ROWS = 2 ** 22


def all_cell_ids() -> List[str]:
    ids = []
    for arch in ARCHS.values():
        for shape in LM_SHAPES:
            ok, _ = shape_applicable(arch, shape)
            if not ok:
                continue
            for mesh in ("single", "multi"):
                ids.append(f"lm:{arch.name}:{shape.name}:{mesh}")
    for cfg in DLRM_CONFIGS.values():
        for mode in ("train", "serve"):
            for mesh in ("single", "multi"):
                ids.append(f"dlrm:{cfg.name}:{mode}:{mesh}")
    return ids


def model_flops_estimate(kind: str, cfg, shape=None) -> float:
    """MODEL_FLOPS: 6·N·D train / 2·N·D inference (N = active params);
    for DLRM 3x (train) or 1x (serve) its dense flops a sample times the
    global batch, which ``shape`` carries."""
    if isinstance(cfg, DLRMConfig):
        return (3.0 if kind == "train" else 1.0) * cfg.flops_per_sample() \
            * shape
    n_active = cfg.param_count(active_only=True)
    if kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # decode: 1 token


def _storages(tree) -> Dict[int, int]:
    """Each distinct storage of ``tree``'s tensors and its bytes."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in op_stream.tensors(tree)}


def measure(cell: steps.CellProgram, mesh: Mesh, device: torch.device,
            model_flops: float) -> Dict:
    """Run ``cell`` once on ``device`` under an op stream and return the
    reference's record fields (after ``cell`` and ``status``). On the card
    the traced run is timed (``traced_wall_s``); a cell whose
    ``timed_untraced`` is set runs its step a second time, untraced, for
    its wall time (``step_wall_s``), else the step's wall time is the
    traced run's (``step_wall_source`` says which)."""
    cuda = device.type == "cuda"
    if cuda:      # what the card held before: not the step's
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
    args = cell.make_args(device)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    stream = op_stream.OpStream()
    t0 = time.perf_counter()
    with stream:
        stream.track(args)
        out, _ = cell.run(device, args)
    record: Dict = {"model_flops": model_flops,
                    "global_batch": cell.global_batch,
                    "n_chips": mesh.size(),
                    "mesh_shape": dict(mesh.shape),
                    "device": str(device)}
    arg_st, out_st = _storages(args), _storages(out)
    stream_peak = stream.peak_bytes
    if cuda:
        torch.cuda.synchronize(device)
        traced = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) - base
        record["traced_wall_s"] = traced
        record["step_wall_source"] = "traced"
        record["step_wall_s"] = traced
        if cell.timed_untraced:
            t0 = time.perf_counter()
            out, _ = cell.run(device, args)
            torch.cuda.synchronize(device)
            record["step_wall_s"] = time.perf_counter() - t0
            record["step_wall_source"] = "untraced"
    else:
        peak = stream_peak
    arg_b = sum(arg_st.values())
    record["memory"] = {
        "argument_bytes": arg_b,
        "output_bytes": sum(out_st.values()),
        "alias_bytes": sum(b for k, b in out_st.items() if k in arg_st),
        "temp_bytes": max(0, peak - arg_b),
        "peak_per_device_bytes": peak,
        "peak_source": ("torch.cuda.max_memory_allocated less what the "
                        "card held before the step's arguments" if cuda
                        else "op stream live bytes"),
        "stream_peak_bytes": stream_peak,
    }
    a = stream.summary()
    record["cost"] = {"flops": a["flops_per_chip"],
                      "bytes_accessed": a["traffic_bytes_per_chip"]}
    record["op_analysis"] = a
    flops = a["flops_per_chip"]
    # each dtype's matmuls at their own dense peak
    peak_flops = (flops / op_analysis.t_compute(stream.flops_by_dtype)
                  if flops > 0 else op_analysis.PEAK_FLOPS_BF16)
    terms = op_analysis.roofline_terms(
        flops, a["traffic_bytes_per_chip"], a["collective_bytes_per_chip"],
        a["collective_count"], peak_flops=peak_flops)
    terms["model_flops"] = model_flops
    terms["useful_flops_ratio"] = (model_flops / mesh.size() / flops
                                   if flops > 0 else 0.0)
    record["roofline"] = terms
    return record


def run_cell(cell_id: str, device=None, dlrm_exchange: str = "unpooled"
             ) -> Dict:
    """One cell's record on ``device`` (None: the card). A MoE or SSM
    arch's LM cell raises ``NotImplementedError`` naming ROADMAP
    A8c-ii-b."""
    kind, *rest = cell_id.split(":")
    t0 = time.time()
    record: Dict = {"cell": cell_id, "status": "ok"}
    if kind == "lm" and len(rest) == 3:
        arch_name, shape_name, mesh_kind = rest
        cfg = ARCHS[arch_name]
        shape = next(s for s in LM_SHAPES if s.name == shape_name)
        cell = steps.build_lm_cell(cfg, shape, make_production_mesh(
            multi_pod=(mesh_kind == "multi")))
        dev = resolve_device(device)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        record.update(measure(cell, mesh, dev, model_flops_estimate(
            shape.kind, cfg, shape)))
        record["elapsed_s"] = time.time() - t0
        return record
    if kind != "dlrm" or len(rest) != 3:
        raise ValueError(f"unknown cell id {cell_id!r}")
    cfg_name, mode, mesh_kind = rest
    dev = resolve_device(device)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    cell = steps.build_dlrm_cell(DLRM_CONFIGS[cfg_name], mode, mesh,
                                 row_wise_exchange=dlrm_exchange,
                                 rows_per_table=DLRM_DRYRUN_ROWS)
    record.update(measure(cell, mesh, dev, model_flops_estimate(
        mode, DLRM_CONFIGS[cfg_name], cell.global_batch)))
    record["elapsed_s"] = time.time() - t0
    return record


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--list", action="store_true")
    p.add_argument("--cell", type=str, default=None)
    p.add_argument("--mesh", choices=["single", "multi", "both"],
                   default="both")
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--out", type=str, default=REPORT_DIR)
    p.add_argument("--dlrm-exchange", choices=["unpooled", "partial_pool"],
                   default="unpooled",
                   help="row-wise embedding exchange: 'unpooled' is the "
                        "paper-faithful baseline; 'partial_pool' is the "
                        "beyond-paper reduce-scatter of partial pools")
    p.add_argument("--device", default=None,
                   help="where rank 0's step runs: the card (default), "
                        "'meta' (a trace without allocation) or 'cpu'")
    args = p.parse_args(argv)

    cells = all_cell_ids()
    if args.cell:
        cells = [c for c in cells if c == args.cell] or [args.cell]
    if args.mesh != "both":
        cells = [c for c in cells if c.endswith(f":{args.mesh}")]
    if args.arch:
        cells = [c for c in cells if f":{args.arch}:" in c
                 or f":{args.arch}" in c.split(":")[1]]

    if args.list:
        for c in cells:
            print(c)
        return 0

    os.makedirs(args.out, exist_ok=True)
    failures = not_ported = 0
    for cell_id in cells:
        out_path = os.path.join(args.out,
                                cell_id.replace(":", "__") + ".json")
        try:
            rec = run_cell(cell_id, device=args.device,
                           dlrm_exchange=args.dlrm_exchange)
            r = rec["roofline"]
            print(f"[dryrun] OK   {cell_id}: "
                  f"mem/dev={rec['memory']['peak_per_device_bytes']/2**30:.2f}"
                  f"GiB compute={r['t_compute_s']*1e3:.2f}ms "
                  f"memory={r['t_memory_s']*1e3:.2f}ms "
                  f"collective={r['t_collective_s']*1e3:.2f}ms "
                  f"-> {r['bottleneck']} ({rec['device']})", flush=True)
        except NotImplementedError as e:
            not_ported += 1
            rec = {"cell": cell_id, "status": "not_ported", "error": str(e)}
            print(f"[dryrun] NOT PORTED {cell_id}: {e}", flush=True)
        except Exception as e:      # a cell's failure is recorded
            failures += 1
            rec = {"cell": cell_id, "status": "fail", "error": str(e),
                   "traceback": traceback.format_exc()}
            print(f"[dryrun] FAIL {cell_id}: {e}", flush=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
    ran = len(cells) - not_ported
    print(f"[dryrun] {ran - failures}/{ran} cells passed, {not_ported} "
          f"not ported")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
