"""The dry-run's analysis (the port's counterpart of the reference's
``src/repro/launch/hlo_analysis.py``, which parses XLA's compiled HLO;
the port has no HLO): the counts of one rank's step come from an op
stream (``repro_torch.op_stream.OpStream``, the reference's ``analyze``
keys in its ``summary``), and this module turns them into the reference's
three roofline terms with the chip's constants.
"""
from __future__ import annotations

from typing import Dict

import torch

# The chip's constants: one NVIDIA H100 (SXM, NVIDIA's data sheet, dense
# rates, at its full 700 W) and NVLink. CC_LATENCY is the paper's central
# parameter, the RecSpeed target of 1 µs a collective issue, not a figure
# of this chip.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
PEAK_FLOPS_BF16 = PEAK_FLOPS[torch.bfloat16]
HBM_BW = 3.35e12              # bytes/s
LINK_BW = 450e9               # NVLink, bytes/s a direction
CC_LATENCY = 1e-6             # s a collective: the paper's parameter


def t_compute(flops_by_dtype: Dict[torch.dtype, float],
              peaks: Dict[torch.dtype, float] = PEAK_FLOPS) -> float:
    """Each dtype's flops at its own dense peak."""
    return sum(f / peaks.get(d, peaks[torch.float32])
               for d, f in flops_by_dtype.items())


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   collective_bytes_per_chip: float,
                   collective_count: float = 0.0, *,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW, link_bw: float = LINK_BW,
                   cc_latency: float = CC_LATENCY) -> Dict[str, object]:
    """The reference's three roofline terms, with the chip's constants as
    keywords (default one H100 over NVLink, and the paper's 1 µs a
    collective): T_cc = latency + volume / BW a collective, summed."""
    t_compute = flops_per_chip / peak_flops
    t_memory = bytes_per_chip / hbm_bw
    t_coll_bw = collective_bytes_per_chip / link_bw
    t_coll_lat = collective_count * cc_latency
    t_collective = t_coll_bw + t_coll_lat
    dominant = max([("compute", t_compute), ("memory", t_memory),
                    ("collective", t_collective)], key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "t_collective_bw_s": t_coll_bw,
        "t_collective_latency_s": t_coll_lat,
        "collective_count": collective_count,
        "bottleneck": dominant,
        "t_bound_s": max(t_compute, t_memory, t_collective),
    }
