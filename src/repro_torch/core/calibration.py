"""Measured-hardware calibration artifacts (ROADMAP debt item).

Several quantities in the repo are modeled and want measurement when real
hardware is available: the monitor's HBM+DDR4 `service_multiplier` curve,
the host<->device PCIe link, the inter-board fabric link, and the
per-kernel serve-path times. Each ships as a small JSON artifact this
module loads; models accept the artifact (path or dict) and override
their defaults with whatever it carries:

    {
      "host_link": {"latency_us": 12.3, "bandwidth_gbs": 13.8},
      "service_multiplier": {"hit_ratio": [0.0, 0.5, 1.0],
                             "multiplier": [3.1, 1.9, 1.0]},
      "kernel_times": {
        "fused_bag_interactions": {"us": 412.0, "shape": "B200 T40 L80 d32"},
        "embedding_bag": 389.5
      }
    }

`service_multiplier` may also be a plain number (a constant multiplier).
The piecewise-linear curve form is interpolated with `np.interp` — flat
beyond its endpoints, so a sparse measurement sweep is safe to ship.

`kernel_times` maps kernel names to measured per-call microseconds —
either a bare number or `{"us": <number>, "shape": "<label>"}` (the shape
label documents what was measured; it is carried along, not interpreted).
`perf_model.inference_breakdown(calibration=...)` consumes it so the
step model runs on MEASURED kernel times instead of purely modeled ones.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Union

import numpy as np

Calibration = Union[str, os.PathLike, Dict[str, Any]]


def load_calibration(source: Calibration) -> Dict[str, Any]:
    """A calibration dict from a JSON file path (or an already-loaded
    dict, passed through so callers can forward either form)."""
    if isinstance(source, dict):
        return source
    with open(os.fspath(source)) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(
            f"calibration file {source} must hold a JSON object, "
            f"got {type(data).__name__}")
    return data


def service_multiplier_from(source: Calibration
                            ) -> Callable[[float], float]:
    """The monitor's hit-ratio -> service-time multiplier, from a
    calibration artifact: either a constant or a measured
    {"hit_ratio": [...], "multiplier": [...]} curve."""
    data = load_calibration(source)
    sm = data.get("service_multiplier")
    if sm is None:
        raise ValueError(
            "calibration artifact has no 'service_multiplier' entry")
    if isinstance(sm, (int, float)):
        return lambda h, _m=float(sm): _m
    xs = np.asarray(sm["hit_ratio"], float)
    ys = np.asarray(sm["multiplier"], float)
    if xs.ndim != 1 or xs.shape != ys.shape or xs.size < 2:
        raise ValueError(
            f"service_multiplier curve needs matching 1-D hit_ratio/"
            f"multiplier arrays of >= 2 points, got {xs.shape}/{ys.shape}")
    if (np.diff(xs) <= 0).any():
        raise ValueError("service_multiplier hit_ratio must be increasing")
    return lambda h: float(np.interp(h, xs, ys))


def kernel_times_from(source: Calibration) -> Dict[str, float]:
    """Measured per-kernel times from a calibration artifact:
    {kernel name -> microseconds per call}.

    Entries may be bare numbers or {"us": <number>, "shape": "<label>"}
    dicts (the optional shape label must be a string; it documents the
    measured shape and is validated but not returned). Raises ValueError
    on a missing/empty section or any malformed entry, naming the entry —
    a half-broken measured artifact must not silently drive the model.
    """
    data = load_calibration(source)
    kt = data.get("kernel_times")
    if kt is None:
        raise ValueError("calibration artifact has no 'kernel_times' entry")
    if not isinstance(kt, dict) or not kt:
        raise ValueError(
            f"kernel_times must be a non-empty object of "
            f"name -> us entries, got {kt!r}")
    out: Dict[str, float] = {}
    for name, entry in kt.items():
        us = entry
        if isinstance(entry, dict):
            us = entry.get("us")
            shape = entry.get("shape")
            if shape is not None and not isinstance(shape, str):
                raise ValueError(
                    f"kernel_times[{name!r}] shape label must be a string, "
                    f"got {shape!r}")
        if isinstance(us, bool) or not isinstance(us, (int, float)):
            raise ValueError(
                f"kernel_times[{name!r}] needs a numeric 'us' value, "
                f"got {us!r}")
        us = float(us)
        if not np.isfinite(us) or us <= 0.0:
            raise ValueError(
                f"kernel_times[{name!r}] must be a positive finite "
                f"microsecond count, got {us}")
        out[str(name)] = us
    return out
