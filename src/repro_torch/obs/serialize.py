"""Shared machine-readable report path.

Every report in the stack (`FleetReport`/`ClusterReport`/`FabricReport`,
`SLAReport`, `PlanReport`, `BlameReport`, `TrainReport`) is a frozen
dataclass built from plain python + numpy scalars; `to_jsonable` folds
any of them — or nested dicts/lists of them — into `json.dump`-ready
structures so the launchers' `--report-json` flag and the reports' own
`asdict()`/`to_json()` methods share one serializer instead of each
report hand-rolling its numpy/key coercions.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np


def to_jsonable(obj: Any) -> Any:
    """Recursively coerce `obj` into JSON-serializable structures:
    dataclasses -> dicts (tagged with their class name as `kind`),
    numpy scalars/arrays -> python scalars/lists, mapping keys -> str,
    tuples/sets -> lists. Unknown objects fall back to `str(obj)`."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.bool_, np.integer, np.floating)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"kind": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_jsonable(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_jsonable(v) for v in obj]
    return str(obj)


def report_asdict(report: Any) -> Any:
    """`to_jsonable` under the name reports expose as `.asdict()`."""
    return to_jsonable(report)


def report_to_json(report: Any, path: Optional[str] = None,
                   indent: int = 2) -> str:
    """Serialize a report; if `path` is given also write it there
    (returns the JSON text either way)."""
    text = json.dumps(to_jsonable(report), indent=indent, sort_keys=False)
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
            f.write("\n")
    return text
