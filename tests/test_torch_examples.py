"""The port's examples (``examples_torch``) on the CPU, held against the
reference's (``examples``).

``quickstart``'s RecSpeed and DGX-2 planner lines equal the reference's
(the reference also prints a TPU system's line, which the port's perf
model leaves out); the reference's training and serving are stubbed there,
since only its planner lines are compared. The port's examples train and
serve end to end on the CPU at the reference's sizes (``dlrm_train_100m``
at fewer steps).
"""
import contextlib
import io
import os
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from examples import quickstart as ref_quickstart  # noqa: E402
from examples_torch import dlrm_train_100m, quickstart, serve_sla  # noqa: E402

torch.set_num_threads(1)


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().splitlines()


class _NoEngine:
    """The reference quickstart's engine, stubbed: its planner lines do not
    depend on the trained or served model."""

    def __init__(self, cfg, **kw):
        pass

    def train_session(self):
        return types.SimpleNamespace(
            params=None, run=lambda n: types.SimpleNamespace(
                start_step=0, steps_run=n, last_loss=0.0))

    def serve_session(self, **kw):
        return types.SimpleNamespace(
            submit=lambda q: types.SimpleNamespace(probs=np.zeros(4)))


def test_quickstart_planner_lines_equal_the_reference(monkeypatch):
    monkeypatch.setattr(ref_quickstart, "Engine", _NoEngine)
    monkeypatch.setattr(ref_quickstart, "make_recsys_batch",
                        lambda cfg, step: None)
    want = [ln for ln in _printed(ref_quickstart.main)
            if ln.startswith("== planner[")]
    got_all = _printed(quickstart.main, ["--device", "cpu"])
    got = [ln for ln in got_all if ln.startswith("== planner[")]
    tpu = [ln for ln in want if ln.startswith("== planner[tpu")]
    assert len(tpu) == 1
    assert got == [ln for ln in want if ln not in tpu]
    assert [ln.split("]")[0] for ln in got] == ["== planner[recspeed",
                                                 "== planner[dgx-2"]
    # the port's train and serve steps ran
    steps = [ln for ln in got_all if ln.lstrip().startswith("steps ")]
    assert len(steps) == 3
    losses = [float(ln.split("bce=")[1]) for ln in steps]
    assert all(np.isfinite(losses))
    served = [ln for ln in got_all if ln.startswith("== served query of")]
    assert len(served) == 1 and "micro-batch of 2" in served[0]


def test_serve_sla_runs_both_experiments():
    lines = _printed(serve_sla.main, ["--device", "cpu"])
    rows = [ln.split(",") for ln in lines if ln[:1].isdigit()]
    assert [r[0] for r in rows] == ["8", "32", "128"]
    assert all(r[-1] in ("PASS", "FAIL") for r in rows)
    servers = [ln.split(",")[0] for ln in lines
               if ln.startswith(("per-query,", "batched(8),"))]
    assert servers == ["per-query", "batched(8)"]


def test_dlrm_train_100m_trains_and_checkpoints(tmp_path):
    lines = _printed(dlrm_train_100m.main,
                     ["--device", "cpu", "--steps", "60", "--ckpt-dir",
                      str(tmp_path)])
    assert any("100.9M params" in ln for ln in lines)
    assert any("(decreased: True)" in ln for ln in lines)
    assert any(p.startswith("step") or p.isdigit() or "ckpt" in p
               for p in os.listdir(tmp_path)), os.listdir(tmp_path)
    # a rerun resumes from the checkpoint taken at step 50
    lines = _printed(dlrm_train_100m.main,
                     ["--device", "cpu", "--steps", "20", "--ckpt-dir",
                      str(tmp_path)])
    assert "== resumed from checkpoint at step 50" in lines


@pytest.mark.parametrize("main", [quickstart.main, serve_sla.main,
                                  dlrm_train_100m.main])
def test_examples_refuse_to_run_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
