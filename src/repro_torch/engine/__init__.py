"""repro_torch.engine: one session API from config -> plan -> step -> run.

``Engine`` owns the profile -> plan -> reconcile -> step pipeline;
``ServeSession`` adds the dynamic-batching request path and its SLA
measurement drivers; ``TrainSession`` the checkpointed training loop;
``planning`` holds the planner stage.
"""
from repro_torch.engine.batching import (MicroBatcher, QueryFuture,
                                         poisson_arrivals)
from repro_torch.engine.engine import Engine
from repro_torch.engine.planning import PlanReport, build_auto_plan
from repro_torch.engine.serving import ServeSession, SLAReport
from repro_torch.engine.training import TrainReport, TrainSession

__all__ = ["Engine", "ServeSession", "SLAReport", "TrainSession",
           "TrainReport", "PlanReport",
           "MicroBatcher", "QueryFuture", "poisson_arrivals",
           "build_auto_plan"]
