"""repro_torch.engine: one session API from config -> step -> serve.

``Engine`` builds the serve pipeline; ``ServeSession`` adds the
dynamic-batching request path and its SLA measurement drivers.
"""
from repro_torch.engine.batching import (MicroBatcher, QueryFuture,
                                         poisson_arrivals)
from repro_torch.engine.engine import Engine
from repro_torch.engine.serving import ServeSession, SLAReport

__all__ = ["Engine", "ServeSession", "SLAReport", "MicroBatcher",
           "QueryFuture", "poisson_arrivals"]
