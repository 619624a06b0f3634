"""repro_torch.obs: observability on the serving stack's virtual clock.

The port's own copies of the reference's pure-Python ``repro.obs``
modules, which ``ServeSession`` reports through:

  * ``obs.trace``       -- ``Tracer``: spans + instant/counter events per
                           (board, lane) track, exported as Chrome
                           trace-event JSON loadable in Perfetto.
  * ``obs.metrics``     -- ``MetricsRegistry``: named counters / gauges /
                           histograms with labels.
  * ``obs.attribution`` -- per-query latency decomposition aggregated into
                           a ``BlameReport`` (p99 tail vs median).
  * ``obs.serialize``   -- the shared report-JSON path (``to_jsonable``).
"""
from repro_torch.obs.attribution import (COMPONENTS, AttributionLog,
                                         BlameReport, QueryRecord,
                                         interval_overlap_s)
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.serialize import (report_asdict, report_to_json,
                                       to_jsonable)
from repro_torch.obs.trace import Tracer

__all__ = [
    "AttributionLog",
    "BlameReport",
    "COMPONENTS",
    "MetricsRegistry",
    "QueryRecord",
    "Tracer",
    "default_registry",
    "interval_overlap_s",
    "report_asdict",
    "report_to_json",
    "to_jsonable",
]
