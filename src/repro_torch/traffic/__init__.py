"""repro_torch.traffic -- scenario traffic generation + trace record/replay.

The port's copy of ``repro.traffic``. `TrafficScenario` compiles a
production traffic regime (stationary / diurnal / flash_crowd /
zipf_drift) into a timestamped `QueryEvent` stream on the virtual clock,
the same events as the reference's; `materialize_query` regenerates each
event's content on a device; `traffic.trace` records/replays event
streams as JSONL in the reference's format.
"""
from repro_torch.traffic.ingest import (IngestError, estimate_zipf_alpha,
                                        ingest_jsonl)
from repro_torch.traffic.scenarios import (SCENARIOS, DiurnalScenario,
                                           FlashCrowdScenario, QueryEvent,
                                           StationaryScenario,
                                           TrafficScenario,
                                           ZipfDriftScenario, make_scenario,
                                           materialize_query)
from repro_torch.traffic.trace import load_trace, record_trace

__all__ = [
    "TrafficScenario", "StationaryScenario", "DiurnalScenario",
    "FlashCrowdScenario", "ZipfDriftScenario", "QueryEvent",
    "SCENARIOS", "make_scenario", "materialize_query",
    "record_trace", "load_trace",
    "ingest_jsonl", "estimate_zipf_alpha", "IngestError",
]
