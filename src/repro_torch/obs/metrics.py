"""Process-local metrics registry: named counters / gauges / histograms
with labels.

The serving stack's meters (fabric wire accounting, hoststore swap
faults, queue depths, cache hits) publish into a `MetricsRegistry`
instead of private ad-hoc tallies where the scoping allows it. A metric
is identified by (name, sorted label items); the snapshot key is the
Prometheus-style `name{k=v,...}` string so artifacts are greppable:

    reg.counter("wire_bytes", board=0).inc(128)
    reg.gauge("queue_depth", rid=1).set(3)
    reg.histogram("flush_service_ms").observe(4.2)
    reg.snapshot()
    # {"wire_bytes{board=0}": 128.0, "queue_depth{rid=1}": 3.0,
    #  "flush_service_ms": {"count": 1, "sum": 4.2, ...}}

Scoping: components that live inside ONE run (a fleet, a cluster) own a
per-instance registry reset at run start, so reports can read their
tallies back without cross-run bleed; process-wide publishers (the
hoststore exchange buried inside an Engine, `ServeSession.run_serial` /
`run_open_loop`) default to `default_registry()`, which launchers
snapshot into `--metrics-out` — but every one of them takes a
`metrics=` override, so back-to-back runs in one process can each own a
fresh registry instead of double-counting into the singleton
(`Engine(metrics=...)` threads one through to its hoststore exchange).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelItems:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_key(name: str, labels: LabelItems) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Counter:
    """Monotonically increasing value (negative increments refused)."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: Union[int, float] = 1.0) -> None:
        a = float(amount)
        if a < 0:
            raise ValueError(f"counter increments must be >= 0, got {a}")
        self.value += a

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Last-write-wins value (queue depth, fleet size)."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: Union[int, float]) -> None:
        self.value = float(value)

    def inc(self, amount: Union[int, float] = 1.0) -> None:
        self.value += float(amount)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Streaming distribution: count / sum / min / max + power-of-two
    magnitude buckets (le=2^k upper bounds), enough to recover the shape
    without storing samples."""

    kind = "histogram"

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets: Dict[str, int] = {}

    def observe(self, value: Union[int, float]) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= 0:
            le = "0"
        else:
            e = 0
            while 2.0 ** e < v and e < 64:
                e += 1
            le = f"2^{e}"
        self.buckets[le] = self.buckets.get(le, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "mean": self.sum / self.count,
                "buckets": dict(sorted(self.buckets.items()))}


class MetricsRegistry:
    """Named metrics with labels; see module docstring."""

    _kinds = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelItems],
                            Union[Counter, Gauge, Histogram]] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, Any]):
        key = (str(name), _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._kinds[kind]()
            self._metrics[key] = m
        elif m.kind != kind:
            raise ValueError(
                f"metric {_fmt_key(*key)!r} already registered as a "
                f"{m.kind}, cannot re-register as a {kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    # -- reading -------------------------------------------------------------
    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Scalar value of a counter/gauge (default if never published)."""
        m = self._metrics.get((str(name), _label_key(labels)))
        if m is None:
            return float(default)
        if isinstance(m, Histogram):
            raise ValueError(f"{name!r} is a histogram; read snapshot()")
        return m.value

    def total(self, name: str) -> float:
        """Sum of a counter/gauge across ALL of its label sets."""
        return float(sum(
            m.value for (n, _), m in self._metrics.items()
            if n == str(name) and not isinstance(m, Histogram)))

    def snapshot(self) -> Dict[str, Any]:
        """The whole registry as a plain `{key: scalar-or-dict}` dict,
        JSON-ready, keys sorted."""
        return {_fmt_key(n, lbl): m.snapshot()
                for (n, lbl), m in sorted(self._metrics.items())}

    def reset(self) -> None:
        self._metrics.clear()

    def __len__(self) -> int:
        return len(self._metrics)


_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry (created on first use)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT
