"""Process-wide metrics registry: named counters, gauges, histograms (a copy of
``photon_ml_tpu/obs/metrics.py``).

Before this module, measurement was split three ways: serving carried its
own private ``ServingStats``, training logged free-text phase timings, and
resilience events vanished into log lines. The registry is the one
instrument they all feed: solver iteration counts, XLA recompiles,
ingest/checkpoint bytes, retry/fault/rollback counters, serving latency
histograms — snapshot-able as JSON (``metrics.json`` next to the run's
models) and exposable in Prometheus text format from ``cli/serve.py``.

Three instrument kinds, all lock-guarded and cheap to record:

- :class:`Counter` — monotonically increasing float (``inc``).
- :class:`Gauge`   — last-write-wins float (``set``).
- :class:`LatencyHistogram` — log-spaced histogram with quantile readout
  (promoted here from ``serving/stats.py``; the serving module re-exports
  it so existing imports keep working).

A process-global default registry (:func:`registry`) serves the common
case; subsystems that need isolation (one ``ServingStats`` per engine)
construct their own :class:`MetricsRegistry`.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Dict

__all__ = [
    "Counter",
    "Gauge",
    "LatencyHistogram",
    "MetricsRegistry",
    "registry",
    "set_registry",
]


class Counter:
    """Monotonic float counter. ``inc`` accepts fractional increments —
    per-entity solver iteration counts aggregate as means, and forcing
    them to ints would silently floor the signal."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increments must be >= 0: {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins float."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class LatencyHistogram:
    """Log-spaced latency histogram (milliseconds) with quantile readout.

    Fixed geometric bucket edges keep recording O(1) and lock-cheap; the
    quantile interpolates within the winning bucket, so resolution is the
    edge ratio (~12% at the default 64 bins over 1e-3..6e4 ms) — plenty
    for p99 dashboards, and bounded memory regardless of request count.
    NOT thread-safe on its own; :class:`MetricsRegistry` (and
    ``ServingStats``) hold the lock.
    """

    def __init__(
        self, lo_ms: float = 1e-3, hi_ms: float = 6e4, bins: int = 64
    ):
        self._lo = math.log(lo_ms)
        self._span = math.log(hi_ms) - self._lo
        self._bins = bins
        self.counts = [0] * (bins + 2)  # + underflow/overflow
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def _edge(self, i: int) -> float:
        return math.exp(self._lo + self._span * i / self._bins)

    def bucket_index(self, ms: float) -> int:
        """The bucket a latency lands in (0 = underflow, bins+1 =
        overflow). Exposed so exemplar rings (obs/exemplars.py) attach
        trace ids to exactly the bucket this histogram counted."""
        if ms <= 0:
            return 0
        f = (math.log(ms) - self._lo) / self._span
        return min(max(int(f * self._bins) + 1, 0), self._bins + 1)

    def bucket_le(self, i: int) -> float:
        """Inclusive upper edge of bucket ``i`` (``inf`` for overflow) —
        the Prometheus-style ``le`` label exemplar lookups key on."""
        if i <= 0:
            return self._edge(0)
        if i >= self._bins + 1:
            return math.inf
        return self._edge(i)

    def record(self, ms: float) -> None:
        self.count += 1
        self.sum_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms
        self.counts[self.bucket_index(ms)] += 1

    def quantile(self, q: float) -> float:
        """q in [0, 1] -> latency in ms (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for b, c in enumerate(self.counts):
            seen += c
            if seen >= target and c > 0:
                if b == 0:
                    return self._edge(0)
                if b == self._bins + 1:
                    return self.max_ms
                # geometric midpoint of the winning bucket
                return math.sqrt(self._edge(b - 1) * self._edge(b))
        return self.max_ms

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean_ms": self.sum_ms / self.count if self.count else 0.0,
            "p50_ms": round(self.quantile(0.50), 4),
            "p95_ms": round(self.quantile(0.95), 4),
            "p99_ms": round(self.quantile(0.99), 4),
            "max_ms": round(self.max_ms, 4),
        }


class MetricsRegistry:
    """Thread-safe name -> instrument map.

    Names are dotted paths (``game.solver_iterations``,
    ``io.checkpoint.bytes_written``) — see docs/OBSERVABILITY.md for the
    taxonomy. Re-requesting a name returns the SAME instrument;
    re-requesting it as a different kind raises (a silent kind change
    would split one metric across two series).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, kind, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {kind.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str, **kwargs) -> LatencyHistogram:
        return self._get(
            name, LatencyHistogram, lambda: LatencyHistogram(**kwargs)
        )

    # -- one-line recording helpers (the common call shape) ----------------

    def inc(self, name: str, amount: float = 1.0) -> None:
        self.counter(name).inc(amount)

    def set_gauge(self, name: str, value: float) -> None:
        self.gauge(name).set(value)

    def observe(self, name: str, ms: float) -> None:
        """Record ``ms`` into histogram ``name`` (created on first use).
        Histogram recording shares the registry lock — one histogram's
        record is not thread-safe on its own."""
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = LatencyHistogram()
                self._instruments[name] = inst
            elif not isinstance(inst, LatencyHistogram):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested LatencyHistogram"
                )
            inst.record(ms)

    def names(self, prefix: str = "") -> list:
        with self._lock:
            return sorted(
                n for n in self._instruments if n.startswith(prefix)
            )

    def reset(self) -> None:
        """Drop every instrument (tests; a long-lived process keeps its
        counters for life, like Prometheus clients)."""
        with self._lock:
            self._instruments.clear()

    # -- readout ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-JSON view: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {count, mean_ms, p50_ms, ...}}}``."""
        with self._lock:
            items = list(self._instruments.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in sorted(items):
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            else:
                with self._lock:
                    out["histograms"][name] = inst.snapshot()
        return out

    def dump(self, path: str) -> str:
        """Atomic-enough snapshot write (write + rename would be overkill
        for an advisory artifact; a torn ``metrics.json`` is re-written by
        the next periodic dump)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {"time_unix": time.time(), **self.snapshot()}, f, indent=2
            )
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4). Dotted names sanitize to
        underscores with a ``photon_`` namespace prefix; histograms export
        summary-style quantile series plus ``_sum``/``_count``."""
        lines = []
        snap = self.snapshot()
        for name, value in snap["counters"].items():
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {_prom_value(value)}")
        for name, value in snap["gauges"].items():
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_prom_value(value)}")
        for name, h in snap["histograms"].items():
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} summary")
            for q, key in ((0.5, "p50_ms"), (0.95, "p95_ms"), (0.99, "p99_ms")):
                lines.append(
                    f'{pn}{{quantile="{q}"}} {_prom_value(h[key])}'
                )
            lines.append(f"{pn}_sum {_prom_value(h['mean_ms'] * h['count'])}")
            lines.append(f"{pn}_count {_prom_value(h['count'])}")
        return "\n".join(lines) + "\n"


_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "photon_" + _PROM_SANITIZE.sub("_", name)


def _prom_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


# ONE process-global default registry: training, serving, and resilience
# all record into the same namespace unless handed an explicit registry.
_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global default registry."""
    return _default


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests). Returns the previous one."""
    global _default
    prev = _default
    _default = reg
    return prev
