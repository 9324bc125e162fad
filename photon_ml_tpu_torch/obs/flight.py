"""Crash flight recorder: a bounded ring of the last N observations (a copy
of ``photon_ml_tpu/obs/flight.py``).

The tracer batches span records 64 deep and the trace document only
exports on clean teardown, so the moments that matter most — the spans
and metric movements immediately BEFORE a divergence rollback, a
preemption, or an unhandled crash — are exactly the ones most likely to
be lost. This module keeps them in memory: a :class:`FlightRecorder` is
a fixed-capacity ring fed by the active tracer (every span, instant
event, and HBM counter sample lands in it the instant it is recorded,
flushed or not) plus periodic metric-delta samples, and
:func:`flight_dump` serializes the ring as ``flight-<reason>.json`` the
moment something goes wrong:

- ``resilience.shutdown.GracefulShutdown`` dumps on SIGTERM/SIGINT/
  preemption (reason ``preemption``; programmatic -> ``shutdown``),
- the GAME divergence guard dumps on a non-finite rollback
  (``divergence``),
- an installed ``sys.excepthook`` chain dumps on any unhandled crash
  (``crash``) before the previous hook runs.

The dump is self-contained: reason, pod identity (``obs.dist``), the
ring (oldest first, with a dropped-record count), and a full metrics
registry snapshot — a post-mortem no longer depends on whatever happened
to be flushed. Recording is O(1) deque appends under the tracer's
existing lock discipline.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

from photon_ml_tpu_torch.obs import dist as _dist
from photon_ml_tpu_torch.obs.metrics import MetricsRegistry
from photon_ml_tpu_torch.obs.metrics import registry as _registry
from photon_ml_tpu_torch.obs.trace import get_tracer

__all__ = [
    "FlightRecorder",
    "install_flight_recorder",
    "uninstall_flight_recorder",
    "flight_recorder",
    "flight_dump",
]

DEFAULT_CAPACITY = 2048


class FlightRecorder:
    """Fixed-capacity ring of recent observation records.

    ``note(record)`` is the tracer-side hook (called for every span /
    instant / counter JSONL-style record); ``sample_metrics()`` appends a
    counter-delta record (what moved since the last sample);
    ``dump(reason)`` writes the ring + a registry snapshot to
    ``flight-<reason>.json`` and never raises — it runs on the failure
    paths it exists to document.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        flight_dir: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.flight_dir = flight_dir
        self._registry = registry
        self._lock = threading.Lock()
        self._ring: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=capacity
        )
        self._seq = 0
        self._dropped = 0
        self._last_counters: Dict[str, float] = {}

    # -- recording ----------------------------------------------------------

    def note(self, record: Dict[str, Any]) -> None:
        """Append one observation record (already JSON-safe)."""
        with self._lock:
            self._seq += 1
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append({"seq": self._seq, **record})

    def sample_metrics(self) -> None:
        """Append a ``metrics_delta`` record: every counter that moved
        since the previous sample. Gauge/histogram state rides the full
        snapshot in :meth:`dump`; counters are the ones whose *movement*
        tells the crash story (retries fired, rollbacks, rejected
        requests)."""
        reg = self._registry if self._registry is not None else _registry()
        counters = reg.snapshot()["counters"]
        with self._lock:
            changed = {
                name: round(value - self._last_counters.get(name, 0.0), 6)
                for name, value in counters.items()
                if value != self._last_counters.get(name, 0.0)
            }
            self._last_counters = dict(counters)
        if changed:
            self.note(
                {
                    "kind": "metrics_delta",
                    "time_unix": round(time.time(), 6),
                    "changed": changed,
                }
            )

    # -- readout ------------------------------------------------------------

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def dump(
        self, reason: str, flight_dir: Optional[str] = None
    ) -> Optional[str]:
        """Write ``flight-<reason>.json`` (suffixing ``-2``, ``-3``… when
        the name exists: repeated rollbacks in one run must not clobber
        the first post-mortem). Returns the path, or None when there is
        nowhere to write or the write failed — the failure path being
        documented must not gain a second failure."""
        directory = flight_dir or self.flight_dir or "."
        reason = "".join(
            c if (c.isalnum() or c in "-_") else "-" for c in str(reason)
        ) or "unknown"
        try:
            self.sample_metrics()
        except Exception:
            pass
        with self._lock:
            records = list(self._ring)
            dropped = self._dropped
        reg = self._registry if self._registry is not None else _registry()
        try:
            metrics = reg.snapshot()
        except Exception:
            metrics = {}
        idx, count = _dist.process_identity()
        payload = {
            "reason": reason,
            "time_unix": round(time.time(), 6),
            "process_index": idx,
            "process_count": count,
            "pid": os.getpid(),
            "capacity": self.capacity,
            "records_dropped": dropped,
            "records": records,
            "metrics": metrics,
        }
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, f"flight-{reason}.json")
            n = 2
            while os.path.exists(path):
                path = os.path.join(directory, f"flight-{reason}-{n}.json")
                n += 1
            with open(path, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            return path
        except Exception:
            return None


# ---------------------------------------------------------------------------
# Process-global recorder + crash hook
# ---------------------------------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_prev_excepthook = None


def _crash_excepthook(exc_type, exc, tb) -> None:
    rec = _recorder
    if rec is not None:
        try:
            rec.note(
                {
                    "kind": "event",
                    "name": "crash",
                    "time_unix": round(time.time(), 6),
                    "exception": f"{exc_type.__name__}: {exc}",
                }
            )
            rec.dump("crash")
        except Exception:
            pass
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def install_flight_recorder(
    capacity: int = DEFAULT_CAPACITY,
    flight_dir: Optional[str] = None,
    registry: Optional[MetricsRegistry] = None,
    crash_hook: bool = True,
) -> FlightRecorder:
    """Install a process-global flight recorder: attach it to the active
    tracer (spans/events/counters start landing in the ring), and chain
    a crash ``sys.excepthook`` that dumps ``flight-crash.json`` before
    the previous hook runs. Returns the recorder. Re-installing replaces
    the previous recorder (its ring is abandoned)."""
    global _recorder, _prev_excepthook
    rec = FlightRecorder(
        capacity=capacity, flight_dir=flight_dir, registry=registry
    )
    _recorder = rec
    tracer = get_tracer()
    if tracer is not None:
        tracer.recorder = rec
    if crash_hook and sys.excepthook is not _crash_excepthook:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _crash_excepthook
    return rec


def uninstall_flight_recorder() -> None:
    """Detach the global recorder and restore the previous excepthook."""
    global _recorder, _prev_excepthook
    tracer = get_tracer()
    if tracer is not None and tracer.recorder is _recorder:
        tracer.recorder = None
    _recorder = None
    if sys.excepthook is _crash_excepthook:
        sys.excepthook = _prev_excepthook or sys.__excepthook__
        _prev_excepthook = None


def flight_recorder() -> Optional[FlightRecorder]:
    """The installed process-global recorder, or None."""
    return _recorder


def flight_dump(
    reason: str, flight_dir: Optional[str] = None
) -> Optional[str]:
    """Dump the global recorder's ring as ``flight-<reason>.json``.
    No-op (returns None) when no recorder is installed — failure paths
    call this unconditionally."""
    rec = _recorder
    if rec is None:
        return None
    return rec.dump(reason, flight_dir=flight_dir)
