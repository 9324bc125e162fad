"""Structured span tracing: Chrome trace events + JSONL event log (a copy
of ``photon_ml_tpu/obs/trace.py``; ``Span.sync`` waits on the value's CUDA
device instead of ``jax.block_until_ready``).

The reference's only timing instrument is ``Driver.scala:124-149`` — ad-hoc
elapsed-millis log lines per phase. That tells you *that* a GAME pass took
9 seconds, never *where* they went (solver iterations vs recompiles vs
host<->device transfer). This module is the process-wide replacement: a
thread-safe span tracer whose output loads directly into Perfetto /
``chrome://tracing`` (trace-event JSON) and doubles as a structured JSONL
event log written next to the run's ``log-message.txt``.

Design constraints, in priority order:

1. **Near-zero disabled overhead.** Training hot loops call
   :func:`span` unconditionally; with no tracer installed the call is one
   module-global read plus returning a shared no-op singleton — no
   allocation, no lock, no branch in the caller. ``benchmarks/obs_overhead.py``
   gates this (<5% on a smoke GAME run, enabled vs disabled).
2. **Thread-safe.** The serving micro-batcher and stats flushers span from
   worker threads; events append under one lock and carry the recording
   thread id so Perfetto lays them out per-track.
3. **No torch dependency at import.** Pure stdlib — the tracer must be
   importable from CPU-only subprocesses; ``Span.sync`` imports torch
   lazily.

Usage::

    from photon_ml_tpu_torch import obs

    with obs.trace("out/trace"):            # install for the block
        with obs.span("train", combo=0):    # nestable, thread-safe
            ...
        obs.emit_event("retry", label="read part-0.avro", attempt=2)
    # -> out/trace/trace.json (Perfetto) + out/trace/events.jsonl

Device-time attribution: wall-clock spans lie on an async runtime — the
dispatch returns before the device finishes. ``span(...).sync(arrays)``
synchronizes the CUDA device holding the value and annotates the span
with the blocked time, splitting host dispatch from device completion.
"""

from __future__ import annotations

import atexit
import contextlib
import io
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "trace",
    "span",
    "span_context",
    "current_span_context",
    "emit_event",
    "get_tracer",
    "set_tracer",
]

EVENTS_FILENAME = "events.jsonl"


def process_identity():
    """``(process_index, process_count)``: :func:`obs.dist.process_identity
    <photon_ml_tpu_torch.obs.dist.process_identity>` (imported here, since
    ``obs.dist`` imports this module)."""
    from photon_ml_tpu_torch.obs import dist as _dist

    return _dist.process_identity()


def _cuda_devices(value) -> set:
    """The CUDA devices of every tensor in ``value`` (nested lists, tuples
    and dict values)."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        out = set()
        for v in value:
            out |= _cuda_devices(v)
        return out
    device = getattr(value, "device", None)
    return {device} if getattr(device, "type", None) == "cuda" else set()
TRACE_FILENAME = "trace.json"


class Tracer:
    """Collects trace events and streams them to a JSONL log.

    ``_FLUSH_EVERY`` bounds the unflushed-span window (see
    :meth:`_log_jsonl`).

    Timestamps are microseconds since the tracer's epoch
    (``perf_counter_ns`` based — monotonic, immune to wall-clock steps),
    which is what the Chrome trace-event format's ``ts`` field wants.
    ``export()`` writes the accumulated events, sorted by ``ts``, as a
    ``{"traceEvents": [...]}`` document loadable in Perfetto.
    """

    _FLUSH_EVERY = 64

    def __init__(
        self,
        trace_dir: Optional[str] = None,
        process_name: str = "photon_ml_tpu_torch",
        keep_events: bool = True,
    ):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        # ring-only mode (keep_events=False): route spans/events to the
        # flight recorder and JSONL without accumulating the in-memory
        # trace — the long-lived-process shape (obs.observe's
        # flight-without-trace envelope) where an unbounded event list
        # would be a leak
        self._keep_events = keep_events
        self._epoch_ns = time.perf_counter_ns()
        self._epoch_unix = time.time()
        # flight-recorder hook: a FlightRecorder (obs.flight) notes every
        # span/instant/counter record into its bounded ring
        self.recorder = None
        # pod identity (obs.dist): in a multi-process run the Chrome pid
        # IS the process index — per-host events land on distinct
        # Perfetto pid tracks and merge without rewriting
        self.process_index, self.process_count = process_identity()
        if self.process_count > 1:
            self._pid = self.process_index
            process_name = f"{process_name} host.{self.process_index}"
        else:
            self._pid = os.getpid()
        self.trace_dir = trace_dir
        self._jsonl: Optional[io.TextIOBase] = None
        self._jsonl_pending = 0
        self._atexit_registered = False
        if trace_dir is not None:
            os.makedirs(trace_dir, exist_ok=True)
            self._jsonl = open(
                os.path.join(trace_dir, EVENTS_FILENAME),
                "a",
                encoding="utf-8",
            )
            # clean-exit guard: a tracer installed WITHOUT the trace()
            # context manager (drivers that set_tracer directly, or a
            # process that exits mid-envelope) still flushes its
            # buffered span records and exports the trace — the
            # up-to-63-spans flush loss-window otherwise
            atexit.register(self._atexit_close)
            self._atexit_registered = True
        # process metadata events (name + stable ordering in Perfetto)
        self._events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": self._pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": process_name},
            }
        )
        if self.process_count > 1:
            self._events.append(
                {
                    "ph": "M",
                    "name": "process_sort_index",
                    "pid": self._pid,
                    "tid": 0,
                    "ts": 0,
                    "args": {"sort_index": self.process_index},
                }
            )

    # -- clock --------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since this tracer's epoch (monotonic)."""
        return (time.perf_counter_ns() - self._epoch_ns) / 1e3

    def _wall(self, ts_us: float) -> float:
        """Unix seconds for a tracer timestamp (JSONL human anchor)."""
        return self._epoch_unix + ts_us / 1e6

    # -- recording ----------------------------------------------------------

    def _log_jsonl(self, record: Dict[str, Any], flush: bool = False) -> None:
        """Append one JSONL record. Span records are flushed every
        ``_FLUSH_EVERY`` writes (a crash loses at most a handful of
        timing lines — the flight recorder's ring covers that window);
        instant events — faults, retries, preemptions — flush
        immediately, since they exist to survive the crash that
        follows them."""
        rec = self.recorder
        if rec is not None:
            rec.note(record)
        if self._jsonl is None or self._jsonl.closed:
            return
        if self.process_count > 1:
            record = {"host": self.process_index, **record}
        self._jsonl.write(json.dumps(record, sort_keys=True) + "\n")
        self._jsonl_pending += 1
        if flush or self._jsonl_pending >= self._FLUSH_EVERY:
            self._jsonl.flush()
            self._jsonl_pending = 0

    def add_span(
        self,
        name: str,
        ts_us: float,
        dur_us: float,
        cat: str = "app",
        tid: Optional[int] = None,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record a complete ('X') event with an explicit window — the
        retro-emission hook for work whose per-piece timing is only known
        after a fused dispatch returns."""
        ev = {
            "ph": "X",
            "name": name,
            "cat": cat,
            "pid": self._pid,
            "tid": tid if tid is not None else threading.get_ident(),
            "ts": round(ts_us, 3),
            "dur": round(max(dur_us, 0.0), 3),
            "args": args or {},
        }
        with self._lock:
            if self._keep_events:
                self._events.append(ev)
            self._log_jsonl(
                {
                    "kind": "span",
                    "name": name,
                    "cat": cat,
                    "time_unix": round(self._wall(ts_us), 6),
                    "duration_ms": round(max(dur_us, 0.0) / 1e3, 6),
                    **(args or {}),
                }
            )

    def add_instant(
        self,
        name: str,
        cat: str = "event",
        args: Optional[Dict[str, Any]] = None,
        flush: bool = True,
    ) -> None:
        """Instant events flush the JSONL immediately by default — they
        exist to survive the crash that follows them. Periodic telemetry
        instants (per-pass convergence summaries) pass ``flush=False``
        and ride the batched span flush instead."""
        ts = self.now_us()
        ev = {
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "name": name,
            "cat": cat,
            "pid": self._pid,
            "tid": threading.get_ident(),
            "ts": round(ts, 3),
            "args": args or {},
        }
        with self._lock:
            if self._keep_events:
                self._events.append(ev)
            self._log_jsonl(
                {
                    "kind": "event",
                    "name": name,
                    "cat": cat,
                    "time_unix": round(self._wall(ts), 6),
                    **(args or {}),
                },
                flush=flush,
            )

    def add_counter(
        self,
        name: str,
        values: Dict[str, float],
        ts_us: Optional[float] = None,
    ) -> None:
        """Record a Chrome counter-track sample ('C' event): Perfetto
        renders successive samples of the same ``name`` as a stacked
        area graph under the timeline — the HBM telemetry surface
        (``obs.device``). ``ts_us`` retro-stamps the sample (the
        convergence layer replays a solve's tape across the solve's
        span window; the iterations happened inside one dispatch, so
        their timestamps are only known after it returns). Samples are
        periodic and bulky, so the JSONL mirror rides the batched span
        flush, not the instant-event immediate flush."""
        ev = {
            "ph": "C",
            "name": name,
            "cat": "counter",
            "pid": self._pid,
            "tid": 0,
            "ts": round(self.now_us() if ts_us is None else ts_us, 3),
            "args": dict(values),
        }
        with self._lock:
            if self._keep_events:
                self._events.append(ev)
            self._log_jsonl(
                {
                    "kind": "counter",
                    "name": name,
                    "time_unix": round(self._wall(ev["ts"]), 6),
                    **values,
                }
            )

    # -- readout ------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome trace-event JSON (sorted by ``ts`` so readers
        that assume emission order see monotone timestamps). Returns the
        path written, or None when there is nowhere to write."""
        if path is None:
            if self.trace_dir is None:
                return None
            path = os.path.join(self.trace_dir, TRACE_FILENAME)
        with self._lock:
            events = sorted(self._events, key=lambda e: (e["ts"], -e.get("dur", 0)))
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "epoch_unix": self._epoch_unix,
                "process_index": self.process_index,
                "process_count": self.process_count,
            },
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return path

    def flush(self) -> None:
        """Force the buffered JSONL span records to disk. Called from
        shutdown paths (``GracefulShutdown``) so a graceful exit never
        loses the up-to-``_FLUSH_EVERY - 1`` buffered records."""
        with self._lock:
            if self._jsonl is not None and not self._jsonl.closed:
                self._jsonl.flush()
                self._jsonl_pending = 0

    def close(self) -> None:
        if self._atexit_registered:
            self._atexit_registered = False
            try:
                atexit.unregister(self._atexit_close)
            except Exception:
                pass
        if self._jsonl is not None and not self._jsonl.closed:
            self._jsonl.close()  # implicit flush of any buffered records

    def _atexit_close(self) -> None:
        """Clean-exit fallback for tracers never close()d: export the
        trace document (the context manager normally does this) and
        flush/close the JSONL log."""
        try:
            self.export()
        except Exception:
            pass
        self.close()


# ---------------------------------------------------------------------------
# Active-tracer plumbing
# ---------------------------------------------------------------------------

# ONE process-global active tracer (like logging's root logger): training,
# serving, and resilience all emit into the same timeline, which is the
# point of a *unified* instrument. Deliberately not thread-local — worker
# threads must land on the main timeline.
_active: Optional[Tracer] = None
_install_lock = threading.Lock()


def get_tracer() -> Optional[Tracer]:
    return _active


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the process-wide destination (None disables).
    Returns the previous tracer so callers can restore it."""
    global _active
    with _install_lock:
        prev = _active
        _active = tracer
    return prev


@contextlib.contextmanager
def trace(trace_dir: Optional[str], process_name: str = "photon_ml_tpu_torch"):
    """Install a :class:`Tracer` writing under ``trace_dir`` for the
    block; export ``trace.json`` and close the JSONL log on exit. With
    ``trace_dir=None`` the block runs untraced (flag-plumbing
    convenience: ``with trace(args.trace_dir): ...``)."""
    if trace_dir is None:
        yield None
        return
    tracer = Tracer(trace_dir, process_name=process_name)
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
        tracer.export()
        tracer.close()


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class _NullSpan:
    """The disabled-mode singleton: every method is a no-op. Shared and
    stateless so ``span()`` allocates nothing when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass

    def sync(self, value):
        return value


_NULL_SPAN = _NullSpan()


class Span:
    """A live span: records a complete event on ``__exit__``.

    ``set(**attrs)`` attaches arguments (visible in Perfetto's args pane
    and in the JSONL record). ``sync(value)`` blocks until the device
    work producing ``value`` is done and annotates the span with the
    blocked milliseconds — wall time alone cannot split an async
    dispatch from device completion. A span that exits via an exception
    is recorded with ``error=True``; where the time went is most valuable
    exactly when the phase died (same contract as ``timed()``).
    """

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: Tracer, name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = tracer.now_us()

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if exc_type is not None:
            self.args["error"] = True
        t1 = self._tracer.now_us()
        self._tracer.add_span(
            self.name, self._t0, t1 - self._t0, cat=self.cat, args=self.args
        )
        return False

    def set(self, **attrs) -> None:
        self.args.update(attrs)

    def sync(self, value):
        """Wait for the CUDA device holding ``value`` (a tensor, or a
        list / tuple / dict of them; anything off CUDA needs no wait),
        annotating the span with the blocked time (``device_wait_ms``) —
        the device-time attribution seam. Imports torch lazily so the
        tracer stays stdlib-only."""
        t0 = self._tracer.now_us()
        out = value
        for device in _cuda_devices(value):
            import torch

            torch.cuda.synchronize(device)
        self.args["device_wait_ms"] = round(
            (self._tracer.now_us() - t0) / 1e3, 4
        )
        return out


# Ambient span context: request-scoped attributes (trace/request ids)
# that cross API seams without threading kwargs through them — the
# serving micro-batcher opens a context around its score_fn call and the
# engine's `serving.score` span inherits the batch/request identity.
# Thread-local so concurrent micro-batchers don't cross-tag. Read ONLY
# when a tracer is active, so disabled-mode span() cost is unchanged.
_span_ctx = threading.local()


def current_span_context() -> Optional[Dict[str, Any]]:
    """The innermost ambient span-context dict, or None."""
    stack = getattr(_span_ctx, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def span_context(**fields):
    """Attach ``fields`` to every span opened in this thread inside the
    block (explicit span attrs win on key collision). Nestable: inner
    contexts layer over outer ones."""
    stack = getattr(_span_ctx, "stack", None)
    if stack is None:
        stack = _span_ctx.stack = []
    merged = {**stack[-1], **fields} if stack else dict(fields)
    stack.append(merged)
    try:
        yield
    finally:
        stack.pop()


def span(name: str, cat: str = "app", **attrs):
    """Open a span on the active tracer (context manager). Disabled mode
    returns a shared no-op singleton — the unconditional-call contract
    every hot loop relies on."""
    tracer = _active
    if tracer is None:
        return _NULL_SPAN
    ctx = current_span_context()
    if ctx:
        attrs = {**ctx, **attrs}
    return Span(tracer, name, cat, attrs)


def emit_event(name: str, cat: str = "event", **fields) -> None:
    """Record an instantaneous structured event (retry fired, fault
    injected, rollback, preemption…) on the active tracer; no-op when
    tracing is off. Fields must be JSON-serializable."""
    tracer = _active
    if tracer is not None:
        tracer.add_instant(name, cat=cat, args=fields)
