"""Observability for the port (counterpart of ``photon_ml_tpu/obs``): one
instrument threaded through the drivers, the solvers, the descent, the
collectives and the serving stack.

- :mod:`.trace`     — nestable thread-safe spans; Chrome trace-event JSON
  and a JSONL event log; near-zero cost when no tracer is installed.
- :mod:`.metrics`   — named counters/gauges/histograms; JSON snapshots and
  Prometheus text (the serve CLI's ``{"cmd": "metrics"}``).
- :mod:`.dist`      — process identity, clock sync and the merge of the
  ranks' trace, event and metrics shards.
- :mod:`.flight`    — the crash flight recorder.
- :mod:`.device`    — device-memory samples and watermarks on the CUDA
  caching allocator.
- :mod:`.collectives` — per-collective counts, bytes and blocked wall.
- :mod:`.cost`      — the cost book: analytic kernel costs against the
  H100's peaks.
- :mod:`.convergence` — solver-tape decode, fleet summaries, the
  convergence report.
- :mod:`.dispatch_count` and :mod:`.build_events` — kernel launches per
  block, and the port's kernel builds and launch plans (where the JAX
  package counts executables and ``xla.compiles``).
- :mod:`.sketches`, :mod:`.exemplars`, :mod:`.reqtrace`, :mod:`.quality`
  — the serving stack's sketches, exemplar rings, request traces, and
  the fingerprint / drift / online-quality layer.

Drivers enable it in one place::

    with obs.observe(trace_dir=..., metrics_path=..., metrics_every=30,
                     profile_dir=..., flight_dir=..., device=device):
        ...

which installs the tracer, a periodic registry dumper, an HBM sampler, a
flight recorder and a ``torch.profiler`` window (a Chrome trace where the
JAX package writes an xplane); everything tears down on exit. Hot paths
call ``obs.span(...)`` / ``obs.emit_event(...)`` / ``obs.registry()``
unconditionally — disabled mode costs one global read. The modules are
copies of the JAX package's stdlib/numpy modules where they can be; the
JAX package's compile listener, HLO collective counter and
``obs.sentinel`` (a bench-record reader) are not ported.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

from photon_ml_tpu_torch.obs import build_events
from photon_ml_tpu_torch.obs import collectives
from photon_ml_tpu_torch.obs import convergence
from photon_ml_tpu_torch.obs import cost
from photon_ml_tpu_torch.obs import dist
from photon_ml_tpu_torch.obs import exemplars
from photon_ml_tpu_torch.obs import metrics
from photon_ml_tpu_torch.obs import quality
from photon_ml_tpu_torch.obs import reqtrace
from photon_ml_tpu_torch.obs import sketches
from photon_ml_tpu_torch.obs import taxonomy
from photon_ml_tpu_torch.obs.build_events import build_events as kernel_build_events
from photon_ml_tpu_torch.obs.collectives import collective_span, record_collective
from photon_ml_tpu_torch.obs.convergence import (
    ConvergenceReport,
    ConvergenceTracker,
    FleetSummary,
    convergence_tracker,
    decode_result,
    fleet_summary,
    install_convergence_tracker,
    uninstall_convergence_tracker,
)
from photon_ml_tpu_torch.obs.cost import (
    CostBook,
    CostRecord,
    annotate_span,
    cost_book,
    set_cost_book,
)
from photon_ml_tpu_torch.obs.device import (
    HbmSampler,
    HbmWatermark,
    hbm_supported,
    hbm_watermark,
    read_memory_stats,
    sample_hbm,
)
from photon_ml_tpu_torch.obs.dispatch_count import DispatchCounts, count_dispatches
from photon_ml_tpu_torch.obs.dist import (
    emit_clock_sync,
    host_metric_prefix,
    merge_trace_shards,
    process_identity,
    set_process_identity,
)
from photon_ml_tpu_torch.obs.flight import (
    FlightRecorder,
    flight_dump,
    flight_recorder,
    install_flight_recorder,
    uninstall_flight_recorder,
)
from photon_ml_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    LatencyHistogram,
    MetricsRegistry,
    registry,
    set_registry,
)
from photon_ml_tpu_torch.obs.trace import (
    Span,
    Tracer,
    current_span_context,
    emit_event,
    get_tracer,
    set_tracer,
    span,
    span_context,
    trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "LatencyHistogram",
    "MetricsRegistry",
    "registry",
    "set_registry",
    "Span",
    "Tracer",
    "emit_event",
    "get_tracer",
    "set_tracer",
    "span",
    "trace",
    "span_context",
    "current_span_context",
    # the port's builds (where the JAX package counts xla.compiles)
    "build_events",
    "kernel_build_events",
    # the cost book (obs.cost)
    "cost",
    "CostBook",
    "CostRecord",
    "annotate_span",
    "cost_book",
    "set_cost_book",
    # device memory (obs.device)
    "HbmSampler",
    "HbmWatermark",
    "hbm_supported",
    "hbm_watermark",
    "read_memory_stats",
    "sample_hbm",
    "MetricsDumper",
    "observe",
    "taxonomy",
    # distributed observability (obs.dist)
    "dist",
    "emit_clock_sync",
    "host_metric_prefix",
    "merge_trace_shards",
    "process_identity",
    "set_process_identity",
    # collective profiler (obs.collectives)
    "collectives",
    "collective_span",
    "record_collective",
    # flight recorder (obs.flight)
    "FlightRecorder",
    "flight_dump",
    "flight_recorder",
    "install_flight_recorder",
    "uninstall_flight_recorder",
    # convergence-health layer (obs.convergence)
    "convergence",
    "ConvergenceReport",
    "ConvergenceTracker",
    "FleetSummary",
    "convergence_tracker",
    "decode_result",
    "fleet_summary",
    "install_convergence_tracker",
    "uninstall_convergence_tracker",
    # kernel-launch counting (obs.dispatch_count)
    "DispatchCounts",
    "count_dispatches",
    # the serving stack's layers
    "metrics",
    "sketches",
    "quality",
    "reqtrace",
    "exemplars",
]


class MetricsDumper:
    """Background thread writing periodic registry snapshots to a JSON file
    (the ``metrics_every`` surface). Daemonized and event-driven so
    ``stop()`` returns promptly instead of waiting out the interval; a
    final dump on stop means the file always reflects the completed run.
    The registry takes its own lock for each snapshot, so the solver may
    write to it while the dump runs."""

    def __init__(self, path: str, every_s: float, reg: Optional[MetricsRegistry] = None):
        self.path = path
        self.every_s = every_s
        self._registry = reg if reg is not None else registry()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            try:
                self._registry.dump(self.path)
            except OSError:
                pass  # a full disk must not kill the training loop

    def start(self) -> "MetricsDumper":
        if self.every_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="obs-metrics-dumper", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._registry.dump(self.path)


@contextlib.contextmanager
def observe(
    trace_dir: Optional[str] = None,
    metrics_path: Optional[str] = None,
    metrics_every: float = 0.0,
    profile_dir: Optional[str] = None,
    hbm_every_s: float = 0.5,
    process_name: str = "photon_ml_tpu_torch",
    flight_dir: Optional[str] = None,
    flight_records: int = 2048,
    device=None,
):
    """Driver-level enable-everything context (JAX ``obs.observe``).

    - ``trace_dir``: install the span tracer; ``trace.json`` +
      ``events.jsonl`` land there on exit. Also starts an HBM sampler on
      ``device`` (a CUDA device; default: every visible card; a CPU device
      samples nothing) emitting counter tracks every ``hbm_every_s``
      seconds (0 disables), and records a ``clock.sync`` event that
      anchors the shard for merging (``obs.dist``).
    - ``metrics_path`` (+ ``metrics_every`` seconds): periodic registry
      snapshots; a final snapshot is always written on exit. With only
      ``trace_dir`` set, ``metrics.json`` defaults into it.
    - ``profile_dir``: a ``torch.profiler`` window around the block (CPU
      activity, and CUDA activity where ``device`` is CUDA), written as a
      Chrome trace (``utils.debug.profile_trace``); the JAX package writes
      an xplane there instead.
    - ``flight_dir``/``flight_records``: install a crash flight recorder
      holding the last ``flight_records`` observations;
      ``flight-<reason>.json`` dumps land in ``flight_dir`` (default:
      ``trace_dir``). With ``flight_dir`` set but no ``trace_dir``, a
      ring-only tracer is installed so spans still feed the recorder
      without accumulating a trace. ``flight_records=0`` disables.

    An exception inside the block dumps ``flight-crash.json`` while the
    recorder still holds the spans leading into it. All-None is a no-op:
    drivers wrap their body unconditionally and let flags decide.
    """
    from photon_ml_tpu_torch.utils.debug import profile_trace

    if metrics_path is None and trace_dir is not None:
        metrics_path = os.path.join(trace_dir, "metrics.json")
    dumper = None
    hbm = None
    flight = None
    installed_tracer = False
    with contextlib.ExitStack() as stack:
        if trace_dir is not None:
            stack.enter_context(trace(trace_dir, process_name=process_name))
            hbm = HbmSampler(hbm_every_s, device=device).start()
            installed_tracer = True
        elif flight_dir is not None and flight_records > 0:
            # ring-only tracer: spans/events route to the flight recorder,
            # nothing accumulates, nothing is written unless a dump fires
            ring_tracer = Tracer(None, process_name=process_name, keep_events=False)
            prev = set_tracer(ring_tracer)
            stack.callback(set_tracer, prev)
            installed_tracer = True
        if (trace_dir is not None or flight_dir is not None) and flight_records > 0:
            flight = install_flight_recorder(
                capacity=flight_records,
                flight_dir=flight_dir if flight_dir is not None else trace_dir,
            )
            stack.callback(uninstall_flight_recorder)
        if installed_tracer:
            # anchor this shard for merging (the barrier-backed sync is
            # emitted by parallel.multihost when a world joins)
            emit_clock_sync(sync_id="observe-start")
        if profile_dir is not None:
            stack.enter_context(profile_trace(profile_dir, device=device, name=process_name))
        if metrics_path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(metrics_path)), exist_ok=True)
            dumper = MetricsDumper(metrics_path, metrics_every).start()
        try:
            yield
        except BaseException as e:
            # the envelope unwinds BEFORE sys.excepthook runs, so the crash
            # hook would fire with the recorder already uninstalled — dump
            # here, while the ring still holds the spans leading into the
            # crash. GeneratorExit and SystemExit are deliberate exits, not
            # crashes (a signal dumps "preemption" from the GracefulShutdown
            # handler while the recorder is still installed)
            if flight is not None and not isinstance(e, (GeneratorExit, SystemExit)):
                try:
                    flight.note({"kind": "event", "name": "crash",
                                 "exception": f"{type(e).__name__}: {e}"})
                    flight.dump("crash")
                except Exception:  # noqa: BLE001
                    pass
            raise
        finally:
            if flight is not None:
                flight.sample_metrics()
            if hbm is not None:
                hbm.stop()
            if dumper is not None:
                dumper.stop()
