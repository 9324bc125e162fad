"""Observability for the port's serving stack (counterpart of
``photon_ml_tpu/obs``): the pieces ``serving/`` and ``cli/serve.py`` use.

- :mod:`.trace`     — nestable thread-safe spans; Chrome trace-event JSON
  and a JSONL event log; near-zero cost when no tracer is installed.
- :mod:`.metrics`   — named counters/gauges/histograms; JSON snapshots and
  Prometheus text (the serve CLI's ``{"cmd": "metrics"}``).
- :mod:`.sketches`  — mergeable fixed-bin histograms (per-version score
  distributions).
- :mod:`.exemplars` and :mod:`.reqtrace` — tail-sampled exemplar rings
  and request-trace ids.
- :func:`hbm_watermark` — device-memory watermarks on the CUDA caching
  allocator (:mod:`.device`).

Copies of the JAX package's stdlib/numpy modules. Not ported: the cost
book (XLA's cost analysis; the score span carries no MFU), the compile
listener (the engine counts its own bucket builds), the flight recorder,
the pod-trace merge, the convergence and quality layers (ROADMAP.md queue
A items 5 and 10).
"""

from __future__ import annotations

from photon_ml_tpu_torch.obs import exemplars
from photon_ml_tpu_torch.obs import metrics
from photon_ml_tpu_torch.obs import reqtrace
from photon_ml_tpu_torch.obs import sketches
from photon_ml_tpu_torch.obs.device import HbmWatermark, hbm_watermark
from photon_ml_tpu_torch.obs.metrics import (
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
    "HbmWatermark",
    "LatencyHistogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "current_span_context",
    "emit_event",
    "exemplars",
    "get_tracer",
    "hbm_watermark",
    "metrics",
    "registry",
    "reqtrace",
    "set_registry",
    "set_tracer",
    "sketches",
    "span",
    "span_context",
    "trace",
]
