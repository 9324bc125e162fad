"""The observability NAME TAXONOMY as a machine-readable registry (a copy
of ``photon_ml_tpu/obs/taxonomy.py``).

docs/OBSERVABILITY.md documents the dotted-path naming scheme
(``<subsystem>.<thing>``) that every span, instant event, and metric in
the tree follows — it is what makes ``photon-obs merge`` output, the
Prometheus exposition, and the BENCH sentinel's direction rules
navigable. Until now that taxonomy lived only in prose: a typo'd
subsystem (``sevring.request_ms``) still recorded happily and silently
orphaned its dashboard panel.

This module is the single source of truth the prose now points at.
Consumers:

- ``photon-lint`` rule **PL006 obs-taxonomy** validates every literal
  name passed to ``obs.span`` / ``obs.emit_event`` / registry
  ``inc``/``set_gauge``/``observe``/``counter``/``gauge``/``histogram``
  against :func:`matches` at build time (f-strings validate their
  static prefix via :func:`valid_prefix`).
- docs/OBSERVABILITY.md's taxonomy section references :data:`TAXONOMY`
  so the doc table and the lint gate cannot drift.

Growing a NEW subsystem is one tuple here (plus its doc blurb) — the
lint failure for an unknown prefix is the reminder.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

__all__ = [
    "TAXONOMY",
    "subsystems",
    "matches",
    "subsystem_of",
    "valid_prefix",
]

# (subsystem, name regex, one-line description). The regex is anchored
# at the start; a name is documented when ANY entry matches. Kept in the
# same order as the docs/OBSERVABILITY.md taxonomy table.
TAXONOMY: Tuple[Tuple[str, str, str], ...] = (
    (
        "game",
        r"game\.[a-z_]+(\.[a-z0-9_.]+)?",
        "GAME descent spans/counters (game.pass, game.updates, "
        "game.checkpoint.submit_ms, ...)",
    ),
    (
        "solver",
        r"solver\.[a-z0-9_]+(\.[a-z_]+)?",
        "per-optimizer counters recorded at the train_glm host boundary",
    ),
    (
        "glm",
        r"glm\.[a-z_]+",
        "GLM driver/solve spans (glm.solve, glm.solve_path)",
    ),
    (
        "xla",
        r"xla\.[a-z_]+(\..+)?",
        "compile listener + cost book (xla.compiles, xla.cost.*)",
    ),
    (
        "hbm",
        r"hbm\..+",
        "live HBM telemetry gauges/counter tracks + watermark labels",
    ),
    (
        "io",
        r"io\.(ingest|checkpoint|pipeline)\.[a-z0-9_.]+",
        "durability I/O: ingest reads, checkpoint saves/loads, pipeline "
        "lifecycle events",
    ),
    (
        "ingest",
        r"ingest\.[a-z_]+(\.[a-z0-9_.{}<>]+)?",
        "streaming ingest->device pipeline spans/metrics (docs/INGEST.md)",
    ),
    (
        "resilience",
        r"resilience\.[a-z_]+(\..+)?",
        "retry/fault/rollback/preemption/host-loss events + counters",
    ),
    (
        "serving.cache",
        r"serving\.cache\.[a-z_]+",
        "tiered HBM/host entity cache: hit/miss/promotion/demotion "
        "counters, tier-error counter, per-batch miss/promotion "
        "instants carrying batch_id for trace joins (serving/cache.py)",
    ),
    (
        "serving.shard",
        r"serving\.shard\.[a-z0-9_.]+",
        "entity-sharded serving: per-shard occupancy gauges + device "
        "latency histograms, shard-degraded counters, the per-process "
        "resident RE-table footprint gauge (serving/sharding.py)",
    ),
    (
        "serving",
        r"serving\.[a-z_]+(\..+)?",
        "ServingStats registry metrics, request spans, SLO gauges",
    ),
    (
        "convergence",
        r"convergence\.[a-z_]+(\..+)?",
        "solver-tape convergence-health layer (reports, precursors)",
    ),
    (
        "collective",
        r"collective\.[a-z_]+(\..+)?",
        "collective profiler metrics/spans + stall/abandon events, incl. "
        "the collective.overlap.* chunked-pipeline series and per-width "
        "wall_frac overlap gauges (docs/PARALLEL.md)",
    ),
    (
        "partition",
        r"partition\.[a-z_]+(\..+)?",
        "multi-device partition layer: entity-shard layout spans, "
        "balanced-blocking stats, shard-skew drill events "
        "(docs/PARALLEL.md)",
    ),
    (
        "heartbeat",
        r"heartbeat\.[a-z_]+",
        "pod heartbeat monitor events (heartbeat.peer_lost)",
    ),
    (
        "pod",
        r"pod\.[a-z_]+(\..+)?",
        "pod-level aggregates: merged counter sums, heartbeat gauges",
    ),
    (
        "host",
        r"host\.\d+\..+",
        "per-process instruments after a pod merge (photon-obs merge)",
    ),
    (
        "clock",
        r"clock\.sync",
        "barrier-backed clock-sync anchors for trace-shard merging",
    ),
    (
        "kernels",
        r"kernels\.[a-z_]+(\..+)?",
        "kernel cost records, builds and launch plans (obs.cost, "
        "obs.build_events)",
    ),
    (
        "lint",
        r"lint\.[a-z_]+(\..+)?",
        "photon-lint analyzer metrics (docs/ANALYSIS.md)",
    ),
    (
        "drift",
        r"drift\.[a-z_]+(\..+)?",
        "serving-vs-baseline drift detection: per-feature PSI/JS "
        "gauges, drift.alarm events (obs.quality.DriftMonitor)",
    ),
    (
        "quality",
        r"quality\.[a-z_]+(\..+)?",
        "model-quality layer: online AUC/calibration gauges from the "
        "feedback loop, baseline-fingerprint health counters",
    ),
    (
        "lifecycle",
        r"lifecycle\.[a-z_]+(\..+)?",
        "self-healing retrain orchestrator: cycle spans/counters, "
        "per-stage retry events, retrain_cycle_s gauge, admission "
        "promotions (lifecycle/orchestrator.py, docs/LIFECYCLE.md)",
    ),
    (
        "frontend",
        r"frontend\.[a-z_]+(\..+)?",
        "async front end: connection/frame/reply counters, rejected "
        "(RESOURCE_EXHAUSTED answers), bytes in/out, per-request "
        "wire_read/reply_write spans + traces_issued counter "
        "(frontend/server.py, docs/FRONTEND.md)",
    ),
    (
        "tenant",
        r"tenant\.[a-z_]+(\..+)?",
        "multi-tenant engine layer: per-tenant rejected/registered "
        "counters keyed by tenant name (frontend/tenants.py)",
    ),
    (
        "replica",
        r"replica\.[a-z_]+(\..+)?",
        "replica router: per-replica batch/failure counters, "
        "replica.down events, per-attempt replica.hop spans (trace "
        "failover joins), failover_ms histogram, exhausted "
        "counter (frontend/replicas.py)",
    ),
)

_COMPILED = tuple(
    (sub, re.compile(pattern + r"$"), desc) for sub, pattern, desc in TAXONOMY
)
# prefixes that legitimately start a dynamic (f-string) name: every
# subsystem root, plus the documented two-level families whose leaf is
# computed (xla.cost.<key>, convergence.reason.<NAME>, ...)
_PREFIXES = tuple(sorted({sub + "." for sub, _, _ in TAXONOMY}))


def subsystems() -> Tuple[str, ...]:
    """The documented subsystem roots, sorted."""
    return tuple(sorted({sub for sub, _, _ in TAXONOMY}))


def matches(name: str) -> bool:
    """True when ``name`` is a documented span/event/metric name."""
    return any(rx.fullmatch(name) for _, rx, _ in _COMPILED)


def subsystem_of(name: str) -> Optional[str]:
    """The subsystem whose pattern matches ``name`` (None = orphan)."""
    for sub, rx, _ in _COMPILED:
        if rx.fullmatch(name):
            return sub
    return None


def valid_prefix(prefix: str) -> bool:
    """True when a STATIC name prefix (the constant head of an f-string
    name like ``f"resilience.faults_injected.{site}"``) can only produce
    documented names: it must start with ``<subsystem>.``."""
    return any(prefix.startswith(p) or p.startswith(prefix) for p in _PREFIXES)
