"""Serving telemetry: latency histograms, QPS, batching/bucket counters
(a copy of ``photon_ml_tpu/serving/stats.py``; the lifecycle loop's
recorders wait for ROADMAP.md queue A item 10, and their snapshot keys
read 0).

The online engine's contract is "steady-state traffic never builds a new
bucket and tail latency is bounded" — both are claims about
*distributions*, so the subsystem carries its own measurement.
:class:`ServingStats` is a thin aggregation over a
:class:`~photon_ml_tpu_torch.obs.MetricsRegistry` — same lock discipline,
same ``snapshot()`` schema as the JAX package's (the ``cli/serve`` stats
endpoint parses it), every counter also a named registry metric.

The JAX package counts XLA backend compiles through a ``jax.monitoring``
listener (``xla.compiles``). PyTorch compiles nothing per bucket; what a
bucket costs the first time is the engine's build of its scorer (device
input buffers, one trial run). :func:`record_build` counts those builds
process-wide under ``serving.builds`` (the rename of ``xla.compiles``)
and :func:`bucket_builds` reads the count — the ground truth an engine's
own ``compile_count`` is checked against.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, Optional

from photon_ml_tpu_torch.obs.metrics import registry as _default_registry
from photon_ml_tpu_torch.obs.trace import emit_event as _emit_event
from photon_ml_tpu_torch.obs.metrics import (  # noqa: F401
    LatencyHistogram,
    MetricsRegistry,
)
from photon_ml_tpu_torch.obs.sketches import HistogramSketch

__all__ = [
    "LatencyHistogram",
    "ServingStats",
    "SloTracker",
    "bucket_builds",
    "record_build",
]

_build_lock = threading.Lock()
_builds = 0


def record_build(bucket: int, fixed_only: bool, seconds: float) -> None:
    """Count one bucket-scorer build process-wide: the default registry's
    ``serving.builds`` counter and a ``serving.build`` instant event."""
    global _builds
    with _build_lock:
        _builds += 1
    _default_registry().inc("serving.builds")
    _emit_event(
        "serving.build",
        cat="serving",
        bucket=int(bucket),
        fixed_only=bool(fixed_only),
        duration_ms=round(seconds * 1e3, 3),
    )


def bucket_builds() -> int:
    """Process-wide count of bucket-scorer builds (every engine)."""
    with _build_lock:
        return _builds


class ServingStats:
    """Thread-safe counters + histograms for one serving process.

    - ``request_ms``: end-to-end per-request latency (enqueue -> result).
    - ``device_ms``: per-micro-batch device call (featurize + dispatch).
    - occupancy: rows per micro-batch (how well coalescing works).
    - buckets: padded-size hit/miss counters; a miss is a NEW build.

    Backed by a :class:`MetricsRegistry` under the ``serving.`` prefix
    (pass ``registry=`` to share one; default is a private instance so
    two engines in one process don't cross-count). Counter attributes
    (``requests``, ``batches``, …) remain readable exactly as before.
    """

    _COUNTERS = (
        "requests",
        "batches",
        "rejected",
        "errors",
        "compile_count",
        "bucket_hits",
        "bucket_misses",
        "reloads",
        "reload_failures",
        "occupancy_sum",
        "expired",
        "shed",
        "degraded_batches",
    )

    def __init__(
        self,
        qps_window: int = 4096,
        registry: Optional[MetricsRegistry] = None,
    ):
        self._lock = threading.Lock()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.started = time.monotonic()
        for name in self._COUNTERS:
            self.registry.counter(f"serving.{name}")
        self.request_ms = self.registry.histogram("serving.request_ms")
        self.device_ms = self.registry.histogram("serving.device_ms")
        # per-bucket row counts keyed by padded size; kept as a host dict
        # (dynamic keys) and mirrored into `serving.bucket.<size>` counters
        self.bucket_counts: Dict[int, int] = collections.Counter()
        # per-model-version score-distribution sketches (fixed linear
        # bins over logit space — obs.sketches): "did the scores move
        # when the model did" is answerable from one stats snapshot
        self.score_hists: Dict[str, HistogramSketch] = {}
        self._recent = collections.deque(maxlen=qps_window)

    def __getattr__(self, name: str):
        # counter attributes read through to the registry (the pre-obs
        # surface: tests and the lab assert on stats.batches etc.)
        if name in ServingStats._COUNTERS:
            return self.registry.counter(f"serving.{name}").value
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}"
        )

    def _inc(self, name: str, amount: float = 1.0) -> None:
        self.registry.counter(f"serving.{name}").inc(amount)

    # -- recording ---------------------------------------------------------

    def record_batch(self, size: int, device_s: float) -> None:
        now = time.monotonic()
        with self._lock:
            self._inc("batches")
            self._inc("requests", size)
            self._inc("occupancy_sum", size)
            self.device_ms.record(device_s * 1e3)
            self._recent.extend([now] * size)

    def record_request_latency(self, seconds: float) -> None:
        with self._lock:
            self.request_ms.record(seconds * 1e3)

    def record_bucket(self, bucket: int, hit: bool) -> None:
        with self._lock:
            self.bucket_counts[bucket] += 1
            self._inc(f"bucket.{bucket}")
            self._inc("bucket_hits" if hit else "bucket_misses")

    def record_bucket_latency(self, bucket: int, device_s: float) -> None:
        """Per-bucket device latency histogram (``serving.bucket_ms.<b>``):
        the aggregate ``device_ms`` histogram hides which padded size is
        slow — a p99 problem confined to the 1024 bucket looks like a
        uniform tail without this split."""
        with self._lock:
            self.registry.observe(
                f"serving.bucket_ms.{int(bucket)}", device_s * 1e3
            )

    def record_queue_depth(self, depth: int) -> None:
        """Instantaneous request-queue depth gauge + peak gauge. Today a
        saturating queue is invisible until ``Backpressure`` rejects;
        the gauge makes the approach visible (alert at 80%, not 100%)."""
        with self._lock:
            self.registry.set_gauge("serving.queue_depth", depth)
            peak = self.registry.gauge("serving.queue_depth_peak")
            if depth > peak.value:
                peak.set(depth)

    def record_scores(self, version: str, scores) -> None:
        """Fold one batch's scores into the per-model-version score
        histogram (``snapshot()['score_distribution']``) — the cheap
        always-on companion to the DriftMonitor's baseline compare."""
        with self._lock:
            h = self.score_hists.get(version)
            if h is None:
                h = self.score_hists[version] = (
                    HistogramSketch.for_scores()
                )
            h.add(scores)

    def record_compile(self) -> None:
        with self._lock:
            self._inc("compile_count")

    def record_rejected(self) -> None:
        with self._lock:
            self._inc("rejected")

    def record_expired(self) -> None:
        """A request whose deadline passed while it sat in the queue —
        dropped BEFORE batch assembly, so it never burned device work."""
        with self._lock:
            self._inc("expired")

    def record_shed(self) -> None:
        """A queued request evicted by admission control to admit a
        higher-priority one (the bounded queue was full)."""
        with self._lock:
            self._inc("shed")

    def record_degraded(self, active: bool) -> None:
        """Degraded-mode gauge: 1 while sustained pressure has switched
        scoring to fixed-effect-only, 0 in full-fidelity mode."""
        with self._lock:
            self.registry.set_gauge(
                "serving.degraded", 1.0 if active else 0.0
            )

    def record_degraded_batch(self) -> None:
        with self._lock:
            self._inc("degraded_batches")

    # -- tiered entity cache (serving/cache.py) ----------------------------

    def record_cache(self, hits: int, misses: int) -> None:
        """One translate() call's hit/miss split — a miss scored
        fixed-effect-only (cold-start semantics) and enqueued an async
        promotion; it never stalled the batch."""
        with self._lock:
            if hits:
                self._inc("cache.hits", hits)
            if misses:
                self._inc("cache.misses", misses)

    def record_promotions(self, n: int) -> None:
        with self._lock:
            self._inc("cache.promotions", n)

    def record_demotions(self, n: int) -> None:
        with self._lock:
            self._inc("cache.demotions", n)

    def record_cache_tier_error(self) -> None:
        """A failed host->HBM promotion batch (e.g. an armed
        ``serving.cache_tier`` fault): the entities stay cold and serve
        fixed-effect-only until the next miss re-enqueues them."""
        with self._lock:
            self._inc("cache.tier_errors")

    def record_admission_logged(self, n: int) -> None:
        """Entity keys recorded into the repeat-miss admission log —
        the lifecycle orchestrator's input for admitting new/cold
        entities into the next training set."""
        with self._lock:
            self._inc("cache.admission_logged", n)

    def record_admission_promoted(self, n: int) -> None:
        """Admission-log entries the lifecycle orchestrator promoted
        into a retrain's entity set (repeat-miss threshold met)."""
        with self._lock:
            self._inc("cache.admission_promoted", n)

    def cache_hit_frac(self) -> float:
        with self._lock:
            hits = self.registry.counter("serving.cache.hits").value
            misses = self.registry.counter("serving.cache.misses").value
        total = hits + misses
        return hits / total if total else 0.0

    # -- entity-sharded serving (serving/sharding.py) ----------------------

    def record_shard_batch(self, counts, device_s: float) -> None:
        """Per-shard occupancy gauges and per-shard device latency
        histograms for one routed batch (``photon_ml_tpu/serving/stats.py:242``).
        The batch scores in one call per device, so the wall attributes to
        every shard that had placements in it."""
        with self._lock:
            for p, rows in enumerate(counts):
                rows = int(rows)
                self.registry.set_gauge(f"serving.shard.occupancy.{p}", rows)
                if rows:
                    self.registry.observe(f"serving.shard.device_ms.{p}", device_s * 1e3)

    def record_shard_degraded(self, shards, rows: int) -> None:
        """A routing fault took shard(s) down for one batch
        (``photon_ml_tpu/serving/stats.py:259``): their entities scored
        fixed-effect-only; every request still completed."""
        with self._lock:
            self._inc("shard.degraded_batches")
            self._inc("shard.degraded_rows", rows)
        from photon_ml_tpu_torch import obs

        obs.emit_event("serving.shard_degraded", cat="serving", shards=list(shards), rows=rows)

    def record_error(self) -> None:
        with self._lock:
            self._inc("errors")

    def record_reload(self) -> None:
        with self._lock:
            self._inc("reloads")

    def record_reload_failure(self) -> None:
        with self._lock:
            self._inc("reload_failures")

    # -- readout -----------------------------------------------------------

    def qps(self) -> float:
        """Recent throughput over the sliding request window (falls back
        to lifetime mean while the window is still filling)."""
        with self._lock:
            if len(self._recent) >= 2:
                span = self._recent[-1] - self._recent[0]
                if span > 0:
                    return (len(self._recent) - 1) / span
            elapsed = time.monotonic() - self.started
            return self.requests / elapsed if elapsed > 0 else 0.0

    def snapshot(self) -> dict:
        qps = self.qps()
        with self._lock:
            requests = self.requests
            batches = self.batches
            return {
                "uptime_s": round(time.monotonic() - self.started, 3),
                "requests": int(requests),
                "batches": int(batches),
                "rejected": int(self.rejected),
                "expired": int(self.expired),
                "shed": int(self.shed),
                "errors": int(self.errors),
                "reloads": int(self.reloads),
                "reload_failures": int(self.reload_failures),
                "degraded_batches": int(self.degraded_batches),
                "degraded": int(
                    self.registry.gauge("serving.degraded").value
                ),
                "qps": round(qps, 2),
                "batch_occupancy_mean": (
                    self.occupancy_sum / batches if batches else 0.0
                ),
                "buckets": {
                    str(k): v for k, v in sorted(self.bucket_counts.items())
                },
                "bucket_hits": int(self.bucket_hits),
                "bucket_misses": int(self.bucket_misses),
                "compile_count": int(self.compile_count),
                "request_latency": self.request_ms.snapshot(),
                "device_latency": self.device_ms.snapshot(),
                "queue_depth": int(
                    self.registry.gauge("serving.queue_depth").value
                ),
                "queue_depth_peak": int(
                    self.registry.gauge("serving.queue_depth_peak").value
                ),
                "bucket_latency": self._bucket_latency_snapshot(),
                "score_distribution": {
                    v: h.summary()
                    for v, h in sorted(self.score_hists.items())
                },
                "cache": self._cache_snapshot(),
                "shards": self._shard_snapshot(),
                "resident_re_bytes_per_process": int(
                    self.registry.gauge(
                        "serving.shard.resident_re_bytes_per_process"
                    ).value
                ),
            }

    def _cache_snapshot(self) -> dict:
        """Tiered-cache counters (all zero when no cache is installed —
        the key is additive, existing schema untouched). Caller holds
        ``self._lock``; registry access takes its own lock."""
        hits = self.registry.counter("serving.cache.hits").value
        misses = self.registry.counter("serving.cache.misses").value
        total = hits + misses
        return {
            "hits": int(hits),
            "misses": int(misses),
            "promotions": int(
                self.registry.counter("serving.cache.promotions").value
            ),
            "demotions": int(
                self.registry.counter("serving.cache.demotions").value
            ),
            "tier_errors": int(
                self.registry.counter("serving.cache.tier_errors").value
            ),
            "hit_frac": round(hits / total, 6) if total else 0.0,
            # additive keys (schema above is golden-tested): the
            # repeat-miss admission log feeding the retrain loop
            "admission_logged": int(
                self.registry.counter(
                    "serving.cache.admission_logged"
                ).value
            ),
            "admission_promoted": int(
                self.registry.counter(
                    "serving.cache.admission_promoted"
                ).value
            ),
        }

    def _shard_snapshot(self) -> dict:
        """Per-shard occupancy gauges + device-latency histograms of the
        entity-sharded engine (empty when serving unsharded)."""
        occ_prefix = "serving.shard.occupancy."
        lat_prefix = "serving.shard.device_ms."
        out: Dict[str, dict] = {}
        for name in self.registry.names(occ_prefix):
            out.setdefault(name[len(occ_prefix):], {})["occupancy"] = int(
                self.registry.gauge(name).value
            )
        for name in self.registry.names(lat_prefix):
            out.setdefault(name[len(lat_prefix):], {})["device_ms"] = (
                self.registry.histogram(name).snapshot()
            )
        return out

    def _bucket_latency_snapshot(self) -> Dict[str, dict]:
        """``{bucket: histogram snapshot}`` for every bucket that has
        recorded device latency. Caller holds ``self._lock``; registry
        access takes its own lock (no ordering cycle: registry methods
        never call back into ServingStats)."""
        prefix = "serving.bucket_ms."
        out: Dict[str, dict] = {}
        for name in self.registry.names(prefix):
            out[name[len(prefix):]] = self.registry.histogram(
                name
            ).snapshot()
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))


class SloTracker:
    """Rolling-window SLO tracking: p99 vs target + error budget.

    Lifetime histograms answer "how has the server done since boot";
    an SLO answers "are we meeting the promise RIGHT NOW and how much
    failure allowance is left". The tracker keeps a bounded window of
    recent requests (at most ``window_s`` seconds and ``max_samples``
    entries — at very high qps the window degrades to the newest
    ``max_samples``, still a current view) and derives:

    - ``p99_ms``: exact 99th percentile over the window,
    - ``violation_rate``: fraction of windowed requests that broke the
      promise (latency > ``target_p99_ms``, or errored),
    - ``error_budget_remaining``: 1 - violation_rate / (1 - objective),
      clamped to [0, 1] — at ``objective=0.99`` a 0.5% violation rate
      has burned half the budget; 0.0 means the SLO is being missed.

    Gauges (``serving.slo.p99_ms``, ``serving.slo.violation_rate``,
    ``serving.slo.error_budget_remaining``) refresh on every snapshot
    and every 256th record, so a Prometheus scrape sees a current view
    without paying the percentile sort per request. Fed by
    ``MicroBatcher`` per request; surfaced by ``cli/serve.py``'s
    ``{"cmd": "slo"}``.
    """

    _GAUGE_EVERY = 256

    def __init__(
        self,
        target_p99_ms: float = 10.0,
        objective: float = 0.99,
        window_s: float = 60.0,
        max_samples: int = 65536,
        registry: Optional[MetricsRegistry] = None,
    ):
        if not (0.0 < objective < 1.0):
            raise ValueError(
                f"objective must be in (0, 1), got {objective}"
            )
        self.target_p99_ms = float(target_p99_ms)
        self.objective = float(objective)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        # (monotonic_ts, latency_ms, violated)
        self._window = collections.deque(maxlen=max_samples)
        self._since_gauge = 0
        self.registry = registry if registry is not None else MetricsRegistry()
        self.total = 0
        self.total_violations = 0

    # -- recording ---------------------------------------------------------

    def record(self, seconds: float, ok: bool = True) -> None:
        ms = seconds * 1e3
        violated = (not ok) or ms > self.target_p99_ms
        now = time.monotonic()
        with self._lock:
            self._window.append((now, ms, violated))
            self.total += 1
            if violated:
                self.total_violations += 1
            self._since_gauge += 1
            refresh = self._since_gauge >= self._GAUGE_EVERY
            if refresh:
                self._since_gauge = 0
        if refresh:
            self.snapshot()

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._window and self._window[0][0] < horizon:
            self._window.popleft()

    # -- readout -----------------------------------------------------------

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            self._prune(now)
            lats = sorted(item[1] for item in self._window)
            violations = sum(1 for item in self._window if item[2])
            total = self.total
            total_violations = self.total_violations
        n = len(lats)
        p99 = lats[min(n - 1, int(0.99 * n))] if n else 0.0
        p50 = lats[n // 2] if n else 0.0
        rate = violations / n if n else 0.0
        allowed = 1.0 - self.objective
        budget = 1.0 - rate / allowed if allowed > 0 else 0.0
        budget = max(0.0, min(1.0, budget))
        out = {
            "target_p99_ms": self.target_p99_ms,
            "objective": self.objective,
            "window_s": self.window_s,
            "window_requests": n,
            "p50_ms": round(p50, 4),
            "p99_ms": round(p99, 4),
            "violations": violations,
            "violation_rate": round(rate, 6),
            "error_budget_remaining": round(budget, 6),
            "slo_met": p99 <= self.target_p99_ms,
            "total_requests": total,
            "total_violations": total_violations,
        }
        self.registry.set_gauge("serving.slo.p99_ms", out["p99_ms"])
        self.registry.set_gauge(
            "serving.slo.violation_rate", out["violation_rate"]
        )
        self.registry.set_gauge(
            "serving.slo.error_budget_remaining",
            out["error_budget_remaining"],
        )
        return out
