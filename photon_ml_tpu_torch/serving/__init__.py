"""Online serving (counterpart of ``photon_ml_tpu/serving``): the resident
low-latency GAME scorer and what stands around it.

- :mod:`.engine`   — device-resident ScoringEngine; power-of-two padded
  buckets whose scorers are built once, so steady-state traffic builds
  nothing; cold-start entities score fixed-effect-only; a fixed-effect-
  only degraded mode for overload. ``bucket_size`` / ``pad_game_data``
  are also the offline driver's padded-batch policy.
- :mod:`.batcher`  — deadline micro-batching (max_batch / max_wait_ms),
  per-request deadlines, bounded-queue admission control (priority shed
  policy), sustained-pressure degrade-to-fixed-effects, drain-on-SIGTERM.
- :mod:`.registry` — versioned models, sha256-manifest-gated atomic
  hot-reload, drain-before-retire, reload circuit breaker.
- :mod:`.stats`    — latency histograms, QPS, batch occupancy,
  bucket/build counters, shed/expired/degraded counters; JSON snapshots.
- :mod:`.cache`    — tiered device/host entity cache: the hot head of
  each entity table in a device tier, the cold tail in host RAM, async
  promotion off the scoring path; a miss scores fixed-effect-only.

Entry point: ``python -m photon_ml_tpu_torch.cli.serve``. Not ported: the
entity-sharded engine (``serving/sharding.py``, ROADMAP.md queue A item
9).
"""

from photon_ml_tpu_torch.serving.batcher import (
    Backpressure,
    DeadlineExceeded,
    MicroBatcher,
)
from photon_ml_tpu_torch.serving.cache import TieredEntityCache
from photon_ml_tpu_torch.serving.engine import (
    DEFAULT_MIN_BUCKET,
    ScoreRequest,
    ScoringEngine,
    SharedCompileCache,
    bucket_size,
    pad_game_data,
    warmup_buckets,
)
from photon_ml_tpu_torch.serving.registry import (
    ModelRegistry,
    ModelVersion,
    NoModelLoaded,
    ReloadCircuitBreaker,
    ReloadQuarantined,
)
from photon_ml_tpu_torch.serving.stats import (
    LatencyHistogram,
    ServingStats,
    SloTracker,
    bucket_builds,
)

__all__ = [
    "TieredEntityCache",
    "Backpressure",
    "DeadlineExceeded",
    "MicroBatcher",
    "DEFAULT_MIN_BUCKET",
    "ScoreRequest",
    "ScoringEngine",
    "SharedCompileCache",
    "bucket_size",
    "pad_game_data",
    "warmup_buckets",
    "ModelRegistry",
    "ModelVersion",
    "NoModelLoaded",
    "ReloadCircuitBreaker",
    "ReloadQuarantined",
    "LatencyHistogram",
    "ServingStats",
    "SloTracker",
    "bucket_builds",
]
