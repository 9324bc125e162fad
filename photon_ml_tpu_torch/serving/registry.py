"""Versioned model registry with integrity-gated atomic hot-reload
(counterpart of ``photon_ml_tpu/serving/registry.py``; the entity-sharded
engine behind ``serving_shards`` > 1 is not ported, ROADMAP.md queue A
item 9).

A serving process outlives any single model export: training keeps
publishing new versions, and the engine must pick them up without dropping
traffic. The registry owns that lifecycle:

- **Integrity gate.** A version loads only after its sha256 export
  manifest verifies
  (:func:`photon_ml_tpu_torch.io.models.verify_model_manifest` — the same digest scheme training checkpoints use). A partially-written,
  torn, or tampered export raises before anything is swapped, so a bad
  model can NEVER serve; the previous version keeps answering.

- **Atomic swap.** The new engine is fully constructed AND warmed up
  (bucket scorers built) before the current pointer moves; requests
  racing the swap see either the old or the new version, never a half-
  loaded one, and the steady-state zero-build property holds across
  reloads.

- **Drain-before-retire.** Scoring goes through acquire/release leases:
  the superseded version is retired (device tables released) only after
  its in-flight count reaches zero. A hot-reload under concurrent load
  drops zero requests.

- **Watch mode.** :meth:`ModelRegistry.poll` scans a directory of version
  exports (subdirectories, lexically-newest last) and reloads when a new
  verified version lands — the push-by-filesystem protocol of the
  reference's HDFS model directories.

- **Reload circuit breaker.** A reload/warmup failure used to be
  re-attempted on EVERY poll forever — a broken export turned the watch
  loop into a busy verify/compile loop competing with live traffic.
  Now ``breaker_threshold`` consecutive failures of the same export dir
  quarantine it: the breaker OPENS, polls skip it, and only an
  exponentially-backed-off half-open probe re-attempts; a probe success
  closes the breaker, a failure re-opens it with doubled backoff. The
  last-good version serves throughout (:meth:`ModelRegistry.health`
  exposes the state; ``{"cmd": "health"}`` on ``cli/serve.py``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.io.models import (
    MODEL_MANIFEST,
    ModelIntegrityError,
    verify_model_manifest,
)
from photon_ml_tpu_torch.resilience import faults as _faults
from photon_ml_tpu_torch.serving.engine import ScoringEngine
from photon_ml_tpu_torch.serving.stats import ServingStats


SHARDING_UNPORTED = (
    "entity-sharded serving (serving_shards > 1, serving/sharding.py) is not "
    "ported: ROADMAP.md queue A item 9"
)


class NoModelLoaded(RuntimeError):
    """score/acquire before any version was loaded."""


class ReloadQuarantined(RuntimeError):
    """Load refused: the export dir's breaker is open (too many
    consecutive reload/warmup failures; next probe not yet due)."""


class ReloadCircuitBreaker:
    """Per-export-dir breaker state machine (closed -> open -> half-open).

    - **closed**: attempts allowed; ``threshold`` CONSECUTIVE failures
      open the breaker.
    - **open**: attempts refused until ``backoff_s`` (doubling per
      re-open, capped at ``max_backoff_s``) has elapsed.
    - **half-open**: the first :meth:`allow` after the backoff admits ONE
      probe attempt; success closes the breaker and clears the failure
      count, failure re-opens with doubled backoff.

    Thread-safe; keyed by normalized export path so a republished export
    at the same path probes through the same breaker.
    """

    def __init__(
        self,
        threshold: int = 3,
        backoff_s: float = 30.0,
        max_backoff_s: float = 600.0,
    ):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self._lock = threading.Lock()
        # key -> {failures, next_probe (monotonic), backoff, probing}
        self._dirs: Dict[str, dict] = {}

    @staticmethod
    def _key(root: str) -> str:
        return os.path.normpath(os.path.abspath(root))

    def _entry(self, root: str) -> dict:
        return self._dirs.setdefault(
            self._key(root),
            {"failures": 0, "next_probe": 0.0, "backoff": self.backoff_s,
             "probing": False},
        )

    def state(self, root: str) -> str:
        with self._lock:
            e = self._dirs.get(self._key(root))
            if e is None or e["failures"] < self.threshold:
                return "closed"
            if time.monotonic() >= e["next_probe"]:
                return "half_open"
            return "open"

    def allow(self, root: str) -> bool:
        """True when an attempt on ``root`` may proceed (closed, or
        half-open with the probe slot free)."""
        with self._lock:
            e = self._entry(root)
            if e["failures"] < self.threshold:
                return True
            if time.monotonic() < e["next_probe"]:
                return False
            # half-open: admit one probe at a time
            if e["probing"]:
                return False
            e["probing"] = True
            return True

    def record_failure(self, root: str) -> bool:
        """Count a failed attempt; returns True when this failure OPENED
        (or re-opened) the breaker."""
        with self._lock:
            e = self._entry(root)
            was_open = e["failures"] >= self.threshold
            e["failures"] += 1
            e["probing"] = False
            if e["failures"] < self.threshold:
                return False
            if was_open:
                # failed half-open probe: double the backoff
                e["backoff"] = min(e["backoff"] * 2.0, self.max_backoff_s)
            e["next_probe"] = time.monotonic() + e["backoff"]
            return True

    def record_success(self, root: str) -> None:
        with self._lock:
            self._dirs.pop(self._key(root), None)

    def quarantined(self) -> Dict[str, dict]:
        """Snapshot of every open/half-open dir (the health endpoint)."""
        now = time.monotonic()
        out: Dict[str, dict] = {}
        with self._lock:
            for key, e in self._dirs.items():
                if e["failures"] < self.threshold:
                    continue
                out[key] = {
                    "failures": e["failures"],
                    "backoff_s": round(e["backoff"], 3),
                    "next_probe_in_s": round(
                        max(0.0, e["next_probe"] - now), 3
                    ),
                }
        return out

    def snapshot(self) -> dict:
        quarantined = self.quarantined()
        return {
            "threshold": self.threshold,
            "open_dirs": quarantined,
            "state": "open" if quarantined else "closed",
        }


class ModelVersion:
    """One loaded model version: engine + in-flight lease count."""

    def __init__(self, version_id: str, root: str, engine: ScoringEngine):
        self.version_id = version_id
        self.root = root
        self.engine: Optional[ScoringEngine] = engine
        self.loaded_at = time.monotonic()
        self.inflight = 0
        self.retired = False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"ModelVersion({self.version_id!r}, inflight={self.inflight}, "
            f"retired={self.retired})"
        )


class ModelRegistry:
    """Thread-safe current-version holder with verified hot-reload."""

    def __init__(
        self,
        *,
        engine_factory: Optional[Callable[[str], ScoringEngine]] = None,
        verify: bool = True,
        warmup_max_batch: Optional[int] = 64,
        warmup_degraded: bool = False,
        retire_timeout_s: float = 60.0,
        stats: Optional[ServingStats] = None,
        breaker: Optional[ReloadCircuitBreaker] = None,
        breaker_threshold: int = 3,
        breaker_backoff_s: float = 30.0,
        breaker_max_backoff_s: float = 600.0,
        serving_shards: int = 1,
        logger=None,
        **engine_kwargs,
    ):
        self.stats = stats if stats is not None else ServingStats()
        # entity-sharded serving (serving/sharding.py) is not ported: the
        # registry keeps the parameter and refuses any value but 1
        self.serving_shards = int(serving_shards)
        if self.serving_shards > 1:
            raise NotImplementedError(SHARDING_UNPORTED)
        self._verify = verify
        self._warmup_max_batch = warmup_max_batch
        self._warmup_degraded = warmup_degraded
        self._retire_timeout_s = retire_timeout_s
        self._logger = logger
        self._engine_kwargs = engine_kwargs
        self._factory = engine_factory or self._default_factory
        self._cond = threading.Condition()
        self._current: Optional[ModelVersion] = None
        self._reload_lock = threading.Lock()  # one reload at a time
        self.retired_versions = []  # version ids, oldest first
        self.breaker = (
            breaker
            if breaker is not None
            else ReloadCircuitBreaker(
                threshold=breaker_threshold,
                backoff_s=breaker_backoff_s,
                max_backoff_s=breaker_max_backoff_s,
            )
        )

    def _default_factory(self, root: str) -> ScoringEngine:
        return ScoringEngine.from_model_dir(
            root, stats=self.stats, **self._engine_kwargs
        )

    # -- loading / hot-reload ----------------------------------------------

    def load(
        self,
        root: str,
        version_id: Optional[str] = None,
        force: bool = False,
    ) -> ModelVersion:
        """Verify, build, warm up, then atomically swap in a model export.
        Any failure (integrity, decode, compile) raises WITHOUT touching
        the currently-served version and counts against ``root``'s
        circuit breaker; once open, further loads raise
        :class:`ReloadQuarantined` until a backoff probe is due
        (``force=True`` — the operator's explicit ``{"cmd": "reload"}`` —
        bypasses the quarantine check but still records the outcome).
        The superseded version is retired after its in-flight requests
        drain."""
        version_id = version_id or os.path.basename(
            os.path.normpath(root)
        )
        with self._reload_lock:
            if not force and not self.breaker.allow(root):
                raise ReloadQuarantined(
                    f"export {root!r} is quarantined after "
                    f"{self.breaker.threshold}+ consecutive reload "
                    "failures; next probe pending"
                )
            try:
                # chaos seam: registry load/warmup. raise-mode is the
                # broken-export drill (breaker opens, last-good serves);
                # delay-mode stretches the warmup window under load.
                _faults.fire("serving.reload", key=version_id)
                if self._verify:
                    verify_model_manifest(root)
                engine = self._factory(root)
                if self._warmup_max_batch:
                    engine.warmup(
                        max_batch=self._warmup_max_batch,
                        include_degraded=self._warmup_degraded,
                    )
            except BaseException as e:
                self.stats.record_reload_failure()
                opened = self.breaker.record_failure(root)
                obs.emit_event(
                    "serving.reload_failed",
                    cat="serving",
                    version=version_id,
                    error=repr(e),
                    breaker_opened=opened,
                )
                if opened:
                    obs.registry().inc("serving.breaker_opened")
                    if self._logger is not None:
                        self._logger.warn(
                            f"reload breaker OPEN for {root!r} after "
                            f"repeated failures ({e!r}); last-good "
                            "version keeps serving"
                        )
                raise
            self.breaker.record_success(root)
            version = ModelVersion(version_id, root, engine)
            with self._cond:
                old = self._current
                self._current = version
            if old is not None:
                self.stats.record_reload()
                if self._logger is not None:
                    self._logger.info(
                        f"hot-reloaded model {old.version_id!r} -> "
                        f"{version_id!r}"
                    )
                self._retire(old)
            return version

    def _retire(self, version: ModelVersion) -> None:
        """Wait for the version's in-flight requests to drain, then drop
        its engine (releasing the device-resident tables)."""
        deadline = time.monotonic() + self._retire_timeout_s
        with self._cond:
            while version.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    if self._logger is not None:
                        self._logger.warn(
                            f"retiring {version.version_id!r} with "
                            f"{version.inflight} request(s) still in flight "
                            f"after {self._retire_timeout_s}s"
                        )
                    break
                self._cond.wait(remaining)
            version.retired = True
            if version.engine is not None:
                # release background resources (cache promotion workers)
                # WITH the device tables — a retired version must not
                # keep promoting rows into tiers nobody scores against
                version.engine.close()
            version.engine = None
            self.retired_versions.append(version.version_id)

    # -- leases ------------------------------------------------------------

    @property
    def current(self) -> Optional[ModelVersion]:
        with self._cond:
            return self._current

    def version(self) -> Optional[str]:
        v = self.current
        return v.version_id if v is not None else None

    def acquire(self) -> ModelVersion:
        """Lease the current version for one scoring call; MUST be paired
        with :meth:`release` (use :meth:`score` unless you need the engine
        directly)."""
        with self._cond:
            v = self._current
            if v is None:
                raise NoModelLoaded("no model version loaded")
            v.inflight += 1
            return v

    def release(self, version: ModelVersion) -> None:
        with self._cond:
            version.inflight -= 1
            self._cond.notify_all()

    def score(self, requests: Sequence[object]) -> np.ndarray:
        """Score through the current version under a lease — the
        ``score_fn`` to hand a :class:`~photon_ml_tpu_torch.serving.batcher.
        MicroBatcher`."""
        v = self.acquire()
        try:
            scores = v.engine.score(requests)
            # per-version score-distribution histogram: "did the score
            # distribution move when the model did" straight from one
            # stats snapshot (serving.stats.record_scores)
            self.stats.record_scores(v.version_id, scores)
            return scores
        finally:
            self.release(v)

    def score_fixed_only(self, requests: Sequence[object]) -> np.ndarray:
        """Degraded-mode scorer (fixed effects only, no random-effect
        gathers) — the ``degraded_score_fn`` for the batcher's
        sustained-pressure fallback."""
        v = self.acquire()
        try:
            return v.engine.score(requests, fixed_only=True)
        finally:
            self.release(v)

    # -- health ------------------------------------------------------------

    def health(self) -> dict:
        """Version + breaker state for the serve ``{"cmd": "health"}``
        endpoint."""
        v = self.current
        drift = None
        if v is not None and v.engine is not None:
            monitor = getattr(v.engine, "drift", None)
            if monitor is not None:
                snap = monitor.snapshot()
                drift = {
                    "checks": snap["checks"],
                    "alarms": snap["alarms"],
                    "psi_max": (
                        snap["last_report"]["psi_max"]
                        if snap["last_report"]
                        else None
                    ),
                }
        cache = None
        admission = None
        if v is not None and v.engine is not None:
            snap = getattr(v.engine, "cache_snapshot", lambda: None)()
            if snap is not None:
                cache = snap
            admission = getattr(
                v.engine, "admission_snapshot", lambda: None
            )()
        return {
            "version": v.version_id if v is not None else None,
            "inflight": v.inflight if v is not None else 0,
            "reloads": int(self.stats.reloads),
            "reload_failures": int(self.stats.reload_failures),
            "retired_versions": list(self.retired_versions),
            "breaker": self.breaker.snapshot(),
            "drift": drift,
            "serving_shards": self.serving_shards,
            "cache": cache,
            "admission_log": admission,
        }

    # -- watch mode --------------------------------------------------------

    def poll(self, watch_root: str) -> Optional[str]:
        """Scan ``watch_root`` for version subdirectories carrying a model
        manifest; when the lexically newest differs from the current
        version, hot-reload it. Returns the newly-loaded version id, or
        None — the current version keeps serving when the candidate fails
        to load. A failing candidate counts against its breaker: once
        open, subsequent polls SKIP it (no verify/compile churn against
        live traffic) until a backoff probe is due."""
        if not os.path.isdir(watch_root):
            return None
        candidates = sorted(
            name
            for name in os.listdir(watch_root)
            if os.path.exists(
                os.path.join(watch_root, name, MODEL_MANIFEST)
            )
        )
        if not candidates:
            return None
        newest = candidates[-1]
        if self.version() == newest:
            return None
        root = os.path.join(watch_root, newest)
        if not self.breaker.allow(root):
            return None  # quarantined; next backoff probe will re-try
        try:
            # force=True: allow() above already consumed the half-open
            # probe slot; load() must not re-ask (it would refuse the
            # probe it was granted)
            self.load(root, version_id=newest, force=True)
        except (ModelIntegrityError, OSError, ValueError, RuntimeError) as e:
            if self._logger is not None:
                self._logger.warn(
                    f"candidate version {newest!r} failed to load ({e}); "
                    "keeping the current model"
                )
            return None
        return newest
