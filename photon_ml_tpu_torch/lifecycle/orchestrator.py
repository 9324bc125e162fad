"""The retrain orchestrator: drift alarm -> warm-started retrain ->
manifest-gated export -> hot-reload, with every stage a named fault
site and a defined degraded outcome (a copy of
``photon_ml_tpu/lifecycle/orchestrator.py``; the retrain leg it drives on
the card is the port's GAME driver, whose fixed effect runs the CUDA
kernels).

The loop (docs/LIFECYCLE.md has the full walkthrough)::

    trigger --> plan --> retrain --> export gate --> reload --> verify
      |          |          |            |              |         |
      |     admission   warm-start   manifest       breaker    drift
      |     log + conv  entity-     verification   guarded    re-check
      |     health      KEYED       (partial        swap      (alarm
      |                 (never by   export never               clears)
      |                 position)   serves)
      +--- no alarm: nothing to do (the cheap steady-state path)

Degraded outcomes are the design center, not the error path: a failed
stage (after its in-cycle retries) fails the CYCLE — the old model
keeps serving, the alarm stays latched, and the next cycle retries
after an exponential backoff. Nothing in this module ever touches the
scoring path directly; the serving registry's reload breaker remains
the last line of defense against a bad retrain that makes it all the
way to an export.

Stage fault sites (resilience/faults.py):

- ``retrain.warm_start`` — the prior-export load. raise = unreadable
  export; corrupt = torn/poisoned warm start that
  :func:`load_warm_start`'s finiteness gate must catch.
- ``retrain.export``     — the re-export. raise = export dies mid-write
  (no manifest lands, the registry never sees the partial dir);
  corrupt = a torn payload written AFTER the manifest, which the
  integrity gate + reload breaker must quarantine.
- ``serving.reload`` / ``cache.admission_log`` participate from their
  own layers.

Warm starts are ENTITY-KEYED end to end: the default GAME path rides
``initial_model_dir`` (``load_game_model`` re-keys rows by raw entity
id into the new run's vocabulary) and checkpoint-based paths ride
:func:`~photon_ml_tpu_torch.io.checkpoint.reindex_entity_params`. A
positional warm start misattributes rows whenever the entity set changes;
nothing here indexes a prior table by row number.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.resilience import faults as _faults

__all__ = [
    "CycleResult",
    "LifecycleError",
    "RetrainOrchestrator",
    "RetrainPlan",
    "StageResult",
    "WarmStartError",
    "export_retrained_model",
    "fingerprint_drift_trigger",
    "latest_version_dir",
    "load_admission_candidates",
    "load_warm_start",
    "next_version_dir",
    "registry_drift_trigger",
    "select_retrain_targets",
]


class LifecycleError(Exception):
    """A lifecycle stage failed in a way retries cannot mask."""


class WarmStartError(LifecycleError):
    """The prior export loaded but its parameters are unusable (non-
    finite values — a torn write or an injected corruption). The cycle
    must fail rather than retrain from poison: a NaN warm start
    converges to a NaN model that the export gate cannot catch."""


# ---------------------------------------------------------------------------
# stage helpers (the named fault seams)
# ---------------------------------------------------------------------------


def load_warm_start(export_dir: str):
    """Load the previous export as the retrain's warm start — entity-
    keyed by construction (``load_game_model_auto`` returns per-RE-type
    ``{raw_id: row}`` vocabularies; consumers re-key by id, never by
    position). Probes the ``retrain.warm_start`` fault site and gates
    the result on finiteness, so a corrupt prior export fails the
    cycle instead of seeding a poisoned retrain.

    Returns ``(params, shards, random_effects, shard_vocabs,
    re_vocabs)`` exactly like ``load_game_model_auto``. The port's loaded
    leaves may be tensors (a factored table's ``gamma`` and
    ``projection``): the gate and the seam read them as host arrays."""
    from photon_ml_tpu_torch.io.models import load_game_model_auto
    from photon_ml_tpu_torch.utils.device import to_numpy

    action = _faults.fire("retrain.warm_start", key=export_dir)
    loaded = load_game_model_auto(export_dir)
    params = dict(loaded[0])
    if action is not None and action.corrupt:
        # chaos seam payload: poison one table the way a torn read
        # would — the finiteness gate below must refuse it
        name = sorted(params)[0]
        table = params[name]
        if hasattr(table, "gamma"):
            table = table.gamma
        poisoned = np.array(to_numpy(table), dtype=float)
        poisoned.reshape(-1)[0] = np.nan
        params[name] = poisoned
    for name, table in params.items():
        leaves = (
            (to_numpy(table.gamma), to_numpy(table.projection))
            if hasattr(table, "gamma")
            else (to_numpy(table),)
        )
        for leaf in leaves:
            if leaf.dtype.kind == "f" and not np.all(np.isfinite(leaf)):
                raise WarmStartError(
                    f"{export_dir}: warm-start coordinate {name!r} has "
                    "non-finite values"
                )
    return (params,) + tuple(loaded[1:])


def export_retrained_model(
    root: str,
    params: Dict[str, object],
    shards: Dict[str, str],
    vocabs: Dict[str, object],
    entity_vocabs: Dict[str, dict],
    random_effects: Dict[str, Optional[str]],
    task=None,
    fingerprint=None,
) -> str:
    """Export a retrained model through the existing manifest gate,
    probing the ``retrain.export`` fault site at the mid-export seam:

    - raise-mode fires AFTER the payload but BEFORE the manifest — the
      partial directory carries no ``model-manifest.json``, so registry
      ``poll()`` never even considers it (the cheapest degraded
      outcome).
    - corrupt-mode tears a manifest-covered file AFTER the manifest is
      sealed — the export looks complete, and the serving integrity
      gate + reload breaker must quarantine it.

    Feature vocabularies save as ``feature-index-<shard>.txt`` at the
    export root (the layout ``load_game_model_auto`` resolves).
    Returns ``root``."""
    from photon_ml_tpu_torch.io.models import save_game_model, write_model_manifest

    save_game_model(
        root,
        params=params,
        shards=shards,
        vocabs=vocabs,
        entity_vocabs=entity_vocabs,
        random_effects=random_effects,
        task=task,
    )
    for shard in sorted({s for s in shards.values()}):
        for name, vocab in vocabs.items():
            if shards[name] == shard:
                vocab.save(os.path.join(root, f"feature-index-{shard}.txt"))
                break
    if fingerprint is not None:
        fingerprint.save(root)
    # chaos seam: the mid-export fault. Everything above is payload;
    # everything below is the integrity seal.
    action = _faults.fire("retrain.export", key=root)
    manifest = write_model_manifest(root)
    if action is not None and action.corrupt:
        import json

        with open(manifest) as f:
            covered = sorted(json.load(f)["digests"])
        _faults.corrupt_file(os.path.join(root, covered[0]))
    return root


def next_version_dir(watch_root: str, prefix: str = "v") -> str:
    """The next lexically-newest version directory name under a serving
    watch root (``v0001``, ``v0002``, ...). Registry ``poll()`` loads
    the lexically newest manifest-bearing subdirectory, so zero-padded
    monotone names ARE the publish ordering."""
    highest = 0
    if os.path.isdir(watch_root):
        for name in os.listdir(watch_root):
            if name.startswith(prefix) and name[len(prefix):].isdigit():
                highest = max(highest, int(name[len(prefix):]))
    return os.path.join(watch_root, f"{prefix}{highest + 1:04d}")


def latest_version_dir(
    watch_root: str, *, verified: bool = False
) -> Optional[str]:
    """The lexically-newest subdirectory carrying a model manifest —
    the warm-start source (same selection rule as registry polling).

    With ``verified=True``, exports whose manifest fails content
    verification are skipped (newest-first): a torn export — sealed
    but corrupted after sealing — must never become a warm-start
    source, mirroring the serving-side breaker quarantine."""
    from photon_ml_tpu_torch.io.models import MODEL_MANIFEST

    if not os.path.isdir(watch_root):
        return None
    candidates = sorted(
        name
        for name in os.listdir(watch_root)
        if os.path.exists(os.path.join(watch_root, name, MODEL_MANIFEST))
    )
    if not verified:
        if not candidates:
            return None
        return os.path.join(watch_root, candidates[-1])
    from photon_ml_tpu_torch.io.models import verify_model_manifest

    for name in reversed(candidates):
        path = os.path.join(watch_root, name)
        try:
            verify_model_manifest(path)
        except Exception:
            continue
        return path
    return None


# ---------------------------------------------------------------------------
# plan inputs: admission log + convergence health
# ---------------------------------------------------------------------------


def load_admission_candidates(
    path: Optional[str],
    min_misses: int = 2,
    max_per_key: Optional[int] = None,
) -> Dict[str, List[str]]:
    """Repeat-missed entity keys from a persisted admission log
    (serving/cache.py's atomic-swap file), most-missed first per RE
    key. A missing/torn log reads as empty — admission is an
    optimization, never a cycle blocker."""
    if not path:
        return {}
    from photon_ml_tpu_torch.serving.cache import AdmissionLog

    out: Dict[str, List[str]] = {}
    for rk, ents in AdmissionLog.load(path).items():
        keys = [
            k for k, v in ents.items() if v["misses"] >= int(min_misses)
        ]
        keys.sort(key=lambda k: (-ents[k]["misses"], k))
        if max_per_key is not None:
            keys = keys[: int(max_per_key)]
        if keys:
            out[rk] = keys
    return out


def select_retrain_targets(
    report: Optional[dict],
    nonconverged_threshold: float = 0.05,
    worst_k: int = 8,
) -> dict:
    """Which coordinates need the retrain, from a convergence
    report (``convergence-report.json``): a coordinate whose
    ``nonconverged_frac`` is at/above the threshold retrains; healthy
    coordinates FREEZE (warm-started and carried bit-identical, not
    re-fit — the paper's incremental per-entity refit made cheap).
    ``worst_entities`` carries each retrained coordinate's worst-k
    table ids for logging/targeting. No report (first cycle, or
    reports disabled) retrains everything and freezes nothing."""
    if not report or not report.get("coordinates"):
        return {"retrain": None, "freeze": [], "worst_entities": {}}
    retrain: List[str] = []
    freeze: List[str] = []
    worst: Dict[str, list] = {}
    for name, stats in sorted(report["coordinates"].items()):
        frac = float(stats.get("nonconverged_frac", 0.0))
        if frac >= nonconverged_threshold:
            retrain.append(name)
            worst[name] = list(stats.get("worst_entities", []))[:worst_k]
        else:
            freeze.append(name)
    if not retrain:
        # the alarm fired but every coordinate converged cleanly last
        # run: the drift is in the DATA, so everything refits
        return {"retrain": None, "freeze": [], "worst_entities": {}}
    return {"retrain": retrain, "freeze": freeze, "worst_entities": worst}


# ---------------------------------------------------------------------------
# triggers
# ---------------------------------------------------------------------------


def registry_drift_trigger(
    registry, psi_alarm: Optional[float] = None
) -> Callable[[], Optional[dict]]:
    """Trigger from a live serving registry's health surface: fires on
    any DriftMonitor alarm (or on ``psi_max >= psi_alarm`` when given a
    threshold of its own)."""

    def check() -> Optional[dict]:
        drift = (registry.health() or {}).get("drift")
        if not drift:
            return None
        psi = drift.get("psi_max")
        if drift.get("alarms", 0) > 0 or (
            psi_alarm is not None and psi is not None and psi >= psi_alarm
        ):
            return {"source": "registry", **drift}
        return None

    return check


def fingerprint_drift_trigger(
    baseline_dir: str, current_dir: str, psi_alarm: float = 0.25
) -> Callable[[], Optional[dict]]:
    """Trigger with ``photon-obs drift`` semantics, in-process: compare
    two quality-fingerprint exports; fire when the report alarms. An
    unreadable fingerprint does NOT trigger (same degraded stance as
    serving without drift monitoring: you cannot retrain your way out
    of missing observability)."""

    def check() -> Optional[dict]:
        from photon_ml_tpu_torch.obs.quality import (
            compare_fingerprints,
            try_load_fingerprint,
        )

        base = try_load_fingerprint(baseline_dir)
        cur = try_load_fingerprint(current_dir)
        if base is None or cur is None:
            return None
        report = compare_fingerprints(base, cur, psi_alarm=psi_alarm)
        if report.get("alarm"):
            return {"source": "fingerprint", **report}
        return None

    return check


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StageResult:
    name: str
    ok: bool
    attempts: int
    seconds: float
    error: Optional[str] = None


@dataclasses.dataclass
class RetrainPlan:
    """What one cycle intends to do — the ``photon-retrain plan``
    surface and the argument every injected ``retrain_fn`` receives."""

    reason: dict
    # RE key -> promoted entity keys (repeat-missed in serving)
    admitted: Dict[str, List[str]]
    # None = retrain every coordinate (no convergence report)
    retrain_coordinates: Optional[List[str]]
    freeze_coordinates: List[str]
    worst_entities: Dict[str, list]
    warm_start_dir: Optional[str]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CycleResult:
    ok: bool
    triggered: bool
    skipped: bool = False
    stage: Optional[str] = None  # the failed stage, None when ok
    stages: List[StageResult] = dataclasses.field(default_factory=list)
    plan: Optional[RetrainPlan] = None
    export_dir: Optional[str] = None
    version: Optional[str] = None
    cycle_s: float = 0.0
    next_retry_s: Optional[float] = None


class _StageFailed(Exception):
    def __init__(self, result: StageResult):
        super().__init__(result.error)
        self.result = result


class RetrainOrchestrator:
    """Drives alarm -> retrain -> reload cycles with per-stage retry
    and cycle-level exponential backoff.

    The train/reload legs are injected callables so the same
    orchestration (and the same fault sites and degraded outcomes)
    serves the real CLI wiring, the chaos drill, and the tests:

    - ``trigger()`` -> truthy reason dict when drift demands a retrain
      (see :func:`registry_drift_trigger` /
      :func:`fingerprint_drift_trigger`).
    - ``retrain_fn(plan)`` -> path of the new export directory. It is
      expected to warm-start entity-keyed from ``plan.warm_start_dir``
      (:func:`load_warm_start`) and to publish through
      :func:`export_retrained_model` (or the GAME driver's own
      manifest-gated export).
    - ``reload_fn(export_dir)`` -> served version id (falsy = the swap
      did not happen). Typically ``registry.poll(watch_root)`` so the
      reload breaker stays in the loop.
    - ``verify_fn()`` -> post-reload drift report (``{"alarm": ...,
      "psi_max": ...}``) or None to skip verification.

    Failure semantics (the contract the chaos drill proves): any stage
    failing after ``max_stage_attempts`` fails the cycle; the old model
    keeps serving, the alarm stays LATCHED, and :meth:`run_cycle`
    refuses to start again until the backoff expires (``force=True``
    overrides). A clean verify clears the latch and resets the
    backoff."""

    def __init__(
        self,
        trigger: Callable[[], Optional[dict]],
        retrain_fn: Callable[[RetrainPlan], str],
        reload_fn: Callable[[str], Optional[str]],
        verify_fn: Optional[Callable[[], Optional[dict]]] = None,
        *,
        watch_root: Optional[str] = None,
        admission_log_path: Optional[str] = None,
        admission_min_misses: int = 2,
        admission_max_per_key: Optional[int] = None,
        convergence_report_path: Optional[str] = None,
        nonconverged_threshold: float = 0.05,
        max_stage_attempts: int = 2,
        stage_backoff_s: float = 0.05,
        cycle_backoff_s: float = 1.0,
        cycle_backoff_mult: float = 2.0,
        max_cycle_backoff_s: float = 600.0,
        stats=None,
        sleep: Callable[[float], None] = time.sleep,
        logger=None,
    ):
        self.trigger = trigger
        self.retrain_fn = retrain_fn
        self.reload_fn = reload_fn
        self.verify_fn = verify_fn
        self.watch_root = watch_root
        self.admission_log_path = admission_log_path
        self.admission_min_misses = admission_min_misses
        self.admission_max_per_key = admission_max_per_key
        self.convergence_report_path = convergence_report_path
        self.nonconverged_threshold = nonconverged_threshold
        self.max_stage_attempts = max(1, int(max_stage_attempts))
        self.stage_backoff_s = stage_backoff_s
        self.cycle_backoff_s = cycle_backoff_s
        self.cycle_backoff_mult = cycle_backoff_mult
        self.max_cycle_backoff_s = max_cycle_backoff_s
        self.stats = stats
        self._sleep = sleep
        self._logger = logger
        self.alarm_latched = False
        self.consecutive_failures = 0
        self._not_before = 0.0
        self.last_result: Optional[CycleResult] = None

    # -- stage machinery ---------------------------------------------------

    def _run_stage(self, name: str, fn: Callable[[], object], out: list):
        """One named stage with bounded in-cycle retries. Returns the
        stage's value; raises :class:`_StageFailed` when attempts are
        exhausted (the cycle's failure path)."""
        t0 = time.perf_counter()
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_stage_attempts + 1):
            try:
                value = fn()
                out.append(
                    StageResult(
                        name, True, attempt, time.perf_counter() - t0
                    )
                )
                return value
            except Exception as e:  # noqa: BLE001 — every stage error
                # has the same degraded outcome: the old model serves
                last = e
                obs.registry().inc("lifecycle.stage_failures")
                if attempt < self.max_stage_attempts:
                    obs.emit_event(
                        "lifecycle.stage_retry",
                        cat="lifecycle",
                        stage=name,
                        attempt=attempt,
                        error=repr(e),
                    )
                    self._sleep(self.stage_backoff_s * (2 ** (attempt - 1)))
        result = StageResult(
            name,
            False,
            self.max_stage_attempts,
            time.perf_counter() - t0,
            error=repr(last),
        )
        out.append(result)
        raise _StageFailed(result)

    def _plan(self, reason: dict) -> RetrainPlan:
        admitted = load_admission_candidates(
            self.admission_log_path,
            min_misses=self.admission_min_misses,
            max_per_key=self.admission_max_per_key,
        )
        n_admitted = sum(len(v) for v in admitted.values())
        if n_admitted:
            # the promotion counter pairs with the cache's
            # serving.cache.admission_logged
            if self.stats is not None:
                self.stats.record_admission_promoted(n_admitted)
            else:
                obs.registry().inc(
                    "serving.cache.admission_promoted", n_admitted
                )
            obs.registry().inc("lifecycle.admitted_entities", n_admitted)
        report = None
        if self.convergence_report_path and os.path.exists(
            self.convergence_report_path
        ):
            import json

            try:
                with open(self.convergence_report_path) as f:
                    report = json.load(f)
            except (OSError, ValueError):
                report = None  # health input lost: retrain everything
        targets = select_retrain_targets(
            report, nonconverged_threshold=self.nonconverged_threshold
        )
        warm = (
            latest_version_dir(self.watch_root, verified=True)
            if self.watch_root
            else None
        )
        return RetrainPlan(
            reason=reason,
            admitted=admitted,
            retrain_coordinates=targets["retrain"],
            freeze_coordinates=targets["freeze"],
            worst_entities=targets["worst_entities"],
            warm_start_dir=warm,
        )

    # -- the cycle ---------------------------------------------------------

    def run_cycle(self, force: bool = False) -> CycleResult:
        """One full cycle. Steady state (no alarm) is one trigger probe;
        a latched alarm inside its backoff window is a no-op skip."""
        now = time.monotonic()
        if not force and now < self._not_before:
            result = CycleResult(
                ok=False,
                triggered=True,
                skipped=True,
                next_retry_s=round(self._not_before - now, 3),
            )
            self.last_result = result
            return result
        t0 = time.perf_counter()
        stages: List[StageResult] = []
        obs.registry().inc("lifecycle.cycles")
        try:
            with obs.span("lifecycle.cycle"):
                reason = self._run_stage(
                    "trigger", self.trigger, stages
                )
                if not reason and not self.alarm_latched:
                    result = CycleResult(
                        ok=True,
                        triggered=False,
                        stages=stages,
                        cycle_s=time.perf_counter() - t0,
                    )
                    self.last_result = result
                    return result
                if not self.alarm_latched:
                    self.alarm_latched = True
                    obs.registry().set_gauge("lifecycle.alarm_latched", 1)
                    obs.emit_event(
                        "lifecycle.alarm_latched",
                        cat="lifecycle",
                        reason=reason,
                    )
                reason = dict(reason or {"source": "latched"})
                plan = self._run_stage(
                    "plan", lambda: self._plan(reason), stages
                )
                export_dir = self._run_stage(
                    "retrain", lambda: self.retrain_fn(plan), stages
                )
                # defense in depth BEFORE asking the registry: a partial
                # export must fail here, not burn a breaker probe
                self._run_stage(
                    "export_gate",
                    lambda: self._verify_export(export_dir),
                    stages,
                )
                version = self._run_stage(
                    "reload",
                    lambda: self._reload(export_dir),
                    stages,
                )
                self._run_stage("verify", self._verify_recovery, stages)
        except _StageFailed as e:
            return self._fail(e.result.name, stages, t0)
        # success: clear the latch, reset the backoff
        self.alarm_latched = False
        self.consecutive_failures = 0
        self._not_before = 0.0
        cycle_s = time.perf_counter() - t0
        obs.registry().inc("lifecycle.retrains")
        obs.registry().set_gauge("lifecycle.retrain_cycle_s", cycle_s)
        obs.registry().set_gauge("lifecycle.alarm_latched", 0)
        obs.emit_event(
            "lifecycle.cycle_completed",
            cat="lifecycle",
            export_dir=export_dir,
            version=version,
            cycle_s=round(cycle_s, 3),
            admitted=sum(len(v) for v in plan.admitted.values()),
        )
        if self._logger is not None:
            self._logger.info(
                f"lifecycle cycle complete: serving {version} "
                f"from {export_dir} ({cycle_s:.2f}s)"
            )
        result = CycleResult(
            ok=True,
            triggered=True,
            stages=stages,
            plan=plan,
            export_dir=export_dir,
            version=version,
            cycle_s=cycle_s,
        )
        self.last_result = result
        return result

    def _verify_export(self, export_dir: str) -> bool:
        from photon_ml_tpu_torch.io.models import verify_model_manifest

        verify_model_manifest(export_dir)
        return True

    def _reload(self, export_dir: str) -> str:
        version = self.reload_fn(export_dir)
        if not version:
            raise LifecycleError(
                f"reload did not swap to {export_dir!r} (breaker open "
                "or candidate rejected)"
            )
        return version

    def _verify_recovery(self) -> Optional[dict]:
        if self.verify_fn is None:
            return None
        report = self.verify_fn()
        if report and report.get("alarm"):
            raise LifecycleError(
                "post-retrain drift still alarming "
                f"(psi_max={report.get('psi_max')})"
            )
        return report

    def _fail(
        self, stage: str, stages: List[StageResult], t0: float
    ) -> CycleResult:
        """The defined degraded outcome: old model keeps serving, alarm
        stays latched, next cycle backs off exponentially."""
        self.consecutive_failures += 1
        backoff = min(
            self.cycle_backoff_s
            * (self.cycle_backoff_mult ** (self.consecutive_failures - 1)),
            self.max_cycle_backoff_s,
        )
        self._not_before = time.monotonic() + backoff
        obs.registry().inc("lifecycle.cycle_failures")
        obs.emit_event(
            "lifecycle.cycle_failed",
            cat="lifecycle",
            stage=stage,
            failures=self.consecutive_failures,
            backoff_s=round(backoff, 3),
        )
        if self._logger is not None:
            self._logger.warn(
                f"lifecycle cycle failed at stage {stage!r} "
                f"(failure #{self.consecutive_failures}); old model "
                f"keeps serving, retry in {backoff:.1f}s"
            )
        result = CycleResult(
            ok=False,
            triggered=True,
            stage=stage,
            stages=stages,
            cycle_s=time.perf_counter() - t0,
            next_retry_s=backoff,
        )
        self.last_result = result
        return result

    # -- watch mode --------------------------------------------------------

    def watch(
        self,
        poll_s: float = 30.0,
        max_cycles: Optional[int] = None,
        shutdown=None,
    ) -> int:
        """Cron-less mode: poll the trigger forever (or ``max_cycles``
        probes), honoring a GracefulShutdown. Returns the number of
        SUCCESSFUL retrains."""
        retrains = 0
        cycles = 0
        while max_cycles is None or cycles < max_cycles:
            if shutdown is not None and getattr(
                shutdown, "requested", False
            ):
                break
            result = self.run_cycle()
            cycles += 1
            if result.ok and result.triggered:
                retrains += 1
            if max_cycles is not None and cycles >= max_cycles:
                break
            self._sleep(poll_s)
        return retrains
