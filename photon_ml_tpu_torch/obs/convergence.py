"""Convergence-health layer: decode solver tapes after the solve (a copy of
``photon_ml_tpu/obs/convergence.py``).

The reference ships OptimizationStatesTracker + ModelTracker
(``optimization/OptimizationStatesTracker.scala``,
``supervised/model/ModelTracker.scala``) because GLM debugging is
convergence debugging. The port's solvers record per-iteration tapes on
the solve's device (``solvers/common.SolverResult``: values, grad norms,
trust-region radius + CG steps for TRON, step size + evaluations for
L-BFGS/OWL-QN/Newton); its loop counters are host ints. This module reads
them:

- :func:`decode_result` — one completed :class:`SolverResult` (tapes
  truncated past ``iterations``) -> a :class:`ConvergenceReport`:
  ConvergenceReason, linear/superlinear rate estimate, plateau / stall /
  oscillation detection, the truncated tapes themselves.
- :func:`fleet_summary` — the batched GAME regime: the per-entity solves
  of one coordinate update collapse to an iterations-to-converge
  histogram, non-converged entity count/fraction, and the worst-k
  entities by final gradient norm (``convergence.precursor`` events fire
  on a high non-converged fraction or any non-finite per-entity
  gradient).
- :func:`note_solve` / :func:`note_update` — route reports into the
  instruments: ``convergence.*`` registry metrics, structured
  ``convergence.solve`` / ``convergence.fleet`` events (which also ride
  the tracer's hook into the flight recorder), Chrome counter tracks
  replaying a solve's value/grad curves under its span, and an installed
  :class:`ConvergenceTracker` (the ``convergence_report`` surface).

Everything here is host-side numpy over tapes read from the device; the
recording paths are gated by the callers (an active tracer or an
installed tracker), so an untraced run reads nothing more.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ConvergenceReport",
    "FleetSummary",
    "ConvergenceTracker",
    "analyze_history",
    "decode_result",
    "fleet_summary",
    "note_solve",
    "note_update",
    "emit_tape_counters",
    "install_convergence_tracker",
    "uninstall_convergence_tracker",
    "convergence_tracker",
    "tracking_enabled",
]

# non-converged fraction above which a coordinate update emits a
# `convergence.precursor` event — the fleet-level early-warning the
# divergence guard (non-finite objective, one update later) lacks
PRECURSOR_NONCONVERGED_FRAC = 0.5
# how many trailing grad-norm ratios the rate estimate uses
_RATE_WINDOW = 6


# lazy taxonomy caches: the solvers package imports torch, which this
# module does not need at import
_REASON_NAMES: Dict[int, str] = {}
_NONCONVERGED: Optional[Tuple[int, int]] = None


def _reason_name(code) -> str:
    code = int(code)
    if not _REASON_NAMES:
        from photon_ml_tpu_torch.solvers.common import ConvergenceReason

        _REASON_NAMES.update({int(r): r.name for r in ConvergenceReason})
    return _REASON_NAMES.get(code, f"UNKNOWN_{code}")


def _nonconverged_codes() -> Tuple[int, int]:
    global _NONCONVERGED
    if _NONCONVERGED is None:
        from photon_ml_tpu_torch.solvers.common import ConvergenceReason

        _NONCONVERGED = (
            int(ConvergenceReason.NOT_CONVERGED),
            int(ConvergenceReason.MAX_ITERATIONS),
        )
    return _NONCONVERGED


# ---------------------------------------------------------------------------
# Per-solve decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConvergenceReport:
    """Post-solve decode of one scalar :class:`SolverResult`."""

    optimizer: str
    iterations: int
    reason: str
    final_value: float
    final_grad_norm: float
    # estimated asymptotic contraction ratio g_{k+1}/g_k over the last
    # few iterations (None when the tape is too short)
    rate: Optional[float]
    # "superlinear" | "linear" | "sublinear" | "stalled" | "unknown"
    order: str
    # trailing iterations whose relative objective change stayed below
    # tolerance while the gradient had NOT converged (a plateau/stall)
    plateau_iters: int
    # iterations where the tracked objective went UP (trust-region
    # rejections, line-search overshoot — oscillation)
    oscillations: int
    values: List[float]
    grad_norms: List[float]
    # solver-specific tapes: {"radius": [...], "cg": [...]} (TRON) or
    # {"step": [...], "evals": [...]} (L-BFGS / OWL-QN / Newton)
    tapes: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze_history(
    values: Sequence[float],
    grad_norms: Sequence[float],
    tolerance: float = 1e-9,
) -> Dict[str, Any]:
    """Rate/order estimate + plateau + oscillation counts from masked
    (values, grad_norms) tapes. Pure numpy; NaN/inf entries (batched
    masking, untracked buffers) are ignored."""
    v = np.asarray(values, dtype=float)
    g = np.asarray(grad_norms, dtype=float)
    v = v[np.isfinite(v)]
    g = g[np.isfinite(g)]
    out: Dict[str, Any] = {
        "rate": None,
        "order": "unknown",
        "plateau_iters": 0,
        "oscillations": 0,
    }
    if v.size >= 2:
        dv = np.diff(v)
        scale = max(abs(float(v[0])), 1e-30)
        out["oscillations"] = int(np.sum(dv > tolerance * scale))
        # trailing run of ~no objective movement
        flat = np.abs(dv) <= tolerance * scale
        n_flat = 0
        for moved in flat[::-1]:
            if not moved:
                break
            n_flat += 1
        out["plateau_iters"] = n_flat
    gp = g[g > 0.0]
    if gp.size >= 3:
        ratios = gp[1:] / gp[:-1]
        window = ratios[-_RATE_WINDOW:]
        # geometric mean of the trailing contraction ratios
        rate = float(np.exp(np.mean(np.log(np.maximum(window, 1e-300)))))
        out["rate"] = rate
        if window.size >= 2 and window[-1] <= 0.5 * window[0] and rate < 0.3:
            # ratios themselves shrinking: faster than any geometric
            # series — Newton/TRON's terminal behaviour
            out["order"] = "superlinear"
        elif rate < 0.95:
            out["order"] = "linear"
        elif rate < 1.0:
            out["order"] = "sublinear"
        else:
            out["order"] = "stalled"
    return out


def decode_result(result, optimizer: str = "solver") -> ConvergenceReport:
    """One scalar SolverResult -> ConvergenceReport. Reads the result's
    tapes to the host; callers gate on observability being enabled, like
    ``record_solver_metrics``."""
    from photon_ml_tpu_torch.solvers.common import mask_tape

    values, grad_norms = result.masked_history()[:2]
    analysis = analyze_history(values, grad_norms)
    tapes: Dict[str, List[float]] = {}
    if result.radius_tape is not None:
        tapes["radius"] = np.asarray(
            mask_tape(result.radius_tape, result.iterations), float
        ).tolist()
    if result.cg_tape is not None:
        tapes["cg"] = np.asarray(
            mask_tape(result.cg_tape, result.iterations), float
        ).tolist()
    if result.step_tape is not None:
        tapes["step"] = np.asarray(
            mask_tape(result.step_tape, result.iterations), float
        ).tolist()
    if result.eval_tape is not None:
        tapes["evals"] = np.asarray(
            mask_tape(result.eval_tape, result.iterations), float
        ).tolist()
    return ConvergenceReport(
        optimizer=optimizer,
        iterations=int(np.asarray(result.iterations)),
        reason=_reason_name(np.asarray(result.reason)),
        final_value=float(np.asarray(values)[-1]),
        final_grad_norm=float(np.asarray(grad_norms)[-1]),
        rate=analysis["rate"],
        order=analysis["order"],
        plateau_iters=analysis["plateau_iters"],
        oscillations=analysis["oscillations"],
        values=np.asarray(values, float).tolist(),
        grad_norms=np.asarray(grad_norms, float).tolist(),
        tapes=tapes,
    )


# ---------------------------------------------------------------------------
# Fleet-level decode (the batched GAME regime)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetSummary:
    """One coordinate update's per-entity convergence, aggregated —
    the analog of ``RandomEffectOptimizationTracker.scala:33-110``."""

    coordinate: str
    iteration: int
    entities: int
    # iterations-to-converge histogram: iterations -> entity count
    iters_histogram: Dict[int, int]
    median_iters: float
    reason_counts: Dict[str, int]
    nonconverged: int
    nonconverged_frac: float
    # worst-k (entity table row, final grad norm), worst first
    worst: List[Tuple[int, float]]
    nonfinite_grad_norms: int

    def to_dict(self) -> dict:
        # hand-rolled (dataclasses.asdict deep-copies recursively —
        # measurable on the per-update decode path)
        return {
            "coordinate": self.coordinate,
            "iteration": self.iteration,
            "entities": self.entities,
            "iters_histogram": self.iters_histogram,
            "median_iters": self.median_iters,
            "reason_counts": self.reason_counts,
            "nonconverged": self.nonconverged,
            "nonconverged_frac": self.nonconverged_frac,
            "worst": [[int(e), float(g)] for e, g in self.worst],
            "nonfinite_grad_norms": self.nonfinite_grad_norms,
        }


def fleet_summary(
    reasons,
    iterations,
    grad_norms=None,
    entity_ids=None,
    coordinate: str = "",
    iteration: int = 0,
    worst_k: int = 5,
) -> FleetSummary:
    """Aggregate one update's per-entity (reason, iterations[, final
    grad norm[, entity id]]) arrays. Host-side numpy on already-fetched
    data."""
    reasons = np.atleast_1d(np.asarray(reasons)).astype(np.int64)
    iters = np.atleast_1d(np.asarray(iterations)).astype(np.int64)
    n = int(reasons.size)
    bad_a, bad_b = _nonconverged_codes()
    nonconverged = int(((reasons == bad_a) | (reasons == bad_b)).sum())
    # iterations and reason codes are small non-negative ints: bincount
    # beats np.unique on the per-pass decode path
    it_counts = np.bincount(np.maximum(iters, 0))
    hist = {int(k): int(c) for k, c in enumerate(it_counts) if c}
    r_counts = np.bincount(np.maximum(reasons, 0))
    reason_counts = {
        _reason_name(r): int(c) for r, c in enumerate(r_counts) if c
    }
    worst: List[Tuple[int, float]] = []
    nonfinite = 0
    if grad_norms is not None:
        gn = np.atleast_1d(np.asarray(grad_norms, dtype=float))
        nonfinite = int((~np.isfinite(gn)).sum())
        ids = (
            np.atleast_1d(np.asarray(entity_ids)).astype(np.int64)
            if entity_ids is not None
            else np.arange(gn.size, dtype=np.int64)
        )
        # non-finite sorts worst of all: substitute +inf-like rank
        rank = np.where(np.isfinite(gn), gn, np.inf)
        k = min(worst_k, gn.size)
        top = (
            np.argpartition(-rank, k - 1)[:k] if k < gn.size
            else np.arange(gn.size)
        )
        top = top[np.argsort(-rank[top], kind="stable")]
        worst = [(int(ids[i]), float(gn[i])) for i in top]
    return FleetSummary(
        coordinate=coordinate,
        iteration=int(iteration),
        entities=n,
        iters_histogram=hist,
        median_iters=float(np.median(iters)) if n else 0.0,
        reason_counts=reason_counts,
        nonconverged=nonconverged,
        nonconverged_frac=nonconverged / n if n else 0.0,
        worst=worst,
        nonfinite_grad_norms=nonfinite,
    )


# ---------------------------------------------------------------------------
# Recording: registry metrics + events + tracker
# ---------------------------------------------------------------------------


def _registry(registry=None):
    if registry is not None:
        return registry
    from photon_ml_tpu_torch.obs.metrics import registry as _default

    return _default()


def note_solve(
    report: ConvergenceReport,
    label: str = "",
    registry=None,
    emit: bool = True,
) -> None:
    """Record one per-solve report: ``convergence.*`` metrics, a
    ``convergence.solve`` event (tapes included — via the tracer hook it
    also lands in the flight recorder ring), and the installed tracker."""
    reg = _registry(registry)
    reg.inc("convergence.solves")
    reg.inc(f"convergence.reason.{report.reason}")
    reg.observe("convergence.iters", float(report.iterations))
    if report.reason in ("NOT_CONVERGED", "MAX_ITERATIONS"):
        reg.inc("convergence.nonconverged")
    if report.rate is not None:
        reg.set_gauge("convergence.rate", report.rate)
    if emit:
        from photon_ml_tpu_torch.obs.trace import emit_event

        emit_event(
            "convergence.solve",
            cat="convergence",
            label=label,
            **report.to_dict(),
        )
    tracker = _tracker
    if tracker is not None:
        tracker.note_solve(report, label=label)


def note_update(
    coordinate: str,
    iteration: int,
    reasons,
    iterations,
    grad_norms=None,
    entity_ids=None,
    registry=None,
    worst_k: int = 5,
    emit: bool = True,
) -> Optional[FleetSummary]:
    """Record one coordinate update's per-entity convergence: fleet
    summary -> metrics + ``convergence.fleet`` event + precursor check +
    tracker. Returns the summary (None for empty input)."""
    summary = fleet_summary(
        reasons,
        iterations,
        grad_norms,
        entity_ids,
        coordinate=coordinate,
        iteration=iteration,
        worst_k=worst_k,
    )
    if summary.entities == 0:
        return None
    reg = _registry(registry)
    reg.inc("convergence.solves", float(summary.entities))
    reg.inc("convergence.nonconverged", float(summary.nonconverged))
    for name, count in summary.reason_counts.items():
        reg.inc(f"convergence.reason.{name}", float(count))
    reg.set_gauge(
        f"convergence.{coordinate}.median_iters", summary.median_iters
    )
    reg.set_gauge(
        f"convergence.{coordinate}.nonconverged_frac",
        summary.nonconverged_frac,
    )
    if summary.worst:
        reg.set_gauge(
            f"convergence.{coordinate}.worst_grad_norm",
            summary.worst[0][1]
            if math.isfinite(summary.worst[0][1])
            else -1.0,
        )
    precursor = (
        summary.nonconverged_frac > PRECURSOR_NONCONVERGED_FRAC
        or summary.nonfinite_grad_norms > 0
    )
    summary_dict = summary.to_dict()  # built once, shared by all sinks
    if emit:
        from photon_ml_tpu_torch.obs.trace import get_tracer

        tracer = get_tracer()
        if tracer is not None:
            # periodic telemetry, not a crash instant: ride the batched
            # span flush (the precursor below DOES flush immediately)
            tracer.add_instant(
                "convergence.fleet",
                cat="convergence",
                args=summary_dict,
                flush=False,
            )
        if precursor:
            from photon_ml_tpu_torch.obs.trace import emit_event

            emit_event(
                "convergence.precursor",
                cat="convergence",
                coordinate=coordinate,
                iteration=iteration,
                nonconverged_frac=round(summary.nonconverged_frac, 4),
                nonfinite_grad_norms=summary.nonfinite_grad_norms,
            )
    if precursor:
        reg.inc("convergence.precursors")
    tracker = _tracker
    if tracker is not None:
        tracker.note_fleet(summary, summary_dict)
    return summary


def emit_tape_counters(
    report: ConvergenceReport,
    tracer,
    ts_us: float,
    dur_us: float,
    name: str = "convergence.solve",
) -> None:
    """Replay a solve's (value, grad_norm) tape as a Chrome counter
    track spread evenly across the solve's span window — in Perfetto the
    convergence curve renders directly under the ``glm.solve`` span that
    produced it. The tape has no per-iteration timestamps, so even
    spacing is the honest rendering."""
    if tracer is None:
        return
    n = len(report.values)
    if n == 0:
        return
    step = dur_us / max(n - 1, 1)
    for i in range(n):
        vals = {"value": float(report.values[i])}
        if i < len(report.grad_norms):
            g = float(report.grad_norms[i])
            # log scale: grad norms span many decades per solve
            vals["log10_grad_norm"] = (
                math.log10(g) if g > 0 and math.isfinite(g) else -12.0
            )
        tracer.add_counter(name, vals, ts_us=ts_us + i * step)


# ---------------------------------------------------------------------------
# ConvergenceTracker: the --convergence-report collector
# ---------------------------------------------------------------------------


class ConvergenceTracker:
    """Bounded collector of per-solve reports and fleet summaries,
    aggregated into one run-level convergence report
    (``convergence-report.json`` under the driver's output dir).
    Thread-safe; keeps the last ``last_n`` solve tapes whole (the
    flight-recorder-style bound) plus running aggregates for everything.
    """

    def __init__(self, last_n: int = 64, worst_k: int = 5):
        self.last_n = last_n
        self.worst_k = worst_k
        self._lock = threading.Lock()
        self._solves: List[dict] = []
        self._fleet: List[dict] = []
        self._n_solves = 0
        self._n_updates = 0

    def note_solve(self, report: ConvergenceReport, label: str = "") -> None:
        with self._lock:
            self._n_solves += 1
            self._solves.append({"label": label, **report.to_dict()})
            del self._solves[: -self.last_n]

    def note_fleet(
        self, summary: FleetSummary, summary_dict: Optional[dict] = None
    ) -> None:
        with self._lock:
            self._n_updates += 1
            self._fleet.append(
                summary_dict if summary_dict is not None
                else summary.to_dict()
            )
            del self._fleet[: -max(self.last_n, 256)]

    def report(self) -> dict:
        """Aggregate across everything noted: per-coordinate medians,
        reason taxonomy totals, overall non-converged fraction, the
        retained last-N solve reports and fleet summaries."""
        with self._lock:
            solves = list(self._solves)
            fleet = list(self._fleet)
            n_solves = self._n_solves
            n_updates = self._n_updates
        coords: Dict[str, dict] = {}
        reason_totals: Dict[str, int] = {}
        total_entities = 0
        total_nonconverged = 0
        all_medians: List[float] = []
        for f in fleet:
            c = coords.setdefault(
                f["coordinate"],
                {
                    "updates": 0,
                    "entities": 0,
                    "nonconverged": 0,
                    "median_iters": [],
                    "worst": [],
                },
            )
            c["updates"] += 1
            c["entities"] += f["entities"]
            c["nonconverged"] += f["nonconverged"]
            c["median_iters"].append(f["median_iters"])
            c["worst"].extend(f["worst"])
            total_entities += f["entities"]
            total_nonconverged += f["nonconverged"]
            all_medians.append(f["median_iters"])
            for name, count in f["reason_counts"].items():
                reason_totals[name] = reason_totals.get(name, 0) + count
        for r in solves:
            reason_totals[r["reason"]] = reason_totals.get(r["reason"], 0) + 1
            total_entities += 1
            if r["reason"] in ("NOT_CONVERGED", "MAX_ITERATIONS"):
                total_nonconverged += 1
            all_medians.append(float(r["iterations"]))
        per_coord = {}
        for name, c in coords.items():
            worst = sorted(
                c["worst"],
                key=lambda eg: -(
                    eg[1] if math.isfinite(eg[1]) else float("inf")
                ),
            )[: self.worst_k]
            per_coord[name] = {
                "updates": c["updates"],
                "entities": c["entities"],
                "nonconverged": c["nonconverged"],
                "nonconverged_frac": (
                    c["nonconverged"] / c["entities"] if c["entities"] else 0.0
                ),
                "median_iters": (
                    float(np.median(c["median_iters"]))
                    if c["median_iters"]
                    else 0.0
                ),
                "worst_entities": worst,
            }
        return {
            "solves": n_solves,
            "updates": n_updates,
            "median_iters": (
                float(np.median(all_medians)) if all_medians else 0.0
            ),
            "nonconverged": total_nonconverged,
            "nonconverged_frac": (
                total_nonconverged / total_entities if total_entities else 0.0
            ),
            "reason_counts": reason_totals,
            "coordinates": per_coord,
            "last_solves": solves,
            "last_fleet": fleet,
        }

    def dump(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.report(), f, indent=2)
        return path


_tracker: Optional[ConvergenceTracker] = None


def install_convergence_tracker(
    last_n: int = 64, worst_k: int = 5
) -> ConvergenceTracker:
    """Install the process-global tracker (replacing any previous one).
    While installed, solver call sites decode tapes even without an
    active tracer — the ``--convergence-report`` opt-in."""
    global _tracker
    _tracker = ConvergenceTracker(last_n=last_n, worst_k=worst_k)
    return _tracker


def uninstall_convergence_tracker() -> None:
    global _tracker
    _tracker = None


def convergence_tracker() -> Optional[ConvergenceTracker]:
    return _tracker


def tracking_enabled() -> bool:
    """True when a ConvergenceTracker is installed — the gate the solve
    paths OR with ``obs.get_tracer() is not None`` before paying the
    decode (both read the device; an untraced run reads nothing more)."""
    return _tracker is not None
