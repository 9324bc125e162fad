"""Model/data-quality observability: baselines, drift, online quality (a
copy of ``photon_ml_tpu/obs/quality.py``, numpy only, on the port's own
``obs.metrics``, ``obs.sketches``, ``obs.trace`` and
``resilience.faults``).

Three layers close the gap between "the system is healthy" (spans,
SLOs, breakers) and "the MODEL is healthy":

1. **Train-time baseline fingerprint** (:class:`BaselineFingerprint`) —
   per-feature, label, and margin sketches (:mod:`.sketches`)
   accumulated over ingest chunks by the io paths through an installed
   process-global collector (:func:`install_fingerprint_collector`,
   mirroring the convergence-tracker pattern), exported as
   ``quality-fingerprint.json`` next to ``model-manifest.json`` by the
   train CLIs. Sketch ``merge()`` is exact, so per-chunk / per-host
   fingerprints fold into the single-pass fingerprint bit-for-bit.

2. **Serving-side drift detection** (:class:`DriftMonitor`) — hung off
   the :class:`~photon_ml_tpu_torch.serving.engine.ScoringEngine`, sampling
   request features and score distributions into live sketches and
   comparing tumbling windows against the loaded model's baseline:
   per-feature PSI / JS-divergence as ``drift.*`` gauges, a
   ``drift.alarm`` instant event (which rides the tracer hook into the
   crash flight recorder) when any PSI crosses the alarm threshold.
   Hot-reload swaps the monitor WITH the engine, so baselines change
   atomically with the model. :func:`compare_fingerprints` compares two
   fingerprints offline.

3. **Online quality** (:class:`OnlineQuality`) — the delayed-label
   feedback loop: ``{"cmd": "feedback"}`` on ``cli/serve.py`` records
   (label, score, weight) into a bounded rolling window whose exact
   weighted tie-aware AUC (:func:`exact_auc` — the numpy mirror of
   ``ops.metrics.area_under_roc_curve``, equal to ≤1e-6 on any stream)
   and calibration error export as ``quality.*`` gauges.

A missing or corrupt fingerprint must never take down serving: loads go
through :func:`try_load_fingerprint`, which probes the
``quality.baseline`` fault site, counts
``quality.baseline_missing`` / ``quality.baseline_errors``, and returns
None — the engine serves without drift monitoring and says so.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.obs.metrics import MetricsRegistry
from photon_ml_tpu_torch.obs.metrics import registry as _default_registry
from photon_ml_tpu_torch.obs.sketches import (
    HistogramSketch,
    MomentSketch,
    TopKSketch,
    histogram_add_matrix,
    moments_add_matrix,
    psi,
    psi_and_js,
)
from photon_ml_tpu_torch.obs.trace import emit_event
from photon_ml_tpu_torch.resilience import faults as _faults

__all__ = [
    "QUALITY_FINGERPRINT",
    "FeatureSketch",
    "BaselineFingerprint",
    "try_load_fingerprint",
    "install_fingerprint_collector",
    "uninstall_fingerprint_collector",
    "fingerprint_collector",
    "DriftMonitor",
    "OnlineQuality",
    "exact_auc",
    "calibration_error",
    "compare_fingerprints",
]

QUALITY_FINGERPRINT = "quality-fingerprint.json"

DEFAULT_MAX_FEATURES = 64
DEFAULT_PSI_ALARM = 0.25
# drift monitors sample 1-in-N scored batches by default: covariate
# shift persists across batches, so sampling trades alarm latency (x N)
# for per-batch overhead (/ N) — drills that need tight latency pass
# sample_every=1 explicitly
DEFAULT_SAMPLE_EVERY = 4


class FeatureSketch:
    """One tracked quantity: moments + fixed-bin histogram (+ label)."""

    __slots__ = ("name", "moments", "histogram")

    def __init__(
        self,
        name: Optional[str] = None,
        histogram: Optional[HistogramSketch] = None,
    ):
        self.name = name
        self.moments = MomentSketch()
        self.histogram = (
            histogram
            if histogram is not None
            else HistogramSketch.for_features()
        )

    def add(self, values, weights=None) -> "FeatureSketch":
        self.moments.add(values, weights)
        self.histogram.add(values, weights)
        return self

    def merge(self, other: "FeatureSketch") -> "FeatureSketch":
        if self.name is None:
            self.name = other.name
        self.moments.merge(other.moments)
        self.histogram.merge(other.histogram)
        return self

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "moments": self.moments.to_dict(),
            "histogram": self.histogram.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureSketch":
        out = cls(name=d.get("name"))
        out.moments = MomentSketch.from_dict(d["moments"])
        out.histogram = HistogramSketch.from_dict(d["histogram"])
        return out


class BaselineFingerprint:
    """What the training data looked like, as mergeable sketches.

    Per-shard, per-column feature sketches (capped at ``max_features``
    leading columns per shard — deterministic, so chunked and
    single-pass fingerprints track the same set), a label sketch, a
    margin sketch (score space — what the serving DriftMonitor compares
    live score distributions against), and optional categorical top-k
    sketches (entity types). Thread-safe: the ingest pipeline's decode
    pool and the in-core paths both feed it.
    """

    VERSION = 1

    def __init__(self, max_features: int = DEFAULT_MAX_FEATURES):
        self.max_features = int(max_features)
        self.shards: Dict[str, Dict[int, FeatureSketch]] = {}
        self.label = FeatureSketch("label")
        self.margin = FeatureSketch(
            "margin", HistogramSketch.for_scores()
        )
        self.categoricals: Dict[str, TopKSketch] = {}
        self.rows = 0
        self._lock = threading.Lock()

    # -- accumulation -------------------------------------------------------

    def observe_rows(
        self,
        shard: str,
        matrix,
        weights=None,
        names: Optional[Sequence[str]] = None,
    ) -> None:
        """One dense (n, d) host chunk of shard ``shard``. Only the
        leading ``max_features`` columns are sketched (bounded cost and
        file size; the cap is part of the fingerprint so both sides of
        a comparison track the same columns)."""
        m = np.asarray(matrix)
        if m.ndim != 2 or m.shape[0] == 0:
            return
        ncols = min(m.shape[1], self.max_features)
        with self._lock:
            cols = self.shards.setdefault(shard, {})
            for j in range(ncols):
                if j not in cols:
                    name = (
                        str(names[j])
                        if names is not None and j < len(names)
                        else None
                    )
                    cols[j] = FeatureSketch(name)
            sks = [cols[j] for j in range(ncols)]
            sub = m[:, :ncols]
            histogram_add_matrix(
                [sk.histogram for sk in sks], sub, weights
            )
            moments_add_matrix([sk.moments for sk in sks], sub, weights)

    def observe_labels(self, labels, weights=None) -> None:
        lab = np.asarray(labels)
        if lab.size == 0:
            return
        with self._lock:
            self.label.add(lab, weights)
            self.rows += int(lab.size)

    def observe_margins(self, margins, weights=None) -> None:
        with self._lock:
            self.margin.add(np.asarray(margins), weights)

    def observe_categorical(self, kind: str, keys, weights=None) -> None:
        with self._lock:
            sk = self.categoricals.get(kind)
            if sk is None:
                sk = self.categoricals[kind] = TopKSketch()
            sk.add_many(keys, weights)

    def observe_batch(
        self,
        features=None,
        labels=None,
        weights=None,
        shard: str = "features",
        names: Optional[Sequence[str]] = None,
    ) -> None:
        """One ingest chunk: dense features (None / non-2D — e.g. a
        sparse container — contribute nothing), labels, weights."""
        if features is not None and getattr(features, "ndim", 0) == 2:
            self.observe_rows(shard, features, weights, names=names)
        if labels is not None:
            self.observe_labels(labels, weights)

    # -- merge / io ---------------------------------------------------------

    def merge(self, other: "BaselineFingerprint") -> "BaselineFingerprint":
        """Exact fold: self ∪ other equals the single-pass fingerprint
        over the concatenated rows (the pod-merge contract)."""
        with self._lock:
            for shard, cols in other.shards.items():
                mine = self.shards.setdefault(shard, {})
                for j, sk in cols.items():
                    if j in mine:
                        mine[j].merge(sk)
                    else:
                        mine[j] = sk
            self.label.merge(other.label)
            self.margin.merge(other.margin)
            for kind, sk in other.categoricals.items():
                if kind in self.categoricals:
                    self.categoricals[kind].merge(sk)
                else:
                    self.categoricals[kind] = sk
            self.rows += other.rows
        return self

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "version": self.VERSION,
                "max_features": self.max_features,
                "rows": self.rows,
                "shards": {
                    shard: {
                        str(j): sk.to_dict()
                        for j, sk in sorted(cols.items())
                    }
                    for shard, cols in sorted(self.shards.items())
                },
                "label": self.label.to_dict(),
                "margin": self.margin.to_dict(),
                "categoricals": {
                    k: sk.to_dict()
                    for k, sk in sorted(self.categoricals.items())
                },
            }

    @classmethod
    def from_dict(cls, d: dict) -> "BaselineFingerprint":
        out = cls(max_features=int(d.get("max_features", DEFAULT_MAX_FEATURES)))
        out.rows = int(d["rows"])
        for shard, cols in d.get("shards", {}).items():
            out.shards[shard] = {
                int(j): FeatureSketch.from_dict(sk)
                for j, sk in cols.items()
            }
        out.label = FeatureSketch.from_dict(d["label"])
        out.margin = FeatureSketch.from_dict(d["margin"])
        out.categoricals = {
            k: TopKSketch.from_dict(sk)
            for k, sk in d.get("categoricals", {}).items()
        }
        return out

    def save(self, path: str) -> str:
        """Write the fingerprint JSON (``path`` may be the export dir).
        Write-then-rename so a reader never sees a torn fingerprint."""
        if os.path.isdir(path):
            path = os.path.join(path, QUALITY_FINGERPRINT)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "BaselineFingerprint":
        if os.path.isdir(path):
            path = os.path.join(path, QUALITY_FINGERPRINT)
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


def try_load_fingerprint(
    root: str, registry: Optional[MetricsRegistry] = None
) -> Optional[BaselineFingerprint]:
    """Load the export's fingerprint, or None — NEVER raises. A model
    without a (readable) baseline must still serve; the degraded state
    is counted (``quality.baseline_missing`` / ``.baseline_errors``)
    and evented so the silent-no-drift-monitoring mode is visible.
    Probes the ``quality.baseline`` fault site (raise = unreadable,
    corrupt = torn/garbage fingerprint)."""
    reg = registry if registry is not None else _default_registry()
    path = (
        os.path.join(root, QUALITY_FINGERPRINT)
        if os.path.isdir(root)
        else root
    )
    try:
        action = _faults.fire(
            "quality.baseline", key=os.path.basename(os.path.dirname(path))
        )
        if not os.path.exists(path):
            reg.inc("quality.baseline_missing")
            emit_event(
                "quality.baseline_missing", cat="quality", path=path
            )
            return None
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if action.corrupt:
            raise ValueError("injected fingerprint corruption")
        return BaselineFingerprint.from_dict(doc)
    except OSError as e:
        reg.inc("quality.baseline_missing")
        emit_event(
            "quality.baseline_missing", cat="quality", path=path,
            error=repr(e),
        )
        return None
    except (ValueError, KeyError, TypeError) as e:
        reg.inc("quality.baseline_errors")
        emit_event(
            "quality.baseline_error", cat="quality", path=path,
            error=repr(e),
        )
        return None


# ---------------------------------------------------------------------------
# process-global fingerprint collector (the ingest-side hook)
# ---------------------------------------------------------------------------

_collector: Optional[BaselineFingerprint] = None


def install_fingerprint_collector(
    fingerprint: Optional[BaselineFingerprint] = None,
    max_features: int = DEFAULT_MAX_FEATURES,
) -> BaselineFingerprint:
    """Install a process-global fingerprint the io paths feed
    (``io/ingest.py`` in-core assembly, ``io/pipeline.py`` staged
    chunks). Mirrors the convergence-tracker install pattern: drivers
    install around ingest, export, then uninstall. Re-installing
    replaces the previous collector."""
    global _collector
    fp = (
        fingerprint
        if fingerprint is not None
        else BaselineFingerprint(max_features=max_features)
    )
    _collector = fp
    return fp


def uninstall_fingerprint_collector() -> None:
    global _collector
    _collector = None


def fingerprint_collector() -> Optional[BaselineFingerprint]:
    """The installed collector, or None (the common, zero-cost case)."""
    return _collector


# ---------------------------------------------------------------------------
# serving-side drift monitor
# ---------------------------------------------------------------------------


class DriftMonitor:
    """Compare sampled serving traffic against a training baseline.

    Feeds per-feature live sketches (same fixed-bin configs as the
    baseline's, so PSI is well-defined) from every ``sample_every``-th
    scored batch; every ``check_every_rows`` sampled rows it computes
    per-feature PSI / JS against the baseline over the tumbling window,
    exports ``drift.*`` gauges, and — when any PSI (features or score
    distribution) reaches ``psi_alarm`` — counts ``drift.alarms`` and
    emits a ``drift.alarm`` instant event carrying the worst offenders
    (the flight recorder sees it through the tracer hook). The window
    then resets; a persistent shift re-alarms every window.
    """

    def __init__(
        self,
        baseline: BaselineFingerprint,
        registry: Optional[MetricsRegistry] = None,
        psi_alarm: float = DEFAULT_PSI_ALARM,
        check_every_rows: int = 512,
        min_rows: int = 128,
        sample_every: int = DEFAULT_SAMPLE_EVERY,
        max_rows_per_batch: int = 128,
    ):
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}"
            )
        if max_rows_per_batch < 1:
            raise ValueError(
                f"max_rows_per_batch must be >= 1, got {max_rows_per_batch}"
            )
        self.baseline = baseline
        self.registry = (
            registry if registry is not None else MetricsRegistry()
        )
        self.psi_alarm = float(psi_alarm)
        self.check_every_rows = int(check_every_rows)
        self.min_rows = int(min_rows)
        self.sample_every = int(sample_every)
        # rows within a batch are exchangeable, so a huge coalesced
        # batch contributes a capped prefix — bounds per-batch overhead
        # independent of the engine's bucket ladder
        self.max_rows_per_batch = int(max_rows_per_batch)
        self._lock = threading.Lock()
        self._batches = 0
        self._rows_in_window = 0
        self.alarms = 0
        self.checks = 0
        self.last_report: Optional[dict] = None
        self._reset_window_locked()

    def _reset_window_locked(self) -> None:
        self._live: Dict[str, Dict[int, HistogramSketch]] = {
            shard: {
                j: HistogramSketch(
                    scale=sk.histogram.scale,
                    lo=sk.histogram.lo,
                    hi=sk.histogram.hi,
                    bins=sk.histogram.bins,
                    x0=sk.histogram.x0,
                )
                for j, sk in cols.items()
            }
            for shard, cols in self.baseline.shards.items()
        }
        self._live_score = HistogramSketch(
            scale=self.baseline.margin.histogram.scale,
            lo=self.baseline.margin.histogram.lo,
            hi=self.baseline.margin.histogram.hi,
            bins=self.baseline.margin.histogram.bins,
            x0=self.baseline.margin.histogram.x0,
        )
        # hot-path cache: contiguous-leading-column histogram lists per
        # shard (the baseline's column set is fixed for the monitor's
        # lifetime, so this never changes shape across window resets)
        self._live_fast: Dict[str, Tuple[int, List[HistogramSketch]]] = {}
        for shard, cols in self._live.items():
            ncols = (max(cols) + 1) if cols else 0
            if ncols and all(j in cols for j in range(ncols)):
                self._live_fast[shard] = (
                    ncols,
                    [cols[j] for j in range(ncols)],
                )
        self._rows_in_window = 0

    # -- recording ----------------------------------------------------------

    def observe(
        self,
        features: Mapping[str, np.ndarray],
        scores: Optional[np.ndarray] = None,
    ) -> Optional[dict]:
        """One scored batch (unpadded rows). Returns the drift report
        when this observation completed a window check, else None."""
        with self._lock:
            self._batches += 1
            if (self._batches - 1) % self.sample_every != 0:
                return None
            rows = 0
            cap = self.max_rows_per_batch
            for shard, cols in self._live.items():
                m = features.get(shard)
                if m is None:
                    continue
                m = np.asarray(m)[:cap]
                if m.ndim != 2 or m.shape[0] == 0:
                    continue
                rows = max(rows, m.shape[0])
                fast = self._live_fast.get(shard)
                if fast is not None and m.shape[1] >= fast[0]:
                    # contiguous leading columns — the common case —
                    # one bincount for the whole matrix, checks skipped
                    # (this window owns every sketch, one config)
                    histogram_add_matrix(
                        fast[1], m[:, : fast[0]], check_configs=False
                    )
                else:
                    for j, hist in cols.items():
                        if j < m.shape[1]:
                            hist.add(m[:, j])
            if scores is not None:
                s = np.asarray(scores)[:cap]
                rows = max(rows, s.size)
                self._live_score.add(s)
            self._rows_in_window += rows
            if (
                self._rows_in_window < self.check_every_rows
                or self._rows_in_window < self.min_rows
            ):
                return None
            return self._check_locked()

    def check(self) -> Optional[dict]:
        """Force a window check now (tests, shutdown) — None when the
        window holds fewer than ``min_rows`` sampled rows."""
        with self._lock:
            if self._rows_in_window < self.min_rows:
                return None
            return self._check_locked()

    def _check_locked(self) -> dict:
        reg = self.registry
        per_feature: Dict[str, dict] = {}
        psi_max = 0.0
        js_max = 0.0
        worst: List[Tuple[float, str]] = []
        for shard, cols in self._live.items():
            base_cols = self.baseline.shards.get(shard, {})
            for j, hist in cols.items():
                base = base_cols.get(j)
                if base is None or hist.weight <= 0.0:
                    continue
                p, jsd = psi_and_js(base.histogram, hist)
                key = f"{shard}.{j}"
                per_feature[key] = {
                    "psi": round(p, 6),
                    "js": round(jsd, 6),
                    "name": base.name,
                }
                reg.set_gauge(f"drift.psi.{shard}.{j}", p)
                psi_max = max(psi_max, p)
                js_max = max(js_max, jsd)
                worst.append((p, key))
        score_psi = None
        if (
            self.baseline.margin.histogram.weight > 0.0
            and self._live_score.weight > 0.0
        ):
            score_psi = psi(
                self.baseline.margin.histogram, self._live_score
            )
            reg.set_gauge("drift.score_psi", score_psi)
        flagged = sorted(
            (k for p, k in worst if p >= self.psi_alarm),
        )
        alarm = bool(flagged) or (
            score_psi is not None and score_psi >= self.psi_alarm
        )
        self.checks += 1
        reg.inc("drift.checks")
        reg.set_gauge("drift.psi_max", psi_max)
        reg.set_gauge("drift.js_max", js_max)
        reg.set_gauge("drift.features_flagged", len(flagged))
        report = {
            "rows": self._rows_in_window,
            "psi_max": round(psi_max, 6),
            "js_max": round(js_max, 6),
            "score_psi": (
                round(score_psi, 6) if score_psi is not None else None
            ),
            "flagged": flagged,
            "alarm": alarm,
            "features": per_feature,
        }
        if alarm:
            self.alarms += 1
            reg.inc("drift.alarms")
            top = sorted(worst, reverse=True)[:5]
            emit_event(
                "drift.alarm",
                cat="quality",
                psi_max=round(psi_max, 6),
                score_psi=report["score_psi"],
                threshold=self.psi_alarm,
                rows=self._rows_in_window,
                worst={k: round(p, 4) for p, k in top},
            )
        self.last_report = report
        self._reset_window_locked()
        return report

    # -- readout ------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "psi_alarm": self.psi_alarm,
                "check_every_rows": self.check_every_rows,
                "sample_every": self.sample_every,
                "baseline_rows": self.baseline.rows,
                "window_rows": self._rows_in_window,
                "checks": self.checks,
                "alarms": self.alarms,
                "last_report": self.last_report,
            }


# ---------------------------------------------------------------------------
# online quality: the delayed-label feedback loop
# ---------------------------------------------------------------------------


def exact_auc(labels, scores, weights=None) -> float:
    """Exact weighted, tie-aware AUROC — the numpy mirror of
    ``ops.metrics.area_under_roc_curve`` (same closed form:
    P(s⁺ > s⁻) + ½·P(s⁺ = s⁻), pair-weighted; 0.5 when a class is
    empty; zero-weight rows invisible). The streaming/online quality
    path computes THIS, and tests assert ≤1e-6 agreement with
    ``ops.metrics.area_under_roc_curve`` on the same stream."""
    s = np.asarray(scores, np.float64).ravel()
    y = np.asarray(labels, np.float64).ravel()
    w = (
        np.ones_like(s)
        if weights is None
        else np.asarray(weights, np.float64).ravel()
    )
    if s.size == 0:
        return 0.5
    order = np.argsort(s, kind="stable")
    s, y, w = s[order], y[order], w[order]
    pos_w = np.where(y > 0.5, w, 0.0)
    neg_w = np.where(y > 0.5, 0.0, w)
    cum_neg = np.cumsum(neg_w)
    total_neg = cum_neg[-1]
    total_pos = pos_w.sum()
    left = np.searchsorted(s, s, side="left")
    right = np.searchsorted(s, s, side="right")
    cum0 = np.concatenate([np.zeros(1), cum_neg])
    neg_below = cum0[left]
    neg_equal = cum0[right] - neg_below
    pairs = float(np.sum(pos_w * (neg_below + 0.5 * neg_equal)))
    denom = total_pos * total_neg
    return pairs / denom if denom > 0.0 else 0.5


def calibration_error(labels, scores, weights=None) -> float:
    """Calibration-in-the-large: |E_w[σ(score)] − E_w[label]| — the
    one-number answer to "are the served probabilities drifting from
    observed rates". Scores are margins (logits); labels {0, 1}."""
    s = np.asarray(scores, np.float64).ravel()
    y = np.asarray(labels, np.float64).ravel()
    w = (
        np.ones_like(s)
        if weights is None
        else np.asarray(weights, np.float64).ravel()
    )
    total = w.sum()
    if total <= 0.0:
        return 0.0
    # numerically-stable sigmoid
    p = np.where(s >= 0, 1.0 / (1.0 + np.exp(-s)), 0.0)
    ex = np.exp(s[s < 0])
    p[s < 0] = ex / (1.0 + ex)
    return abs(float(((p - y) * w).sum()) / float(total))


class OnlineQuality:
    """Rolling-window model quality from delayed labels.

    ``record(label, score, weight)`` appends to a bounded window (at
    most ``max_samples`` newest feedbacks — like the SLO tracker's
    window, full-precision samples, not a sketch, because the AUC
    contract is EXACT agreement with the offline replay). Every
    ``refresh_every`` records the gauges refresh:
    ``quality.auc`` / ``quality.calibration_error`` /
    ``quality.window_n``; ``quality.feedback_total`` counts for life.
    """

    _REFRESH_EVERY = 64

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        max_samples: int = 8192,
        refresh_every: int = _REFRESH_EVERY,
    ):
        self.registry = (
            registry if registry is not None else MetricsRegistry()
        )
        self._lock = threading.Lock()
        self._window = collections.deque(maxlen=max_samples)
        self._since_refresh = 0
        self.refresh_every = max(int(refresh_every), 1)
        self.total = 0

    def record(
        self, label: float, score: float, weight: float = 1.0
    ) -> None:
        label = float(label)
        score = float(score)
        weight = float(weight)
        if not math.isfinite(score) or not math.isfinite(label):
            raise ValueError(
                f"feedback must be finite (label={label}, score={score})"
            )
        with self._lock:
            self._window.append((label, score, weight))
            self.total += 1
            self.registry.inc("quality.feedback_total")
            self._since_refresh += 1
            refresh = self._since_refresh >= self.refresh_every
            if refresh:
                self._since_refresh = 0
        if refresh:
            self.snapshot()

    @property
    def window_n(self) -> int:
        with self._lock:
            return len(self._window)

    def window_arrays(self):
        """(labels, scores, weights) of the current window — what the
        exact-replay equivalence drills feed to ``ops.metrics``."""
        with self._lock:
            items = list(self._window)
        if not items:
            z = np.zeros(0)
            return z, z, z
        a = np.asarray(items, np.float64)
        return a[:, 0], a[:, 1], a[:, 2]

    def snapshot(self) -> dict:
        labels, scores, weights = self.window_arrays()
        auc = exact_auc(labels, scores, weights)
        cal = calibration_error(labels, scores, weights)
        out = {
            "window_n": int(labels.size),
            "total": self.total,
            "auc": round(auc, 6),
            "calibration_error": round(cal, 6),
            "positive_weight": float(
                weights[labels > 0.5].sum() if labels.size else 0.0
            ),
            "negative_weight": float(
                weights[labels <= 0.5].sum() if labels.size else 0.0
            ),
        }
        self.registry.set_gauge("quality.auc", auc)
        self.registry.set_gauge("quality.calibration_error", cal)
        self.registry.set_gauge("quality.window_n", labels.size)
        return out


# ---------------------------------------------------------------------------
# offline fingerprint comparison
# ---------------------------------------------------------------------------


def compare_fingerprints(
    baseline: BaselineFingerprint,
    current: BaselineFingerprint,
    psi_alarm: float = DEFAULT_PSI_ALARM,
) -> dict:
    """Per-feature PSI/JS between two fingerprints (features present in
    both), plus label and margin distribution distances."""
    features: Dict[str, dict] = {}
    psi_max = 0.0
    js_max = 0.0
    for shard, cols in sorted(baseline.shards.items()):
        cur_cols = current.shards.get(shard, {})
        for j, base in sorted(cols.items()):
            cur = cur_cols.get(j)
            if cur is None or cur.histogram.weight <= 0.0:
                continue
            if base.histogram.weight <= 0.0:
                continue
            p, jsd = psi_and_js(base.histogram, cur.histogram)
            features[f"{shard}.{j}"] = {
                "psi": round(p, 6),
                "js": round(jsd, 6),
                "name": base.name or cur.name,
                "baseline_mean": round(base.moments.mean, 6),
                "current_mean": round(cur.moments.mean, 6),
            }
            psi_max = max(psi_max, p)
            js_max = max(js_max, jsd)
    label_psi = None
    if (
        baseline.label.histogram.weight > 0.0
        and current.label.histogram.weight > 0.0
    ):
        label_psi = round(
            psi(baseline.label.histogram, current.label.histogram), 6
        )
    margin_psi = None
    if (
        baseline.margin.histogram.weight > 0.0
        and current.margin.histogram.weight > 0.0
    ):
        margin_psi = round(
            psi(baseline.margin.histogram, current.margin.histogram), 6
        )
    flagged = sorted(
        k for k, v in features.items() if v["psi"] >= psi_alarm
    )
    alarm = bool(flagged) or (
        margin_psi is not None and margin_psi >= psi_alarm
    )
    return {
        "psi_alarm": psi_alarm,
        "psi_max": round(psi_max, 6),
        "js_max": round(js_max, 6),
        "label_psi": label_psi,
        "margin_psi": margin_psi,
        "flagged": flagged,
        "alarm": alarm,
        "baseline_rows": baseline.rows,
        "current_rows": current.rows,
        "features": features,
    }
