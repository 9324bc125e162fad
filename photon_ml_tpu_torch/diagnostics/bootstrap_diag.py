"""Bootstrap training diagnostic: coefficient and metric confidence
intervals (counterpart of ``photon_ml_tpu/diagnostics/bootstrap_diag.py``;
the reference's ``diagnostics/bootstrap/BootstrapTrainingDiagnostic.scala:26-150``)
on top of :func:`photon_ml_tpu_torch.models.bootstrap.bootstrap_train_glm`:
15 bootstrap samples of 70% of the data, per-metric five-number summaries,
the importance-ranked feature list with per-coefficient quartiles, and the
"straddling zero" list (features whose [q1, q3] crosses 0 — candidates for
pruning).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from photon_ml_tpu_torch.utils.device import to_numpy

NUM_IMPORTANT_FEATURES = 15
DEFAULT_BOOTSTRAP_SAMPLES = 15
DEFAULT_BOOTSTRAP_PORTION = 0.7
# report-size cap for the straddling-zero list (wide models can have
# thousands of noise features)
MAX_STRADDLING_REPORTED = 100


@dataclasses.dataclass(frozen=True)
class CoefficientInterval:
    """Five-number summary of one coefficient across replicas."""

    name: str
    term: str
    index: int
    importance: float
    min: float
    q1: float
    median: float
    q3: float
    max: float

    @property
    def straddles_zero(self) -> bool:
        return self.q1 < 0.0 < self.q3


@dataclasses.dataclass(frozen=True)
class BootstrapDiagnosticReport:
    """``bootstrap/BootstrapReport.scala``: metric distributions plus the
    important and zero-straddling coefficient intervals."""

    # metric -> (min, q1, median, q3, max) across replicas
    metric_distributions: Dict[str, Tuple[float, float, float, float, float]]
    important_features: Tuple[CoefficientInterval, ...]
    straddling_zero: Tuple[CoefficientInterval, ...]
    num_replicas: int
    portion: float


def bootstrap_diagnostic(
    batch,
    config,
    model_coefficients,
    vocab,
    summary=None,
    evaluation_batch=None,
    num_replicas: int = DEFAULT_BOOTSTRAP_SAMPLES,
    portion: float = DEFAULT_BOOTSTRAP_PORTION,
    seed: int = 0,
) -> BootstrapDiagnosticReport:
    """Bootstrap intervals for ONE (task, lambda) configuration.

    ``model_coefficients``: the full-data fit's raw-space means, for the
    importance ranking (|coef| * meanAbs, or |coef| without a summary;
    ``BootstrapTrainingDiagnostic.scala:36-60``)."""
    from photon_ml_tpu_torch.models.bootstrap import bootstrap_train_glm

    result = bootstrap_train_glm(
        batch,
        config,
        num_replicas=num_replicas,
        seed=seed,
        evaluation_batch=evaluation_batch if evaluation_batch is not None else batch,
        portion=portion,
    )

    coef = to_numpy(model_coefficients, np.float64)
    scale = to_numpy(summary.mean_abs, np.float64) if summary is not None else np.ones_like(coef)
    importance = np.abs(coef) * scale

    w = result.coefficients  # (R, d)
    q1, med, q3 = (
        np.quantile(w, 0.25, axis=0),
        np.quantile(w, 0.5, axis=0),
        np.quantile(w, 0.75, axis=0),
    )
    lo, hi = w.min(axis=0), w.max(axis=0)

    def interval(idx: int) -> CoefficientInterval:
        name, term = vocab.name_term(idx)
        return CoefficientInterval(
            name=name, term=term, index=idx, importance=float(importance[idx]),
            min=float(lo[idx]), q1=float(q1[idx]), median=float(med[idx]),
            q3=float(q3[idx]), max=float(hi[idx]),
        )

    order = np.argsort(-importance, kind="stable")
    important = tuple(interval(int(i)) for i in order[:NUM_IMPORTANT_FEATURES])
    straddles = (q1 < 0.0) & (q3 > 0.0)
    straddling = tuple(
        interval(int(i)) for i in order[straddles[order]][:MAX_STRADDLING_REPORTED]
    )
    metric_distributions = {
        name: (
            float(np.min(vals)),
            float(np.quantile(vals, 0.25)),
            float(np.quantile(vals, 0.5)),
            float(np.quantile(vals, 0.75)),
            float(np.max(vals)),
        )
        for name, vals in result.metric_distributions.items()
    }
    return BootstrapDiagnosticReport(
        metric_distributions=metric_distributions,
        important_features=important,
        straddling_zero=straddling,
        num_replicas=int(w.shape[0]),
        portion=portion,
    )
