"""Feature importance rankings (counterpart of
``photon_ml_tpu/diagnostics/importance.py``).

Rebuild of ``diagnostics/featureimportance/*.scala``: two notions of
per-feature importance over a fitted GLM —

  EXPECTED_MAGNITUDE  |coef_j| * meanAbs_j   (inner-product expectation,
                      ``ExpectedMagnitudeFeatureImportanceDiagnostic.scala:29-62``)
  VARIANCE            |coef_j| * variance_j  (inner-product variance,
                      ``VarianceFeatureImportanceDiagnostic.scala:29-60``)

both falling back to |coef_j| when no feature summary is available, with
the reference's top-50 detail list and 101-point importance-by-fractile
curve (``AbstractFeatureImportanceDiagnostic.scala:39-127``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.utils.device import to_numpy

MAX_RANKED_FEATURES = 50
NUM_IMPORTANCE_FRACTILES = 100

IMPORTANCE_KINDS = ("EXPECTED_MAGNITUDE", "VARIANCE")


@dataclasses.dataclass(frozen=True)
class RankedFeature:
    name: str
    term: str
    index: int
    importance: float
    coefficient: float
    description: str


@dataclasses.dataclass(frozen=True)
class FeatureImportanceReport:
    """``featureimportance/FeatureImportanceReport.scala``."""

    importance_type: str
    importance_description: str
    features: Tuple[RankedFeature, ...]  # top MAX_RANKED_FEATURES, desc
    rank_to_importance: Dict[float, float]  # fractile (%) -> importance


def feature_importance(
    coefficients,
    vocab,
    summary=None,
    kind: str = "EXPECTED_MAGNITUDE",
) -> FeatureImportanceReport:
    """Rank every feature by the chosen importance measure.

    coefficients: (d,) raw-space means; vocab: FeatureVocabulary;
    summary: BasicStatisticalSummary or None.
    """
    if kind not in IMPORTANCE_KINDS:
        raise ValueError(f"kind must be one of {IMPORTANCE_KINDS}: {kind}")
    coef = to_numpy(coefficients, np.float64)
    d = coef.shape[0]
    if summary is not None:
        stats = {name: to_numpy(getattr(summary, name), np.float64)
                 for name in ("mean_abs", "variance", "min", "mean", "max")}
        scale = stats["mean_abs" if kind == "EXPECTED_MAGNITUDE" else "variance"]
        description = (
            "Expected magnitude of inner product contribution"
            if kind == "EXPECTED_MAGNITUDE"
            else "Expected inner product variance contribution"
        )
    else:
        scale = np.ones(d)
        description = "Magnitude of feature coefficient"
    importance = np.abs(coef * scale)

    order = np.argsort(-importance, kind="stable")
    top = order[:MAX_RANKED_FEATURES]
    features = []
    for idx in top:
        name, term = vocab.name_term(int(idx))
        desc = (
            f"Feature (name=[{name}], term=[{term}]) importance = "
            f"[{importance[idx]:.3f}], coefficient = [{coef[idx]:.6g}]"
        )
        if summary is not None:
            desc += (
                f" min=[{float(stats['min'][idx])}]"
                f", mean=[{float(stats['mean'][idx])}]"
                f", max=[{float(stats['max'][idx])}]"
                f", variance=[{float(stats['variance'][idx])}]"
            )
        features.append(
            RankedFeature(
                name=name,
                term=term,
                index=int(idx),
                importance=float(importance[idx]),
                coefficient=float(coef[idx]),
                description=desc,
            )
        )

    # importance at evenly spaced ranks, reported by fractile percent.
    # Intentional divergence: ``AbstractFeatureImportanceDiagnostic.scala:94-97``
    # divides the rank by MAX_RANKED_FEATURES (50) while iterating 0..100
    # fractiles, so its curve saturates at the minimum importance beyond the
    # 50% fractile — an apparent bug; we use the fractile count so the curve
    # spans the whole ranking.
    sorted_imp = importance[order]
    rank_to_importance = {}
    for f in range(NUM_IMPORTANCE_FRACTILES + 1):
        pos = min(d - 1, f * d // NUM_IMPORTANCE_FRACTILES)
        rank_to_importance[100.0 * f / NUM_IMPORTANCE_FRACTILES] = float(
            sorted_imp[pos]
        )

    return FeatureImportanceReport(
        importance_type=(
            "Inner product expectation"
            if kind == "EXPECTED_MAGNITUDE"
            else "Inner product variance"
        ),
        importance_description=description,
        features=tuple(features),
        rank_to_importance=rank_to_importance,
    )
