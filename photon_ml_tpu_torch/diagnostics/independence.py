"""Prediction/error independence via Kendall's tau (counterpart of
``photon_ml_tpu/diagnostics/independence.py``).

Rebuild of ``diagnostics/independence/KendallTauAnalysis.scala:26-128`` +
``PredictionErrorIndependenceDiagnostic.scala:26-54``. The reference
samples up to 5000 (prediction, error) pairs and classifies every ordered
pair via a cartesian RDD / nested loop; here the pair classification is a
single vectorized O(m^2) broadcast (25M sign comparisons — one fused device
or numpy pass), with identical tie semantics: a tie in the FIRST variable
is TIES_IN_A regardless of the second (``KendallTauAnalysis.scala:101-127``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from photon_ml_tpu_torch.utils.device import to_numpy

MAXIMUM_SAMPLE_SIZE = 5000  # ``PredictionErrorIndependenceDiagnostic.scala:52``


@dataclasses.dataclass(frozen=True)
class KendallTauReport:
    """``independence/KendallTauReport.scala``."""

    num_concordant: int
    num_discordant: int
    num_items: int
    num_pairs: int
    num_effective_pairs: int  # concordant + discordant
    tau_alpha: float
    tau_beta: float
    z_alpha: float
    p_value: float
    message: str


@dataclasses.dataclass(frozen=True)
class PredictionErrorIndependenceReport:
    """``independence/PredictionErrorIndependenceReport.scala``: the
    sampled (prediction, error) arrays plus the tau analysis."""

    predictions: np.ndarray
    errors: np.ndarray
    kendall_tau: KendallTauReport


def _normal_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def kendall_tau(a, b) -> KendallTauReport:
    """Tau-alpha / tau-beta / z / p over all i<j pairs of (a, b) draws.

    Matches ``KendallTauAnalysis.analyze``: tau_alpha = (C-D)/(C+D),
    tau_beta = (C-D)/sqrt((P-Ta)(P-Tb)) with P = m(m-1)/2, z from the
    standard tau variance approximation, and the two-sided-mass "p value"
    convention the reference uses (cdf(|z|) - cdf(-|z|): LARGE means
    dependence detected).

    Note: the reference classifies each pair into exactly one category
    with ties in the FIRST variable taking precedence, so pairs tied in
    BOTH variables count toward Ta but never Tb. Its tau_beta therefore
    differs slightly from the textbook/scipy tau-b whenever double ties
    exist; we reproduce the reference's arithmetic.
    """
    a = to_numpy(a, np.float64)
    b = to_numpy(b, np.float64)
    m = a.shape[0]
    iu = np.triu_indices(m, k=1)
    # index the pair vectors directly — no (m, m) temporaries
    dx = np.sign(a[iu[0]] - a[iu[1]])
    dy = np.sign(b[iu[0]] - b[iu[1]])
    ties_a = int(np.sum(dx == 0))
    ties_b = int(np.sum((dx != 0) & (dy == 0)))
    concordant = int(np.sum(dx * dy > 0))
    discordant = int(np.sum(dx * dy < 0))

    num_pairs = m * (m - 1) // 2
    no_ties_a = num_pairs - ties_a
    no_ties_b = num_pairs - ties_b
    effective = concordant + discordant
    tau_alpha = (concordant - discordant) / effective if effective else 0.0
    denom = math.sqrt(float(no_ties_a) * float(no_ties_b))
    tau_beta = (concordant - discordant) / denom if denom else 0.0
    va = 2.0 * (2.0 * m + 5.0)
    vb = 9.0 * m * (m - 1.0)
    d = math.sqrt(va / vb) if vb > 0 else 1.0
    z_alpha = tau_alpha / d
    p_value = _normal_cdf(abs(z_alpha)) - _normal_cdf(-abs(z_alpha))

    message = (
        f"Note: detected ties (ties in first variable: {ties_a}, ties in "
        f"second variable: {ties_b}). This means that the computed z score "
        "/ p value for tau-alpha over-estimates the degree of independence "
        "between A and B."
        if ties_a + ties_b > 0
        else ""
    )
    return KendallTauReport(
        num_concordant=concordant,
        num_discordant=discordant,
        num_items=m,
        num_pairs=num_pairs,
        num_effective_pairs=effective,
        tau_alpha=tau_alpha,
        tau_beta=tau_beta,
        z_alpha=z_alpha,
        p_value=p_value,
        message=message,
    )


def prediction_error_independence(
    labels,
    predicted_means,
    weights=None,
    seed: int = 0,
    max_sample: int = MAXIMUM_SAMPLE_SIZE,
) -> PredictionErrorIndependenceReport:
    """error = label - predicted mean; tau analysis on a <=5000-row sample
    (``PredictionErrorIndependenceDiagnostic.scala:31-49``)."""
    y = to_numpy(labels, np.float64)
    p = to_numpy(predicted_means, np.float64)
    if weights is not None:
        keep = to_numpy(weights, np.float64) > 0
        y, p = y[keep], p[keep]
    err = y - p
    n = y.shape[0]
    if n > max_sample:
        idx = np.random.default_rng(seed).choice(n, max_sample, replace=False)
        p, err = p[idx], err[idx]
    return PredictionErrorIndependenceReport(
        predictions=p, errors=err, kendall_tau=kendall_tau(p, err)
    )
