"""Hosmer–Lemeshow goodness-of-fit for logistic models (counterpart of
``photon_ml_tpu/diagnostics/hl.py``).

Rebuild of ``diagnostics/hl/HosmerLemeshowDiagnostic.scala:28-97`` +
``DefaultPredictedProbabilityVersusObservedFrequencyBinner.scala:28-62`` +
``PredictedProbabilityVersusObservedFrequencyHistogramBin.scala:30-79``.
The reference walks the RDD once per partition updating mutable bins via
binary search; here the whole binning is two ``bincount`` calls on the bin
index vector (one device pass), after which the chi-square arithmetic is
host-side scalar work on the B-bin table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from photon_ml_tpu_torch.utils.device import to_numpy

# ``HosmerLemeshowDiagnostic.scala:92-96``
STANDARD_CONFIDENCE_LEVELS = (
    0.000001, 0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5,
    0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 0.999999,
)
MINIMUM_EXPECTED_IN_BUCKET = 5
# ``DefaultPredictedProbabilityVersusObservedFrequencyBinner`` — the
# reference applies FACTOR_A to both the sqrt and log1p terms (its
# FACTOR_B constant is defined but unused); replicated as-written.
DATA_HEURISTIC_FACTOR_A = 0.9


@dataclasses.dataclass(frozen=True)
class HistogramBin:
    """One [lower, upper) probability bin with observed +/- counts and the
    midpoint-based expected counts (``...HistogramBin.scala:30-79``)."""

    lower: float
    upper: float
    observed_pos: int
    observed_neg: int

    @property
    def total(self) -> int:
        return self.observed_pos + self.observed_neg

    @property
    def expected_pos(self) -> int:
        # ceil(total * bin midpoint), like the reference's Long ceil
        return int(math.ceil(self.total * (self.lower + self.upper) / 2.0))

    @property
    def expected_neg(self) -> int:
        return self.total - self.expected_pos


@dataclasses.dataclass(frozen=True)
class HosmerLemeshowReport:
    """``hl/HosmerLemeshowReport.scala``: the binned table plus the
    chi-square score, degrees of freedom, and confidence cutoffs."""

    binning_msg: str
    chi_square_msg: str
    chi_square: float
    degrees_of_freedom: int
    chi_square_probability: float  # P(X^2 <= observed) under H0
    cutoffs: Tuple[Tuple[float, float], ...]  # (confidence level, cutoff)
    bins: Tuple[HistogramBin, ...]

    @property
    def p_value(self) -> float:
        """P(X^2 >= observed): small means the model is poorly calibrated."""
        return 1.0 - self.chi_square_probability


def _bin_count(num_items: int, num_dimensions: int) -> Tuple[str, int]:
    """``DefaultPredictedProbabilityVersusObservedFrequencyBinner``: the
    min of a dimension-driven and a data-volume-driven bin target."""
    by_dim = num_dimensions + 2
    by_data = int(
        DATA_HEURISTIC_FACTOR_A * math.sqrt(num_items)
        + DATA_HEURISTIC_FACTOR_A * math.log1p(num_items)
    )
    actual = max(1, min(by_data, by_dim))
    ok = (
        "Sufficient bins for a discriminative test"
        if actual >= by_dim
        else "Not enough bins for a discriminative test; please be careful "
        "when interpreting these results or rerun with more data"
    )
    msg = (
        f"Number of test set samples: {num_items}\n"
        f"Sample dimensionality: {num_dimensions}\n"
        f"Target number of bins based on dimensionality alone: {by_dim}\n"
        f"Target number of bins based on data alone: {by_data}\n"
        f"{ok}"
    )
    return msg, actual


def hosmer_lemeshow(
    labels,
    predicted_probabilities,
    num_dimensions: int,
    weights=None,
) -> HosmerLemeshowReport:
    """HL test on (observed label, predicted probability) pairs.

    ``labels`` in {0, 1}; probabilities in [0, 1]. Rows with weight 0
    (padding) are dropped. Binning + counting is vectorized; the chi-square
    over the B-bin table follows ``HosmerLemeshowDiagnostic.scala:46-90``
    exactly, including the zero-expected guards and the small-expected-count
    warnings.
    """
    y = to_numpy(labels, np.float64)
    p = to_numpy(predicted_probabilities, np.float64)
    if weights is not None:
        keep = to_numpy(weights, np.float64) > 0
        y, p = y[keep], p[keep]
    n = y.shape[0]
    bin_msg, num_bins = _bin_count(n, num_dimensions)

    idx = np.clip((p * num_bins).astype(np.int64), 0, num_bins - 1)
    pos = np.bincount(idx, weights=(y > 0.5), minlength=num_bins)
    tot = np.bincount(idx, minlength=num_bins)
    neg = tot - pos

    bins: List[HistogramBin] = [
        HistogramBin(
            lower=b / num_bins,
            upper=(b + 1) / num_bins,
            observed_pos=int(pos[b]),
            observed_neg=int(neg[b]),
        )
        for b in range(num_bins)
    ]

    chi_sq = 0.0
    msgs: List[str] = []
    for b in bins:
        ep, en = b.expected_pos, b.expected_neg
        if ep > 0:
            chi_sq += (b.observed_pos - ep) ** 2 / float(ep)
        if ep < MINIMUM_EXPECTED_IN_BUCKET:
            msgs.append(
                f"For bin [{b.lower:.4f}, {b.upper:.4f}), expected positive "
                "count is too small to soundly use in a Chi^2 estimate"
            )
        if en > 0:
            chi_sq += (b.observed_neg - en) ** 2 / float(en)
        if en < MINIMUM_EXPECTED_IN_BUCKET:
            msgs.append(
                f"For bin [{b.lower:.4f}, {b.upper:.4f}), expected negative "
                "count is too small to soundly use in a Chi^2 estimate"
            )

    from scipy.stats import chi2 as chi2_dist

    dof = max(num_bins - 2, 1)
    cutoffs = tuple(
        (level, float(chi2_dist.ppf(level, dof)))
        for level in STANDARD_CONFIDENCE_LEVELS
    )
    prob = float(chi2_dist.cdf(chi_sq, dof))

    return HosmerLemeshowReport(
        binning_msg=bin_msg,
        chi_square_msg="\n".join(msgs),
        chi_square=chi_sq,
        degrees_of_freedom=dof,
        chi_square_probability=prob,
        cutoffs=cutoffs,
        bins=tuple(bins),
    )
