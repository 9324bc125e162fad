"""Feature normalization as whitening algebra folded into the objective
(counterpart of ``photon_ml_tpu/core/normalization.py``; the reference's
``normalization/NormalizationContext.scala:41-151``).

The model is trained in normalized space, x' = (x - shift) * factor, but
the margin is computed against raw features:

    margin = x' . w = x . (w * factor) - sum(shift * factor * w)

so normalization costs one extra dot per evaluation and never
materializes normalized features. ``transform_model_coefficients`` maps
the normalized-space solution back to raw-feature space: w_raw = w *
factor, with the intercept absorbing the shift term.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from photon_ml_tpu_torch.core.types import Coefficients


class NormalizationType(enum.Enum):
    """``normalization/NormalizationType.java:21-44``."""

    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """(factors, shifts) whitening parameters; intercept excluded from both.

    factors: (d,) multiplicative scale, or None for identity
    shifts:  (d,) subtractive shift, or None for zero
    """

    factors: Optional[torch.Tensor]
    shifts: Optional[torch.Tensor]

    def effective_coefficients(self, w: torch.Tensor) -> torch.Tensor:
        """coef * factor (``ValueAndGradientAggregator.scala:95-104``)."""
        return w * self.factors if self.factors is not None else w

    def margin_shift(self, w: torch.Tensor) -> torch.Tensor:
        """Constant-in-x margin correction, -shift . effective_coefficients,
        as a 0-dim tensor on ``w``'s device
        (``ValueAndGradientAggregator.scala:106-118``)."""
        if self.shifts is None:
            return torch.zeros((), dtype=w.dtype, device=w.device)
        return -torch.dot(self.shifts, self.effective_coefficients(w))

    def transform_model_coefficients(
        self, coef: Coefficients, intercept_index: Optional[int]
    ) -> Coefficients:
        """Normalized-space solution -> raw-feature space
        (``NormalizationContext.scala:77-94``)."""
        w = coef.means
        w_raw = self.effective_coefficients(w)
        if self.shifts is not None:
            if intercept_index is None:
                raise ValueError(
                    "normalization with shifts requires an intercept "
                    "(reference Params.scala:166-169)"
                )
            w_raw = w_raw.clone()
            w_raw[intercept_index] += self.margin_shift(w)
        variances = coef.variances
        if variances is not None and self.factors is not None:
            variances = variances * self.factors**2
        return Coefficients(means=w_raw, variances=variances)

    def inverse_transform_model_coefficients(
        self, coef: Coefficients, intercept_index: Optional[int]
    ) -> Coefficients:
        """Raw-feature space -> normalized space (the exact inverse of
        ``transform_model_coefficients``), for warm starts."""
        w_raw = coef.means
        if self.shifts is not None:
            if intercept_index is None:
                raise ValueError(
                    "normalization with shifts requires an intercept "
                    "(reference Params.scala:166-169)"
                )
            # w_raw_int = w_int + margin_shift(w) = w_int - sum(s*f*w), and
            # s.f.w == s.w_raw off-intercept (shift/factor are 0/1 there)
            correction = torch.dot(self.shifts, w_raw) - (
                self.shifts[intercept_index] * w_raw[intercept_index]
            )
            w_raw = w_raw.clone()
            w_raw[intercept_index] += correction
        w = w_raw / self.factors if self.factors is not None else w_raw
        variances = coef.variances
        if variances is not None and self.factors is not None:
            variances = variances / self.factors**2
        return Coefficients(means=w, variances=variances)


def no_normalization() -> NormalizationContext:
    """``normalization/NoNormalization.scala`` — identity context."""
    return NormalizationContext(factors=None, shifts=None)


def build_normalization_context(
    norm_type: NormalizationType,
    summary,
    intercept_index: Optional[int],
) -> NormalizationContext:
    """``NormalizationContext.apply`` (``NormalizationContext.scala:96-151``):
    (factors, shifts) from a feature summary exposing ``mean``,
    ``variance`` and ``max_abs`` as (d,) tensors (``ops.stats``)."""
    if norm_type == NormalizationType.NONE:
        return no_normalization()

    def protect(x):
        # zero-variance / zero-magnitude features get factor 1.0
        return torch.where(x > 0, x, torch.ones_like(x))

    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors = 1.0 / torch.sqrt(protect(summary.variance))
        shifts = None
    elif norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors = 1.0 / protect(summary.max_abs)
        shifts = None
    elif norm_type == NormalizationType.STANDARDIZATION:
        factors = 1.0 / torch.sqrt(protect(summary.variance))
        shifts = summary.mean.clone()
    else:
        raise ValueError(f"unknown normalization type {norm_type}")

    if intercept_index is not None:
        factors[intercept_index] = 1.0
        if shifts is not None:
            shifts[intercept_index] = 0.0
    elif shifts is not None:
        raise ValueError(
            "standardization requires an intercept term "
            "(reference Params.scala:166-169)"
        )
    return NormalizationContext(factors=factors, shifts=shifts)
