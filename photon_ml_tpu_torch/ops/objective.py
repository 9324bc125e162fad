"""GLM objectives: value / gradient / curvature / Hessian-vector /
Hessian diagonal / full Hessian (counterpart of
``photon_ml_tpu/ops/objective.py``; the reference's
``function/ValueAndGradientAggregator.scala``,
``function/HessianVectorAggregator.scala``,
``function/TwiceDiffFunction.scala`` and
``function/GeneralizedLinearModelLossFunction.scala``).

    margins = X @ (w * factor) + margin_shift(w) + offsets          (n,)
    a       = weight * mask * l'(margins, labels)                   (n,)
    grad    = factor * (X^T @ a) - (shift*factor) * sum(a)          (d,)

Features are never whitened in memory: normalization costs one rank-1
correction. The Hessian-vector product and the Hessian diagonal use the
analytic second derivative the same way. L2 is folded into
value/grad/HVP/diagonal; L1 is kept as ``l1_weight`` for the OWL-QN
solver (``solvers.lbfgs.minimize_owlqn``), which handles it itself.

Padded-ELL designs take the fused single-read passes
(:mod:`photon_ml_tpu_torch.kernels.fused`) on every device — the CUDA
kernels on the card, their plain versions on the CPU; dense designs take
plain tensor products. This is a single-device slice: the JAX package's
``axis_name`` psum and feature-sharded branches are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.core.normalization import (
    NormalizationContext,
    no_normalization,
)
from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.kernels.fused import (
    fused_hessian_diagonal,
    fused_hessian_vector,
    fused_value_grad_curvature,
)
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.sparse import as_dense, colsum, is_sparse, matvec, rmatvec

_REG_TYPES = ("NONE", "L1", "L2", "ELASTIC_NET")


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """Elastic-net split of one regularization weight
    (``optimization/RegularizationContext.scala:25-47``):
    l1 = alpha * lambda, l2 = (1 - alpha) * lambda."""

    reg_type: str = "NONE"  # NONE | L1 | L2 | ELASTIC_NET
    alpha: float = 0.0  # elastic-net mixing; 1.0 = pure L1

    def __post_init__(self):
        if self.reg_type not in _REG_TYPES:
            raise ValueError(
                f"unknown reg_type {self.reg_type!r}; expected one of {_REG_TYPES}"
            )
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"elastic-net alpha must be in [0,1], got {self.alpha}")

    def l1_weight(self, reg_weight: float) -> float:
        if self.reg_type == "L1":
            return reg_weight
        if self.reg_type == "ELASTIC_NET":
            return self.alpha * reg_weight
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        if self.reg_type == "L2":
            return reg_weight
        if self.reg_type == "ELASTIC_NET":
            return (1.0 - self.alpha) * reg_weight
        return 0.0


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """A pointwise loss bound to normalization and regularization. Every
    method is a function of (w, batch); the scalars it returns are 0-dim
    tensors on the batch's device, so nothing here waits for the card."""

    loss: PointwiseLoss
    normalization: NormalizationContext = dataclasses.field(
        default_factory=no_normalization
    )
    l2_weight: float = 0.0
    l1_weight: float = 0.0  # for OWL-QN, NOT added to value/grad here

    @property
    def _has_l2(self) -> bool:
        return self.l2_weight != 0.0

    # -- margins ---------------------------------------------------------

    def margins(self, w: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        return self._dmargin_dot(w, batch) + batch.offsets

    def _dmargin_dot(self, v: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        """(d margin / d w) @ v for each row: the normalized-feature dot."""
        norm = self.normalization
        return matvec(batch.features, norm.effective_coefficients(v)) + norm.margin_shift(v)

    def _backproject(self, a: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        """X'^T @ a, X' the (virtually) normalized design matrix."""
        return self._correct_backprojection(rmatvec(batch.features, a), a.sum())

    def _correct_backprojection(self, g: torch.Tensor, total_a: torch.Tensor):
        """The normalization algebra applied to a raw X^T a, given sum(a)."""
        norm = self.normalization
        if norm.factors is not None:
            g = g * norm.factors
        if norm.shifts is not None:
            shift_eff = norm.shifts * (
                norm.factors if norm.factors is not None else 1.0
            )
            g = g - shift_eff * total_a
        return g

    # -- value / gradient ------------------------------------------------

    def value(self, w: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        return self.value_and_grad(w, batch)[0]

    def value_and_grad(self, w: torch.Tensor, batch: LabeledBatch):
        """Loss and gradient (``ValueAndGradientAggregator.scala:204-235``)."""
        val, grad, _ = self.value_grad_curvature(w, batch)
        return val, grad

    def grad(self, w: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        return self.value_and_grad(w, batch)[1]

    def value_grad_curvature(self, w: torch.Tensor, batch: LabeledBatch):
        """(value, gradient, curvature weights) from ONE margins pass. The
        curvature weights c = ew_i * l''(z_i) are what
        :meth:`hessian_vector_at` takes: TRON's acceptance evaluation
        already computes z at the trial point, so the next CG loop starts
        with c for free. ELL designs: one ``fused_value_grad_curvature``
        pass."""
        if is_sparse(batch.features):
            return self._value_grad_curvature_fused(w, batch)
        z = self.margins(w, batch)
        ew = batch.effective_weights()
        val = torch.sum(ew * self.loss.value(z, batch.labels))
        a = ew * self.loss.d1(z, batch.labels)
        grad = self._backproject(a, batch)
        c = ew * self.loss.d2(z, batch.labels)
        return self._with_l2(val, grad, w) + (c,)

    def _with_l2(self, val, grad, w):
        if self._has_l2:
            val = val + 0.5 * self.l2_weight * torch.dot(w, w)
            grad = grad + self.l2_weight * w
        return val, grad

    def _value_grad_curvature_fused(self, w: torch.Tensor, batch: LabeledBatch):
        x = batch.features
        norm = self.normalization
        # the margin shift is a scalar: it folds into the per-row offsets
        off = batch.offsets + norm.margin_shift(w)
        val, g, asum, c = fused_value_grad_curvature(
            x.indices, x.values, batch.labels, off, batch.effective_weights(),
            norm.effective_coefficients(w), x.d, self.loss,
        )
        grad = self._correct_backprojection(g, asum)
        return self._with_l2(val, grad, w) + (c,)

    # -- second-order ----------------------------------------------------

    def hessian_vector(
        self, w: torch.Tensor, v: torch.Tensor, batch: LabeledBatch
    ) -> torch.Tensor:
        """H(w) @ v via the analytic l'' (``HessianVectorAggregator.scala:57-117``)."""
        return self.hessian_vector_at(self.hessian_coefficients(w, batch), v, batch)

    def hessian_coefficients(self, w: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        """(n,) curvature weights c = ew_i * l''(z_i, y_i): the only
        w-dependent part of H(w) @ v, fixed across one CG solve."""
        z = self.margins(w, batch)
        return batch.effective_weights() * self.loss.d2(z, batch.labels)

    def hessian_vector_at(
        self, c: torch.Tensor, v: torch.Tensor, batch: LabeledBatch
    ) -> torch.Tensor:
        """H @ v given the curvature weights ``c``. ELL designs: one
        ``fused_hessian_vector`` pass (the v-margins gather and the
        back-projection scatter share one sweep of the design)."""
        norm = self.normalization
        x = batch.features
        if is_sparse(x):
            hv0, usum = fused_hessian_vector(
                x.indices, x.values, c, norm.effective_coefficients(v),
                norm.margin_shift(v), x.d,
            )
            hv = self._correct_backprojection(hv0, usum)
        else:
            hv = self._backproject(c * self._dmargin_dot(v, batch), batch)
        if self._has_l2:
            hv = hv + self.l2_weight * v
        return hv

    def hessian_diagonal(self, w: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        """diag(H) for coefficient variances (``TwiceDiffFunction.scala:179-394``,
        used by ``OptimizationProblem.updateCoefficientsVariances``). ELL
        designs: one ``fused_hessian_diagonal`` pass; dense designs: column
        sums. Whitening shifts expand (x - s)^2 into
        colsum(x^2 c) - 2 s colsum(x c) + s^2 sum(c)."""
        norm = self.normalization
        x = batch.features
        if is_sparse(x):
            d_x2, d_x, csum = fused_hessian_diagonal(
                x.indices, x.values, batch.labels,
                batch.offsets + norm.margin_shift(w), batch.effective_weights(),
                norm.effective_coefficients(w), x.d, self.loss,
            )
        else:
            c = self.hessian_coefficients(w, batch)
            d_x2 = colsum(x, c, square=True)
            if norm.shifts is not None:
                d_x, csum = colsum(x, c), c.sum()
        diag = d_x2
        if norm.shifts is not None:
            s = norm.shifts
            diag = d_x2 - 2.0 * s * d_x + s * s * csum
        if norm.factors is not None:
            diag = diag * norm.factors**2
        if self._has_l2:
            diag = diag + self.l2_weight
        return diag

    def hessian_full(self, w: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        """The explicit (d, d) Hessian X'^T diag(c) X' + l2 I, for the exact
        Newton solver at small d: dense designs with scale-only (or no)
        normalization. A plain matrix product; no kernel of the port."""
        norm = self.normalization
        if norm.shifts is not None:
            raise ValueError(
                "hessian_full supports scale-only normalization (whiten "
                "shifts change X densely; use hessian_vector instead)"
            )
        if is_sparse(batch.features):
            raise ValueError("hessian_full requires dense features")
        x = as_dense(batch.features)
        c = self.hessian_coefficients(w, batch)
        x = x.to(c.dtype)
        h = x.T @ (c[:, None] * x)
        if norm.factors is not None:
            h = h * torch.outer(norm.factors, norm.factors)
        if self._has_l2:
            h = h + self.l2_weight * torch.eye(w.shape[-1], dtype=h.dtype, device=h.device)
        return h

    # -- variations ------------------------------------------------------

    def with_l2(self, l2_weight: float) -> "GLMObjective":
        return dataclasses.replace(self, l2_weight=l2_weight)

    def with_regularization(
        self, reg: RegularizationContext, reg_weight: float
    ) -> "GLMObjective":
        """``DiffFunction.withRegularization`` (``DiffFunction.scala:198-321``):
        L2 into the objective, L1 as an optimizer flag."""
        return dataclasses.replace(
            self,
            l2_weight=reg.l2_weight(reg_weight),
            l1_weight=reg.l1_weight(reg_weight),
        )
