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
plain tensor products. A hybrid design takes the unfused passes, as in the
JAX package: ``matvec`` / ``rmatvec`` / ``colsum`` per cold segment (the
``ell_matvec`` kernel and the column-sorted reduce on the card) plus a
plain product on its dense slab.

Distribution (the JAX package's ``axis_name`` / ``_maybe_psum`` /
``with_axis``): every method computes this rank's pure data partials, and
with ``axis_name`` set they are summed over that axis of the active mesh
(:func:`photon_ml_tpu_torch.parallel.mesh.set_mesh`) by one explicit
all-reduce per pass — the value and the gradient together, the
Hessian-vector product, the diagonal — with L2 added once, to the reduced
value. Under a mesh that splits the coefficient axis, ``w`` and every
(d,) vector are this rank's block: the margins are a block sum over the
'feature' group, with the coefficient-space dots (the L2 term, the
normalization's margin shift) riding the same all-reduce when
``fuse_feature_reductions`` (``ops.sparse.matvec_and_feature_dots``); the
ELL blocks run ``ell_matvec`` and the column-sorted reduce, and the fused
passes run on a row-sharded ELL design.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
from photon_ml_tpu_torch.ops.sparse import (
    as_dense,
    colsum,
    is_sparse,
    is_structured,
    margins_sum_blocks,
    matvec,
    matvec_and_feature_dots,
    rmatvec,
)
from photon_ml_tpu_torch.parallel.mesh import all_reduce, feature_sharded, feature_sum

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
    # the active mesh's axis the data partials sum over (None: local sums)
    axis_name: Optional[str] = None
    # under a mesh that splits the coefficient axis: the L2 value dot and
    # the margin shift ride the margins' all-reduce (one collective a pass)
    fuse_feature_reductions: bool = True

    @property
    def _has_l2(self) -> bool:
        return self.l2_weight != 0.0

    def _psum(self, *ts: torch.Tensor, label: str):
        """The tensors summed over ``axis_name`` by ONE all-reduce of their
        concatenation (themselves without an axis)."""
        if self.axis_name is None:
            return ts if len(ts) > 1 else ts[0]
        flat = torch.cat([t.reshape(-1) for t in ts])
        flat = all_reduce(flat, self.axis_name, label)
        out, i = [], 0
        for t in ts:
            out.append(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return tuple(out) if len(out) > 1 else out[0]

    def _fused_dots(self, batch: LabeledBatch) -> bool:
        return self.fuse_feature_reductions and margins_sum_blocks(batch.features)

    # -- margins ---------------------------------------------------------

    def margins(self, w: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        return self._dmargin_dot(w, batch) + batch.offsets

    def _dmargin_dot(self, v: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        """(d margin / d w) @ v for each row: the normalized-feature dot. On
        a feature-sharded solve with whitening shifts the margin shift
        rides the margins' all-reduce."""
        norm = self.normalization
        eff = norm.effective_coefficients(v)
        if self._fused_dots(batch) and norm.shifts is not None:
            z0, (ms,) = matvec_and_feature_dots(batch.features, eff, ((norm.shifts, eff),))
            return z0 - ms
        return matvec(batch.features, eff) + norm.margin_shift(v)

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
        pass; other designs: a margins pass and a back-projection. The
        value and gradient partials reduce in one all-reduce over
        ``axis_name``."""
        if is_sparse(batch.features):
            return self._value_grad_curvature_fused(w, batch)
        norm = self.normalization
        wdot = None
        if self._fused_dots(batch) and (self._has_l2 or norm.shifts is not None):
            eff = norm.effective_coefficients(w)
            pairs = []
            if norm.shifts is not None:
                pairs.append((norm.shifts, eff))
            if self._has_l2:
                pairs.append((w, w))
            z0, dots = matvec_and_feature_dots(batch.features, eff, pairs)
            if norm.shifts is not None:
                z0 = z0 - dots[0]
                dots = dots[1:]
            z = z0 + batch.offsets
            if self._has_l2:
                wdot = dots[0]
        else:
            z = self.margins(w, batch)
        ew = batch.effective_weights()
        val = torch.sum(ew * self.loss.value(z, batch.labels))
        a = ew * self.loss.d1(z, batch.labels)
        grad = self._backproject(a, batch)
        c = ew * self.loss.d2(z, batch.labels)
        val, grad = self._psum(val, grad, label="value_grad")
        return self._with_l2(val, grad, w, wdot) + (c,)

    def _with_l2(self, val, grad, w, wdot=None):
        if self._has_l2:
            if wdot is None:
                wdot = feature_sum(torch.dot(w, w))
            val = val + 0.5 * self.l2_weight * wdot
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
        val, grad = self._psum(val, grad, label="value_grad")
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
        hv = self._psum(hv, label="hvp")
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
        diag = self._psum(diag, label="hdiag")
        if self._has_l2:
            diag = diag + self.l2_weight
        return diag

    def hessian_full(self, w: torch.Tensor, batch: LabeledBatch) -> torch.Tensor:
        """The explicit (d, d) Hessian X'^T diag(c) X' + l2 I, for the exact
        Newton solver at small d: dense designs with scale-only (or no)
        normalization. A plain matrix product; no kernel of the port. ELL
        and hybrid designs are refused, as in the JAX package."""
        norm = self.normalization
        if norm.shifts is not None:
            raise ValueError(
                "hessian_full supports scale-only normalization (whiten "
                "shifts change X densely; use hessian_vector instead)"
            )
        if is_structured(batch.features):
            raise ValueError("hessian_full requires dense features")
        if feature_sharded():
            raise ValueError(
                "hessian_full needs the whole coefficient axis on each rank; "
                "a feature-sharded solve runs TRON, LBFGS or OWL-QN"
            )
        x = as_dense(batch.features)
        c = self.hessian_coefficients(w, batch)
        x = x.to(c.dtype)
        h = x.T @ (c[:, None] * x)
        if norm.factors is not None:
            h = h * torch.outer(norm.factors, norm.factors)
        h = self._psum(h, label="hessian_full")
        if self._has_l2:
            h = h + self.l2_weight * torch.eye(w.shape[-1], dtype=h.dtype, device=h.device)
        return h

    # -- variations ------------------------------------------------------

    def with_l2(self, l2_weight: float) -> "GLMObjective":
        return dataclasses.replace(self, l2_weight=l2_weight)

    def with_axis(self, axis_name: Optional[str]) -> "GLMObjective":
        return dataclasses.replace(self, axis_name=axis_name)

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
