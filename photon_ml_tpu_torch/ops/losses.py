"""Pointwise GLM losses: l(z, y), dl/dz, d2l/dz2 on the margin
z = x.w + offset (counterpart of ``photon_ml_tpu/ops/losses.py``; the
reference's ``function/PointwiseLossFunction.scala:23-39``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Fn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _identity(z: torch.Tensor) -> torch.Tensor:
    return z


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """l(z,y), l'(z,y), l''(z,y) — all elementwise over same-shape tensors."""

    name: str
    value: Fn
    d1: Fn
    d2: Fn
    # E[y|z] link inverse for scoring (``GeneralizedLinearModel.computeMean``)
    mean: Callable[[torch.Tensor], torch.Tensor] = _identity
    # smoothed hinge is first-order only in the reference
    twice_differentiable: bool = True


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``logaddexp(x, 0)`` — the same formula as
    ``jax.nn.softplus`` (``torch.nn.functional.softplus`` switches to the
    identity above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _logistic_value(z, y):
    # labels {0,1} -> s in {-1,+1}; l = softplus(-s z)
    # (``function/LogisticLossFunction.scala:31-88``)
    s = 2.0 * y - 1.0
    return softplus(-s * z)


def _logistic_d1(z, y):
    s = 2.0 * y - 1.0
    return -s * torch.sigmoid(-s * z)  # = sigmoid(z) - y for y in {0,1}


def _logistic_d2(z, y):
    p = torch.sigmoid(z)
    return p * (1.0 - p)


LOGISTIC_LOSS = PointwiseLoss(
    name="logistic",
    value=_logistic_value,
    d1=_logistic_d1,
    d2=_logistic_d2,
    mean=torch.sigmoid,
)


SQUARED_LOSS = PointwiseLoss(
    # l = 0.5 (z - y)^2  (``function/SquaredLossFunction.scala:29-64``)
    name="squared",
    value=lambda z, y: 0.5 * (z - y) ** 2,
    d1=lambda z, y: z - y,
    d2=lambda z, y: torch.ones_like(z),
)


POISSON_LOSS = PointwiseLoss(
    # l = exp(z) - y z  (``function/PoissonLossFunction.scala:29-81``)
    name="poisson",
    value=lambda z, y: torch.exp(z) - y * z,
    d1=lambda z, y: torch.exp(z) - y,
    d2=lambda z, y: torch.exp(z),
    mean=torch.exp,
)


def _smoothed_hinge_value(z, y):
    # Rennie smoothed hinge on s*z, s in {-1,+1}
    # (``function/SmoothedHingeLossFunction.scala:24-60``)
    m = (2.0 * y - 1.0) * z
    return torch.where(
        m >= 1.0,
        torch.zeros_like(m),
        torch.where(m <= 0.0, 0.5 - m, 0.5 * (1.0 - m) ** 2),
    )


def _smoothed_hinge_d1(z, y):
    s = 2.0 * y - 1.0
    m = s * z
    dldm = torch.where(
        m >= 1.0,
        torch.zeros_like(m),
        torch.where(m <= 0.0, -torch.ones_like(m), m - 1.0),
    )
    return s * dldm


def _smoothed_hinge_d2(z, y):
    m = (2.0 * y - 1.0) * z
    return ((m > 0.0) & (m < 1.0)).to(z.dtype)


SMOOTHED_HINGE_LOSS = PointwiseLoss(
    name="smoothed_hinge",
    value=_smoothed_hinge_value,
    d1=_smoothed_hinge_d1,
    d2=_smoothed_hinge_d2,
    twice_differentiable=False,
)


_LOSS_BY_TASK = {
    "LOGISTIC_REGRESSION": LOGISTIC_LOSS,
    "LINEAR_REGRESSION": SQUARED_LOSS,
    "POISSON_REGRESSION": POISSON_LOSS,
    "SMOOTHED_HINGE_LOSS_LINEAR_SVM": SMOOTHED_HINGE_LOSS,
}


def loss_for_task(task_type) -> PointwiseLoss:
    """Task -> loss dispatch (``ModelTraining.scala:50-93``)."""
    key = getattr(task_type, "name", task_type)
    if key not in _LOSS_BY_TASK:
        raise ValueError(
            f"unknown task type {task_type!r}; expected one of "
            f"{sorted(_LOSS_BY_TASK)}"
        )
    return _LOSS_BY_TASK[key]
