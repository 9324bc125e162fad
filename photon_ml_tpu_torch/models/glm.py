"""Generalized linear models (counterpart of
``photon_ml_tpu/models/glm.py``; the reference's
``supervised/model/GeneralizedLinearModel.scala:27`` and its task
subclasses): coefficients plus a task, which picks the link."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import Coefficients
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.sparse import matvec

__all__ = ["GeneralizedLinearModel", "TaskType"]


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """(coefficients, task)."""

    coefficients: Coefficients
    task: TaskType

    @property
    def dim(self) -> int:
        return self.coefficients.dim

    def compute_margin(
        self, features, offsets: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        m = matvec(features, self.coefficients.means)
        return m if offsets is None else m + offsets

    def compute_mean(self, features, offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """E[y|x]: identity / sigmoid / exp link per task
        (``GeneralizedLinearModel.computeMean`` overrides)."""
        return loss_for_task(self.task).mean(self.compute_margin(features, offsets))

    def predict_class(
        self, features, threshold: float = 0.5, offsets: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """``BinaryClassifier.predictClassWithThreshold``: mean > t -> 1.0."""
        if not self.task.is_classifier:
            raise ValueError(f"{self.task} is not a binary classifier")
        mean = self.compute_mean(features, offsets)
        return (mean > threshold).to(mean.dtype)

    def validate_coefficients(self) -> bool:
        """``GeneralizedLinearModel.validateCoefficients``: all finite."""
        return bool(torch.isfinite(self.coefficients.means).all())

    def with_coefficients(self, coefficients: Coefficients):
        return dataclasses.replace(self, coefficients=coefficients)
