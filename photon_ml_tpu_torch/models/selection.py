"""Best-model selection on validation data (counterpart of
``photon_ml_tpu/models/selection.py``; the reference's
``ModelSelection.scala:31,39-77``): classifiers pick max AUROC, linear
regression min RMSE, Poisson min total Poisson loss."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.models.training import TrainedModel
from photon_ml_tpu_torch.ops import metrics


def validation_metric(task: TaskType, model, batch: LabeledBatch) -> Tuple[str, torch.Tensor]:
    """(metric name, value) used for selection; higher is better iff AUC."""
    w = batch.effective_weights()
    margins = model.compute_margin(batch.features, batch.offsets)
    if task.is_classifier:
        return "AUC", metrics.area_under_roc_curve(batch.labels, margins, w)
    if task == TaskType.POISSON_REGRESSION:
        return "POISSON_LOSS", metrics.total_poisson_loss(batch.labels, margins, w)
    return "RMSE", metrics.root_mean_squared_error(
        batch.labels, model.compute_mean(batch.features, batch.offsets), w
    )


def select_best_model(
    trained: Sequence[TrainedModel], validation: LabeledBatch
) -> Tuple[TrainedModel, dict]:
    """(best model, {reg_weight: metric value}). Candidates compare by
    position, so duplicate reg weights stay distinct candidates."""
    if not trained:
        raise ValueError("no trained models to select from")
    task = trained[0].model.task
    higher_is_better = task.is_classifier
    scores = {}
    values = []
    for tm in trained:
        _, value = validation_metric(task, tm.model, validation)
        values.append(float(value))
        scores[tm.reg_weight] = float(value)
    best_i = (max if higher_is_better else min)(range(len(trained)), key=values.__getitem__)
    return trained[best_i], scores
