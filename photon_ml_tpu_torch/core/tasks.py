"""Training task types (``supervised/TaskType.scala:21``).

Lives in core (not models/) so that low layers — validators, losses,
configs — can dispatch on the task without importing the model classes.

A copy of ``photon_ml_tpu/core/tasks.py``.
"""

from __future__ import annotations

import enum


class TaskType(enum.Enum):
    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"

    @property
    def is_classifier(self) -> bool:
        return self in (
            TaskType.LOGISTIC_REGRESSION,
            TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
        )
