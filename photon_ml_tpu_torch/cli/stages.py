"""Driver stage protocol (a copy of ``photon_ml_tpu/cli/stages.py``, which
imports nothing of JAX; the port keeps its own).

Rebuild of ``DriverStage.scala:22-55`` + the stage assertions woven through
``Driver.scala:76-570``: the pipeline progresses INIT -> PREPROCESSED ->
TRAINED -> VALIDATED -> DIAGNOSED; each phase asserts its preconditions so
a driver bug surfaces as a clear stage error, and the completed-stage
history is recorded for the integration tests (the reference's
``MockDriver`` asserts exactly this, ``MockDriver.scala:49-86``)."""

from __future__ import annotations

import enum
from typing import List


class DriverStage(enum.IntEnum):
    INIT = 0
    PREPROCESSED = 1
    TRAINED = 2
    VALIDATED = 3
    DIAGNOSED = 4


class StageTracker:
    """Monotone stage progression with precondition assertions."""

    def __init__(self) -> None:
        self.stage = DriverStage.INIT
        self.history: List[DriverStage] = [DriverStage.INIT]

    def assert_at_least(self, stage: DriverStage) -> None:
        if self.stage < stage:
            raise RuntimeError(
                f"driver stage error: requires {stage.name}, at {self.stage.name}"
            )

    def advance(self, stage: DriverStage) -> None:
        if stage <= self.stage:
            raise RuntimeError(
                f"driver stage error: cannot move {self.stage.name} -> {stage.name}"
            )
        self.stage = stage
        self.history.append(stage)
