"""Resilience (counterpart of ``photon_ml_tpu/resilience``): the
preemption handler and marker the GAME training driver uses, and the
retry with backoff of the checkpoint writer."""

from photon_ml_tpu_torch.resilience.retry import RetryBudgetExceeded, retry_call
from photon_ml_tpu_torch.resilience.shutdown import (
    PREEMPTED_MARKER,
    GracefulShutdown,
    clear_preempted_marker,
    read_preempted_marker,
    write_preempted_marker,
)

__all__ = [
    "GracefulShutdown",
    "PREEMPTED_MARKER",
    "RetryBudgetExceeded",
    "clear_preempted_marker",
    "read_preempted_marker",
    "retry_call",
    "write_preempted_marker",
]
