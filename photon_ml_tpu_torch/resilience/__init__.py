"""Resilience (counterpart of ``photon_ml_tpu/resilience``): the
preemption handler and marker the GAME training driver uses, the retry
with backoff of the checkpoint writer and the collective watchdog, the
fault-injection registry (``faults``) whose sites the checkpoint store,
coordinate descent, the serving stack and the host collectives probe, and
the host-loss contract (``hostloss``: detection -> marker -> the distinct
exit code)."""

from photon_ml_tpu_torch.resilience.faults import (
    KNOWN_SITES,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    UnknownFaultSite,
    arm_from_env,
    corrupt_file,
    fire,
    inject,
    known_sites,
    parse_spec,
    register_site,
    registered_sites,
    registry,
)
from photon_ml_tpu_torch.resilience.hostloss import (
    HOST_LOSS_EXIT_CODE,
    HOST_LOSS_MARKER,
    HostLossDetected,
    clear_host_loss_marker,
    is_host_loss,
    read_host_loss_marker,
    write_host_loss_marker,
)
from photon_ml_tpu_torch.resilience.retry import (
    RetryBudgetExceeded,
    backoff_delays,
    retry_call,
)
from photon_ml_tpu_torch.resilience.shutdown import (
    PREEMPTED_MARKER,
    GracefulShutdown,
    clear_preempted_marker,
    read_preempted_marker,
    write_preempted_marker,
)

__all__ = [
    "KNOWN_SITES",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "UnknownFaultSite",
    "arm_from_env",
    "backoff_delays",
    "corrupt_file",
    "fire",
    "inject",
    "known_sites",
    "parse_spec",
    "register_site",
    "registered_sites",
    "registry",
    "GracefulShutdown",
    "HOST_LOSS_EXIT_CODE",
    "HOST_LOSS_MARKER",
    "HostLossDetected",
    "clear_host_loss_marker",
    "is_host_loss",
    "read_host_loss_marker",
    "write_host_loss_marker",
    "PREEMPTED_MARKER",
    "RetryBudgetExceeded",
    "clear_preempted_marker",
    "read_preempted_marker",
    "retry_call",
    "write_preempted_marker",
]
