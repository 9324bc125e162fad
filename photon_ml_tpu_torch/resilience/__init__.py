"""Resilience (counterpart of ``photon_ml_tpu/resilience``): the
preemption handler and marker the GAME training driver uses, the retry
with backoff of the checkpoint writer, and the fault-injection registry
(``faults``) whose sites the checkpoint store, coordinate descent and
the serving stack probe."""

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
    "PREEMPTED_MARKER",
    "RetryBudgetExceeded",
    "clear_preempted_marker",
    "read_preempted_marker",
    "retry_call",
    "write_preempted_marker",
]
