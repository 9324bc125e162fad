"""Self-healing model lifecycle: drift-triggered continual retrain
(counterpart of ``photon_ml_tpu/lifecycle``).

The drift monitor's alarms and the train-time baseline fingerprints are
the trigger; the reload breaker and the manifest gate are the safety
nets. This package closes the loop: a retrain orchestrator that consumes
the drift signal, runs an incremental warm-started retrain (the port's
GAME driver, on the card by default), re-exports through the manifest
gate, and hot-reloads under live traffic with the breaker as the last
line of defense. docs/LIFECYCLE.md is the walkthrough;
``python -m photon_ml_tpu_torch.cli.retrain`` is the operational surface.
"""

from photon_ml_tpu_torch.lifecycle.orchestrator import (
    CycleResult,
    LifecycleError,
    RetrainOrchestrator,
    RetrainPlan,
    StageResult,
    WarmStartError,
    export_retrained_model,
    fingerprint_drift_trigger,
    latest_version_dir,
    load_admission_candidates,
    load_warm_start,
    next_version_dir,
    registry_drift_trigger,
    select_retrain_targets,
)

__all__ = [
    "CycleResult",
    "LifecycleError",
    "RetrainOrchestrator",
    "RetrainPlan",
    "StageResult",
    "WarmStartError",
    "export_retrained_model",
    "fingerprint_drift_trigger",
    "latest_version_dir",
    "load_admission_candidates",
    "load_warm_start",
    "next_version_dir",
    "registry_drift_trigger",
    "select_retrain_targets",
]
