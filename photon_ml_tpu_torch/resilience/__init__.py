"""Resilience (counterpart of ``photon_ml_tpu/resilience``): so far the
preemption handler the GAME training driver installs."""

from photon_ml_tpu_torch.resilience.shutdown import GracefulShutdown

__all__ = ["GracefulShutdown"]
