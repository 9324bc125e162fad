"""Hand-written CUDA kernels for Hopper (counterpart of
``photon_ml_tpu/kernels``, whose Pallas TPU kernels they replace).

``dispatch`` routes by tensor device and counts launches; ``build``
compiles ``csrc/*.cu`` with ``nvcc`` at first use; ``ell`` holds the
padded-ELL kernels with their plain PyTorch versions.
"""

from photon_ml_tpu_torch.kernels.dispatch import (
    design_reads,
    launch_counts,
    record_kernel_cost,
    reset_launch_counts,
)
from photon_ml_tpu_torch.kernels.ell import ell_matvec, ell_matvec_reference

__all__ = [
    "design_reads",
    "launch_counts",
    "record_kernel_cost",
    "reset_launch_counts",
    "ell_matvec",
    "ell_matvec_reference",
]
