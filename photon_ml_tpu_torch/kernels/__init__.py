"""Hand-written CUDA kernels for Hopper (counterpart of
``photon_ml_tpu/kernels``, whose Pallas TPU kernels they replace).

``dispatch`` routes by tensor device and counts launches; ``build``
compiles ``csrc/*.cu`` with ``nvcc`` at first use; ``ell`` holds the
padded-ELL gather and scatter kernels, ``fused`` the fused objective
passes and ``lab`` the sparse kernel lab's lane gather, column-sorted
gather and column-sorted reduce with their layout; each kernel with its
plain PyTorch version.
"""

from photon_ml_tpu_torch.kernels.dispatch import (
    design_reads,
    launch_counts,
    record_kernel_cost,
    reset_launch_counts,
)
from photon_ml_tpu_torch.kernels.ell import (
    ell_colsum,
    ell_matvec,
    ell_matvec_reference,
    ell_rmatvec,
    ell_scatter_add,
    ell_scatter_add_reference,
)
from photon_ml_tpu_torch.kernels.fused import (
    fused_hessian_diagonal,
    fused_hessian_diagonal_reference,
    fused_hessian_vector,
    fused_hessian_vector_reference,
    fused_value_grad_curvature,
    fused_value_grad_curvature_reference,
)
from photon_ml_tpu_torch.kernels.lab import (
    ColumnTiles,
    column_sorted_tiles,
    lane_gather,
    lane_gather_reference,
    onehot_gather,
    onehot_gather_reference,
    onehot_reduce,
    onehot_reduce_reference,
)

__all__ = [
    "design_reads",
    "launch_counts",
    "record_kernel_cost",
    "reset_launch_counts",
    "ell_colsum",
    "ell_matvec",
    "ell_matvec_reference",
    "ell_rmatvec",
    "ell_scatter_add",
    "ell_scatter_add_reference",
    "fused_hessian_diagonal",
    "fused_hessian_diagonal_reference",
    "fused_hessian_vector",
    "fused_hessian_vector_reference",
    "fused_value_grad_curvature",
    "fused_value_grad_curvature_reference",
    "ColumnTiles",
    "column_sorted_tiles",
    "lane_gather",
    "lane_gather_reference",
    "onehot_gather",
    "onehot_gather_reference",
    "onehot_reduce",
    "onehot_reduce_reference",
]
