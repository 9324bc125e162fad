"""Kernel routing, launch counts and the kernel cost record
(counterpart of ``photon_ml_tpu/kernels/dispatch.py``).

The route follows the tensors' device, and nothing else:

- every tensor on the CPU -> the kernel's plain PyTorch version;
- every tensor on one CUDA device -> the hand-written CUDA kernel, which
  either launches or raises. There is no probe, no environment knob and no
  fallback to the plain version for a CUDA tensor.
- anything else (mixed devices, another device type) raises.

Each kernel wrapper adds one to its launch count where it launches its
kernel, so a run can show that its main path went through the kernels.
``record_kernel_cost`` keeps each (kernel, shape)'s analytic cost — FLOPs,
bytes, and the one-design-read roofline traffic — in a plain dict.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

__all__ = [
    "KERNELS",
    "use_kernel",
    "count_launch",
    "launch_counts",
    "reset_launch_counts",
    "design_reads",
    "record_kernel_cost",
    "kernel_costs",
]

# Design reads per pass, per kernel: the least traffic of each pass reads
# (indices, values) once. On the card ell_rmatvec, ell_colsum and the fused
# passes' X^T side run the column-sorted reduce (kernels/colsort.py), which
# counts its own launches as colsort_reduce as well and reads the design's
# column-sorted copy once; the fused passes read the design twice (the ELL,
# then the copy), which their analytic_bytes record. The sparse kernel
# lab's kernels (kernels/lab.py) read their table or column-sorted tiles
# once.
_DESIGN_READS = {
    "ell_matvec": 1,
    "ell_scatter_add": 1,
    "ell_rmatvec": 1,
    "ell_colsum": 1,
    "fused_vgc": 1,
    "fused_hvp": 1,
    "fused_hdiag": 1,
    "colsort_reduce": 1,
    "lane_gather": 1,
    "onehot_gather": 1,
    "onehot_reduce": 1,
}
KERNELS: Tuple[str, ...] = tuple(_DESIGN_READS)

_lock = threading.Lock()
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_costs: Dict[tuple, Dict[str, float]] = {}


def use_kernel(kernel: str, *tensors: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version.
    Raises unless all ``tensors`` share one CPU or CUDA device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"{kernel}: tensors on more than one device: "
            f"{sorted(str(d) for d in devices)}"
        )
    (dev,) = devices
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{kernel}: no route for device {dev}")


def count_launch(kernel: str) -> None:
    with _lock:
        _launches[kernel] += 1


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0


def design_reads(kernel: str) -> int:
    return _DESIGN_READS[kernel]


def record_kernel_cost(
    kernel: str,
    n: int,
    k: int,
    d: int,
    itemsize: int,
    flops_per_slot: float = 2.0,
    extra_bytes: float = 0.0,
) -> None:
    """Record one (kernel, shape)'s analytic cost, once per key.

    ``roofline_bytes`` is ``design_reads(kernel)`` times the stored design
    bytes (int32 ids + payload): the least HBM traffic of the pass."""
    key = (kernel, n, k, d, itemsize)
    slots = float(n) * float(k)
    design_bytes = slots * (4 + itemsize)
    reads = design_reads(kernel)
    with _lock:
        _costs.setdefault(
            key,
            {
                "analytic_flops": flops_per_slot * slots,
                "analytic_bytes": reads * design_bytes + extra_bytes,
                "roofline_bytes": reads * design_bytes,
            },
        )


def kernel_costs() -> Dict[tuple, Dict[str, float]]:
    with _lock:
        return {k: dict(v) for k, v in _costs.items()}
