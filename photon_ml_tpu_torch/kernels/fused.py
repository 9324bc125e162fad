"""Fused ELL objective passes: one design read per pass (counterpart of
``photon_ml_tpu/kernels/fused.py``; kernels in ``csrc/fused.cu``).

- :func:`fused_value_grad_curvature` — margins, the weighted loss sum, the
  raw back-projection X^T a with a = ew * l'(z), sum(a) for the
  normalization rank-1 correction, and the curvature weights
  c = ew * l''(z) that TRON's next CG loop takes.
- :func:`fused_hessian_vector` — one CG step's raw H @ v:
  X^T (c * (X @ v_eff + shift)) and sum(u).
- :func:`fused_hessian_diagonal` — the variance pass: margins, then
  colsum(x^2 c), colsum(x c) and sum(c) with c = ew * l''(z).

``GLMObjective`` applies the normalization algebra and L2 outside; those
touch (d,) and (n,) vectors, not the design. On CUDA tensors each wrapper
makes one C call (or raises), which zeroes the (d,) outputs and launches
the kernel and a fixed-order sum of the per-block scalar partials on the
current stream; on CPU tensors it runs the ``*_reference`` function, the
plain PyTorch version. All three take tiles of whole rows and sum a tile's
repeated columns in shared memory before they reach the (d,) outputs
(``fused_hdiag``: both of its sums under one table slot per column, and
its column sums accumulated in float64 in every compute type, rounded to
float32 once).

Compute type ``result_type(values, w, labels, offsets, ew)``; taken pairs
(values, compute): (float64, float64), (float32, float32),
(bfloat16, float32). The row vectors and the coefficient vector are cast
to the compute type, as the JAX package casts them.
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.kernels import dispatch
from photon_ml_tpu_torch.kernels.ell import (
    check_launch,
    device_scope,
    ell_matvec_reference,
    ell_scatter_add_reference,
    load_entry,
    stream_of,
)

__all__ = [
    "fused_value_grad_curvature",
    "fused_value_grad_curvature_reference",
    "fused_hessian_vector",
    "fused_hessian_vector_reference",
    "fused_hessian_diagonal",
    "fused_hessian_diagonal_reference",
    "fused_compute_dtype",
]

# (values dtype, compute dtype) -> C entry-point suffix
_FUSED_TYPES = {
    (torch.float64, torch.float64): "f64",
    (torch.float32, torch.float32): "f32",
    (torch.bfloat16, torch.float32): "bf16_f32",
}

# PointwiseLoss.name -> the LossId of csrc/fused.cu
LOSS_IDS = {"logistic": 0, "squared": 1, "poisson": 2, "smoothed_hinge": 3}


def fused_compute_dtype(values_dtype: torch.dtype, *others: torch.dtype) -> torch.dtype:
    """``result_type`` of the pass's inputs; raises for a pair the kernels
    do not take."""
    cd = values_dtype
    for o in others:
        cd = torch.promote_types(cd, o)
    if (values_dtype, cd) not in _FUSED_TYPES:
        raise TypeError(
            f"fused passes take (values, compute) dtypes "
            f"{[(str(v), str(c)) for v, c in _FUSED_TYPES]}, got "
            f"({values_dtype}, {cd})"
        )
    return cd


def _loss_id(loss) -> int:
    try:
        return LOSS_IDS[loss.name]
    except KeyError:
        raise ValueError(
            f"fused passes take the losses {sorted(LOSS_IDS)}, got {loss.name!r}"
        ) from None


# -- value / grad / curvature ------------------------------------------------


def fused_value_grad_curvature_reference(
    indices, values, labels, offsets, ew, w_eff, d: int, loss
):
    """Plain PyTorch version: ``ell_matvec_reference`` margins, the loss
    terms, and ``ell_scatter_add_reference`` of v_ik * a_i."""
    cd = fused_compute_dtype(values.dtype, labels.dtype, offsets.dtype, ew.dtype, w_eff.dtype)
    y, off, e = labels.to(cd), offsets.to(cd), ew.to(cd)
    v = values.to(cd)
    z = ell_matvec_reference(indices, v, w_eff.to(cd), d) + off
    val = (e * loss.value(z, y)).sum()
    a = e * loss.d1(z, y)
    grad = ell_scatter_add_reference(indices, v * a[:, None], d)
    return val, grad, a.sum(), e * loss.d2(z, y)


def fused_value_grad_curvature(indices, values, labels, offsets, ew, w_eff, d: int, loss):
    """One design read -> (loss sum, raw gradient X^T a, sum(a), curvature
    weights c). ``offsets`` already carry the margin shift; ``w_eff`` is
    the normalization-effective coefficient vector. The scalars are 0-dim
    tensors on the inputs' device (no host sync)."""
    cd = fused_compute_dtype(values.dtype, labels.dtype, offsets.dtype, ew.dtype, w_eff.dtype)
    loss_id = _loss_id(loss)
    n, k = indices.shape
    dispatch.record_kernel_cost(
        "fused_vgc", n, k, d, values.element_size(), flops_per_slot=4.0,
        extra_bytes=2 * d * cd.itemsize + 4 * n * cd.itemsize,
    )
    if not dispatch.use_kernel("fused_vgc", indices, values, labels, offsets, ew, w_eff):
        return fused_value_grad_curvature_reference(
            indices, values, labels, offsets, ew, w_eff, d, loss
        )
    y, off, e, w = (t.to(cd).contiguous() for t in (labels, offsets, ew, w_eff))
    check_launch(
        "fused_vgc", indices, d, tables=[("values", values)],
        rows=[("labels", y), ("offsets", off), ("ew", e)], cols=[("w_eff", w)],
    )
    dev = indices.device
    curvature = torch.empty((n,), dtype=cd, device=dev)
    if n == 0:
        sums = torch.zeros((2,), dtype=cd, device=dev)
        return sums[0], torch.zeros((d,), dtype=cd, device=dev), sums[1], curvature
    # the entry point clears grad on the stream before the kernel
    grad = torch.empty((d,), dtype=cd, device=dev)
    import ctypes

    lib, entry = load_entry(
        "fused", f"photon_fused_vgc_{_FUSED_TYPES[(values.dtype, cd)]}",
        [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p],
    )
    # the two sums (written by the kernels' fixed-order finish), then two
    # partials per block
    sums = torch.empty((2 + 2 * _blocks(n, k),), dtype=cd, device=dev)
    with device_scope(dev):
        code = entry(
            indices.data_ptr(), values.data_ptr(), y.data_ptr(), off.data_ptr(),
            e.data_ptr(), w.data_ptr(), grad.data_ptr(), curvature.data_ptr(),
            sums.data_ptr() + 2 * cd.itemsize, sums.data_ptr(), n, k, d, loss_id,
            stream_of(indices),
        )
    from photon_ml_tpu_torch.kernels import build

    build.check(lib, code, "fused_vgc launch")
    dispatch.count_launch("fused_vgc")
    return sums[0], grad, sums[1], curvature


# -- Hessian-vector ----------------------------------------------------------


def fused_hessian_vector_reference(indices, values, c, v_eff, shift_v, d: int):
    """Plain PyTorch version: u = c * (X @ v_eff + shift), X^T u, sum(u)."""
    cd = fused_compute_dtype(values.dtype, c.dtype, v_eff.dtype)
    v = values.to(cd)
    zv = ell_matvec_reference(indices, v, v_eff.to(cd), d) + torch.as_tensor(
        shift_v, dtype=cd, device=c.device
    )
    u = c.to(cd) * zv
    return ell_scatter_add_reference(indices, v * u[:, None], d), u.sum()


def fused_hessian_vector(indices, values, c, v_eff, shift_v, d: int):
    """One design read -> (raw H @ v back-projection, sum(u)). ``c`` are
    the curvature weights of :func:`fused_value_grad_curvature`;
    ``shift_v`` is the scalar margin shift of the direction (a 0-dim
    tensor on the device, read by the kernel: no host sync)."""
    cd = fused_compute_dtype(values.dtype, c.dtype, v_eff.dtype)
    n, k = indices.shape
    dispatch.record_kernel_cost(
        "fused_hvp", n, k, d, values.element_size(), flops_per_slot=4.0,
        extra_bytes=2 * d * cd.itemsize + n * cd.itemsize,
    )
    shift = torch.as_tensor(shift_v, dtype=cd, device=c.device)
    if not dispatch.use_kernel("fused_hvp", indices, values, c, v_eff, shift):
        return fused_hessian_vector_reference(indices, values, c, v_eff, shift, d)
    cc, vv, sh = (t.to(cd).contiguous() for t in (c, v_eff, shift))
    check_launch(
        "fused_hvp", indices, d, tables=[("values", values)],
        rows=[("c", cc)], cols=[("v_eff", vv)],
    )
    dev = indices.device
    if n == 0:
        return torch.zeros((d,), dtype=cd, device=dev), torch.zeros((), dtype=cd, device=dev)
    # the entry point clears hv on the stream before the kernel
    hv = torch.empty((d,), dtype=cd, device=dev)
    import ctypes

    lib, entry = load_entry(
        "fused", f"photon_fused_hvp_{_FUSED_TYPES[(values.dtype, cd)]}",
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p],
    )
    # the sum (written by the kernels' fixed-order finish), then one
    # partial per block
    usum = torch.empty((1 + _blocks(n, k),), dtype=cd, device=dev)
    with device_scope(dev):
        code = entry(
            indices.data_ptr(), values.data_ptr(), cc.data_ptr(), sh.data_ptr(),
            vv.data_ptr(), hv.data_ptr(), usum.data_ptr() + cd.itemsize, usum.data_ptr(),
            n, k, d, stream_of(indices),
        )
    from photon_ml_tpu_torch.kernels import build

    build.check(lib, code, "fused_hvp launch")
    dispatch.count_launch("fused_hvp")
    return hv, usum[0]


# -- Hessian diagonal --------------------------------------------------------


def fused_hessian_diagonal_reference(
    indices, values, labels, offsets, ew, w_eff, d: int, loss
):
    """Plain PyTorch version: ``ell_matvec_reference`` margins, c = ew *
    l''(z), and ``ell_scatter_add_reference`` of v_ik^2 c_i and v_ik c_i
    (each slot squared on its own)."""
    cd = fused_compute_dtype(values.dtype, labels.dtype, offsets.dtype, ew.dtype, w_eff.dtype)
    v = values.to(cd)
    z = ell_matvec_reference(indices, v, w_eff.to(cd), d) + offsets.to(cd)
    c = ew.to(cd) * loss.d2(z, labels.to(cd))
    dx2 = ell_scatter_add_reference(indices, v * v * c[:, None], d)
    return dx2, ell_scatter_add_reference(indices, v * c[:, None], d), c.sum()


def fused_hessian_diagonal(indices, values, labels, offsets, ew, w_eff, d: int, loss):
    """One design read -> (colsum(x^2, c), colsum(x, c), sum(c)) with
    c = ew * l''(z) from the sweep's own margins. ``offsets`` already
    carry the margin shift; ``w_eff`` is the normalization-effective
    coefficient vector. ``sum(c)`` is a 0-dim tensor on the inputs'
    device (no host sync)."""
    cd = fused_compute_dtype(values.dtype, labels.dtype, offsets.dtype, ew.dtype, w_eff.dtype)
    loss_id = _loss_id(loss)
    n, k = indices.shape
    dispatch.record_kernel_cost(
        "fused_hdiag", n, k, d, values.element_size(), flops_per_slot=5.0,
        extra_bytes=3 * d * cd.itemsize + 3 * n * cd.itemsize,
    )
    if not dispatch.use_kernel("fused_hdiag", indices, values, labels, offsets, ew, w_eff):
        return fused_hessian_diagonal_reference(
            indices, values, labels, offsets, ew, w_eff, d, loss
        )
    y, off, e, w = (t.to(cd).contiguous() for t in (labels, offsets, ew, w_eff))
    check_launch(
        "fused_hdiag", indices, d, tables=[("values", values)],
        rows=[("labels", y), ("offsets", off), ("ew", e)], cols=[("w_eff", w)],
    )
    dev = indices.device
    if n == 0:
        return (torch.zeros((d,), dtype=cd, device=dev), torch.zeros((d,), dtype=cd, device=dev),
                torch.zeros((), dtype=cd, device=dev))
    import ctypes

    lib, entry = load_entry(
        "fused", f"photon_fused_hdiag_{_FUSED_TYPES[(values.dtype, cd)]}",
        [ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p],
    )
    # one allocation: dx2 and dx (cleared by the entry point on the stream),
    # the sum (written by the kernels' fixed-order finish), then one partial
    # per block; in float32 the column sums accumulate in a float64 scratch
    out = torch.empty((2 * d + 1 + _blocks(n, k),), dtype=cd, device=dev)
    dx2, dx, csum = out[:d], out[d:2 * d], out[2 * d]
    wide = None if cd == torch.float64 else torch.empty((2 * d,), dtype=torch.float64,
                                                        device=dev)
    with device_scope(dev):
        code = entry(
            indices.data_ptr(), values.data_ptr(), y.data_ptr(), off.data_ptr(),
            e.data_ptr(), w.data_ptr(), dx2.data_ptr(), dx.data_ptr(),
            None if wide is None else wide.data_ptr(), csum.data_ptr() + cd.itemsize,
            csum.data_ptr(), n, k, d, loss_id, stream_of(indices),
        )
    from photon_ml_tpu_torch.kernels import build

    build.check(lib, code, "fused_hdiag launch")
    dispatch.count_launch("fused_hdiag")
    return dx2, dx, csum


def _blocks(n: int, k: int) -> int:
    """Blocks of a fused launch (the scalar partials of each), as the .cu
    computes them (``photon_fused_tile_blocks``)."""
    import ctypes

    _, fn = load_entry("fused", "photon_fused_tile_blocks", [ctypes.c_longlong, ctypes.c_int],
                       ctypes.c_longlong)
    return int(fn(n, k))
