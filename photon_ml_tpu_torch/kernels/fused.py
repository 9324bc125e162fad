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
makes one C call (or raises), which launches on the current stream the
row pass over tiles of whole rows (margins, row terms, each row's scale
a_i, u_i or c_i, and a fixed-order sum of the per-block scalar partials)
and then the X^T side: the fixed-order column reduce of
:mod:`~photon_ml_tpu_torch.kernels.colsort` over the design's
column-sorted copy, built at the first pass on the ``indices`` tensor and
kept with it (``fused_hdiag``: its column sums in float64 in every
compute type, rounded once). Every output has the same bits from call to
call. On CPU tensors each wrapper runs its ``*_reference`` function, the
plain PyTorch version.

Compute type ``result_type(values, w, labels, offsets, ew)``; taken pairs
(values, compute): (float64, float64), (float32, float32),
(bfloat16, float32). The row vectors and the coefficient vector are cast
to the compute type, as the JAX package casts them.
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_tpu_torch.kernels import colsort, dispatch
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
    if not dispatch.use_kernel("fused_vgc", indices, values, labels, offsets, ew, w_eff):
        _record_cost("fused_vgc", n, k, d, values, cd, None, flops=4.0, d_out=2, n_rows=4)
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
    copy, cvals = _columns(indices, values, d)
    _record_cost("fused_vgc", n, k, d, values, cd, copy, flops=4.0, d_out=2, n_rows=4)
    # the entry point clears grad on the stream before the reduce
    grad = torch.empty((d,), dtype=cd, device=dev)
    lib, entry = load_entry(
        "fused", f"photon_fused_vgc_{_FUSED_TYPES[(values.dtype, cd)]}",
        [ctypes.c_void_p] * 11 + _COPY_ARGTYPES + [ctypes.c_longlong, ctypes.c_int,
                                                   ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p],
    )
    # the two sums (written by the row pass's fixed-order finish), two
    # partials per block, then each row's a_i
    blocks = _blocks(n, k)
    work = torch.empty((2 + 2 * blocks + n,), dtype=cd, device=dev)
    at = work.data_ptr()
    edge = _edge(copy, 1, dev)
    with device_scope(dev):
        code = entry(
            indices.data_ptr(), values.data_ptr(), y.data_ptr(), off.data_ptr(),
            e.data_ptr(), w.data_ptr(), grad.data_ptr(), curvature.data_ptr(),
            at + (2 + 2 * blocks) * cd.itemsize, at + 2 * cd.itemsize, at,
            *_copy_args(copy, cvals, edge), n, k, d, loss_id, stream_of(indices),
        )
    from photon_ml_tpu_torch.kernels import build

    build.check(lib, code, "fused_vgc launch")
    dispatch.count_launch("fused_vgc")
    dispatch.count_launch("colsort_reduce")
    return work[0], grad, work[1], curvature


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
    shift = torch.as_tensor(shift_v, dtype=cd, device=c.device)
    if not dispatch.use_kernel("fused_hvp", indices, values, c, v_eff, shift):
        _record_cost("fused_hvp", n, k, d, values, cd, None, flops=4.0, d_out=2, n_rows=1)
        return fused_hessian_vector_reference(indices, values, c, v_eff, shift, d)
    cc, vv, sh = (t.to(cd).contiguous() for t in (c, v_eff, shift))
    check_launch(
        "fused_hvp", indices, d, tables=[("values", values)],
        rows=[("c", cc)], cols=[("v_eff", vv)],
    )
    dev = indices.device
    if n == 0:
        return torch.zeros((d,), dtype=cd, device=dev), torch.zeros((), dtype=cd, device=dev)
    copy, cvals = _columns(indices, values, d)
    _record_cost("fused_hvp", n, k, d, values, cd, copy, flops=4.0, d_out=2, n_rows=1)
    # the entry point clears hv on the stream before the reduce
    hv = torch.empty((d,), dtype=cd, device=dev)
    lib, entry = load_entry(
        "fused", f"photon_fused_hvp_{_FUSED_TYPES[(values.dtype, cd)]}",
        [ctypes.c_void_p] * 9 + _COPY_ARGTYPES + [ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_void_p],
    )
    # the sum (written by the row pass's fixed-order finish), one partial
    # per block, then each row's u_i
    blocks = _blocks(n, k)
    work = torch.empty((1 + blocks + n,), dtype=cd, device=dev)
    at = work.data_ptr()
    edge = _edge(copy, 1, dev)
    with device_scope(dev):
        code = entry(
            indices.data_ptr(), values.data_ptr(), cc.data_ptr(), sh.data_ptr(),
            vv.data_ptr(), hv.data_ptr(), at + (1 + blocks) * cd.itemsize,
            at + cd.itemsize, at, *_copy_args(copy, cvals, edge),
            n, k, d, stream_of(indices),
        )
    from photon_ml_tpu_torch.kernels import build

    build.check(lib, code, "fused_hvp launch")
    dispatch.count_launch("fused_hvp")
    dispatch.count_launch("colsort_reduce")
    return hv, work[0]


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
    if not dispatch.use_kernel("fused_hdiag", indices, values, labels, offsets, ew, w_eff):
        _record_cost("fused_hdiag", n, k, d, values, cd, None, flops=5.0, d_out=3, n_rows=3)
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
    copy, cvals = _columns(indices, values, d)
    _record_cost("fused_hdiag", n, k, d, values, cd, copy, flops=5.0, d_out=3, n_rows=3)
    lib, entry = load_entry(
        "fused", f"photon_fused_hdiag_{_FUSED_TYPES[(values.dtype, cd)]}",
        [ctypes.c_void_p] * 11 + _COPY_ARGTYPES + [ctypes.c_longlong, ctypes.c_int,
                                                   ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p],
    )
    # one allocation: dx2 and dx (cleared by the entry point on the stream),
    # the sum (written by the row pass's fixed-order finish), one partial
    # per block, then each row's c_i
    blocks = _blocks(n, k)
    out = torch.empty((2 * d + 1 + blocks + n,), dtype=cd, device=dev)
    dx2, dx, csum = out[:d], out[d:2 * d], out[2 * d]
    at = out.data_ptr()
    edge = _edge(copy, 2, dev)
    with device_scope(dev):
        code = entry(
            indices.data_ptr(), values.data_ptr(), y.data_ptr(), off.data_ptr(),
            e.data_ptr(), w.data_ptr(), at, at + d * cd.itemsize,
            at + (2 * d + 1 + blocks) * cd.itemsize, at + (2 * d + 1) * cd.itemsize,
            at + 2 * d * cd.itemsize, *_copy_args(copy, cvals, edge), n, k, d, loss_id,
            stream_of(indices),
        )
    from photon_ml_tpu_torch.kernels import build

    build.check(lib, code, "fused_hdiag launch")
    dispatch.count_launch("fused_hdiag")
    dispatch.count_launch("colsort_reduce")
    return dx2, dx, csum


# the copy's arguments of the fused entry points: cols, rows, values,
# chains, edge scratch, ntiles, nchains
_COPY_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2


def _columns(indices, values, d: int):
    """The design's column-sorted copy (built at the first pass on
    ``indices``, kept with it) and ``values`` laid out in its order."""
    copy = colsort.design_columns(indices, d)
    return copy, colsort.column_values(copy, values)


def _edge(copy, sums: int, dev):
    """The reduce's float64 scratch: ``sums`` values at each side of each
    tile."""
    return torch.empty((max(1, 2 * copy.ntiles * sums),), dtype=torch.float64, device=dev)


def _copy_args(copy, cvals, edge):
    return (copy.cols.data_ptr(), copy.rows.data_ptr(), cvals.data_ptr(),
            copy.chains.data_ptr(), edge.data_ptr(), copy.ntiles, copy.chains.shape[0])


def _record_cost(kernel, n, k, d, values, cd, copy, flops, d_out, n_rows):
    """The pass's analytic cost: the ELL read once (the roofline's least
    traffic), the (d,) vectors and ``n_rows`` (n,) vectors, and on the card
    what this design moves beyond that: the copy read (column, row and
    value of each entry and of the tail padding) and each row's scale
    written and read."""
    extra = d_out * d * cd.itemsize + n_rows * n * cd.itemsize
    if copy is not None:
        extra += copy.cols.shape[0] * (8 + values.element_size()) + 2 * n * cd.itemsize
    dispatch.record_kernel_cost(kernel, n, k, d, values.element_size(), flops_per_slot=flops,
                                extra_bytes=extra)


def _blocks(n: int, k: int) -> int:
    """Blocks of a fused launch (the scalar partials of each), as the .cu
    computes them (``photon_fused_tile_blocks``)."""
    _, fn = load_entry("fused", "photon_fused_tile_blocks", [ctypes.c_longlong, ctypes.c_int],
                       ctypes.c_longlong)
    return int(fn(n, k))
