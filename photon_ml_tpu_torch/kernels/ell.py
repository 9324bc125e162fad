"""Padded-ELL kernels (counterpart of ``photon_ml_tpu/kernels/ell.py``).

- ``ell_matvec``: z_i = sum_k v_ik * w[c_ik] (``csrc/ell_matvec.cu``);
- ``ell_scatter_add``: g_j = sum over slots with c_ik = j of upd_ik
  (``csrc/ell_scatter_add.cu``), for any per-slot update table;
- ``ell_rmatvec`` (v_ik * a_i summed by column, the gradient
  back-projection) and
- ``ell_colsum`` (v_ik * c_i or v_ik^2 * c_i summed by column): on CPU
  tensors the plain version forms the update table and scatters it, as
  the JAX package does; on CUDA tensors the fixed-order column reduce over
  the design's column-sorted copy (``kernels/colsort.py``), so the
  feature summary has the same bits from run to run.

Padding slots (column id ``d``, value 0) read 0 and add nothing; so do ids
outside [0, d). On CUDA tensors each wrapper launches its hand-written
kernel (or raises); on CPU tensors it runs the ``*_reference`` function,
the plain PyTorch version of the same contract.

Compute types: ``ell_matvec`` follows ``result_type(values, w)`` and takes
only these pairs (anything else raises on either device)::

    values   w      -> out
    float64  float64   float64
    float32  float32   float32
    bfloat16 float32   float32

``ell_scatter_add`` takes float64 or float32 updates and sums in their
dtype (so bf16 values times a float32 vector scatter in float32).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from photon_ml_tpu_torch.kernels import dispatch

__all__ = [
    "ell_matvec",
    "ell_matvec_reference",
    "ell_scatter_add",
    "ell_scatter_add_reference",
    "ell_rmatvec",
    "ell_rmatvec_reference",
    "ell_colsum",
    "ell_colsum_reference",
    "compute_dtype",
]

# (values dtype, w dtype) -> (output dtype, C entry point)
_MATVEC_TYPES = {
    (torch.float64, torch.float64): (torch.float64, "photon_ell_matvec_f64"),
    (torch.float32, torch.float32): (torch.float32, "photon_ell_matvec_f32"),
    (torch.bfloat16, torch.float32): (torch.float32, "photon_ell_matvec_bf16_f32"),
}

# update dtype -> C entry point of ell_scatter_add
_SCATTER_TYPES = {
    torch.float64: "photon_ell_scatter_add_f64",
    torch.float32: "photon_ell_scatter_add_f32",
}

_INT32_MAX = 2**31 - 1


def compute_dtype(values_dtype: torch.dtype, w_dtype: torch.dtype) -> torch.dtype:
    """The accumulation/output dtype of ``ell_matvec`` for a type pair."""
    try:
        return _MATVEC_TYPES[(values_dtype, w_dtype)][0]
    except KeyError:
        raise TypeError(
            f"ell_matvec takes (values, w) dtypes "
            f"{[(str(v), str(w)) for v, w in _MATVEC_TYPES]}, got "
            f"({values_dtype}, {w_dtype})"
        ) from None


def _scatter_entry(dtype: torch.dtype) -> str:
    try:
        return _SCATTER_TYPES[dtype]
    except KeyError:
        raise TypeError(
            f"ell_scatter_add takes float64 or float32 updates, got {dtype}"
        ) from None


def check_launch(kernel: str, indices, d: int, tables=(), rows=(), cols=()) -> None:
    """Raise on what a CUDA kernel over an (n, k) ELL does not take: int32
    ids, (n, k) ``tables``, (n,) ``rows``, (d,) ``cols``, all contiguous,
    d and the launch grid within int32."""
    if indices.dtype != torch.int32:
        raise TypeError(f"{kernel}: indices must be int32, got {indices.dtype}")
    if indices.dim() != 2:
        raise ValueError(f"{kernel}: indices must be (n, k), got {tuple(indices.shape)}")
    n, k = indices.shape
    for name, t in tables:
        if t.shape != indices.shape:
            raise ValueError(
                f"{kernel}: indices {tuple(indices.shape)} and {name} "
                f"{tuple(t.shape)} must be the same (n, k)"
            )
    for name, t in rows:
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{kernel}: {name} must be ({n},), got {tuple(t.shape)}")
    for name, t in cols:
        if t.dim() != 1 or t.shape[0] != d:
            raise ValueError(f"{kernel}: {name} must be ({d},), got {tuple(t.shape)}")
    if not (0 <= d <= _INT32_MAX):
        raise ValueError(f"{kernel}: d={d} outside int32")
    # a grid of max(n * 32, n * k) / 256 blocks at most: above every kernel's
    # (tiles of at most 1024 slots, at least one row each)
    if k > _INT32_MAX or -(-max(n * 32, n * k) // 256) > _INT32_MAX:
        raise ValueError(f"{kernel}: (n, k)=({n}, {k}) exceeds the launch grid")
    for name, t in (("indices", indices), *tables, *rows, *cols):
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


# (library, entry) -> (library, entry point with its signature set)
_entries: Dict[Tuple[str, str], tuple] = {}


def load_entry(library: str, entry: str, argtypes, restype=None):
    """(library, the C entry point ``entry`` of kernel library ``library``
    with its ctypes signature; ``restype`` defaults to ``c_int``). The
    library is built at first use; each entry is resolved, and its
    signature set, once per process."""
    found = _entries.get((library, entry))
    if found is not None:
        return found
    import ctypes

    from photon_ml_tpu_torch.kernels import build

    lib = build.load(library)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int if restype is None else restype
    _entries[(library, entry)] = (lib, fn)
    return lib, fn


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def device_scope(dev: torch.device):
    """``torch.cuda.device(dev)`` around a launch; nothing when ``dev`` is
    already the current device, the common case, which then costs the host
    one query instead of two device switches."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _valid_ids(indices: torch.Tensor, d: int) -> torch.Tensor:
    """int64 ids with every id outside [0, d) sent to the padding id d."""
    ids = indices.long()
    return torch.where((ids >= 0) & (ids < d), ids, d)


# -- matvec ------------------------------------------------------------------


def ell_matvec_reference(
    indices: torch.Tensor, values: torch.Tensor, w: torch.Tensor, d: int
) -> torch.Tensor:
    """Plain PyTorch ``ell_matvec``: pad ``w`` with one zero at id ``d``,
    gather, multiply and sum over the slots in the compute dtype. Ids
    outside [0, d) read the zero. (``torch.take`` gathers the same values
    as ``index_select``, several times faster on the CPU.)"""
    cd = compute_dtype(values.dtype, w.dtype)
    w_pad = torch.cat([w.to(cd), w.new_zeros(1, dtype=cd)])
    gathered = torch.take(w_pad, _valid_ids(indices, d))
    return (values.to(cd) * gathered).sum(-1)


def ell_matvec(
    indices: torch.Tensor, values: torch.Tensor, w: torch.Tensor, d: int
) -> torch.Tensor:
    """z = ELL(indices, values) @ w, shape (n,), in ``compute_dtype``.

    CUDA tensors: one launch of the CUDA kernel on the current stream (or
    an exception); CPU tensors: ``ell_matvec_reference``."""
    cd = compute_dtype(values.dtype, w.dtype)
    n, k = indices.shape
    dispatch.record_kernel_cost(
        "ell_matvec", n, k, d, values.element_size(),
        extra_bytes=d * w.element_size() + n * cd.itemsize,
    )
    if not dispatch.use_kernel("ell_matvec", indices, values, w):
        return ell_matvec_reference(indices, values, w, d)
    check_launch("ell_matvec", indices, d, tables=[("values", values)], cols=[("w", w)])
    out = torch.empty((n,), dtype=cd, device=indices.device)
    if n == 0:
        return out
    import ctypes

    lib, entry = load_entry(
        "ell_matvec", _MATVEC_TYPES[(values.dtype, w.dtype)][1],
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p],
    )
    with device_scope(indices.device):
        code = entry(
            indices.data_ptr(), values.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, k, d, stream_of(indices),
        )
    from photon_ml_tpu_torch.kernels import build

    build.check(lib, code, "ell_matvec launch")
    dispatch.count_launch("ell_matvec")
    return out


# -- scatter-add (rmatvec / colsum) ------------------------------------------


def ell_scatter_add_reference(
    indices: torch.Tensor, upd: torch.Tensor, d: int
) -> torch.Tensor:
    """Plain PyTorch ``ell_scatter_add``: every slot added into a (d + 1,)
    buffer whose last entry takes the padding, then dropped. On the CPU
    ``scatter_add_`` adds in slot order, as ``index_add_`` does (the same
    bits), in half its time."""
    _scatter_entry(upd.dtype)
    ids = _valid_ids(indices, d)
    out = upd.new_zeros(d + 1)
    out.scatter_add_(0, ids.reshape(-1), upd.reshape(-1))
    return out[:d]


def ell_scatter_add(indices: torch.Tensor, upd: torch.Tensor, d: int) -> torch.Tensor:
    """g = column sums of ``upd`` by ``indices``, shape (d,), in ``upd``'s
    dtype. CUDA tensors: a zeroed output and one launch of the CUDA kernel
    on the current stream (or an exception); CPU tensors:
    ``ell_scatter_add_reference``."""
    entry_name = _scatter_entry(upd.dtype)
    n, k = indices.shape
    dispatch.record_kernel_cost(
        "ell_scatter_add", n, k, d, upd.element_size(),
        flops_per_slot=1.0, extra_bytes=d * upd.element_size(),
    )
    if not dispatch.use_kernel("ell_scatter_add", indices, upd):
        return ell_scatter_add_reference(indices, upd, d)
    check_launch("ell_scatter_add", indices, d, tables=[("upd", upd)])
    out = torch.zeros((d,), dtype=upd.dtype, device=indices.device)
    if n * k == 0:
        return out
    import ctypes

    lib, entry = load_entry(
        "ell_scatter_add", entry_name,
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    )
    with device_scope(indices.device):
        code = entry(
            indices.data_ptr(), upd.data_ptr(), out.data_ptr(), n * k, d,
            stream_of(indices),
        )
    from photon_ml_tpu_torch.kernels import build

    build.check(lib, code, "ell_scatter_add launch")
    dispatch.count_launch("ell_scatter_add")
    return out


def _rmatvec_update(values: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return values * a[..., None]


def _colsum_update(values: torch.Tensor, c: torch.Tensor, square: bool) -> torch.Tensor:
    v = values * values if square else values
    return v * c[..., None]


def ell_rmatvec_reference(indices, values, a, d: int) -> torch.Tensor:
    return ell_scatter_add_reference(indices, _rmatvec_update(values, a), d)


def _column_reduce(kernel: str, indices, values, c, d: int, mode: str) -> torch.Tensor:
    """``kernel``'s CUDA route: the reduce of ``mode`` over the design's
    column-sorted copy (built at the first call on ``indices``)."""
    from photon_ml_tpu_torch.kernels import colsort

    n, k = indices.shape
    check_launch(kernel, indices, d, tables=[("values", values)])
    vdt, cd = colsort.reduce_dtypes(values.dtype, c.dtype)
    if n * k == 0:
        return torch.zeros((d,), dtype=cd, device=indices.device)
    copy = colsort.design_columns(indices, d)
    if copy.nvalid == 0:
        # an all-padding design (a hybrid's cold segment whose rows hold no
        # cold entry): its copy has no tile, so the sums are exact zeros and
        # nothing is launched or counted
        return torch.zeros((d,), dtype=cd, device=indices.device)
    out = colsort.column_reduce(copy, colsort.column_values(copy, values.to(vdt)), c, mode)
    dispatch.count_launch(kernel)
    return out


def ell_rmatvec(indices, values, a, d: int) -> torch.Tensor:
    """g = ELL^T @ a, shape (d,), in ``result_type(values, a)``. CUDA
    tensors: the column reduce (one launch, no atomics, a fixed order);
    CPU tensors: the per-slot update v_ik * a_i scattered by
    ``ell_scatter_add_reference``."""
    n, k = indices.shape
    dispatch.record_kernel_cost(
        "ell_rmatvec", n, k, d, values.element_size(),
        extra_bytes=d * torch.promote_types(values.dtype, a.dtype).itemsize,
    )
    if not dispatch.use_kernel("ell_rmatvec", indices, values, a):
        return ell_scatter_add(indices, _rmatvec_update(values, a), d)
    return _column_reduce("ell_rmatvec", indices, values, a, d, "linear")


def ell_colsum_reference(indices, values, c, d: int, square: bool = False) -> torch.Tensor:
    return ell_scatter_add_reference(indices, _colsum_update(values, c, square), d)


def ell_colsum(indices, values, c, d: int, square: bool = False) -> torch.Tensor:
    """s_j = sum_i c_i * v_ij (or v_ij^2), shape (d,): the column sums of
    the feature summary and the Hessian diagonal. CUDA tensors: the column
    reduce (each slot squared on its own, in the compute type); CPU
    tensors: the per-slot update through ``ell_scatter_add`` (its plain
    version)."""
    n, k = indices.shape
    dispatch.record_kernel_cost(
        "ell_colsum", n, k, d, values.element_size(),
        extra_bytes=d * torch.promote_types(values.dtype, c.dtype).itemsize,
    )
    if not dispatch.use_kernel("ell_colsum", indices, values, c):
        return ell_scatter_add(indices, _colsum_update(values, c, square), d)
    return _column_reduce("ell_colsum", indices, values, c, d,
                          "square" if square else "linear")
