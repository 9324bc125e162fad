"""Padded-ELL kernels (counterpart of ``photon_ml_tpu/kernels/ell.py``).

``ell_matvec``: z_i = sum_k v_ik * w[c_ik], with padding slots (column id
``d``, value 0) reading 0. On CUDA tensors it launches the hand-written
kernel in ``csrc/ell_matvec.cu``; on CPU tensors it runs
``ell_matvec_reference``, the plain PyTorch version of the same function.

Compute types follow ``result_type(values, w)`` and only these pairs are
taken (anything else raises on either device):

    values   w      -> out
    float64  float64   float64
    float32  float32   float32
    bfloat16 float32   float32
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.kernels import dispatch

__all__ = ["ell_matvec", "ell_matvec_reference", "compute_dtype"]

# (values dtype, w dtype) -> (output dtype, C entry point)
_MATVEC_TYPES = {
    (torch.float64, torch.float64): (torch.float64, "photon_ell_matvec_f64"),
    (torch.float32, torch.float32): (torch.float32, "photon_ell_matvec_f32"),
    (torch.bfloat16, torch.float32): (torch.float32, "photon_ell_matvec_bf16_f32"),
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


def ell_matvec_reference(
    indices: torch.Tensor, values: torch.Tensor, w: torch.Tensor, d: int
) -> torch.Tensor:
    """Plain PyTorch ``ell_matvec``: pad ``w`` with one zero at id ``d``,
    gather, multiply and sum over the slots in the compute dtype. Ids
    outside [0, d) read the zero."""
    cd = compute_dtype(values.dtype, w.dtype)
    w_pad = torch.cat([w.to(cd), w.new_zeros(1, dtype=cd)])
    ids = indices.long()
    ids = torch.where((ids >= 0) & (ids < d), ids, d)
    gathered = w_pad.index_select(0, ids.reshape(-1)).reshape(ids.shape)
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
    if indices.dtype != torch.int32:
        raise TypeError(f"ell_matvec: indices must be int32, got {indices.dtype}")
    if indices.dim() != 2 or values.shape != indices.shape:
        raise ValueError(
            f"ell_matvec: indices {tuple(indices.shape)} and values "
            f"{tuple(values.shape)} must be the same (n, k)"
        )
    if w.dim() != 1 or w.shape[0] != d:
        raise ValueError(f"ell_matvec: w must be ({d},), got {tuple(w.shape)}")
    if not (0 <= d <= _INT32_MAX):
        raise ValueError(f"ell_matvec: d={d} outside int32")
    for name, t in (("indices", indices), ("values", values), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"ell_matvec: {name} must be contiguous")
    out = torch.empty((n,), dtype=cd, device=indices.device)
    if n == 0:
        return out
    group = min(32, 1 << (max(k, 1) - 1).bit_length())  # lanes per row, as in the .cu
    if k > _INT32_MAX or -(-n * group // 256) > _INT32_MAX:
        raise ValueError(f"ell_matvec: (n, k)=({n}, {k}) exceeds the launch grid")
    import ctypes

    from photon_ml_tpu_torch.kernels import build

    lib = build.load("ell_matvec")
    entry = getattr(lib, _MATVEC_TYPES[(values.dtype, w.dtype)][1])
    entry.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    entry.restype = ctypes.c_int
    with torch.cuda.device(indices.device):
        stream = torch.cuda.current_stream(indices.device).cuda_stream
        code = entry(
            indices.data_ptr(), values.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, k, d, stream,
        )
    build.check(lib, code, "ell_matvec launch")
    dispatch.count_launch("ell_matvec")
    return out
