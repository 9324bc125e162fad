"""Sparse (wide) feature batches in padded row-wise (ELL) format
(counterpart of ``photon_ml_tpu/ops/sparse.py``).

Every row holds up to ``k`` (column, value) pairs, padded with column id
``d`` (one past the last feature) and value 0, so padding is algebraically
invisible: a gather at id ``d`` reads 0 and a scatter to it adds nothing.
``matvec``, ``rmatvec`` and ``colsum`` send a dense design to plain tensor
products and an ELL design to the ``ell_matvec`` / ``ell_rmatvec`` /
``ell_colsum`` kernels (:mod:`photon_ml_tpu_torch.kernels.ell`), which
route by the tensors' device. The hybrid and feature-sharded containers
are not ported yet: anything else raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.kernels.ell import ell_colsum, ell_matvec, ell_rmatvec


@dataclasses.dataclass(frozen=True)
class SparseFeatures:
    """(n, k) padded sparse design matrix with width ``d``.

    indices: (n, k) int32 column ids; padding slots hold ``d``.
    values:  (n, k) float payloads; padding slots hold 0.0.
    d:       number of feature columns.
    """

    indices: torch.Tensor
    values: torch.Tensor
    d: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.indices.shape[-2], self.d)

    @property
    def nnz_per_row(self) -> int:
        return self.indices.shape[-1]

    def __matmul__(self, w: torch.Tensor) -> torch.Tensor:
        return matvec(self, w)


def is_sparse(x) -> bool:
    return isinstance(x, SparseFeatures)


def is_hybrid(x) -> bool:
    """Always False: the JAX package's ``HybridFeatures`` (dense hot slab
    plus sparse cold rows, in a row order of its own) is not ported yet,
    so no value of the port is one. The predicate is kept so that callers
    guard against it as the JAX package's do."""
    return False


def is_structured(x) -> bool:
    """Any non-plain-array representation this module owns (only the ELL
    container so far)."""
    return is_sparse(x) or is_hybrid(x)


def cast_values(x, dtype: torch.dtype, device="cpu"):
    """Representation-preserving placement: a dense matrix, or an ELL's
    values, to ``dtype`` on ``device`` (ELL ids stay int32)."""
    device = torch.device(device)
    if is_sparse(x):
        return SparseFeatures(
            indices=torch.as_tensor(x.indices, dtype=torch.int32, device=device),
            values=torch.as_tensor(x.values, dtype=dtype, device=device),
            d=x.d,
        )
    return torch.as_tensor(x, dtype=dtype, device=device)


def as_dense(x) -> torch.Tensor:
    """``x`` itself if it is a dense tensor; raises for the containers the
    port does not have yet."""
    if not isinstance(x, torch.Tensor):
        raise NotImplementedError(
            f"{type(x).__name__} designs are not ported to photon_ml_tpu_torch "
            "yet (ROADMAP.md, queue A: 'Hybrid designs' and 'Parallel'); the "
            "port takes a dense tensor or a padded-ELL SparseFeatures"
        )
    return x


def _promoted(x: torch.Tensor, v: torch.Tensor):
    """A dense design and a vector of another dtype, promoted to
    ``torch.promote_types`` (the JAX package's bf16 low-precision dense
    product is not ported)."""
    if x.dtype != v.dtype:
        cd = torch.promote_types(x.dtype, v.dtype)
        return x.to(cd), v.to(cd)
    return x, v


def matvec(x, w: torch.Tensor) -> torch.Tensor:
    """Margins contraction: (n, d) @ (d,) -> (n,)."""
    if is_sparse(x):
        return ell_matvec(x.indices, x.values, w, x.d)
    x, w = _promoted(as_dense(x), w)
    return torch.matmul(x, w)


def rmatvec(x, a: torch.Tensor) -> torch.Tensor:
    """Gradient back-projection: (n, d)^T @ (n,) -> (d,)."""
    if is_sparse(x):
        return ell_rmatvec(x.indices, x.values, a, x.d)
    x, a = _promoted(as_dense(x), a)
    return torch.matmul(x.T, a)


def colsum(x, c: torch.Tensor, square: bool = False) -> torch.Tensor:
    """sum_i c_i * x_ij (or x_ij^2) -> (d,): the column sums of the feature
    summary and the Hessian diagonal."""
    if is_sparse(x):
        return ell_colsum(x.indices, x.values, c, x.d, square=square)
    x, c = _promoted(as_dense(x), c)
    v = x * x if square else x
    return torch.einsum("n,nd->d", c, v)


# -- construction ------------------------------------------------------------


def from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    num_cols: int,
    nnz_per_row: int = 0,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> SparseFeatures:
    """Build from COO triplets (host-side, then placed on ``device``).
    Duplicate (row, col) entries are summed (the reference's dedup-by-sum,
    ``DataProcessingUtils.scala:70-76``). ``nnz_per_row`` pads the row
    width and raises if a row is wider; 0 means the widest row (at least
    1). Within a row, entries are in ascending column order."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    flat = rows * num_cols + cols
    uniq, inv = np.unique(flat, return_inverse=True)
    summed = np.zeros(uniq.size, np.float64)
    np.add.at(summed, inv, vals)
    r = uniq // num_cols
    c = uniq % num_cols
    counts = np.bincount(r, minlength=num_rows)
    k = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if nnz_per_row:
        if k > nnz_per_row:
            raise ValueError(
                f"a row has {k} entries, above nnz_per_row={nnz_per_row}"
            )
        k = nnz_per_row
    indices = np.full((num_rows, k), num_cols, np.int32)
    values = np.zeros((num_rows, k), np.float64)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = np.arange(uniq.size) - starts[r]
    indices[r, slot] = c
    values[r, slot] = summed
    device = torch.device(device)
    return SparseFeatures(
        indices=torch.from_numpy(indices).to(device),
        values=torch.from_numpy(values).to(device=device, dtype=dtype),
        d=num_cols,
    )


def from_dense(
    x: np.ndarray, nnz_per_row: int = 0, dtype: torch.dtype = torch.float32,
    device="cpu",
) -> SparseFeatures:
    """Sparsify a dense matrix (testing / oracles)."""
    x = np.asarray(x)
    r, c = np.nonzero(x)
    return from_coo(
        r, c, x[r, c], x.shape[0], x.shape[1], nnz_per_row, dtype, device
    )


def to_dense(sf: SparseFeatures) -> np.ndarray:
    """Densify (small problems / tests only), host-side, in float64 for
    bf16 payloads (numpy has no bfloat16)."""
    ind = sf.indices.cpu().numpy()
    val_t = sf.values.cpu()
    if val_t.dtype == torch.bfloat16:
        val_t = val_t.to(torch.float64)
    val = val_t.numpy()
    n, k = ind.shape
    out = np.zeros((n, sf.d), val.dtype)
    keep = (ind >= 0) & (ind < sf.d)
    np.add.at(
        out, (np.repeat(np.arange(n), k)[keep.reshape(-1)], ind[keep]), val[keep]
    )
    return out
