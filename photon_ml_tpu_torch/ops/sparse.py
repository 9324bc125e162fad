"""Sparse (wide) feature batches: padded row-wise (ELL) and hybrid
designs (counterpart of ``photon_ml_tpu/ops/sparse.py``).

Every ELL row holds up to ``k`` (column, value) pairs, padded with column
id ``d`` (one past the last feature) and value 0, so padding is
algebraically invisible: a gather at id ``d`` reads 0 and a scatter to it
adds nothing. ``matvec``, ``rmatvec`` and ``colsum`` send a dense design
to plain tensor products and an ELL design to the ``ell_matvec`` /
``ell_rmatvec`` / ``ell_colsum`` kernels
(:mod:`photon_ml_tpu_torch.kernels.ell`), which route by the tensors'
device.

A :class:`HybridFeatures` design (built on the host by :func:`to_hybrid`)
is a dense slab of the hot columns, a plain ``torch.matmul`` as in the JAX
package, plus the cold tail as contiguous-row ELL segments, each of its
own width, in a permuted row order; the three contractions run each
segment through the ELL kernels and add the segments' outputs in segment
order. The feature-sharded container is not ported: ``as_dense`` raises
for it.
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


@dataclasses.dataclass(frozen=True)
class HybridFeatures:
    """Power-law split of a sparse matrix: a dense slab for the hot
    columns, row-bucketed padded ELL for the cold tail.

    The cold rows are sorted by cold-entry count and cut into contiguous
    segments by the exact-DP padding minimizer of the GAME random-effect
    designs, each an ELL at its own width, so the rows live in a PERMUTED
    order: ``row_perm[i]`` is the original index of stored row i. Callers
    permute the rest of the batch (labels, offsets, weights, mask) once at
    construction; training is row-order invariant.

    dense:         (n, H) slab holding the hot columns (stored row order).
    hot_ids:       (H,) int32 original column ids of the slab columns.
    cold_segments: contiguous-row ELL segments over the same d covering
                   all n rows in stored order (hot columns never appear).
    row_perm:      (n,) int32 stored-row -> original-row map.
    """

    dense: torch.Tensor
    hot_ids: torch.Tensor
    cold_segments: Tuple[SparseFeatures, ...]
    row_perm: torch.Tensor

    @property
    def d(self) -> int:
        return self.cold_segments[0].d

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.dense.shape[-2], self.d)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return self.dense.dtype

    def segment_bounds(self) -> Tuple[Tuple[int, int], ...]:
        """[(lo, hi)) stored-row ranges, one per cold segment."""
        bounds = []
        lo = 0
        for seg in self.cold_segments:
            hi = lo + seg.indices.shape[-2]
            bounds.append((lo, hi))
            lo = hi
        return tuple(bounds)

    def __matmul__(self, w: torch.Tensor) -> torch.Tensor:
        return matvec(self, w)


def is_sparse(x) -> bool:
    return isinstance(x, SparseFeatures)


def is_hybrid(x) -> bool:
    return isinstance(x, HybridFeatures)


def is_structured(x) -> bool:
    """Any non-plain-array representation this module owns."""
    return is_sparse(x) or is_hybrid(x)


def cast_values(x, dtype: torch.dtype, device="cpu"):
    """Representation-preserving placement: a dense matrix, an ELL's
    values, or a hybrid's slab and cold values, to ``dtype`` on ``device``
    (column ids and the row permutation stay int32)."""
    device = torch.device(device)
    if is_hybrid(x):
        return HybridFeatures(
            dense=torch.as_tensor(x.dense, dtype=dtype, device=device),
            hot_ids=torch.as_tensor(x.hot_ids, dtype=torch.int32, device=device),
            cold_segments=tuple(cast_values(seg, dtype, device) for seg in x.cold_segments),
            row_perm=torch.as_tensor(x.row_perm, dtype=torch.int32, device=device),
        )
    if is_sparse(x):
        return SparseFeatures(
            indices=torch.as_tensor(x.indices, dtype=torch.int32, device=device),
            values=torch.as_tensor(x.values, dtype=dtype, device=device),
            d=x.d,
        )
    return torch.as_tensor(x, dtype=dtype, device=device)


def as_dense(x) -> torch.Tensor:
    """``x`` itself if it is a dense tensor; raises for a container the
    port does not have (the JAX package's feature-sharded one)."""
    if not isinstance(x, torch.Tensor):
        raise NotImplementedError(
            f"{type(x).__name__} designs are not ported to photon_ml_tpu_torch "
            "yet (ROADMAP.md, queue A: 'Parallel'); the port takes a dense "
            "tensor, a padded-ELL SparseFeatures or a HybridFeatures"
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


def _cold_sum(x: HybridFeatures, v: torch.Tensor, contract) -> torch.Tensor:
    """The (d,) sum over the cold segments of ``contract(segment, rows of
    v)``, added in segment order as the JAX package adds them. Each segment
    writes a (d,) vector of its own."""
    g = None
    for (lo, hi), seg in zip(x.segment_bounds(), x.cold_segments):
        part = contract(seg, v[lo:hi])
        g = part if g is None else g + part
    return g


def _add_hot(g: torch.Tensor, x: HybridFeatures, hot: torch.Tensor) -> torch.Tensor:
    """g with the slab's sums added at the hot columns. The hot ids are
    unique, so ``index_add_`` has no colliding atomics on the card: each
    column takes one add, and the result is the same from run to run."""
    return g.index_add_(0, x.hot_ids, hot.to(g.dtype))


def matvec(x, w: torch.Tensor) -> torch.Tensor:
    """Margins contraction: (n, d) @ (d,) -> (n,). A hybrid's output is in
    its STORED (permuted) row order, matching the permuted batch."""
    if is_hybrid(x):
        cold = torch.cat([matvec(seg, w) for seg in x.cold_segments])
        dense, hw = _promoted(x.dense, w.index_select(0, x.hot_ids))
        return torch.matmul(dense, hw) + cold
    if is_sparse(x):
        return ell_matvec(x.indices, x.values, w, x.d)
    x, w = _promoted(as_dense(x), w)
    return torch.matmul(x, w)


def rmatvec(x, a: torch.Tensor) -> torch.Tensor:
    """Gradient back-projection: (n, d)^T @ (n,) -> (d,). A hybrid's ``a``
    is in stored row order."""
    if is_hybrid(x):
        g = _cold_sum(x, a, rmatvec)
        dense, a2 = _promoted(x.dense, a)
        return _add_hot(g, x, torch.matmul(a2, dense))
    if is_sparse(x):
        return ell_rmatvec(x.indices, x.values, a, x.d)
    x, a = _promoted(as_dense(x), a)
    return torch.matmul(x.T, a)


def colsum(x, c: torch.Tensor, square: bool = False) -> torch.Tensor:
    """sum_i c_i * x_ij (or x_ij^2) -> (d,): the column sums of the feature
    summary and the Hessian diagonal."""
    if is_hybrid(x):
        dense, c2 = _promoted(x.dense, c)
        v = dense * dense if square else dense
        hot = torch.einsum("n,nh->h", c2, v)
        g = _cold_sum(x, c, lambda seg, part: colsum(seg, part, square=square))
        return _add_hot(g, x, hot)
    if is_sparse(x):
        return ell_colsum(x.indices, x.values, c, x.d, square=square)
    x, c = _promoted(as_dense(x), c)
    v = x * x if square else x
    return torch.einsum("n,nd->d", c, v)


def pad_rows(x, pad: int):
    """Append ``pad`` all-padding rows (id d, value 0) to an ELL or a
    hybrid, keeping the padding invariant that zero rows would break; a
    hybrid's new rows go to its last segment and map to themselves."""
    if is_hybrid(x):
        n = x.dense.shape[-2]
        segs = list(x.cold_segments)
        segs[-1] = pad_rows(segs[-1], pad)
        return HybridFeatures(
            dense=torch.cat([x.dense, x.dense.new_zeros((pad, x.dense.shape[-1]))]),
            hot_ids=x.hot_ids,
            cold_segments=tuple(segs),
            row_perm=torch.cat([x.row_perm, torch.arange(
                n, n + pad, dtype=torch.int32, device=x.row_perm.device)]),
        )
    return SparseFeatures(
        indices=torch.cat([x.indices, x.indices.new_full((pad, x.nnz_per_row), x.d)]),
        values=torch.cat([x.values, x.values.new_zeros((pad, x.nnz_per_row))]),
        d=x.d,
    )


def row_density(x) -> torch.Tensor:
    """Per-row stored-entry count (diagnostic; a hybrid's in stored
    order)."""
    if is_hybrid(x):
        cold = torch.cat([row_density(seg) for seg in x.cold_segments])
        return (x.dense != 0).sum(-1) + cold
    if is_sparse(x):
        return (x.indices < x.d).sum(-1)
    return (as_dense(x) != 0).sum(-1)


def stored_cold_entries(hf: HybridFeatures) -> int:
    """Total stored (non-padding) entries across the cold segments."""
    return sum(int((seg.indices < seg.d).sum()) for seg in hf.cold_segments)


def cold_padded_slots(hf: HybridFeatures) -> int:
    """Total padded ELL slots across the cold segments (the quantity each
    segment's kernels stream)."""
    return sum(seg.indices.numel() for seg in hf.cold_segments)


def cold_as_single_ell(hf: HybridFeatures) -> SparseFeatures:
    """The cold segments as one ELL at the widest segment's width, in
    stored row order. It brings back the padding: for consumers that run
    once a run (the feature summary), not for the solves. A new tensor on
    every call, so the card builds its column-sorted copy again each
    time."""
    kmax = max(seg.nnz_per_row for seg in hf.cold_segments)
    ind, val = [], []
    for seg in hf.cold_segments:
        n, extra = seg.indices.shape[0], kmax - seg.nnz_per_row
        ind.append(torch.cat([seg.indices, seg.indices.new_full((n, extra), seg.d)], dim=1))
        val.append(torch.cat([seg.values, seg.values.new_zeros((n, extra))], dim=1))
    return SparseFeatures(indices=torch.cat(ind), values=torch.cat(val), d=hf.d)


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


def to_hybrid(
    sf: SparseFeatures,
    hot_columns: int = -1,
    dtype: torch.dtype = None,
    min_count: int = 64,
    max_slab_bytes: int = 1 << 30,
    num_row_buckets: int = 8,
) -> HybridFeatures:
    """Split an ELL matrix into a dense hot slab and bucketed sparse cold
    segments, on the host, once per dataset; the result is placed on
    ``sf``'s device.

    ``hot_columns`` = H picks the H columns with the most stored entries;
    -1 sizes the slab itself: the columns stored more than ``min_count``
    times, most first, until the slab reaches ``max_slab_bytes`` at the
    target dtype (the JAX package's TPU break-even, kept unchanged so that
    both packages split alike). A slab with no such column takes the one
    column stored most (H = 1).

    The rows are then sorted by their count of cold entries and cut into
    at most ``num_row_buckets`` contiguous ELL segments by the exact-DP
    padding minimizer of ``game/data.py``; ``row_perm`` records stored row
    -> original row. The input must be dedup-summed (``from_coo``'s
    invariant): a (row, column) pair stored twice would sum into one slab
    cell and square differently there than in the ELL, so it is refused.
    """
    from photon_ml_tpu_torch.game.data import _split_minimizing_padding

    out_dtype = dtype or sf.values.dtype
    device = sf.indices.device
    ind = sf.indices.cpu().numpy()
    val_t = sf.values.cpu()
    if val_t.dtype == torch.bfloat16:
        val_t = val_t.to(torch.float64)
    val = val_t.numpy()
    n, k = ind.shape
    sorted_cols = np.sort(np.where(ind < sf.d, ind, -1), axis=-1)
    dup_rows = np.flatnonzero(
        ((sorted_cols[:, 1:] == sorted_cols[:, :-1]) & (sorted_cols[:, 1:] >= 0)).any(axis=-1)
    )
    if dup_rows.size:
        raise ValueError(
            f"to_hybrid requires dedup-summed input (from_coo's invariant); "
            f"{dup_rows.size} rows store a (row, column) pair twice, e.g. row "
            f"{int(dup_rows[0])}"
        )
    flat = ind.reshape(-1)
    keep = flat < sf.d
    counts = np.bincount(flat[keep], minlength=sf.d)
    if hot_columns < 0:
        hot = np.flatnonzero(counts > min_count)
        hot = hot[np.argsort(-counts[hot], kind="stable")]
        h_cap = max(1, max_slab_bytes // (n * out_dtype.itemsize))
        hot = hot[:h_cap]
        if hot.size == 0:
            hot = np.argsort(-counts, kind="stable")[:1]
    else:
        h = max(1, min(hot_columns, sf.d))
        hot = np.argsort(-counts, kind="stable")[:h]
    H = hot.size
    hot_rank = np.full(sf.d + 1, -1, np.int64)
    hot_rank[hot] = np.arange(H)
    is_hot = hot_rank[ind] >= 0  # (n, k); the padding id d is never hot

    # row permutation: ascending cold-entry count (the DP's input)
    cold_entry = ~is_hot & (ind < sf.d)
    cold_counts = cold_entry.sum(axis=1)
    row_perm = np.argsort(cold_counts, kind="stable").astype(np.int32)
    sorted_counts = cold_counts[row_perm]
    bounds = _split_minimizing_padding(sorted_counts, max(1, num_row_buckets)) or [(0, n)]

    # the slab, summed in float32 or float64 (never narrower), stored order
    acc_dtype = np.float64 if out_dtype == torch.float64 else np.float32
    dense = np.zeros((n, H), acc_dtype)
    rows = np.broadcast_to(np.arange(n)[:, None], ind.shape)
    np.add.at(dense, (rows[is_hot], hot_rank[ind[is_hot]]), val[is_hot])
    inv_perm = np.empty(n, np.int64)
    inv_perm[row_perm] = np.arange(n)
    dense = dense[row_perm]

    # cold segments: contiguous stored-row ranges, each its own ELL width
    stored_rows = inv_perm[rows[cold_entry]]
    cold_cols = ind[cold_entry]
    cold_vals = val[cold_entry]
    order = np.argsort(stored_rows, kind="stable")
    stored_rows, cold_cols, cold_vals = stored_rows[order], cold_cols[order], cold_vals[order]
    entry_starts = np.searchsorted(stored_rows, [lo for lo, _ in bounds])
    entry_ends = np.searchsorted(stored_rows, [hi for _, hi in bounds])
    segments = tuple(
        from_coo(stored_rows[es:ee] - lo, cold_cols[es:ee], cold_vals[es:ee], hi - lo, sf.d,
                 dtype=out_dtype, device=device)
        for (lo, hi), es, ee in zip(bounds, entry_starts, entry_ends)
    )
    return HybridFeatures(
        dense=torch.from_numpy(dense).to(device=device, dtype=out_dtype),
        hot_ids=torch.from_numpy(hot.astype(np.int32)).to(device),
        cold_segments=segments,
        row_perm=torch.from_numpy(row_perm).to(device),
    )


def to_dense(sf) -> np.ndarray:
    """Densify (small problems / tests only), host-side, in float64 for
    bf16 payloads (numpy has no bfloat16). A hybrid comes back in its
    ORIGINAL row order (``row_perm`` inverted)."""
    if is_hybrid(sf):
        stored = np.concatenate([to_dense(seg) for seg in sf.cold_segments])
        slab = sf.dense.cpu()
        stored[:, sf.hot_ids.cpu().numpy()] += slab.to(torch.float64).numpy().astype(
            stored.dtype)
        out = np.empty_like(stored)
        out[sf.row_perm.cpu().numpy()] = stored
        return out
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
