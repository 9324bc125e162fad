"""Per-feature statistics in one masked pass over the batch (counterpart of
``photon_ml_tpu/ops/stats.py``; the reference's
``stat/BasicStatisticalSummary.scala:33-127`` over Spark's colStats).

The summary feeds normalization
(``core.normalization.build_normalization_context``) and the driver's
``feature-summary.tsv``. Padded-ELL designs take five ``colsum`` calls
(the column-sorted reduce on the card, in a fixed order) for the moments,
and
``scatter_reduce_`` ("amin" / "amax") for the extremes — the JAX package
does those in XLA, outside Pallas. A hybrid design's columns split
disjointly, so its statistics are the cold segments' (joined into one
ELL) with the hot columns overwritten by the dense slab's. A blocked
container's statistics are its held blocks' columns, in blocked order.

Under a mesh with a 'data' axis each rank sums its own rows and the sums,
counts and extremes are reduced over the 'data' group (one all-reduce of
the sums, one each for the minima and maxima) before the moments are
formed.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.ops import sparse as sparse_ops
from photon_ml_tpu_torch.parallel.mesh import data_sum


@dataclasses.dataclass(frozen=True)
class BasicStatisticalSummary:
    """Per-feature moments; every field (d,) except ``count`` (0-dim).

    Mirrors ``BasicStatisticalSummary.scala``: the variance is the unbiased
    (n-1) sample variance like Spark's colStats, set to 0 when negative or
    NaN."""

    mean: torch.Tensor
    variance: torch.Tensor
    count: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    norm_l1: torch.Tensor
    norm_l2: torch.Tensor
    mean_abs: torch.Tensor
    num_nonzeros: torch.Tensor

    @property
    def max_abs(self) -> torch.Tensor:
        """max(|x|) per feature, for SCALE_WITH_MAX_MAGNITUDE."""
        return torch.maximum(self.min.abs(), self.max.abs())


def _finish(n, s1, s2, sabs, nnz, mn, mx) -> BasicStatisticalSummary:
    safe_n = torch.clamp(n, min=1.0)
    mean = s1 / safe_n
    var = (s2 - n * mean * mean) / torch.clamp(n - 1.0, min=1.0)
    var = torch.where(torch.isfinite(var) & (var > 0.0), var, torch.zeros_like(var))
    return BasicStatisticalSummary(
        mean=mean,
        variance=var,
        count=n,
        min=mn,
        max=mx,
        norm_l1=sabs,
        norm_l2=torch.sqrt(s2),
        mean_abs=sabs / safe_n,
        num_nonzeros=nnz,
    )


def _reduced(n, s1, s2, sabs, nnz, stored, mn, mx):
    """The row sums, counts and extremes over the active mesh's 'data'
    group (unchanged without one)."""
    sums = torch.cat([n.reshape(1), s1, s2, sabs, nnz, stored])
    sums = data_sum(sums, "summary")
    mn = data_sum(mn, "summary", op="min")
    mx = data_sum(mx, "summary", op="max")
    d = s1.shape[0]
    parts = torch.split(sums[1:], [d, d, d, d, stored.shape[0]])
    return (sums[0],) + tuple(parts) + (mn, mx)


def summarize_features(batch: LabeledBatch) -> BasicStatisticalSummary:
    """Single-pass masked column statistics (unweighted rows, like
    colStats). Sparse batches count each column's implicit zeros in every
    statistic, matching the dense semantics."""
    x = batch.features
    if sparse_ops.is_hybrid(x):
        return _summarize_hybrid(batch)
    if sparse_ops.is_sparse(x) or sparse_ops.is_feature_sharded(x):
        return _summarize_sparse(batch)
    x = sparse_ops.as_dense(x)
    m = batch.mask[:, None]
    # where (not *): padding rows may hold NaN/Inf (validators exempt masked
    # rows) and NaN * 0 would poison every sum
    xm = torch.where(m > 0, x, torch.zeros_like(x))
    n = batch.mask.sum()
    s1 = xm.sum(0)
    s2 = (xm * xm).sum(0)
    sabs = xm.abs().sum(0)
    nnz = ((xm != 0.0) * m).sum(0)
    big = torch.full_like(x, float("inf"))
    mn = torch.where(m > 0, x, big).amin(0)
    mx = torch.where(m > 0, x, -big).amax(0)
    n, s1, s2, sabs, nnz, _, mn, mx = _reduced(n, s1, s2, sabs, nnz, s1.new_zeros((0,)), mn, mx)
    return _finish(n, s1, s2, sabs, nnz, mn, mx)


def _summarize_hybrid(batch: LabeledBatch) -> BasicStatisticalSummary:
    """A hybrid's columns split disjointly, so the statistics merge by
    overwrite: the hot columns take the dense slab's (the cold pass sees
    them as all-zero columns), the cold columns keep the ELL's."""
    x = batch.features
    cold = summarize_features(
        dataclasses.replace(batch, features=sparse_ops.cold_as_single_ell(x)))
    slab = summarize_features(dataclasses.replace(batch, features=x.dense))
    hot = x.hot_ids.long()

    def merge(cold_v, slab_v):
        out = cold_v.clone()
        out[hot] = slab_v.to(cold_v.dtype)
        return out

    return BasicStatisticalSummary(
        **{f.name: merge(getattr(cold, f.name), getattr(slab, f.name))
           for f in dataclasses.fields(BasicStatisticalSummary) if f.name != "count"},
        count=cold.count,
    )


def _entry_extremes(indices, values, row_ok, d: int):
    """Per-column (min, max) over the stored entries of rows ``row_ok``,
    +-inf for a column with none (``scatter_reduce_``)."""
    dtype = values.dtype
    entry_ok = (indices >= 0) & (indices < d) & row_ok[:, None]
    flat_idx = torch.where(entry_ok, indices.long(), d).reshape(-1)
    big = torch.tensor(float("inf"), dtype=dtype, device=values.device)
    mn = torch.full((d + 1,), float("inf"), dtype=dtype, device=big.device)
    mn.scatter_reduce_(0, flat_idx, torch.where(entry_ok, values, big).reshape(-1), "amin")
    mx = torch.full((d + 1,), float("-inf"), dtype=dtype, device=big.device)
    mx.scatter_reduce_(0, flat_idx, torch.where(entry_ok, values, -big).reshape(-1), "amax")
    return mn[:d], mx[:d]


def _summarize_sparse(batch: LabeledBatch) -> BasicStatisticalSummary:
    """Column statistics over a padded-ELL design (or a blocked container,
    block by block) without densifying: moments by column sums, extremes
    by scatter-min/max corrected for each column's implicit zeros (a
    column stored in fewer unmasked rows than exist contains zeros, as a
    dense matrix would)."""
    x = batch.features
    m = batch.mask

    def colsum_of(values, square=False):
        if sparse_ops.is_feature_sharded(x):
            return sparse_ops.colsum(_with_values(x, values), m, square=square)
        return sparse_ops.colsum(dataclasses.replace(x, values=values), m, square=square)

    vals = x.values if sparse_ops.is_sparse(x) else None
    if sparse_ops.is_feature_sharded(x):
        vals = [b.values for b in x.blocks]
        abs_v = [v.abs() for v in vals]
        nz_v = [(v != 0.0).to(v.dtype) for v in vals]
        ones_v = [torch.ones_like(v) for v in vals]
        ext = [_entry_extremes(b.indices, b.values, x.block_weights(f, m) > 0, x.d_shard)
               for f, b in enumerate(x.blocks)]
        mn_stored = torch.cat([e[0] for e in ext])
        mx_stored = torch.cat([e[1] for e in ext])
    else:
        abs_v, nz_v, ones_v = vals.abs(), (vals != 0.0).to(vals.dtype), torch.ones_like(vals)
        mn_stored, mx_stored = _entry_extremes(x.indices, vals, m > 0, x.d)
    n = m.sum()
    s1 = colsum_of(vals)
    s2 = colsum_of(vals, square=True)
    sabs = colsum_of(abs_v)
    nnz = colsum_of(nz_v)
    # stored-slot count per column (for implicit-zero detection); padding
    # slots carry the padding id, so their all-ones payload adds nothing
    stored = colsum_of(ones_v)
    n, s1, s2, sabs, nnz, stored, mn_stored, mx_stored = _reduced(
        n, s1, s2, sabs, nnz, stored, mn_stored, mx_stored)
    has_zero = stored < n  # some unmasked row lacks a stored entry
    zero = torch.zeros((), dtype=mn_stored.dtype, device=mn_stored.device)
    mn = torch.where(has_zero, torch.minimum(mn_stored, zero), mn_stored)
    mx = torch.where(has_zero, torch.maximum(mx_stored, zero), mx_stored)
    mn = torch.where(torch.isfinite(mn), mn, zero)
    mx = torch.where(torch.isfinite(mx), mx, zero)
    return _finish(n, s1, s2, sabs, nnz, mn, mx)


def _with_values(x, values):
    """A blocked container with each block's values replaced."""
    return dataclasses.replace(x, blocks=tuple(
        dataclasses.replace(b, values=v) for b, v in zip(x.blocks, values)))
