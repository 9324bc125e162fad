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
ELL) with the hot columns overwritten by the dense slab's.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.ops import sparse as sparse_ops


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


def summarize_features(batch: LabeledBatch) -> BasicStatisticalSummary:
    """Single-pass masked column statistics (unweighted rows, like
    colStats). Sparse batches count each column's implicit zeros in every
    statistic, matching the dense semantics."""
    x = batch.features
    if sparse_ops.is_hybrid(x):
        return _summarize_hybrid(batch)
    if sparse_ops.is_sparse(x):
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


def _summarize_sparse(batch: LabeledBatch) -> BasicStatisticalSummary:
    """Column statistics over a padded-ELL design without densifying:
    moments by scatter-add, extremes by scatter-min/max corrected for each
    column's implicit zeros (a column stored in fewer unmasked rows than
    exist contains zeros, as a dense matrix would)."""
    x = batch.features
    d = x.d
    m = batch.mask
    dtype = x.values.dtype

    def colsum_of(values, square=False):
        return sparse_ops.colsum(dataclasses.replace(x, values=values), m, square=square)

    n = m.sum()
    s1 = colsum_of(x.values)
    s2 = colsum_of(x.values, square=True)
    sabs = colsum_of(x.values.abs())
    nnz = colsum_of((x.values != 0.0).to(dtype))
    # stored-slot count per column (for implicit-zero detection); padding
    # slots carry index d, so their all-ones payload adds nothing
    stored = colsum_of(torch.ones_like(x.values))

    entry_ok = (x.indices >= 0) & (x.indices < d) & (m[:, None] > 0)
    flat_idx = torch.where(entry_ok, x.indices.long(), d).reshape(-1)
    big = torch.tensor(float("inf"), dtype=dtype, device=x.values.device)
    mn_stored = torch.full((d + 1,), float("inf"), dtype=dtype, device=big.device)
    mn_stored.scatter_reduce_(
        0, flat_idx, torch.where(entry_ok, x.values, big).reshape(-1), "amin"
    )
    mx_stored = torch.full((d + 1,), float("-inf"), dtype=dtype, device=big.device)
    mx_stored.scatter_reduce_(
        0, flat_idx, torch.where(entry_ok, x.values, -big).reshape(-1), "amax"
    )
    mn_stored, mx_stored = mn_stored[:d], mx_stored[:d]
    has_zero = stored < n  # some unmasked row lacks a stored entry
    zero = torch.zeros((), dtype=dtype, device=big.device)
    mn = torch.where(has_zero, torch.minimum(mn_stored, zero), mn_stored)
    mx = torch.where(has_zero, torch.maximum(mx_stored, zero), mx_stored)
    mn = torch.where(torch.isfinite(mn), mn, zero)
    mx = torch.where(torch.isfinite(mx), mx, zero)
    return _finish(n, s1, s2, sabs, nnz, mn, mx)
