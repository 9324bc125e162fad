"""Core containers: labeled batches and model coefficients, as dataclasses
of tensors (counterpart of ``photon_ml_tpu/core/types.py``).

A batch is struct-of-arrays: a design matrix (dense ``(n, d)`` tensor or an
``ops.sparse.SparseFeatures`` padded-ELL container) plus ``(n,)`` label /
offset / weight / mask columns, all on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class LabeledBatch:
    """A batch of labeled examples (``data/LabeledPoint.scala:29``
    column-wise).

      features: (n, d) dense tensor or ``SparseFeatures``
      labels:   (n,) response
      offsets:  (n,) fixed per-example margin added to x.w
      weights:  (n,) importance weights
      mask:     (n,) 1.0 for real rows, 0.0 for padding
    """

    features: object
    labels: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor
    mask: torch.Tensor

    def effective_weights(self) -> torch.Tensor:
        """Weights with padding zeroed — the only weights kernels should use."""
        return self.weights * self.mask

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]

    @staticmethod
    def pad_to(batch: "LabeledBatch", n: int) -> "LabeledBatch":
        """Pad a batch to ``n`` rows with masked (invisible) rows: zeros in
        every column, all-padding rows in a structured design."""
        from photon_ml_tpu_torch.ops import sparse as sparse_ops

        cur = batch.batch_size
        if cur == n:
            return batch
        if cur > n:
            raise ValueError(f"cannot pad batch of {cur} rows down to {n}")
        pad = n - cur

        def pad_rows(x):
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

        features = (
            sparse_ops.pad_rows(batch.features, pad)
            if sparse_ops.is_structured(batch.features)
            else pad_rows(batch.features)
        )
        return LabeledBatch(
            features=features,
            labels=pad_rows(batch.labels),
            offsets=pad_rows(batch.offsets),
            weights=pad_rows(batch.weights),
            mask=pad_rows(batch.mask),
        )

    @staticmethod
    def create(
        features,
        labels,
        offsets=None,
        weights=None,
        mask=None,
        dtype: torch.dtype = torch.float32,
        device="cpu",
    ) -> "LabeledBatch":
        """Place every column on ``device`` at ``dtype`` (ELL indices stay
        int32)."""
        from photon_ml_tpu_torch.ops.sparse import cast_values

        device = torch.device(device)
        features = cast_values(features, dtype, device)
        n = features.shape[-2]

        def column(x, fill):
            if x is None:
                return torch.full((n,), fill, dtype=dtype, device=device)
            return torch.as_tensor(x, dtype=dtype, device=device)

        return LabeledBatch(
            features,
            column(labels, 0.0),
            column(offsets, 0.0),
            column(weights, 1.0),
            column(mask, 1.0),
        )


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """Model coefficients: means plus optional per-coefficient variances
    (``model/Coefficients.scala:27-86``)."""

    means: torch.Tensor
    variances: Optional[torch.Tensor] = None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]
