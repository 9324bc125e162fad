"""Data sanity validation as plain tensor checks (counterpart of
``photon_ml_tpu/core/validators.py``; the reference's
``data/DataValidators.scala:29-136``).

Per-task row checks (finite features, offset, weight and label; binary
labels for classifiers; non-negative labels for Poisson) in FULL,
SAMPLE (1%) or DISABLED mode. One masked pass; the counts come back to the
host in one read.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Dict, Optional

import torch

from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import LabeledBatch


class DataValidationType(enum.Enum):
    """``DataValidationType.scala``."""

    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"


def _row_checks(batch: LabeledBatch, task: TaskType) -> Dict[str, torch.Tensor]:
    """Per-check boolean (n,) tensors; True = the row VIOLATES the check."""
    from photon_ml_tpu_torch.ops.sparse import is_hybrid, is_sparse

    m = batch.mask > 0
    x = batch.features
    if is_hybrid(x):
        # the slab and every cold segment, row by row in stored order
        cold_finite = torch.cat(
            [torch.isfinite(seg.values).all(dim=-1) for seg in x.cold_segments])
        feats_finite = torch.isfinite(x.dense).all(dim=-1) & cold_finite
    else:
        # only stored ELL slots can be non-finite; padding slots hold 0.0
        values = x.values if is_sparse(x) else x
        feats_finite = torch.isfinite(values).all(dim=-1)
    checks = {
        "finite_features": m & ~feats_finite,
        "finite_label": m & ~torch.isfinite(batch.labels),
        "finite_offset": m & ~torch.isfinite(batch.offsets),
        "finite_weight": m & ~torch.isfinite(batch.weights),
    }
    if task.is_classifier:
        checks["binary_label"] = m & ~((batch.labels == 0.0) | (batch.labels == 1.0))
    if task == TaskType.POISSON_REGRESSION:
        checks["non_negative_label"] = m & (batch.labels < 0.0)
    return checks


def sanity_check_data(
    batch: LabeledBatch,
    task: TaskType,
    mode: DataValidationType = DataValidationType.VALIDATE_FULL,
    sample_fraction: float = 0.01,
    seed: Optional[int] = None,
) -> Dict[str, int]:
    """Raise ValueError on any violation (``DataValidators.sanityCheckData``).

    Returns the (all-zero) per-check violation counts on success. SAMPLE
    mode keeps each row with probability ``sample_fraction``, drawn from a
    ``torch.Generator`` seeded by ``seed`` (OS entropy when None); the JAX
    package draws its sample with ``jax.random``, so the two sample
    different rows from the same seed."""
    if mode == DataValidationType.VALIDATE_DISABLED:
        return {}
    checked = batch
    if mode == DataValidationType.VALIDATE_SAMPLE:
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        gen = torch.Generator().manual_seed(seed)
        keep = torch.rand(batch.mask.shape, generator=gen) < sample_fraction
        checked = dataclasses.replace(
            batch, mask=batch.mask * keep.to(batch.mask.device, batch.mask.dtype)
        )
    checks = _row_checks(checked, task)
    totals = torch.stack([v.sum() for v in checks.values()]).tolist()
    counts = {k: int(v) for k, v in zip(checks, totals)}
    bad = {k: v for k, v in counts.items() if v > 0}
    if bad:
        detail = (
            f" (sample seed={seed})"
            if mode == DataValidationType.VALIDATE_SAMPLE
            else ""
        )
        raise ValueError(f"input data failed validation: {bad}{detail}")
    return counts
