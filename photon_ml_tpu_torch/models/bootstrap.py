"""Bootstrap training: resampled replicas of one training configuration
(counterpart of ``photon_ml_tpu/models/bootstrap.py``; the reference's
``BootstrapTraining.scala:29-194`` and
``supervised/model/CoefficientSummary.scala``).

Resampling with replacement is a multinomial reweighting: each replica's
count of a row multiplies its weight, so every replica keeps the batch's
shapes. The JAX package solves all replicas in one vmapped call; here
:func:`bootstrap_replicas` solves them one after another on the batch's
device (batching them is later work). The draws come from a
``torch.Generator`` and so differ from ``jax.random``'s for the same seed;
:func:`bootstrap_replicas` takes an (R, n) weight matrix, so the same
weights can be fed to both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.core.types import Coefficients, LabeledBatch
from photon_ml_tpu_torch.models.training import (
    GLMTrainingConfig,
    _solver_step_fn,
    prepare_normalization,
    solve_dtype,
)
from photon_ml_tpu_torch.ops import metrics as metrics_mod
from photon_ml_tpu_torch.ops.sparse import matvec
from photon_ml_tpu_torch.utils.device import to_numpy


@dataclasses.dataclass(frozen=True)
class CoefficientSummary:
    """Per-coefficient statistics across bootstrap fits
    (``CoefficientSummary.scala``: min/max/mean/stddev), plus percentile
    confidence bounds from the replica matrix."""

    mean: np.ndarray
    stddev: np.ndarray
    min: np.ndarray
    max: np.ndarray
    lower: np.ndarray  # percentile CI lower bound
    upper: np.ndarray  # percentile CI upper bound
    confidence: float

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]


@dataclasses.dataclass(frozen=True)
class BootstrapResult:
    """(replica coefficient matrix, summary, metric distributions)."""

    coefficients: np.ndarray  # (num_replicas, d) raw-feature space
    summary: CoefficientSummary
    metric_distributions: Dict[str, np.ndarray]  # name -> (num_replicas,)


def resample_weights(
    generator: torch.Generator, base_weights, mask, num_replicas: int,
    portion: float = 1.0,
) -> torch.Tensor:
    """(R, n) multinomial bootstrap weights on the CPU: each replica draws
    ``portion * m`` rows with replacement from the m unmasked rows (padding
    does not count), and a row's draw count multiplies its weight
    (``BootstrapTrainingDiagnostic.scala:146`` uses portion 0.7)."""
    base = torch.as_tensor(to_numpy(base_weights, np.float64))
    real = torch.nonzero(torch.as_tensor(to_numpy(mask)) > 0).flatten()
    m = int(real.numel())
    draws = max(1, int(round(m * portion)))
    picks = real[torch.randint(0, m, (num_replicas, draws), generator=generator)]
    counts = torch.zeros((num_replicas, base.shape[0]), dtype=torch.float64)
    counts.scatter_add_(1, picks, torch.ones_like(picks, dtype=torch.float64))
    return base * counts


def bootstrap_replicas(
    batch: LabeledBatch, config: GLMTrainingConfig, weights_r,
    normalization=None,
) -> np.ndarray:
    """Solve one replica per row of the (R, n) weight matrix ``weights_r``
    (replacing the batch's weights; its mask stays), each from zero at the
    config's single reg weight. Returns the (R, d) raw-space coefficients."""
    config.validate()
    if len(config.reg_weights) != 1:
        raise ValueError(
            "bootstrap trains one configuration; pass exactly one reg weight "
            f"(got {config.reg_weights})"
        )
    lam = config.reg_weights[0]
    norm = normalization if normalization is not None else prepare_normalization(config, batch)
    solve = _solver_step_fn(config)
    dtype = solve_dtype(batch)
    device = batch.labels.device
    d = batch.features.shape[-1]
    weights_r = torch.as_tensor(to_numpy(weights_r)).to(device=device, dtype=batch.weights.dtype)
    out = []
    for wts in weights_r:
        result = solve(torch.zeros((d,), dtype=dtype, device=device), lam,
                       dataclasses.replace(batch, weights=wts), norm)
        out.append(norm.transform_model_coefficients(
            Coefficients(means=result.w), config.intercept_index).means)
    return to_numpy(torch.stack(out))


def bootstrap_train_glm(
    batch: LabeledBatch,
    config: GLMTrainingConfig,
    num_replicas: int = 100,
    seed: int = 0,
    confidence: float = 0.95,
    evaluation_batch: Optional[LabeledBatch] = None,
    portion: float = 1.0,
) -> BootstrapResult:
    """Fit ``num_replicas`` bootstrap resamples of one training config
    (single reg weight). With ``evaluation_batch`` every replica is
    evaluated on it and the named-metric distributions are returned
    (``BootstrapTraining.aggregateMetricsDistributions``)."""
    weights_r = resample_weights(
        torch.Generator().manual_seed(seed), batch.weights * batch.mask,
        batch.mask, num_replicas, portion,
    )
    return summarize_replicas(
        batch, config, bootstrap_replicas(batch, config, weights_r),
        confidence, evaluation_batch,
    )


def summarize_replicas(
    batch: LabeledBatch, config: GLMTrainingConfig, w_raw: np.ndarray,
    confidence: float = 0.95, evaluation_batch: Optional[LabeledBatch] = None,
) -> BootstrapResult:
    """The coefficient summary and metric distributions of an (R, d)
    replica matrix."""
    num_replicas = w_raw.shape[0]
    alpha = (1.0 - confidence) / 2.0
    summary = CoefficientSummary(
        mean=w_raw.mean(axis=0),
        stddev=(w_raw.std(axis=0, ddof=1) if num_replicas > 1
                else np.zeros(w_raw.shape[1])),
        min=w_raw.min(axis=0),
        max=w_raw.max(axis=0),
        lower=np.quantile(w_raw, alpha, axis=0),
        upper=np.quantile(w_raw, 1.0 - alpha, axis=0),
        confidence=confidence,
    )
    metric_distributions: Dict[str, np.ndarray] = {}
    if evaluation_batch is not None:
        eb = evaluation_batch
        dtype = solve_dtype(batch)
        per_replica: Dict[str, list] = {}
        ew = eb.effective_weights()
        for r in range(num_replicas):
            w = torch.from_numpy(w_raw[r]).to(device=eb.labels.device, dtype=dtype)
            margins = matvec(eb.features, w) + eb.offsets
            for name, value in metrics_mod.evaluate(config.task, eb.labels, margins, ew).items():
                per_replica.setdefault(name, []).append(value)
        metric_distributions = {k: np.asarray(v) for k, v in per_replica.items()}
    return BootstrapResult(
        coefficients=w_raw, summary=summary, metric_distributions=metric_distributions
    )
