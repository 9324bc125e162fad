"""Learning-curve (fitting) diagnostic (counterpart of
``photon_ml_tpu/diagnostics/fitting.py``; the reference's
``diagnostics/fitting/FittingDiagnostic.scala:33-131``).

Rows are tagged uniformly into NUM_TRAINING_PARTITIONS buckets from a
numpy generator (the same draws as the JAX package for the same seed), the
last bucket is held out, and models are refit on cumulative portions (10%,
20%, ... 90%), each portion warm-started from the previous one; train and
holdout metrics per lambda per portion form the learning curves. Every
portion is the same batch with the mask zeroed outside it, so the shapes
never change.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.utils.device import to_numpy

NUM_TRAINING_PARTITIONS = 10
MIN_SAMPLES_PER_PARTITION_PER_DIMENSION = 10


@dataclasses.dataclass(frozen=True)
class FittingReport:
    """``fitting/FittingReport.scala``: per metric, aligned arrays of
    (portion %, train value, holdout value)."""

    metrics: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]
    message: str = ""


def fitting_diagnostic(batch, config, seed: int = 0) -> Dict[float, FittingReport]:
    """Learning curves for every reg weight in ``config``: {lambda:
    FittingReport}, empty when there is too little data
    (``FittingDiagnostic.scala:62-64``: more than
    d * MIN_SAMPLES_PER_PARTITION_PER_DIMENSION real rows are needed)."""
    from photon_ml_tpu_torch.models.training import train_glm
    from photon_ml_tpu_torch.ops import metrics as metrics_mod

    mask = to_numpy(batch.mask)
    real = mask > 0
    n_real = int(real.sum())
    d = batch.features.shape[-1]
    if n_real <= d * MIN_SAMPLES_PER_PARTITION_PER_DIMENSION:
        return {}

    rng = np.random.default_rng(seed)
    tags = np.where(real, rng.integers(0, NUM_TRAINING_PARTITIONS, size=mask.shape), -1)
    device = batch.labels.device

    def on_device(a):
        return torch.from_numpy(a).to(device=device, dtype=batch.weights.dtype)

    holdout_w = batch.effective_weights() * on_device(
        (tags == NUM_TRAINING_PARTITIONS - 1).astype(np.float64))

    # lambda -> portion -> {metric: value}, built portion by portion
    curves_train: Dict[float, Dict[float, Dict[str, float]]] = {
        lam: {} for lam in config.reg_weights
    }
    curves_test: Dict[float, Dict[float, Dict[str, float]]] = {
        lam: {} for lam in config.reg_weights
    }
    warm = None
    for max_tag in range(NUM_TRAINING_PARTITIONS - 1):
        in_portion = (tags >= 0) & (tags <= max_tag)
        portion_pct = 100.0 * in_portion.sum() / n_real
        in_portion_t = on_device(in_portion.astype(np.float64))
        sub = dataclasses.replace(batch, mask=in_portion_t * batch.mask)
        models = train_glm(sub, config, initial_coefficients=warm)
        warm = models[0].model.coefficients  # chain to the next portion
        portion_w = batch.weights * in_portion_t
        for tm in models:
            margins = tm.model.compute_margin(batch.features, batch.offsets)
            curves_train[tm.reg_weight][portion_pct] = metrics_mod.evaluate(
                config.task, batch.labels, margins, portion_w
            )
            curves_test[tm.reg_weight][portion_pct] = metrics_mod.evaluate(
                config.task, batch.labels, margins, holdout_w
            )

    out: Dict[float, FittingReport] = {}
    for lam in config.reg_weights:
        portions = sorted(curves_test[lam])
        metric_names = sorted({m for p in portions for m in curves_test[lam][p]})
        out[lam] = FittingReport(
            metrics={
                name: (
                    np.asarray(portions),
                    np.asarray([curves_train[lam][p].get(name, np.nan) for p in portions]),
                    np.asarray([curves_test[lam][p].get(name, np.nan) for p in portions]),
                )
                for name in metric_names
            },
        )
    return out
