"""Carry data across from the JAX package as numpy arrays.

The inputs are numpy arrays taken from ``photon_ml_tpu``'s
``Coefficients``, ``SparseFeatures``, ``LabeledBatch``,
``NormalizationContext`` and ``SolverConfig`` (``np.asarray`` of their
fields); this module never imports that package. bfloat16 arrays
(numpy's ``ml_dtypes`` bfloat16) are converted exactly through float32.
The other bridge is the GLM Avro model file, which both packages read and
write (``io.models``).
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.core.normalization import NormalizationContext
from photon_ml_tpu_torch.core.types import Coefficients, LabeledBatch
from photon_ml_tpu_torch.ops.sparse import SparseFeatures
from photon_ml_tpu_torch.solvers.common import SolverConfig


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy -> tensor on ``device`` in the same dtype (bfloat16 kept),
    copied: arrays taken from JAX are read-only views."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def coefficients_from_numpy(means, variances=None, device="cpu") -> Coefficients:
    return Coefficients(
        means=tensor_from_numpy(means, device),
        variances=None if variances is None else tensor_from_numpy(variances, device),
    )


def sparse_from_numpy(indices, values, d: int, device="cpu") -> SparseFeatures:
    return SparseFeatures(
        indices=tensor_from_numpy(np.asarray(indices, np.int32), device),
        values=tensor_from_numpy(values, device),
        d=int(d),
    )


def labeled_batch_from_numpy(
    features, labels, offsets, weights, mask, device="cpu"
) -> LabeledBatch:
    """``features`` is a dense numpy matrix or a port ``SparseFeatures``
    (from :func:`sparse_from_numpy`); the columns keep their dtypes."""
    if not isinstance(features, SparseFeatures):
        features = tensor_from_numpy(features, device)
    return LabeledBatch(
        features=features,
        labels=tensor_from_numpy(labels, device),
        offsets=tensor_from_numpy(offsets, device),
        weights=tensor_from_numpy(weights, device),
        mask=tensor_from_numpy(mask, device),
    )


def normalization_from_numpy(factors=None, shifts=None, device="cpu") -> NormalizationContext:
    """A ``NormalizationContext`` from its (d,) factors and shifts (either
    may be None)."""
    return NormalizationContext(
        factors=None if factors is None else tensor_from_numpy(factors, device),
        shifts=None if shifts is None else tensor_from_numpy(shifts, device),
    )


def solver_config_from_numpy(
    lower_bounds=None, upper_bounds=None, device="cpu", **knobs
) -> SolverConfig:
    """A ``SolverConfig`` with numpy box constraints; ``knobs`` are its
    scalar fields (max_iters, tolerance, ...), as in the JAX package's."""
    return SolverConfig(
        lower_bounds=None if lower_bounds is None else tensor_from_numpy(lower_bounds, device),
        upper_bounds=None if upper_bounds is None else tensor_from_numpy(upper_bounds, device),
        **knobs,
    )
