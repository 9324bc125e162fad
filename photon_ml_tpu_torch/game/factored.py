"""Factored random-effect parameters (counterpart of the parameter
container of ``photon_ml_tpu/game/factored.py``; the reference's
``algorithm/FactoredRandomEffectCoordinate.scala:37-267``): w_e = B gamma_e
with a shared projection B (d x k) and per-entity latent coefficients
gamma_e (k,). The coordinate that trains them and the matrix-factorization
model are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FactoredParams:
    """(per-entity latent table, shared projection)."""

    gamma: torch.Tensor  # (E, k)
    projection: torch.Tensor  # (d, k)


def is_factored_params(x) -> bool:
    """THE predicate for factored parameter containers: persistence and
    scoring dispatch on it."""
    return isinstance(x, FactoredParams)
