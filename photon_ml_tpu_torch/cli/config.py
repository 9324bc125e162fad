"""Typed driver configuration (counterpart of the scoring half of
``photon_ml_tpu/cli/config.py``), plus the two output-side helpers the JAX
package keeps in ``cli/train.py`` (``resolve_date_range``,
``prepare_output_dir``). Params load from a dict or a JSON file; unknown
keys are rejected.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

from photon_ml_tpu_torch.utils.dates import DateRange


@dataclasses.dataclass
class ScoringParams:
    """Scoring-driver knobs (``cli/game/scoring/Params.scala``)."""

    input: List[str]
    model_dir: str
    output_dir: str
    model_kind: str = "game"  # "glm" | "game"
    # explicit .avro model file (glm only) — overrides the best-model.avro /
    # models/ resolution inside model_dir
    model_path: Optional[str] = None
    task: str = "LOGISTIC_REGRESSION"
    evaluate: bool = False  # requires labels in the input
    sparse: bool = False
    # GAME only: shards stored sparse
    sparse_shards: List[str] = dataclasses.field(default_factory=list)
    date_range: Optional[str] = None
    date_range_days_ago: Optional[str] = None
    field_names: str = "TRAINING_EXAMPLE"
    overwrite: bool = False
    log_level: str = "DEBUG"

    def validate(self) -> None:
        if not self.input:
            raise ValueError("input is required")
        if self.model_kind not in ("glm", "game"):
            raise ValueError("model_kind must be 'glm' or 'game'")


def _from_dict(cls, data: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - fields
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**data)


def load_params(source, cls):
    """Load driver params from an instance, a dict or a JSON file path."""
    if isinstance(source, cls):
        return source
    if isinstance(source, dict):
        return _from_dict(cls, source)
    with open(source) as f:
        return _from_dict(cls, json.load(f))


def resolve_date_range(params) -> Optional[DateRange]:
    if params.date_range:
        return DateRange.from_dates(params.date_range)
    if params.date_range_days_ago:
        return DateRange.from_days_ago(params.date_range_days_ago)
    return None


def prepare_output_dir(path: str, overwrite: bool) -> None:
    """Refuse a pre-existing output directory unless overwriting
    (``Driver.scala:520-526``)."""
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(
                f"output dir {path} exists; pass overwrite to replace"
            )
    else:
        os.makedirs(path)
