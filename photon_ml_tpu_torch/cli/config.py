"""Typed driver configuration (counterpart of the GLM-training and scoring
halves of ``photon_ml_tpu/cli/config.py``), plus the two output-side
helpers the JAX package keeps in ``cli/train.py`` (``resolve_date_range``,
``prepare_output_dir``). Params load from a dict or a JSON file; unknown
keys are rejected.

``GLMDriverParams`` keeps every field of the JAX package's, so one JSON
config drives both drivers. A field whose path the port does not run yet
raises ``NotImplementedError`` naming its ROADMAP item when it is set;
its default keeps it off. ``quality_fingerprint`` defaults to off here
(the JAX package's default is on).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from photon_ml_tpu_torch.core.normalization import NormalizationType
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.models.training import (
    GLMTrainingConfig,
    OptimizerType,
    not_ported,
)
from photon_ml_tpu_torch.ops.objective import RegularizationContext
from photon_ml_tpu_torch.utils.dates import DateRange

MODEL_OUTPUT_MODES = ("ALL", "BEST", "NONE")

# GLMDriverParams fields the port does not run yet: field -> (the value
# that keeps it off, its item in ROADMAP.md queue A)
_OBS = "Host layers with no device math"
UNPORTED_GLM_FIELDS = {
    "out_of_core": (False, "I/O runtime"),
    "streamed_ingest": (False, "I/O runtime"),
    "mesh_shape": (None, "Parallel"),
    "hot_columns": (0, "Hybrid designs"),
    "quality_fingerprint": (False, "Ingest hooks"),
    "profile": (False, _OBS),
    "debug_nans": (False, _OBS),
    "trace_dir": (None, _OBS),
    "metrics_every": (0.0, _OBS),
    "profile_dir": (None, _OBS),
    "flight_dir": (None, _OBS),
    "convergence_report": (False, _OBS),
    "heartbeat_s": (0.0, "Parallel"),
    "collective_timeout_s": (None, "Parallel"),
    "sharded_ckpt": (False, "Parallel"),
    "collective_mode": (None, "Parallel"),
}


@dataclasses.dataclass
class GLMDriverParams:
    """Core GLM train-driver knobs (``Params.scala:36-183``); the fields and
    defaults of ``photon_ml_tpu.cli.config.GLMDriverParams`` except
    ``quality_fingerprint``."""

    train_input: List[str]
    output_dir: str
    task: str = "LOGISTIC_REGRESSION"
    optimizer: str = "LBFGS"
    reg_type: str = "L2"
    reg_weights: List[float] = dataclasses.field(default_factory=lambda: [1.0])
    elastic_net_alpha: float = 0.5
    normalization: str = "NONE"
    max_iters: int = 80
    tolerance: float = 1e-7
    add_intercept: bool = True
    sparse: bool = False
    streamed_ingest: bool = False
    out_of_core: bool = False
    # ingest-pipeline knobs: read only by streamed_ingest / out_of_core
    ingest_chunk_mb: float = 64.0
    decode_threads: int = 0
    prefetch_depth: int = 2
    stage_timeout_s: Optional[float] = None
    epoch_policy: str = "fail"
    hot_columns: int = 0
    validate_input: List[str] = dataclasses.field(default_factory=list)
    data_validation: str = "VALIDATE_FULL"
    feature_file: Optional[str] = None  # pinned vocabulary (one key per line)
    # coefficient bounds JSON (io/constraints.py), read by the driver
    constraint_file: Optional[str] = None
    date_range: Optional[str] = None  # "yyyymmdd-yyyymmdd"
    date_range_days_ago: Optional[str] = None  # "N-M"
    field_names: str = "TRAINING_EXAMPLE"
    model_output_mode: str = "ALL"
    overwrite: bool = False
    compute_variances: bool = False
    # evaluate every iteration's coefficients on the validation data
    # (``Driver.scala:293-347`` validatePerIteration + ModelTracker)
    validate_per_iteration: bool = False
    # warm start: a previous GLM run's directory or an explicit .avro
    initial_model_dir: Optional[str] = None
    log_level: str = "DEBUG"
    # model diagnostics (HL, error independence, importances) -> HTML
    # report + DIAGNOSED stage; requires validate_input
    diagnostics: bool = False
    # additionally the training diagnostics: learning-curve refits and
    # bootstrap intervals (``Params.trainingDiagnosticsEnabled``)
    training_diagnostics: bool = False
    # "float64" (the reference's double-precision solves); anything else
    # solves in float32
    precision: str = "float64"
    mesh_shape: Optional[Dict[str, int]] = None
    profile: bool = False
    debug_nans: bool = False
    trace_dir: Optional[str] = None
    metrics_every: float = 0.0
    profile_dir: Optional[str] = None
    # read only while tracing (trace_dir)
    hbm_every: float = 0.5
    flight_dir: Optional[str] = None
    convergence_report: bool = False
    # "scan" | "loop": the port runs the per-lambda loop for both
    path_mode: str = "scan"
    heartbeat_s: float = 0.0
    collective_timeout_s: Optional[float] = None
    sharded_ckpt: bool = False
    quality_fingerprint: bool = False
    collective_mode: Optional[str] = None

    def validate(self) -> None:
        if not self.train_input:
            raise ValueError("train_input is required")
        for name, (off, item) in UNPORTED_GLM_FIELDS.items():
            if getattr(self, name) != off:
                raise not_ported(f"{name}={getattr(self, name)!r}", item)
        if self.model_output_mode not in MODEL_OUTPUT_MODES:
            raise ValueError(
                f"model_output_mode must be one of {MODEL_OUTPUT_MODES}"
            )
        if self.date_range and self.date_range_days_ago:
            raise ValueError(
                "date_range and date_range_days_ago are mutually exclusive"
            )
        if self.training_diagnostics and not self.diagnostics:
            raise ValueError("training_diagnostics requires diagnostics=True")
        if self.validate_per_iteration and not self.validate_input:
            raise ValueError("validate_per_iteration requires validate_input")
        if self.diagnostics and not self.validate_input:
            raise ValueError(
                "diagnostics requires validate_input (the model diagnostics "
                "run against validation data, Driver.scala:424-474)"
            )
        self.to_training_config().validate()

    def to_training_config(self) -> GLMTrainingConfig:
        return GLMTrainingConfig(
            task=TaskType[self.task],
            optimizer=OptimizerType[self.optimizer],
            reg_weights=tuple(self.reg_weights),
            regularization=RegularizationContext(
                self.reg_type, alpha=self.elastic_net_alpha
            )
            if self.reg_type != "NONE"
            else RegularizationContext("NONE"),
            normalization=NormalizationType[self.normalization],
            max_iters=self.max_iters,
            tolerance=self.tolerance,
            compute_variances=self.compute_variances,
            track_models=self.validate_per_iteration,
            path_mode=self.path_mode,
            # set by the driver once the vocabulary exists
            intercept_index=None,
        )


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
