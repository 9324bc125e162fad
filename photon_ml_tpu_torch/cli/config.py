"""Typed driver configuration (counterpart of ``photon_ml_tpu/cli/config.py``:
the GLM-training, GAME-training and scoring params), plus the two
output-side helpers the JAX package keeps in ``cli/train.py``
(``resolve_date_range``, ``prepare_output_dir``). Params load from a dict
or a JSON file; unknown keys are rejected.

``GLMDriverParams``, ``CoordinateSpec`` and ``GameDriverParams`` keep every
field of the JAX package's, so one JSON config drives both packages' drivers.
A field whose path the port does not run yet raises ``NotImplementedError``
naming its ROADMAP item when it is set; its default keeps it off.
"""

from __future__ import annotations

import dataclasses
import itertools
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
    defaults of ``photon_ml_tpu.cli.config.GLMDriverParams``."""

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
    # with sparse: the hottest columns as a dense slab, the rest as row
    # buckets of ELL (ops.sparse.to_hybrid); 0 = off, -1 = sized by column
    # counts, N > 0 = the N columns stored most
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
    # per-feature/label/margin sketches of the training data written to
    # quality-fingerprint.json: the serving drift monitor's baseline
    quality_fingerprint: bool = True
    collective_mode: Optional[str] = None

    def validate(self) -> None:
        if not self.train_input:
            raise ValueError("train_input is required")
        # the JAX package's hybrid refusals, with its messages, ahead of the
        # settings the port does not run (mesh_shape is one)
        if self.hot_columns and not self.sparse:
            raise ValueError("hot_columns requires sparse=True")
        if self.hot_columns and self.mesh_shape:
            raise ValueError(
                "hot_columns (hybrid features) is single-device for now: "
                "the bucketed cold segments have unequal row counts, "
                "which the row-sharded mesh path does not partition"
            )
        if self.hot_columns and self.optimizer == "NEWTON":
            raise ValueError(
                "NEWTON materializes the exact Hessian from dense "
                "features; hot_columns (hybrid) is not supported"
            )
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


# GameDriverParams fields the port does not run yet: field -> (the value
# that keeps it off, its item in ROADMAP.md queue A). ``entity_shards`` is
# off at 0 or 1.
UNPORTED_GAME_FIELDS = {
    "streamed_ingest": (False, "I/O runtime"),
    "trace_dir": (None, _OBS),
    "metrics_every": (0.0, _OBS),
    "profile_dir": (None, _OBS),
    "flight_dir": (None, _OBS),
    "convergence_report": (False, _OBS),
    "entity_shards": (0, "Parallel"),
    "heartbeat_s": (0.0, "Parallel"),
    "collective_timeout_s": (None, "Parallel"),
    "sharded_ckpt": (False, "Parallel"),
    "collective_mode": (None, "Parallel"),
}
# the same for each CoordinateSpec (every coordinate field runs)
UNPORTED_COORDINATE_FIELDS: Dict[str, tuple] = {}


def _unported_game_setting(params: "GameDriverParams"):
    """-> (what, item) of the first setting the port does not run, or None."""
    for name, (off, item) in UNPORTED_GAME_FIELDS.items():
        value = getattr(params, name)
        if value != off and not (name == "entity_shards" and value == 1):
            return f"{name}={value!r}", item
    for cname, spec in params.coordinates.items():
        for name, (off, item) in UNPORTED_COORDINATE_FIELDS.items():
            value = getattr(spec, name)
            if value != off:
                return f"coordinate {cname!r}: {name}={value!r}", item
    if params.passes_per_dispatch > 1 and params.convergence_tolerance > 0:
        # the JAX package tests the early exit once per dispatch chunk of
        # its fused passes; the port's descent runs pass by pass
        return (f"passes_per_dispatch={params.passes_per_dispatch} with "
                f"convergence_tolerance={params.convergence_tolerance!r}",
                "Combo grid and dispatch chunks")
    return None


@dataclasses.dataclass
class CoordinateSpec:
    """One GAME coordinate's optimization + data knobs — the typed analog
    of "maxIter,tol,lambda,downSampleRate,optimizer,regType" plus the data
    config DSL. ``reg_weights`` is a GRID axis: the driver trains the
    cartesian product over all coordinates' grids
    (``cli/game/training/Driver.scala:317-320``)."""

    shard: str  # feature bag id
    random_effect: Optional[str] = None  # metadataMap key; None = fixed
    optimizer: str = "TRON"
    reg_weights: List[float] = dataclasses.field(default_factory=lambda: [50.0])
    l1_ratio: float = 0.0
    max_iters: int = 20
    tolerance: float = 1e-5
    down_sampling_rate: Optional[float] = None
    active_cap: Optional[int] = None
    num_buckets: int = 4
    projector: Optional[str] = None  # RANDOM=<k> | INDEX_MAP | IDENTITY
    # per-entity Pearson feature selection: keep at most
    # ceil(ratio * numSamples_e) features per entity
    feature_ratio: Optional[float] = None
    # per-entity support filter, applied before the Pearson ranking
    # (``LocalDataSet.filterFeaturesBySupport``, LocalDataSet.scala:80-109)
    min_support: int = 0
    # factored random effect (w_e = B gamma_e)
    latent_dim: Optional[int] = None
    num_inner_iterations: int = 1
    latent_reg_weight: Optional[float] = None
    latent_max_iters: Optional[int] = None
    latent_tolerance: Optional[float] = None
    # a fixed effect on a shard in sparse_shards: its design as a hybrid
    # (to_hybrid, -1 = sized by column counts), built once per grid sweep;
    # the row permutation stays inside the coordinate
    hot_columns: int = 0
    # per-iteration solver tapes inside this coordinate's solves
    track_states: bool = False


@dataclasses.dataclass
class GameDriverParams:
    """GAME train-driver knobs (``cli/game/training/Params.scala:81-292``);
    the fields and defaults of ``photon_ml_tpu.cli.config.GameDriverParams``."""

    train_input: List[str]
    output_dir: str
    coordinates: Dict[str, CoordinateSpec]
    updating_sequence: List[str]
    task: str = "LOGISTIC_REGRESSION"
    num_iterations: int = 1
    validate_input: List[str] = dataclasses.field(default_factory=list)
    validate_per_coordinate: bool = True
    # shard id -> feature list file; a shard without one takes the
    # vocabulary of every key in the training records (the native scan)
    feature_shards: Dict[str, Optional[str]] = dataclasses.field(default_factory=dict)
    add_intercept: bool = True
    date_range: Optional[str] = None
    date_range_days_ago: Optional[str] = None
    field_names: str = "TRAINING_EXAMPLE"
    model_output_mode: str = "BEST"
    overwrite: bool = False
    log_level: str = "DEBUG"
    precision: str = "float64"
    checkpoint_every: int = 0
    resume: bool = False
    # roll back + damped-retry non-finite coordinate updates, freezing a
    # coordinate that keeps failing
    divergence_guard: bool = False
    # SIGTERM/SIGINT finish the current pass; without checkpoints the run
    # then ends and saves nothing
    graceful_shutdown: bool = True
    initial_model_dir: Optional[str] = None
    # coordinates that keep their warm start and are never updated
    freeze_coordinates: List[str] = dataclasses.field(default_factory=list)
    # merge coordinates sharing (effect type, shard) at save
    collapse_output: bool = False
    # padded-ELL shards (fixed effects, and random effects with projector
    # INDEX_MAP)
    sparse_shards: List[str] = dataclasses.field(default_factory=list)
    streamed_ingest: bool = False
    # ingest-pipeline knobs: read only by streamed_ingest
    ingest_chunk_mb: float = 64.0
    decode_threads: int = 0
    prefetch_depth: int = 2
    stage_timeout_s: Optional[float] = None
    epoch_policy: str = "fail"
    trace_dir: Optional[str] = None
    metrics_every: float = 0.0
    profile_dir: Optional[str] = None
    # read only while tracing (trace_dir)
    hbm_every: float = 0.5
    flight_dir: Optional[str] = None
    convergence_report: bool = False
    # passes per dispatch: the port runs one pass at a time whatever K
    # (the same math); K > 1 with a convergence tolerance is not ported
    passes_per_dispatch: int = 1
    convergence_tolerance: float = 0.0
    heartbeat_s: float = 0.0
    collective_timeout_s: Optional[float] = None
    sharded_ckpt: bool = False
    # quality-fingerprint.json in every export subdir (the serving drift
    # monitor's baseline)
    quality_fingerprint: bool = True
    entity_shards: int = 0
    collective_mode: Optional[str] = None

    def validate(self) -> None:
        """The JAX package's checks, in its order, then the settings the
        port does not run (``NotImplementedError`` naming the item)."""
        if not self.train_input:
            raise ValueError("train_input is required")
        if not self.updating_sequence:
            raise ValueError("updating_sequence is required")
        if self.freeze_coordinates:
            unknown = set(self.freeze_coordinates) - set(self.coordinates)
            if unknown:
                raise ValueError(
                    f"freeze_coordinates names unknown coordinates: {sorted(unknown)}"
                )
            if not self.initial_model_dir:
                raise ValueError(
                    "freeze_coordinates requires initial_model_dir "
                    "(a frozen cold start would serve zeros)"
                )
        if self.collective_mode is not None and self.collective_mode not in (
            "fused", "overlap",
        ):
            raise ValueError(
                f"collective_mode must be 'fused' or 'overlap', got {self.collective_mode!r}"
            )
        if self.entity_shards < 0:
            raise ValueError(f"entity_shards must be >= 0, got {self.entity_shards}")
        sparse = set(self.sparse_shards)
        for name, spec in self.coordinates.items():
            uses_sparse = spec.shard in sparse
            entityish = (
                spec.random_effect is not None
                or spec.latent_dim is not None
                or spec.projector
            )
            sparse_re_ok = (
                spec.random_effect is not None
                and spec.latent_dim is None
                and (spec.projector or "").strip().upper() == "INDEX_MAP"
            )
            if uses_sparse and entityish and not sparse_re_ok:
                raise ValueError(
                    f"coordinate {name!r} uses sparse shard {spec.shard!r} but "
                    "random/factored/projected effects need dense per-row "
                    "features (EXCEPT a random effect with projector INDEX_MAP, "
                    "which solves in each entity's compact column space)"
                )
            if spec.hot_columns and (entityish or not uses_sparse):
                raise ValueError(
                    f"coordinate {name!r}: hot_columns applies to fixed-effect "
                    "coordinates on a shard listed in sparse_shards"
                )
            if spec.hot_columns and spec.optimizer == "NEWTON":
                raise ValueError(
                    f"coordinate {name!r}: NEWTON materializes the exact Hessian "
                    "from dense features; hot_columns (hybrid) is not supported"
                )
        for name in self.updating_sequence:
            if name not in self.coordinates:
                raise ValueError(f"updating_sequence names unknown coordinate {name!r}")
        if self.model_output_mode not in MODEL_OUTPUT_MODES:
            raise ValueError(f"model_output_mode must be one of {MODEL_OUTPUT_MODES}")
        fixed = [n for n, c in self.coordinates.items() if c.random_effect is None]
        if len(fixed) > 1:
            raise ValueError(f"at most one fixed-effect coordinate supported, got {fixed}")
        if self.collapse_output:
            factored = [n for n, c in self.coordinates.items() if c.latent_dim is not None]
            if factored:
                raise ValueError(
                    f"collapse_output cannot merge factored coordinates {factored} "
                    "(ModelProcessingUtils.scala:235-236); failing before "
                    "training rather than at save"
                )
        if self.resume and self.checkpoint_every <= 0:
            raise ValueError(
                "resume=True requires checkpoint_every > 0; without checkpoints "
                "a resumed run would silently retrain from scratch over the "
                "existing output directory"
            )
        if self.passes_per_dispatch < 1:
            raise ValueError(
                f"passes_per_dispatch must be >= 1, got {self.passes_per_dispatch}"
            )
        if self.ingest_chunk_mb <= 0:
            raise ValueError(f"ingest_chunk_mb must be > 0, got {self.ingest_chunk_mb}")
        if self.decode_threads < 0:
            raise ValueError(
                f"decode_threads must be >= 0 (0 = auto), got {self.decode_threads}"
            )
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.stage_timeout_s is not None and self.stage_timeout_s < 0:
            raise ValueError(f"stage_timeout_s must be >= 0, got {self.stage_timeout_s}")
        if self.epoch_policy not in ("fail", "skip"):
            raise ValueError(
                f"epoch_policy must be 'fail' or 'skip', got {self.epoch_policy!r}"
            )
        if self.convergence_tolerance < 0:
            raise ValueError(
                f"convergence_tolerance must be >= 0, got {self.convergence_tolerance}"
            )
        if self.heartbeat_s < 0:
            raise ValueError(f"heartbeat_s must be >= 0 (0 = off), got {self.heartbeat_s}")
        if self.collective_timeout_s is not None and self.collective_timeout_s <= 0:
            raise ValueError(
                "collective_timeout_s must be > 0 (or null = no watchdog), got "
                f"{self.collective_timeout_s}"
            )
        unported = _unported_game_setting(self)
        if unported is not None:
            raise not_ported(*unported)

    def grid(self) -> List[Dict[str, float]]:
        """Cartesian product over each coordinate's reg-weight grid
        (``Driver.scala:317-320``): a list of {coordinate: reg_weight}."""
        names = list(self.updating_sequence)
        axes = [self.coordinates[n].reg_weights for n in names]
        return [dict(zip(names, combo)) for combo in itertools.product(*axes)]


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
    """A params dataclass from a JSON dict, with nested CoordinateSpec
    parsing and unknown-key rejection."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - fields
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    kwargs = dict(data)
    if cls is GameDriverParams and "coordinates" in kwargs:
        kwargs["coordinates"] = {
            name: spec if isinstance(spec, CoordinateSpec)
            else _from_dict(CoordinateSpec, spec)
            for name, spec in kwargs["coordinates"].items()
        }
    return cls(**kwargs)


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
