"""GAME training driver (counterpart of ``photon_ml_tpu/cli/game_train.py``;
the reference's ``cli/game/training/Driver.scala:47-541``): read the
per-shard feature lists, convert Avro records to a GAME dataset (feature
bags + entity columns), build one coordinate per updating-sequence entry,
train the cartesian product of the per-coordinate reg-weight grids
(``Driver.scala:317-384``), log the training objective and the validation
metric after every coordinate update (``CoordinateDescent.scala:173-189``),
and save models in the reference's output layout with BEST/ALL selection
(``Driver.scala:393-441``). Run as

    python -m photon_ml_tpu_torch.cli.game_train --config params.json

or programmatically via :func:`run_game_training`. It runs on the CUDA
device unless given another: a fixed effect on a shard in
``sparse_shards`` solves through the ``fused_vgc`` / ``fused_hvp`` kernels
(one launch per TRON evaluation / CG step) and rescores through
``ell_matvec`` — with ``hot_columns`` through a hybrid design instead,
``ell_matvec`` and the column-sorted reduce per cold segment — as does
each validation and, with ``quality_fingerprint`` (the default), the
best model's margins on the training rows, which
complete the fingerprint the training ingest fed
(``quality-fingerprint.json`` in every export subdir). A shard without a
``feature_shards`` file takes the vocabulary of every key in the training
records (the native scan, ``IngestSource.build_vocab``). With
``streamed_ingest`` the training records decode through the ingest
pipeline's bounded pool (``IngestSource.game_data_streamed``): the same
GameData.

Single process: fixed effects; plain random effects and random effects
projected by ``RANDOM=k`` or ``INDEX_MAP`` on dense shards; wide random
effects on a sparse shard through ``INDEX_MAP`` straight from the ELL; and
factored random effects (``latent_dim``). With ``checkpoint_every`` each
grid combo checkpoints under ``output_dir/checkpoints/combo-<i>``; a
SIGTERM finishes the pass, writes a final checkpoint and
``preempted.json`` and saves no model, and a run with ``resume`` continues
from the checkpoints. Without validation data, warm start, checkpoints
or divergence guard, and with no factored, projected or sparse random
effect, the grid's combos train at once (``descent.run_grid``, where the
JAX driver vmaps them; log ``train grid xC (vmapped)``; the grid writes
no checkpoints, so a SIGTERM ends it after its pass and saves nothing);
otherwise one after another, each with ``passes_per_dispatch`` and
``convergence_tolerance``. The observability envelope is the JAX
driver's (``obs.observe``): ``trace_dir`` (``trace.json``,
``events.jsonl`` and ``metrics.json`` there), ``metrics_every``,
``profile_dir`` (a ``torch.profiler`` Chrome trace), ``flight_dir``
(``flight-<reason>.json`` on a divergence rollback, a preemption or a
crash) and ``convergence_report`` (``convergence-report.json`` beside the
models).

On a ``torch.distributed`` world (one process per card, e.g. ``torchrun
--nproc-per-node P -m photon_ml_tpu_torch.cli.game_train``; the driver
joins the launcher's world, NCCL on the card, gloo with ``--device cpu``):

- with ``entity_shards`` = P every rank ingests the whole input to its
  host and lays it out by entity there (``partition.entity_layout``,
  ``game.data.entity_partition_game_data``), then places only its row
  block (the fixed effect's rows, on ``fused_vgc`` / ``fused_hvp`` /
  ``ell_matvec`` for an ELL shard) and its entities' block of the random
  effect (``EntityShardedRandomEffectCoordinate``, an update with no
  collective) on its card;
- without it (the JAX driver's multi-process branch) every rank ingests
  its own part files (``process_local_paths``), which must be
  entity-partitioned, and owns the entities of its rows (dense shards); a
  factored random effect keeps the gamma rows of its entities and reduces
  its shared projection's solve over the ranks
  (``game.factored.EntityShardedFactoredRandomEffectCoordinate``).

Exported tables are in global entity order and every rank returns the
same model; rank 0 alone validates (on the whole model, gathered) and
writes the outputs. ``sharded_ckpt`` writes the sharded checkpoints (every
rank its shard), ``heartbeat_s`` starts the heartbeat monitor polled at
pass boundaries, ``collective_timeout_s`` puts the watchdog on the host
exchanges and ``collective_mode`` is set for the run; ``main`` exits with
``HOST_LOSS_EXIT_CODE`` when a peer is lost.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.cli.config import (
    CoordinateSpec,
    GameDriverParams,
    load_params,
    prepare_output_dir,
    resolve_date_range,
)
from photon_ml_tpu_torch.cli.train import driver_dtype
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game.coordinates import (
    CoordinateConfig,
    EntityShardedRandomEffectCoordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.data import (
    GameData,
    build_bucketed_random_effect_design,
    contiguous_entity_assignment,
    entity_partition_game_data,
    entity_shard_assignment,
)
from photon_ml_tpu_torch.game.descent import CoordinateDescent, GameModel, run_grid
from photon_ml_tpu_torch.game.factored import (
    EntityShardedFactoredRandomEffectCoordinate,
    FactoredConfig,
    FactoredRandomEffectCoordinate,
    is_factored_params,
)
from photon_ml_tpu_torch.game.projected import (
    ProjectedRandomEffectCoordinate,
    build_index_map_columns,
    parse_projector_spec,
    project_design_and_rows,
)
from photon_ml_tpu_torch.game.projectors import IndexMapProjection, build_random_projection
from photon_ml_tpu_torch.game.scoring import CompactReTable, score_game_data
from photon_ml_tpu_torch.io.ingest import IngestSource
from photon_ml_tpu_torch.io.pipeline import PipelineStats
from photon_ml_tpu_torch.io.models import (
    collapse_game_model,
    load_game_model,
    save_game_model,
    write_model_manifest,
)
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.models.training import OptimizerType
from photon_ml_tpu_torch.obs import quality as quality_mod
from photon_ml_tpu_torch.obs.trace import process_identity
from photon_ml_tpu_torch.ops import metrics as metrics_mod
from photon_ml_tpu_torch.ops.sparse import cast_values, is_sparse
from photon_ml_tpu_torch.parallel import mesh as parallel_mesh
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.heartbeat import HeartbeatMonitor, current_monitor, install_monitor
from photon_ml_tpu_torch.parallel.overlap import COLLECTIVE_MODE_ENV
from photon_ml_tpu_torch.resilience import GracefulShutdown
from photon_ml_tpu_torch.resilience.hostloss import HOST_LOSS_EXIT_CODE, is_host_loss
from photon_ml_tpu_torch.utils.dates import expand_date_paths
from photon_ml_tpu_torch.utils.device import resolve_device, synchronize, to_numpy
from photon_ml_tpu_torch.utils.logging import PhotonLogger, timed


def _refuse_multiprocess_hybrid(params: GameDriverParams) -> None:
    """The JAX driver's multi-process refusal of ``hot_columns``, with its
    message: a hybrid's row permutation is private to one process. A run
    is multi-process when the PHOTON_PROCESS_* environment says so
    (``obs.trace.process_identity``); the port's other multi-process
    paths are ROADMAP item 'Parallel'."""
    if process_identity()[1] <= 1:
        return
    problems = [f"coordinate {name!r}: hot_columns (the hybrid row permutation is "
                "process-local)" for name, spec in params.coordinates.items()
                if spec.hot_columns]
    if problems:
        raise ValueError("multi-process GAME training does not support: "
                         + "; ".join(problems))


def _validate_multiprocess_params(params: GameDriverParams) -> None:
    """The JAX driver's constraints of its multi-process branch, with its
    messages (``photon_ml_tpu/cli/game_train.py:89-135``): dense fixed
    effects and plain or factored random effects with ``num_buckets`` 1 on
    entity-partitioned splits; everything else fails loudly instead of
    diverging across processes."""
    problems = []
    if params.validate_input:
        problems.append("validate_input (validation rows would need the same entity "
                        "partitioning; score offline with cli.score)")
    if params.initial_model_dir:
        problems.append(
            "initial_model_dir (warm start: the loaded RE tables are remapped by POSITION "
            "into each process's local entity vocabulary before globalization, so "
            "coefficients would silently attach to the wrong entities; warm-start a "
            "single-process run or export per-partition models)")
    if params.sparse_shards:
        problems.append("sparse_shards (the projected-sparse RE path is per-process host "
                        "work)")
    if params.checkpoint_every > 0 and not params.sharded_ckpt:
        problems.append(
            "checkpoint_every > 0 without sharded_ckpt (the whole-model save_checkpoint is "
            "single-writer: every process racing the same step dir would trample the "
            "tmp/swap protocol — set sharded_ckpt so each process writes only its shard, "
            "docs/MULTIHOST.md)")
    for name, spec in params.coordinates.items():
        if spec.hot_columns:
            problems.append(f"coordinate {name!r}: hot_columns (the hybrid row permutation "
                            "is process-local)")
        if spec.random_effect is not None and spec.num_buckets != 1:
            problems.append(f"coordinate {name!r}: num_buckets != 1 (bucket shapes must "
                            "agree across processes)")
        if spec.projector:
            problems.append(f"coordinate {name!r}: projector")
    if problems:
        raise ValueError("multi-process GAME training does not support: " + "; ".join(problems))


def _ordered_entity_ids(re_key: str, vocab: dict) -> list:
    """One rank's entity vocabulary ordered by local index, for the
    allgather that makes it global; the ids must be str already
    (``photon_ml_tpu/cli/game_train.py:140``)."""
    ordered = [None] * len(vocab)
    for raw, i in vocab.items():
        if not isinstance(raw, str):
            raise ValueError(
                f"random effect {re_key!r}: entity id {raw!r} is {type(raw).__name__}, not "
                "str — multi-process GAME requires string entity ids (coerce them at "
                "ingest, before the vocabulary is built, so every process and every "
                "artifact agrees on key types)")
        ordered[i] = raw
    return ordered


def _pad_game_data(data: GameData, n_target: int) -> GameData:
    """Pad to ``n_target`` rows with weight-0, entity -1 rows, so that every
    rank holds the same row count."""
    pad = n_target - data.num_rows
    if pad == 0:
        return data
    return GameData(
        features={k: np.pad(np.asarray(v), ((0, pad), (0, 0))) for k, v in data.features.items()},
        labels=np.pad(data.labels, (0, pad)),
        offsets=np.pad(data.offsets, (0, pad)),
        weights=np.pad(data.weights, (0, pad)),
        entity_ids={k: np.pad(v, (0, pad), constant_values=-1)
                    for k, v in data.entity_ids.items()},
    )


def _coordinate_config(name: str, spec: CoordinateSpec, task: TaskType,
                       reg_weight: float) -> CoordinateConfig:
    return CoordinateConfig(
        shard=spec.shard,
        task=task,
        optimizer=OptimizerType[spec.optimizer],
        reg_weight=reg_weight,
        l1_ratio=spec.l1_ratio,
        max_iters=spec.max_iters,
        tolerance=spec.tolerance,
        down_sampling_rate=spec.down_sampling_rate,
        random_effect=spec.random_effect,
        active_cap=spec.active_cap,
        track_states=spec.track_states,
    )


def build_coordinates(
    params: GameDriverParams,
    data: GameData,
    task: TaskType,
    reg_combo: Dict[str, float],
    entity_counts: Dict[str, int],
    dtype: torch.dtype = torch.float64,
    device=None,
    design_cache: Dict[str, object] = None,
    shard_vocabs: Dict[str, FeatureVocabulary] = None,
    sharded: dict = None,
):
    """One training coordinate per updating-sequence entry, its data on
    ``device`` (None: the CUDA device, raising without one): fixed effects
    on dense or ELL shards, the latter as a hybrid with ``hot_columns``;
    random effects on dense shards, plain,
    projected (``RANDOM=k``, ``INDEX_MAP``) or factored (``latent_dim``);
    random effects on an ELL shard through ``INDEX_MAP``.
    ``design_cache`` carries the combo-invariant work across a reg-weight
    grid (designs and projections depend on the data, never on lambda).

    ``sharded`` (a world): {"mesh", "assignment", "partition"} with
    ``data`` the whole entity-partitioned dataset (``entity_shards``), or
    {"mesh", "assignment", "entity_spaces", "row_base"} with ``data`` this
    rank's own rows (the multi-process branch). The fixed effect places
    this rank's row block, the plain random effect builds as an
    :class:`EntityShardedRandomEffectCoordinate`."""
    device = resolve_device(device)
    cache = {} if design_cache is None else design_cache
    coords = {}
    for name in params.updating_sequence:
        spec = params.coordinates[name]
        cfg = _coordinate_config(name, spec, task, reg_combo[name])
        if sharded is not None:
            if name not in cache:
                cache[name] = _sharded_inputs(params, spec, data, entity_counts, dtype, device,
                                              sharded)
            if spec.random_effect is None:
                coords[name] = FixedEffectCoordinate(cache[name], cfg)
            elif spec.latent_dim is not None:
                # the factored effect's gamma block on the same lanes and
                # rows as a plain one's table block
                coords[name] = EntityShardedFactoredRandomEffectCoordinate(
                    cache[name].with_config(cfg), cfg, _factored_config(spec, cfg))
            else:
                coords[name] = cache[name].with_config(cfg)
            continue
        if spec.random_effect is None:
            if spec.hot_columns:
                # the hybrid split does not depend on lambda: built once per
                # grid sweep, like the random-effect designs
                key = f"{name}\x00hybrid"
                if key not in cache:
                    cache[key] = FixedEffectCoordinate.hybridize_batch(
                        data.fixed_effect_batch(spec.shard, dtype, device), spec.hot_columns)
                coords[name] = FixedEffectCoordinate(cache[key][0], cfg, hybrid_pack=cache[key])
                continue
            if name not in cache:
                cache[name] = data.fixed_effect_batch(spec.shard, dtype, device)
            coords[name] = FixedEffectCoordinate(cache[name], cfg)
            continue
        if is_sparse(data.features[spec.shard]):
            # a wide sparse random effect: INDEX_MAP straight from the ELL
            # (validate() guarantees the projector)
            key = f"{name}\x00sparse_projected"
            if key in cache:
                coords[name] = cache[key].with_config(cfg)
            else:
                coords[name] = cache[key] = ProjectedRandomEffectCoordinate.from_sparse_shard(
                    data, spec.random_effect, spec.shard, entity_counts[spec.random_effect],
                    cfg, num_buckets=spec.num_buckets, active_cap=spec.active_cap,
                    dtype=dtype, feature_ratio=spec.feature_ratio,
                    min_support=spec.min_support, device=device,
                )
            continue
        if name not in cache:
            design = build_bucketed_random_effect_design(
                data, spec.random_effect, spec.shard,
                entity_counts[spec.random_effect],
                num_buckets=spec.num_buckets, active_cap=spec.active_cap,
                dtype=dtype, feature_ratio=spec.feature_ratio,
                min_support=spec.min_support, device=device,
            )
            cache[name] = (
                design,
                torch.as_tensor(data.features[spec.shard], dtype=dtype, device=device),
                torch.as_tensor(data.entity_ids[spec.random_effect], dtype=torch.int64,
                                device=device),
                torch.as_tensor(data.offsets, dtype=dtype, device=device),
            )
        design, row_features, row_entities, offsets_base = cache[name]
        if spec.latent_dim is not None:
            if spec.projector:
                raise ValueError(
                    f"coordinate {name!r}: latent_dim (factored) and projector are "
                    "mutually exclusive"
                )
            coords[name] = FactoredRandomEffectCoordinate(
                design=design, row_features=row_features, row_entities=row_entities,
                full_offsets_base=offsets_base, re_config=cfg,
                factored=_factored_config(spec, cfg),
            )
            continue
        kind, k = parse_projector_spec(spec.projector) if spec.projector else ("IDENTITY", None)
        if kind == "IDENTITY":
            coords[name] = RandomEffectCoordinate(
                design=design, row_features=row_features, row_entities=row_entities,
                full_offsets_base=offsets_base, config=cfg,
            )
            continue
        key = f"{name}\x00projected"
        if key not in cache:
            d_orig = row_features.shape[1]
            if kind == "RANDOM":
                # the intercept's passthrough column keeps per-entity base
                # rates exactly representable (``ProjectionMatrix.scala:96-126``)
                icpt = (shard_vocabs[spec.shard].intercept_index
                        if shard_vocabs and spec.shard in shard_vocabs else None)
                projector = build_random_projection(d_orig, k, seed=0, intercept_index=icpt,
                                                    dtype=dtype, device=device)
            else:
                projector = build_index_map_columns(
                    data, spec.random_effect, spec.shard,
                    entity_counts[spec.random_effect], device=device)
            cache[key] = (projector, d_orig, project_design_and_rows(
                design, row_features, row_entities, projector))
        projector, d_orig, prebuilt = cache[key]
        coords[name] = ProjectedRandomEffectCoordinate(
            design=design, row_features=row_features, row_entities=row_entities,
            full_offsets_base=offsets_base, config=cfg, projector=projector,
            original_dim=d_orig, prebuilt=prebuilt,
        )
    return coords


def _factored_config(spec, cfg: CoordinateConfig) -> FactoredConfig:
    """A factored coordinate's configuration: the latent-factor solve takes
    the coordinate's config with the spec's ``latent_*`` overrides."""
    latent_cfg = dataclasses.replace(
        cfg,
        reg_weight=(spec.latent_reg_weight if spec.latent_reg_weight is not None
                    else cfg.reg_weight),
        max_iters=(spec.latent_max_iters if spec.latent_max_iters is not None
                   else cfg.max_iters),
        tolerance=(spec.latent_tolerance if spec.latent_tolerance is not None
                   else cfg.tolerance),
    )
    return FactoredConfig(latent_dim=spec.latent_dim,
                          num_inner_iterations=spec.num_inner_iterations,
                          latent_factor_config=latent_cfg)


def _sharded_inputs(params, spec, data: GameData, entity_counts, dtype, device, sharded):
    """A coordinate's combo-invariant inputs in a world: the fixed effect's
    row block of this rank as a LabeledBatch on ``device``, or the random
    effect's :class:`EntityShardedRandomEffectCoordinate` (its lanes and
    rows on the card; ``with_config`` makes each combo's)."""
    mesh = sharded["mesh"]
    local = "partition" not in sharded
    if spec.random_effect is None:
        batch = data.fixed_effect_batch(spec.shard, dtype, "cpu")
        if local:
            return parallel_mesh.shard_rows(batch, 1, 0, device)
        return parallel_mesh.shard_rows(batch, mesh.size, mesh.flat_index(), device)
    re_key = spec.random_effect
    if local:
        e_glob, e_base = sharded["entity_spaces"][re_key]
        design = build_bucketed_random_effect_design(
            data, re_key, spec.shard, len(sharded["local_vocabs"][re_key]),
            num_buckets=spec.num_buckets, active_cap=spec.active_cap, dtype=dtype,
            feature_ratio=spec.feature_ratio, min_support=spec.min_support)
        design = multihost.make_global_re_design(design, mesh, e_glob, e_base,
                                                 sharded["row_base"])
        ents = np.asarray(data.entity_ids[re_key], np.int64)
        coord = EntityShardedRandomEffectCoordinate.from_local(
            design, torch.as_tensor(np.asarray(data.features[spec.shard]), dtype=dtype),
            np.where(ents >= 0, ents + e_base, -1),
            torch.as_tensor(data.offsets, dtype=dtype),
            _coordinate_config("", spec, TaskType[params.task], spec.reg_weights[0]),
            mesh, sharded["assignments"][re_key], device=device)
    else:
        design = build_bucketed_random_effect_design(
            data, re_key, spec.shard, entity_counts[re_key], num_buckets=spec.num_buckets,
            active_cap=spec.active_cap, dtype=dtype, feature_ratio=spec.feature_ratio,
            min_support=spec.min_support)
        coord = EntityShardedRandomEffectCoordinate(
            design, torch.as_tensor(np.asarray(data.features[spec.shard]), dtype=dtype),
            data.entity_ids[re_key], torch.as_tensor(data.offsets, dtype=dtype),
            _coordinate_config("", spec, TaskType[params.task], spec.reg_weights[0]),
            mesh, sharded["assignments"][re_key], sharded["partition"], device=device)
    return coord


def materialize_original_space(model: GameModel, coords: Dict,
                               compact: bool = False) -> GameModel:
    """The model in original feature space: a projected coordinate's
    table back-projected (``RandomEffectModelInProjectedSpace.scala:31-97``;
    persistence and scoring never see projected coefficients). With
    ``compact``, an INDEX_MAP coordinate's table becomes the
    :class:`CompactReTable` of its back-projection instead, on its device
    (the entity's sorted active columns, padded with d): the same scores
    without the dense (E, d) table, which is what each validation needs."""

    def bridge(n, p):
        c = coords.get(n)
        if isinstance(c, (EntityShardedRandomEffectCoordinate,
                          EntityShardedFactoredRandomEffectCoordinate)):
            # the blocks gathered into global entity order (a collective)
            return c.global_table(p)
        if not isinstance(c, ProjectedRandomEffectCoordinate):
            return p
        if compact and isinstance(c.projector, IndexMapProjection):
            cols = c.projector.columns
            active = cols >= 0
            return CompactReTable(
                columns=torch.where(active, cols, torch.full_like(cols, c.original_dim)),
                values=torch.where(active, p, torch.zeros_like(p)),
            )
        return c.back_project(p)

    return dataclasses.replace(model, params={n: bridge(n, p) for n, p in model.params.items()})


@dataclasses.dataclass
class GameTrainingRun:
    params: GameDriverParams
    shard_vocabs: Dict[str, FeatureVocabulary]
    entity_vocabs: Dict[str, dict]
    # one entry per grid combo: (combo, model, history, validation metric,
    # and the port's "seconds": the combo's coordinate build + descent; on
    # the grid branch (``run_grid``) every entry holds the whole grid's
    # build + descent)
    sweep: List[dict]
    best_index: int
    output_dirs: List[str]
    device: str
    # wall-clock seconds per phase: ingest (training Avro decode, shards,
    # entity ids), validation_ingest, train (every combo's designs and
    # descent, per-update validation included), write (models, feature
    # indexes, manifest); with streamed_ingest the pipeline's
    # pipeline_decode and pipeline_stall seconds and pipeline_overlap_frac
    timings: Dict[str, float]
    # the Avro codec of each read: {"ingest": ..., "validation_ingest": ...},
    # each "native" (the C++ codec) or "python"
    codecs: Dict[str, str]


def _join_game_world(params: GameDriverParams, device) -> bool:
    """Join the launcher's world unless one is joined (NCCL for the card,
    gloo for ``device='cpu'``; a no-op without a launcher's variables) and,
    with ``entity_shards`` > 1, check that the world has that many ranks.
    True when this call joined it."""
    cpu = device is not None and torch.device(device).type == "cpu"
    joined_now = (not torch.distributed.is_initialized()
                  and multihost.initialize_multihost(backend="gloo" if cpu else None))
    n_world = parallel_mesh.world()[0]
    if params.entity_shards > 1 and n_world != params.entity_shards:
        if joined_now:
            multihost.shutdown_multihost()
        if params.entity_shards > n_world:
            raise ValueError(f"entity_shards={params.entity_shards} exceeds {n_world} "
                             "visible devices")
        raise ValueError(
            f"entity_shards={params.entity_shards} needs a world of {params.entity_shards} "
            f"ranks; this world has {n_world} (launch one process per device, e.g. torchrun "
            f"--nproc-per-node {params.entity_shards})")
    return joined_now


def run_game_training(params, device=None) -> GameTrainingRun:
    """Train the GAME model described by ``params`` (a GameDriverParams, a
    dict or a JSON path). ``device=None`` means CUDA (in a world, this
    rank's card), and raises when no card is present. Installs the
    preemption handler (``graceful_shutdown``), the collective watchdog
    (``collective_timeout_s``) and the heartbeat monitor (``heartbeat_s``)
    around the run."""
    params = load_params(params, GameDriverParams)
    params.validate()
    _refuse_multiprocess_hybrid(params)
    joined_now = _join_game_world(params, device)
    try:
        n_world, rank = parallel_mesh.world()
        device = (parallel_mesh.rank_device(device) if n_world > 1 and device is None
                  else resolve_device(device))
        if n_world > 1 and params.entity_shards <= 1:
            _validate_multiprocess_params(params)
        writer = rank == 0
        if writer:
            prepare_output_dir(params.output_dir, params.overwrite or params.resume)
        logger = PhotonLogger(
            os.path.join(params.output_dir, "log-message.txt") if writer else os.devnull,
            level=params.log_level,
        )
        shutdown = GracefulShutdown(logger)
        if params.graceful_shutdown:
            shutdown.install()
        prev_resilience = multihost.configure_collective_resilience(
            timeout_s=params.collective_timeout_s)
        prev_mode = os.environ.get(COLLECTIVE_MODE_ENV)
        if params.collective_mode is not None:
            os.environ[COLLECTIVE_MODE_ENV] = params.collective_mode
        monitor = None
        if params.heartbeat_s > 0:
            monitor = HeartbeatMonitor(interval_s=params.heartbeat_s).start()
            install_monitor(monitor)
            logger.info(f"heartbeat monitor: every {params.heartbeat_s}s over "
                        f"{monitor.process_count} process(es)")
        # metrics.json lands in trace_dir when tracing, else beside
        # log-message.txt (the writer's) when snapshots or the report are on
        metrics_path = None
        if params.trace_dir is None and writer and (
                params.metrics_every > 0 or params.convergence_report):
            metrics_path = os.path.join(params.output_dir, "metrics.json")
        # every coordinate update's per-entity convergence decoded even
        # without a tracer; the run's report lands beside the models
        conv_tracker = obs.install_convergence_tracker() if params.convergence_report else None
        n_world, rank = parallel_mesh.world()
        if n_world > 1:
            # every artifact of this rank (the tracer's, from its start) is
            # stamped with its rank, whoever joined the world
            obs.set_process_identity(rank, n_world)
        try:
            with obs.observe(trace_dir=params.trace_dir, metrics_path=metrics_path,
                             metrics_every=params.metrics_every,
                             profile_dir=params.profile_dir, hbm_every_s=params.hbm_every,
                             process_name="photon_ml_tpu_torch.game_train",
                             flight_dir=params.flight_dir, device=device):
                if n_world > 1:
                    # the world joined before this tracer: its barrier-backed
                    # clock.sync anchors this rank's shard for the merge
                    multihost.emit_pod_sync()
                return _run_game_training(params, device, logger, shutdown)
        finally:
            if params.quality_fingerprint:
                # normally uninstalled right after the training ingest; this
                # covers an ingest that raised
                quality_mod.uninstall_fingerprint_collector()
            multihost.configure_collective_resilience(prev_resilience.timeout_s,
                                                      prev_resilience.retries)
            if prev_mode is None:
                os.environ.pop(COLLECTIVE_MODE_ENV, None)
            else:
                os.environ[COLLECTIVE_MODE_ENV] = prev_mode
            if monitor is not None:
                install_monitor(None)
                monitor.stop()
            if conv_tracker is not None:
                if writer:
                    try:
                        path = conv_tracker.dump(
                            os.path.join(params.output_dir, "convergence-report.json"))
                        logger.info(f"wrote convergence report to {path}")
                    except OSError:
                        pass
                obs.uninstall_convergence_tracker()
            shutdown.uninstall()
            logger.close()
    finally:
        if joined_now:
            multihost.shutdown_multihost()


def _placed_game_data(data: GameData, dtype: torch.dtype, device) -> GameData:
    """The same dataset with every column on ``device``, so that scoring it
    after every update copies nothing from the host."""
    return GameData(
        features={k: cast_values(v, dtype, device) for k, v in data.features.items()},
        labels=torch.as_tensor(data.labels, dtype=dtype, device=device),
        offsets=torch.as_tensor(data.offsets, dtype=dtype, device=device),
        weights=torch.as_tensor(data.weights, dtype=dtype, device=device),
        entity_ids={k: torch.as_tensor(v, dtype=torch.int64, device=device)
                    for k, v in data.entity_ids.items()},
    )


def _run_game_training(params: GameDriverParams, device: torch.device,
                       logger: PhotonLogger, shutdown) -> GameTrainingRun:
    task = TaskType[params.task]
    dtype = driver_dtype(params.precision)
    timings: Dict[str, float] = {}
    logger.info(
        f"GAME training driver on {device}: task={params.task} "
        f"sequence={params.updating_sequence} iters={params.num_iterations}"
    )

    # ---- feature maps + dataset --------------------------------------------
    # the ingest paths feed the installed collector per shard; installed
    # for the TRAINING ingest only (validation rows must not blur the
    # baseline)
    fingerprint = None
    if params.quality_fingerprint:
        fingerprint = quality_mod.install_fingerprint_collector()
    n_world, rank = parallel_mesh.world()
    # the JAX driver's multi-process branch: a world without entity_shards,
    # each rank on its own part files
    multi = n_world > 1 and params.entity_shards <= 1
    writer = rank == 0
    with timed(logger, "prepare data"):
        t0 = time.perf_counter()
        date_range = resolve_date_range(params)
        train_paths = expand_date_paths(params.train_input, date_range)
        if multi:
            train_paths = multihost.process_local_paths(train_paths)
        source = IngestSource(train_paths, params.field_names)
        shard_vocabs: Dict[str, FeatureVocabulary] = {}
        fallback_shards = []
        fallback_vocab = None
        for shard in sorted({spec.shard for spec in params.coordinates.values()}):
            feature_file = params.feature_shards.get(shard)
            if feature_file:
                shard_vocabs[shard] = FeatureVocabulary.load(feature_file)
            else:
                fallback_shards.append(shard)
                if fallback_vocab is None:
                    fallback_vocab = source.build_vocab(add_intercept=params.add_intercept)
                shard_vocabs[shard] = fallback_vocab
        if multi and fallback_shards:
            raise ValueError(
                f"multi-process GAME requires a feature_shards file for every shard (got "
                f"none for {sorted(fallback_shards)}): the from-records fallback vocabulary "
                "is built from each process's local rows and would diverge across processes")
        if len(fallback_shards) > 1:
            # the from-records vocabulary is the FULL feature space, so these
            # shards collapse into identical bags, unlike the reference's
            # partitioned feature sections
            logger.warn(
                f"shards {sorted(fallback_shards)} have no feature_shards "
                "file and all fall back to the full from-records vocabulary; "
                "they will share an identical feature space"
            )
        entity_keys = sorted({
            spec.random_effect for spec in params.coordinates.values()
            if spec.random_effect is not None
        })
        if params.streamed_ingest:
            # the bounded parallel decode of the ingest pipeline: the same
            # GameData as the one-shot read
            stats = PipelineStats()
            data, entity_vocabs, _uids, _present = source.game_data_streamed(
                shard_vocabs, entity_keys, sparse_shards=set(params.sparse_shards),
                chunk_mb=params.ingest_chunk_mb, decode_threads=params.decode_threads,
                prefetch_depth=params.prefetch_depth,
                stage_timeout_s=params.stage_timeout_s, epoch_policy=params.epoch_policy,
                stats=stats,
            )
            snap = stats.snapshot()
            timings.update({"pipeline_decode": snap["decode_s"],
                            "pipeline_stall": snap["stall_s"],
                            "pipeline_overlap_frac": snap["overlap_frac"]})
        else:
            data, entity_vocabs, _uids, _present = source.game_data(
                shard_vocabs, entity_keys, sparse_shards=set(params.sparse_shards)
            )
        timings["ingest"] = time.perf_counter() - t0
        codecs = {"ingest": source.codec}
        logger.info(f"read {len(data.labels)} training records ({source.codec} codec)")
        if fingerprint is not None:
            # training ingest done: stop collecting before validation io
            quality_mod.uninstall_fingerprint_collector()
            logger.info(f"quality fingerprint: {fingerprint.rows} rows sketched "
                        f"over shards {sorted(fingerprint.shards)}")
        entity_counts = {k: len(v) for k, v in entity_vocabs.items()}
        logger.info(f"shards: { {s: len(v) for s, v in shard_vocabs.items()} } "
                    f"entities: {entity_counts}")
        sharded = None
        if multi:
            data, entity_vocabs, entity_counts, sharded = _globalize_multiprocess(
                data, entity_vocabs, entity_counts, logger)

        vdata = None
        if params.validate_input:
            t0 = time.perf_counter()
            vsource = IngestSource(
                expand_date_paths(params.validate_input, date_range), params.field_names,
            )
            vdata, _, _, _ = vsource.game_data(
                shard_vocabs, entity_keys, entity_vocabs=entity_vocabs,
                sparse_shards=set(params.sparse_shards),
            )
            codecs["validation_ingest"] = vsource.codec
            # rank 0 alone validates, on the whole model
            logger.info(f"read {vdata.num_rows} validation records")
            vdata = _placed_game_data(vdata, dtype, device) if writer else None
            synchronize(device)
            timings["validation_ingest"] = time.perf_counter() - t0

    if params.entity_shards > 1:
        data, sharded = _entity_layout(params, data, entity_counts, logger)
    shards_by_coord = {n: params.coordinates[n].shard for n in params.updating_sequence}
    res_by_coord = {n: params.coordinates[n].random_effect for n in params.updating_sequence}
    has_validation = bool(params.validate_input)
    # the checkpoints' entity keys, in each table's stored row order (a
    # sharded table's shard-major layout, pad rows keyed uniquely), so that
    # a restore at another width re-keys by entity
    ckpt_entity_keys = None
    if params.sharded_ckpt:
        ckpt_entity_keys = {}
        for n, re_key in res_by_coord.items():
            if re_key is None:
                continue
            ordered = [None] * len(entity_vocabs[re_key])
            for raw, i in entity_vocabs[re_key].items():
                ordered[i] = raw
            if sharded is not None:
                ordered = sharded["assignments"][re_key].stored_entity_keys(ordered)
            ckpt_entity_keys[n] = ordered

    def validation_metric(model: GameModel) -> float:
        if sharded is not None:
            # rank 0 scores; every rank takes its value
            value = _validation_on_rank0(model) if writer else None
            return float(multihost.allgather_objects(value)[0])
        return _validation_on_rank0(model)

    def _validation_on_rank0(model: GameModel) -> float:
        # a dense random-effect table on the device scores through the
        # plain join (game/scoring._random_scores), an INDEX_MAP one
        # through its compact table; no host compaction
        margins = score_game_data(
            model.params, shards_by_coord, res_by_coord, vdata, dtype=dtype, device=device
        ) + vdata.offsets
        if task.is_classifier:
            return float(metrics_mod.area_under_roc_curve(vdata.labels, margins, vdata.weights))
        if task == TaskType.POISSON_REGRESSION:
            return -float(metrics_mod.total_poisson_loss(vdata.labels, margins, vdata.weights))
        return -float(metrics_mod.root_mean_squared_error(vdata.labels, margins, vdata.weights))

    # warm-start tables from a previously saved model: rows remap by raw
    # entity id into THIS run's entity vocabulary
    warm_params: Dict[str, object] = {}
    if params.initial_model_dir:
        loaded, _, _, _ = load_game_model(
            params.initial_model_dir,
            {n: shard_vocabs[shards_by_coord[n]] for n in params.updating_sequence},
            {n: entity_vocabs[res_by_coord[n]] for n in params.updating_sequence
             if res_by_coord[n] is not None},
        )
        warm_params = {n: p for n, p in loaded.items() if n in params.coordinates}
        logger.info(f"warm-starting coordinates {sorted(warm_params)} from "
                    f"{params.initial_model_dir}")

    def warm_start(coords) -> Dict[str, object]:
        """The saved params each coordinate can start from: a plain table
        for a plain coordinate, FactoredParams of its latent dimension for
        a factored one; the others cold-start."""
        init = {}
        for n in params.updating_sequence:
            p, coord = warm_params.get(n), coords[n]
            if p is None:
                continue
            if isinstance(coord, EntityShardedRandomEffectCoordinate) and not is_factored_params(p):
                # a global-order table -> the stored layout (the coordinate
                # takes its block)
                p = coord.assignment.table_from_global(to_numpy(p))
            if isinstance(coord, FactoredRandomEffectCoordinate):
                ok = is_factored_params(p) and p.gamma.shape[1] == coord.factored.latent_dim
            else:
                ok = (not is_factored_params(p)
                      and not isinstance(coord, ProjectedRandomEffectCoordinate))
            if ok:
                init[n] = p
            else:
                logger.warn(f"coordinate {n}: saved params do not match the "
                            "coordinate kind/latent dim; cold-starting it")
        return init

    sweep: List[dict] = []
    design_cache: Dict[str, object] = {}
    t_train = time.perf_counter()
    grid_combos = list(params.grid())
    # the whole grid trains at once (``run_grid``) where the JAX driver
    # vmaps it (``photon_ml_tpu/cli/game_train.py:926-958``): no
    # validation, warm start, checkpoints or guard, and coordinates with
    # the grid surface (no factored, projected or sparse random effect)
    vmappable = (
        len(grid_combos) > 1
        and params.entity_shards <= 1
        and not has_validation
        and not multi
        and not warm_params
        and params.checkpoint_every <= 0
        and not params.divergence_guard
        and all(
            spec.latent_dim is None
            and not spec.projector
            and not (spec.random_effect is not None and is_sparse(data.features[spec.shard]))
            for spec in params.coordinates.values()
        )
    )
    if vmappable:
        t0 = time.perf_counter()
        coords = build_coordinates(params, data, task, grid_combos[0], entity_counts,
                                   dtype=dtype, device=device, design_cache=design_cache,
                                   shard_vocabs=shard_vocabs)
        vmappable = all(hasattr(c, "fused_state_for_reg") for c in coords.values())
        if vmappable:
            with timed(logger, f"train grid x{len(grid_combos)} (vmapped)"):
                cd = CoordinateDescent(
                    coordinates=coords,
                    labels=torch.as_tensor(data.labels, dtype=dtype, device=device),
                    base_offsets=torch.as_tensor(data.offsets, dtype=dtype, device=device),
                    weights=torch.as_tensor(data.weights, dtype=dtype, device=device),
                    task=task,
                )
                # a SIGTERM ends the grid after its pass; nothing is saved
                models, histories = run_grid(cd, grid_combos, params.num_iterations,
                                             stop_check=shutdown)
                synchronize(device)
            seconds = time.perf_counter() - t0
            if shutdown.requested:
                logger.warn("preempted during the grid: it has no checkpoints; "
                            "nothing is saved")
            for combo, model, history in zip(grid_combos, models, histories):
                for h in history:
                    logger.info(f"combo={combo} iter={h.iteration} coord={h.coordinate} "
                                f"objective={h.objective:.6g}")
                sweep.append({"combo": combo,
                              "model": materialize_original_space(model, coords),
                              "history": history, "validation_metric": None,
                              "seconds": seconds})
    for combo_index, combo in enumerate([] if vmappable else grid_combos):
        with timed(logger, f"train combo {combo}"):
            t0 = time.perf_counter()
            coords = build_coordinates(params, data, task, combo, entity_counts,
                                       dtype=dtype, device=device, design_cache=design_cache,
                                       shard_vocabs=shard_vocabs, sharded=sharded)
            rows = _row_block(data, sharded)
            cd = CoordinateDescent(
                coordinates=coords,
                labels=torch.as_tensor(data.labels[rows], dtype=dtype, device=device),
                base_offsets=torch.as_tensor(data.offsets[rows], dtype=dtype, device=device),
                weights=torch.as_tensor(data.weights[rows], dtype=dtype, device=device),
                task=task,
            )
            # validation, like persistence, sees original-space
            # coefficients
            vfn = (
                (lambda model, _coords=coords: validation_metric(
                    materialize_original_space(model, _coords, compact=True)))
                if (has_validation and params.validate_per_coordinate) else None
            )
            # keyed by the grid INDEX: reg-weight strings need not be unique
            ckpt_dir = (
                os.path.join(params.output_dir, "checkpoints", f"combo-{combo_index}")
                if params.checkpoint_every > 0 else None
            )
            mesh_block = (parallel_mesh.set_mesh(sharded["mesh"]) if sharded is not None
                          else contextlib.nullcontext())
            with mesh_block:
                model, history = _run_descent(cd, params, coords, warm_start(coords) or None,
                                              vfn, ckpt_dir, shutdown, ckpt_entity_keys)
                if vfn is not None:
                    final_metric = history[-1].validation_metric
                elif has_validation:
                    final_metric = validation_metric(
                        materialize_original_space(model, coords, compact=True))
                else:
                    final_metric = None
                model = materialize_original_space(model, coords)
            for h in history:
                if h.event == "frozen":
                    logger.warn(f"combo={combo} iter={h.iteration} coordinate "
                                f"{h.coordinate!r} FROZEN by the divergence guard; "
                                "remaining coordinates kept training")
            for h in history:
                logger.info(
                    f"combo={combo} iter={h.iteration} coord={h.coordinate} "
                    f"objective={h.objective:.6g}"
                    + (f" validation={h.validation_metric:.6g}"
                       if h.validation_metric is not None else "")
                    + (f" ({h.seconds:.2f}s/pass)" if h.seconds is not None else "")
                )
            synchronize(device)
            sweep.append({"combo": combo, "model": model, "history": history,
                          "validation_metric": final_metric,
                          "seconds": time.perf_counter() - t0})
            if shutdown.requested:
                if ckpt_dir is not None:
                    logger.warn(f"preempted during combo {combo}: final checkpoint + "
                                f"resumable marker written under {ckpt_dir}; re-run "
                                "with resume=true to continue")
                else:
                    logger.warn(f"preempted during combo {combo}: no checkpoint "
                                "directory (checkpoint_every is 0); nothing is saved")
                break
    timings["train"] = time.perf_counter() - t_train

    # best = highest validation metric (oriented so higher is better);
    # without validation data the last combo wins, like the reference
    if has_validation:
        best_index = int(np.argmax([s["validation_metric"] for s in sweep]))
    else:
        best_index = len(sweep) - 1
    logger.info(f"best combo: {sweep[best_index]['combo']} "
                f"(validation={sweep[best_index]['validation_metric']})")

    # ---- save models (``Driver.scala:393-441`` output modes) ---------------
    # a preempted run saves nothing; in a world rank 0 alone writes (every
    # rank holds the same model)
    output_dirs: List[str] = []
    save_here = writer and not shutdown.requested
    with timed(logger, "save models"):
        t0 = time.perf_counter()
        if fingerprint is not None and fingerprint.rows > 0 and save_here:
            # margin sketch: the best model's score distribution over its
            # own training rows, offsets included (the space serving scores
            # live in); one scoring pass, copied to the host once
            margins = score_game_data(
                sweep[best_index]["model"].params, shards_by_coord, res_by_coord, data,
                dtype=dtype, device=device,
            ) + torch.as_tensor(data.offsets, dtype=dtype, device=device)
            fingerprint.observe_margins(margins.cpu().numpy(), np.asarray(data.weights))
        to_save: List[int] = []
        if not save_here:
            pass
        elif params.model_output_mode == "BEST":
            to_save = [best_index]
        elif params.model_output_mode == "ALL":
            to_save = list(range(len(sweep)))
        for idx in to_save:
            entry = sweep[idx]
            subdir = (
                os.path.join(params.output_dir, "best")
                if params.model_output_mode == "BEST"
                else os.path.join(params.output_dir, "all", str(idx))
            )
            save_params = {
                # FactoredParams pass through whole (the latent wire format)
                n: p if is_factored_params(p) else to_numpy(p)
                for n, p in entry["model"].params.items()
            }
            save_shards = shards_by_coord
            save_res = res_by_coord
            save_evocabs = {n: entity_vocabs[res_by_coord[n]]
                            for n in params.updating_sequence if res_by_coord[n] is not None}
            if params.collapse_output:
                save_params, save_shards, save_res, save_evocabs = collapse_game_model(
                    save_params, save_shards, save_res, save_evocabs
                )
                logger.info(f"collapsed to coordinates {sorted(save_params)}")
            save_game_model(
                subdir,
                params=save_params,
                shards=save_shards,
                vocabs={n: shard_vocabs[save_shards[n]] for n in save_params},
                entity_vocabs=save_evocabs,
                random_effects=save_res,
                task=task,
            )
            with open(os.path.join(subdir, "model-spec.json"), "w") as f:
                json.dump(
                    {
                        "combo": entry["combo"],
                        "validation_metric": entry["validation_metric"],
                        "task": params.task,
                        "updating_sequence": params.updating_sequence,
                    },
                    f,
                    indent=2,
                )
            if fingerprint is not None and fingerprint.rows > 0:
                # before the manifest below, so that the baseline is under
                # the export's digest and hot-reloads with the model
                fingerprint.save(subdir)
            output_dirs.append(subdir)
        if save_here:
            for shard, vocab in shard_vocabs.items():
                vocab.save(os.path.join(params.output_dir, f"feature-index-{shard}.txt"))
        if output_dirs:
            # sha256 manifest over the whole export (models + vocabularies)
            write_model_manifest(params.output_dir)
        timings["write"] = time.perf_counter() - t0

    return GameTrainingRun(
        params=params,
        shard_vocabs=shard_vocabs,
        entity_vocabs=entity_vocabs,
        sweep=sweep,
        best_index=best_index,
        output_dirs=output_dirs,
        device=str(device),
        timings=timings,
        codecs=codecs,
    )


def _run_descent(cd: CoordinateDescent, params: GameDriverParams, coords, initial_model, vfn,
                 ckpt_dir, shutdown, ckpt_entity_keys):
    """``cd.run`` with the driver's settings."""
    return cd.run(
        params.num_iterations,
        initial_model=initial_model,
        validation_fn=vfn,
        checkpoint_dir=ckpt_dir,
        checkpoint_every=max(params.checkpoint_every, 1),
        resume=params.resume,
        divergence_guard=params.divergence_guard,
        # polled at pass boundaries: SIGTERM/SIGINT finishes the pass,
        # checkpoints and falls through to the driver's break
        stop_check=shutdown,
        freeze=params.freeze_coordinates or None,
        # passes in chunks of K with the tolerance's early exit, where the
        # JAX package runs K passes per dispatch
        passes_per_dispatch=params.passes_per_dispatch,
        convergence_tolerance=params.convergence_tolerance,
        # every rank its shard, entity-keyed; the heartbeat polled at pass
        # boundaries turns a lost peer into a final shard set and the
        # host-loss exit
        sharded_checkpoints=params.sharded_ckpt,
        entity_keys=ckpt_entity_keys,
        heartbeat=current_monitor(),
    )


def _row_block(data: GameData, sharded) -> slice:
    """This rank's rows of ``data``: its block of the entity-partitioned
    order (``entity_shards``), else all of them (one process, or a rank's
    own rows)."""
    if sharded is None or "partition" not in sharded:
        return slice(None)
    r = sharded["partition"].rows_per_shard
    p = sharded["mesh"].flat_index()
    return slice(p * r, (p + 1) * r)


def _entity_layout(params: GameDriverParams, data: GameData, entity_counts, logger):
    """The entity-sharded layout on the host (JAX ``cli/game_train.py:
    786-850``): the round-robin assignment of the plain random effect's
    entities and the rows regrouped by owner. Returns (permuted data,
    {"mesh", "assignment", "partition"})."""
    re_name = next(n for n, c in params.coordinates.items() if c.random_effect is not None)
    re_key = params.coordinates[re_name].random_effect
    mesh = parallel_mesh.make_entity_mesh(params.entity_shards)
    assignment = entity_shard_assignment(entity_counts[re_key], params.entity_shards)
    with obs.span("partition.entity_layout", cat="partition", shards=params.entity_shards,
                  entities=entity_counts[re_key]):
        data, partition = entity_partition_game_data(data, re_key, assignment)
    logger.info(f"entity-sharded descent: {params.entity_shards} shards, "
                f"{assignment.rows_per_shard} entities/shard, {partition.rows_per_shard} "
                f"rows/shard (padded from {partition.row_perm.size} stored rows)")
    return data, {"mesh": mesh, "assignments": {re_key: assignment}, "partition": partition}


def _globalize_multiprocess(data: GameData, entity_vocabs, entity_counts, logger):
    """The multi-process branch's global spaces (JAX ``cli/game_train.py:
    716-785``): every rank's rows padded to the world's largest count, each
    entity vocabulary allgathered in rank order into the global one (an
    entity on two ranks' splits is refused), and the contiguous entity
    assignment. Returns (data, global vocabularies, global counts,
    {"mesh", "assignment", "entity_spaces", "row_base", "local_vocabs"})."""
    from collections import Counter

    n_world, rank = parallel_mesh.world()
    n_local = data.num_rows
    n_target = int(multihost.allgather_host(np.asarray([n_local], np.int64)).max())
    data = _pad_game_data(data, n_target)
    local_vocabs = dict(entity_vocabs)
    entity_spaces = {k: multihost.global_entity_space(c) for k, c in sorted(entity_counts.items())}
    global_vocabs = {}
    for k in sorted(entity_vocabs):
        all_raw = multihost.allgather_strings(_ordered_entity_ids(k, entity_vocabs[k]))
        if len(set(all_raw)) != len(all_raw):
            dups = [r for r, c in Counter(all_raw).items() if c > 1]
            raise ValueError(
                f"random effect {k!r}: entity ids {sorted(dups)[:5]}"
                f"{'...' if len(dups) > 5 else ''} appear on more than one process — "
                "multi-process GAME requires ENTITY-PARTITIONED input splits (every "
                "entity's rows in exactly one process's files), like the reference's "
                "RandomEffectIdPartitioner placement")
        global_vocabs[k] = {r: i for i, r in enumerate(all_raw)}
    counts = multihost.allgather_objects({k: len(v) for k, v in local_vocabs.items()})
    res = sorted(entity_vocabs)
    # one random effect owns the table layout (the JAX branch's too: each
    # coordinate's table rows are its random effect's global entities)
    assignments = {k: contiguous_entity_assignment([c[k] for c in counts]) for k in res}
    logger.info(f"multi-process GAME: {n_world} processes; rows/process {n_target} (padded "
                f"from {n_local}), global entities "
                f"{ {k: es[0] for k, es in entity_spaces.items()} }")
    sharded = {"mesh": parallel_mesh.make_mesh(), "entity_spaces": entity_spaces,
               "row_base": n_target * rank, "local_vocabs": local_vocabs,
               "assignments": assignments}
    return data, global_vocabs, {k: es[0] for k, es in entity_spaces.items()}, sharded


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.game_train",
        description="Train GAME (fixed + random effects) models on a CUDA device.",
    )
    p.add_argument("--config", required=True, help="JSON GameDriverParams")
    p.add_argument("--overwrite", action="store_true", default=None)
    p.add_argument(
        "--trace-dir", default=None,
        help="emit a Chrome trace-event JSON + events.jsonl + metrics.json "
        "under this directory",
    )
    p.add_argument(
        "--metrics-every", type=float, default=None,
        help="seconds between periodic metrics.json registry snapshots "
        "(0 = final snapshot only)",
    )
    p.add_argument(
        "--profile-dir", default=None,
        help="a torch.profiler window over the run, written here as a Chrome trace",
    )
    p.add_argument(
        "--hbm-every", type=float, default=None,
        help="seconds between device-memory counter-track samples while "
        "tracing (0 disables; nothing off CUDA)",
    )
    p.add_argument(
        "--flight-dir", default=None,
        help="crash flight recorder output directory: flight-<reason>"
        ".json dumps on divergence/preemption/crash (default: --trace-dir)",
    )
    p.add_argument(
        "--convergence-report", action="store_true", default=None,
        help="decode the solvers' tapes: per-coordinate fleet convergence "
        "summaries every pass (convergence.* metrics + events) and "
        "<output-dir>/convergence-report.json",
    )
    p.add_argument(
        "--no-quality-fingerprint", dest="quality_fingerprint",
        action="store_false", default=None,
        help="skip the train-data quality fingerprint "
        "(quality-fingerprint.json in every export subdir — the "
        "serving drift-detection baseline)",
    )
    p.add_argument(
        "--streamed-ingest", action="store_true", default=None,
        help="decode the training input through the streaming ingest "
        "pipeline (bounded parallel decode)",
    )
    p.add_argument(
        "--ingest-chunk-mb", type=float, default=None,
        help="ingest pipeline: target decoded-chunk size in MB (default 64)",
    )
    p.add_argument(
        "--decode-threads", type=int, default=None,
        help="ingest pipeline: concurrent decode workers (0 = auto)",
    )
    p.add_argument(
        "--prefetch-depth", type=int, default=None,
        help="ingest pipeline: chunks decode may run ahead of the consumer "
        "(default 2)",
    )
    p.add_argument(
        "--stage-timeout-s", type=float, default=None,
        help="ingest pipeline watchdog: abandon and rerun a decode attempt "
        "stalled past this many seconds (default: off)",
    )
    p.add_argument(
        "--epoch-policy", choices=["fail", "skip"], default=None,
        help="exhausted ingest retries: fail the run (default) or skip and "
        "log the lost group",
    )
    p.add_argument(
        "--heartbeat-s", type=float, default=None,
        help="heartbeat interval in seconds (0 = off): a peer missing 3 intervals is "
        "declared lost — survivors write a final checkpoint shard set and exit with the "
        "distinct host-loss code",
    )
    p.add_argument(
        "--collective-timeout-s", type=float, default=None,
        help="watchdog deadline on host collectives: a stalled exchange times out, "
        "retries with backoff, and names the straggler instead of wedging the world "
        "(default: no watchdog)",
    )
    p.add_argument(
        "--sharded-ckpt", action="store_true", default=None,
        help="per-rank sharded checkpoints: each rank writes shard-<p>-of-<P> and rank 0 "
        "publishes a quorum manifest; entity-keyed shards restore onto another world size",
    )
    p.add_argument(
        "--entity-shards", type=int, default=None,
        help="entity-sharded GAME descent over a world of N ranks (the random-effect "
        "table, its bucket lanes and the entity-partitioned rows all shard; no collective "
        "in the random-effect update). 0/1 = off",
    )
    p.add_argument(
        "--collective-mode", choices=("fused", "overlap"), default=None,
        help="collective reduction strategy of feature-sharded solves",
    )
    p.add_argument(
        "--warm-from-watch-root", default=None, metavar="DIR",
        help="lifecycle warm start: resolve initial_model_dir to the newest "
        "manifest-bearing export under this serving watch root (entity-keyed "
        "warm start from whatever is live; cli.retrain drives this itself)",
    )
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; in a world cuda:LOCAL_RANK)")
    args = p.parse_args(argv)
    with open(args.config) as f:
        base = json.load(f)
    for key in ("overwrite", "quality_fingerprint", "streamed_ingest", "ingest_chunk_mb",
                "decode_threads", "prefetch_depth", "stage_timeout_s", "epoch_policy",
                "heartbeat_s", "collective_timeout_s", "sharded_ckpt", "entity_shards",
                "collective_mode", "trace_dir", "metrics_every", "profile_dir", "hbm_every",
                "flight_dir", "convergence_report"):
        if getattr(args, key) is not None:
            base[key] = getattr(args, key)
    if args.warm_from_watch_root is not None:
        from photon_ml_tpu_torch.lifecycle.orchestrator import latest_version_dir

        warm = latest_version_dir(args.warm_from_watch_root)
        if warm is None:
            p.error("--warm-from-watch-root: no manifest-bearing export "
                    f"under {args.warm_from_watch_root}")
        base["initial_model_dir"] = warm
    try:
        run_game_training(base, device=args.device)
    except BaseException as e:
        import sys

        # a lost peer (a lost heartbeat, a collective past its watchdog
        # budget, a failed torch.distributed collective): the final shard set
        # is on disk, so a restart (same or smaller world) resumes from it
        if is_host_loss(e):
            print(f"host loss: {e} — exiting {HOST_LOSS_EXIT_CODE} (restart resumes from "
                  "the sharded checkpoint)", file=sys.stderr)
            sys.exit(HOST_LOSS_EXIT_CODE)
        raise


if __name__ == "__main__":
    main()
