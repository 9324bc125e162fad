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
records (the native scan, ``IngestSource.build_vocab``).

Single process: fixed effects; plain random effects and random effects
projected by ``RANDOM=k`` or ``INDEX_MAP`` on dense shards; wide random
effects on a sparse shard through ``INDEX_MAP`` straight from the ELL; and
factored random effects (``latent_dim``). With ``checkpoint_every`` each
grid combo checkpoints under ``output_dir/checkpoints/combo-<i>``; a
SIGTERM finishes the pass, writes a final checkpoint and
``preempted.json`` and saves no model, and a run with ``resume`` continues
from the checkpoints. The grid combos train one after another (the JAX
package may vmap them, ``descent.run_grid``: the same math);
multi-process and entity-sharded runs and the observability envelope
raise ``NotImplementedError`` naming their ROADMAP item
(``cli/config.UNPORTED_GAME_FIELDS``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

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
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.data import GameData, build_bucketed_random_effect_design
from photon_ml_tpu_torch.game.descent import CoordinateDescent, GameModel
from photon_ml_tpu_torch.game.factored import (
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
from photon_ml_tpu_torch.resilience import GracefulShutdown
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
):
    """One training coordinate per updating-sequence entry, its data on
    ``device`` (None: the CUDA device, raising without one): fixed effects
    on dense or ELL shards, the latter as a hybrid with ``hot_columns``;
    random effects on dense shards, plain,
    projected (``RANDOM=k``, ``INDEX_MAP``) or factored (``latent_dim``);
    random effects on an ELL shard through ``INDEX_MAP``.
    ``design_cache`` carries the combo-invariant work across a reg-weight
    grid (designs and projections depend on the data, never on lambda)."""
    device = resolve_device(device)
    cache = {} if design_cache is None else design_cache
    coords = {}
    for name in params.updating_sequence:
        spec = params.coordinates[name]
        cfg = _coordinate_config(name, spec, task, reg_combo[name])
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
            latent_cfg = dataclasses.replace(
                cfg,
                reg_weight=(spec.latent_reg_weight if spec.latent_reg_weight is not None
                            else cfg.reg_weight),
                max_iters=(spec.latent_max_iters if spec.latent_max_iters is not None
                           else cfg.max_iters),
                tolerance=(spec.latent_tolerance if spec.latent_tolerance is not None
                           else cfg.tolerance),
            )
            coords[name] = FactoredRandomEffectCoordinate(
                design=design, row_features=row_features, row_entities=row_entities,
                full_offsets_base=offsets_base, re_config=cfg,
                factored=FactoredConfig(latent_dim=spec.latent_dim,
                                        num_inner_iterations=spec.num_inner_iterations,
                                        latent_factor_config=latent_cfg),
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
    # and the port's "seconds": the combo's coordinate build + descent)
    sweep: List[dict]
    best_index: int
    output_dirs: List[str]
    device: str
    # wall-clock seconds per phase: ingest (training Avro decode, shards,
    # entity ids), validation_ingest, train (every combo's designs and
    # descent, per-update validation included), write (models, feature
    # indexes, manifest)
    timings: Dict[str, float]
    # the Avro codec of each read: {"ingest": ..., "validation_ingest": ...},
    # each "native" (the C++ codec) or "python"
    codecs: Dict[str, str]


def run_game_training(params, device=None) -> GameTrainingRun:
    """Train the GAME model described by ``params`` (a GameDriverParams, a
    dict or a JSON path). ``device=None`` means CUDA, and raises when no
    card is present. Installs the preemption handler (``graceful_shutdown``)
    around the run."""
    device = resolve_device(device)
    params = load_params(params, GameDriverParams)
    params.validate()
    _refuse_multiprocess_hybrid(params)
    prepare_output_dir(params.output_dir, params.overwrite or params.resume)
    logger = PhotonLogger(
        os.path.join(params.output_dir, "log-message.txt"), level=params.log_level
    )
    shutdown = GracefulShutdown(logger)
    if params.graceful_shutdown:
        shutdown.install()
    try:
        return _run_game_training(params, device, logger, shutdown)
    finally:
        if params.quality_fingerprint:
            # normally uninstalled right after the training ingest; this
            # covers an ingest that raised
            quality_mod.uninstall_fingerprint_collector()
        shutdown.uninstall()
        logger.close()


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
    with timed(logger, "prepare data"):
        t0 = time.perf_counter()
        date_range = resolve_date_range(params)
        source = IngestSource(expand_date_paths(params.train_input, date_range),
                              params.field_names)
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
            vdata = _placed_game_data(vdata, dtype, device)
            synchronize(device)
            timings["validation_ingest"] = time.perf_counter() - t0
            logger.info(f"read {vdata.num_rows} validation records")

    shards_by_coord = {n: params.coordinates[n].shard for n in params.updating_sequence}
    res_by_coord = {n: params.coordinates[n].random_effect for n in params.updating_sequence}

    def validation_metric(model: GameModel) -> float:
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
    for combo_index, combo in enumerate(params.grid()):
        with timed(logger, f"train combo {combo}"):
            t0 = time.perf_counter()
            coords = build_coordinates(params, data, task, combo, entity_counts,
                                       dtype=dtype, device=device, design_cache=design_cache,
                                       shard_vocabs=shard_vocabs)
            cd = CoordinateDescent(
                coordinates=coords,
                labels=torch.as_tensor(data.labels, dtype=dtype, device=device),
                base_offsets=torch.as_tensor(data.offsets, dtype=dtype, device=device),
                weights=torch.as_tensor(data.weights, dtype=dtype, device=device),
                task=task,
            )
            # validation, like persistence, sees original-space
            # coefficients
            vfn = (
                (lambda model, _coords=coords: validation_metric(
                    materialize_original_space(model, _coords, compact=True)))
                if (vdata is not None and params.validate_per_coordinate) else None
            )
            # keyed by the grid INDEX: reg-weight strings need not be unique
            ckpt_dir = (
                os.path.join(params.output_dir, "checkpoints", f"combo-{combo_index}")
                if params.checkpoint_every > 0 else None
            )
            model, history = cd.run(
                params.num_iterations,
                initial_model=warm_start(coords) or None,
                validation_fn=vfn,
                checkpoint_dir=ckpt_dir,
                checkpoint_every=max(params.checkpoint_every, 1),
                resume=params.resume,
                divergence_guard=params.divergence_guard,
                # polled at pass boundaries: SIGTERM/SIGINT finishes the
                # pass, checkpoints and falls through to the break below
                stop_check=shutdown,
                freeze=params.freeze_coordinates or None,
            )
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
            if vfn is not None:
                final_metric = history[-1].validation_metric
            elif vdata is not None:
                final_metric = validation_metric(
                    materialize_original_space(model, coords, compact=True))
            else:
                final_metric = None
            model = materialize_original_space(model, coords)
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
    if vdata is not None:
        best_index = int(np.argmax([s["validation_metric"] for s in sweep]))
    else:
        best_index = len(sweep) - 1
    logger.info(f"best combo: {sweep[best_index]['combo']} "
                f"(validation={sweep[best_index]['validation_metric']})")

    # ---- save models (``Driver.scala:393-441`` output modes) ---------------
    # a preempted run saves nothing
    output_dirs: List[str] = []
    with timed(logger, "save models"):
        t0 = time.perf_counter()
        if fingerprint is not None and fingerprint.rows > 0 and not shutdown.requested:
            # margin sketch: the best model's score distribution over its
            # own training rows, offsets included (the space serving scores
            # live in); one scoring pass, copied to the host once
            margins = score_game_data(
                sweep[best_index]["model"].params, shards_by_coord, res_by_coord, data,
                dtype=dtype, device=device,
            ) + torch.as_tensor(data.offsets, dtype=dtype, device=device)
            fingerprint.observe_margins(margins.cpu().numpy(), np.asarray(data.weights))
        to_save: List[int] = []
        if shutdown.requested:
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
        if not shutdown.requested:
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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.game_train",
        description="Train GAME (fixed + random effects) models on a CUDA device.",
    )
    p.add_argument("--config", required=True, help="JSON GameDriverParams")
    p.add_argument("--overwrite", action="store_true", default=None)
    p.add_argument(
        "--no-quality-fingerprint", dest="quality_fingerprint",
        action="store_false", default=None,
        help="skip the train-data quality fingerprint "
        "(quality-fingerprint.json in every export subdir — the "
        "serving drift-detection baseline)",
    )
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    with open(args.config) as f:
        base = json.load(f)
    for key in ("overwrite", "quality_fingerprint"):
        if getattr(args, key) is not None:
            base[key] = getattr(args, key)
    run_game_training(base, device=args.device)


if __name__ == "__main__":
    main()
