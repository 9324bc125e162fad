"""GLM training driver (counterpart of ``photon_ml_tpu/cli/train.py``; the
reference's staged pipeline, ``Driver.scala:76-570``): INIT -> PREPROCESSED
(Avro ingest, feature indexing, data validation, feature summary) ->
TRAINED (descending-lambda path with warm starts; box constraints from
``constraint_file``; variances with ``compute_variances``) -> VALIDATED
(named metrics per lambda, best-model selection) -> DIAGNOSED (with
``diagnostics``: model-diagnostic.html) -> model, text and summary
outputs. Run as

    python -m photon_ml_tpu_torch.cli.train --config params.json

or programmatically via :func:`run_glm_training`. It runs on the CUDA
device unless given another: with ``sparse`` the objective passes go
through the ``fused_vgc`` / ``fused_hvp`` kernels, the variances through
``fused_hdiag``, the feature summary through ``ell_colsum`` (the
column-sorted reduce on the card), and the validation margins and the
quality fingerprint's margins through ``ell_matvec``. With
``hot_columns`` each batch, training and validation, is split on the
host into a hybrid design (``ops.sparse.to_hybrid``, its own hot columns,
its rows permuted), whose solves take the unfused passes: ``ell_matvec``
and the column-sorted reduce per cold segment and a plain product on the
slab. Without a ``feature_file`` the vocabulary is the native scan of
the training files (``IngestSource.build_vocab``); with
``quality_fingerprint`` (the default) the training ingest feeds a
:class:`~photon_ml_tpu_torch.obs.quality.BaselineFingerprint`, which the
chosen model's margins on the training batch complete and
``quality-fingerprint.json`` stores. With ``streamed_ingest`` the dense
batch is assembled on the device through the ingest pipeline
(:mod:`photon_ml_tpu_torch.io.pipeline`); with ``out_of_core`` the dense
design stays on the host in uniform chunks (pinned for the card) that every
objective pass streams to the device (``train_glm_streamed``), with no
sanity check, feature summary or fingerprint margins. Both feed the
fingerprint per staged chunk.

With ``mesh_shape`` the solve is sharded over a ``torch.distributed``
world whose size is the product of the mesh (``{"data": P}`` rows over P
ranks, ``"feature"`` > 1 also the coefficients;
``photon_ml_tpu_torch.parallel``). Launch one process per card::

    torchrun --nproc-per-node P -m photon_ml_tpu_torch.cli.train --config c.json

The driver joins the world from the launcher's variables (or uses one the
caller has joined), every rank ingests the input to its host and places
only its shard on its card (``cuda:{LOCAL_RANK}`` unless ``device`` is
given); the feature summary and the fingerprint's margins come from the
shards. Rank 0 alone writes the outputs (and runs the diagnostics, on the
whole batch); every rank returns the same models.
``collective_timeout_s`` puts a watchdog on the host collectives,
``heartbeat_s`` starts the heartbeat monitor, ``collective_mode`` picks
the feature-sharded reduction schedule, and ``sharded_ckpt`` is checked
and writes nothing (the GLM path has no checkpoint, as in the JAX
driver). ``main`` exits with the host-loss code when a peer is lost.

The observability envelope is the JAX driver's (``obs.observe``, JAX
``cli/train.py:176-231``): ``trace_dir`` (``trace.json``, ``events.jsonl``
and ``metrics.json`` there; ``glm.solve_path`` and ``glm.solve`` spans with
the cost book's attribution), ``metrics_every`` (periodic ``metrics.json``
snapshots, in ``trace_dir`` or else the output directory), ``profile_dir``
(a ``torch.profiler`` Chrome trace of the whole run), ``flight_dir``
(``flight-<reason>.json`` on a crash or a preemption) and
``convergence_report`` (``convergence-report.json`` beside the models);
``profile`` profiles the train phase into ``<output_dir>/profile`` and
``debug_nans`` raises at the first op or kernel of the train phase that
produces a NaN (``utils.debug``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed

from photon_ml_tpu_torch import obs, parallel
from photon_ml_tpu_torch.cli.config import (
    GLMDriverParams,
    load_params,
    prepare_output_dir,
    resolve_date_range,
)
from photon_ml_tpu_torch.cli.stages import DriverStage, StageTracker
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.validators import DataValidationType, sanity_check_data
from photon_ml_tpu_torch.diagnostics.driver import build_diagnostic_report
from photon_ml_tpu_torch.diagnostics.html import render_html
from photon_ml_tpu_torch.io.constraints import load_constraint_bounds
from photon_ml_tpu_torch.io.ingest import IngestSource
from photon_ml_tpu_torch.io.models import load_glm_model, save_glm_model
from photon_ml_tpu_torch.io.pipeline import (
    IngestPipeline,
    PipelineStats,
    StreamedDesign,
    config_for,
)
from photon_ml_tpu_torch.io.schemas import NAME_TERM_DELIMITER
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.models.selection import select_best_model
from photon_ml_tpu_torch.models.training import TrainedModel, train_glm, train_glm_streamed
from photon_ml_tpu_torch.obs import quality as quality_mod
from photon_ml_tpu_torch.ops import metrics as metrics_mod
from photon_ml_tpu_torch.ops.sparse import matvec, stored_cold_entries, to_hybrid
from photon_ml_tpu_torch.ops.stats import summarize_features
from photon_ml_tpu_torch.parallel import distributed
from photon_ml_tpu_torch.parallel import mesh as parallel_mesh
from photon_ml_tpu_torch.parallel.mesh import shard_rows
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.heartbeat import HeartbeatMonitor, install_monitor
from photon_ml_tpu_torch.parallel.overlap import COLLECTIVE_MODE_ENV
from photon_ml_tpu_torch.resilience.hostloss import HOST_LOSS_EXIT_CODE, is_host_loss
from photon_ml_tpu_torch.utils.dates import expand_date_paths
from photon_ml_tpu_torch.utils.debug import debug_nans, profile_trace
from photon_ml_tpu_torch.utils.device import resolve_device, synchronize
from photon_ml_tpu_torch.utils.logging import PhotonLogger, timed


def driver_dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def _host_f64(values) -> np.ndarray:
    """A tensor (any device or dtype) or array as a host float64 array; the
    widening is exact, so each value prints as the JAX writers'
    ``float(v)`` does."""
    if torch.is_tensor(values):
        values = values.detach().to("cpu", torch.float64).numpy()
    return np.ascontiguousarray(values, np.float64)


def _float_texts(values: np.ndarray) -> List[str]:
    """``str(float(v))`` of every value — Python's shortest round-trip
    repr, what the JAX writers print — formatted once per distinct bit
    pattern (so ``-0.0`` and ``0.0`` stay apart) and gathered."""
    bits, inverse = np.unique(values.view(np.int64), return_inverse=True)
    texts = np.asarray(list(map(str, bits.view(np.float64).tolist())), dtype=object)
    return texts[inverse.reshape(-1)].tolist()


def _name_term_prefixes(vocab: FeatureVocabulary, rows) -> List[str]:
    """"name\\tterm" of each vocabulary row (``vocab.name_term``)."""
    keys = vocab.index_to_key
    return [f"{name}\t{term}" for name, _, term in
            (keys[i].partition(NAME_TERM_DELIMITER) for i in rows)]


def write_model_text(path: str, means, vocab: FeatureVocabulary) -> None:
    """Plain-text model (``GLMSuite.scala:355-400``): one
    "name\\tterm\\tvalue" line per nonzero coefficient, the intercept
    always; the bytes of the JAX driver's writer, built column-wise."""
    values = _host_f64(means)
    keep = values != 0.0  # NaN is written, -0.0 is not (JAX's v == 0.0)
    if vocab.intercept_index is not None:
        keep[vocab.intercept_index] = True
    rows = np.flatnonzero(keep)
    lines = map("\t".join, zip(_name_term_prefixes(vocab, rows.tolist()),
                               _float_texts(values[rows])))
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(line + "\n" for line in lines)


SUMMARY_COLUMNS = ("mean", "variance", "min", "max", "norm_l1", "norm_l2",
                   "mean_abs", "num_nonzeros")


def write_feature_summary(path: str, summary, vocab: FeatureVocabulary) -> None:
    """Per-feature summary TSV, the JAX driver's layout and bytes (one line
    per feature; each value as ``str(float(v))``), built column-wise."""
    columns = [_float_texts(_host_f64(getattr(summary, c))) for c in SUMMARY_COLUMNS]
    lines = map("\t".join, zip(_name_term_prefixes(vocab, range(len(vocab))), *columns))
    with open(path, "w", encoding="utf-8") as f:
        f.write("name\tterm\t" + "\t".join(SUMMARY_COLUMNS) + "\n")
        f.writelines(line + "\n" for line in lines)


def _hybridize(batch, params: GLMDriverParams, logger):
    """The ELL batch as a hybrid design (``ops.sparse.to_hybrid``: the hot
    columns a dense slab, the cold tail in row buckets), with its
    row-aligned columns permuted to the hybrid's stored order on their
    device (training is row-order invariant)."""
    hf = to_hybrid(batch.features, hot_columns=params.hot_columns)
    widths = [seg.nnz_per_row for seg in hf.cold_segments]
    logger.info(
        f"hybrid split: {hf.dense.shape[1]} hot columns densified, "
        f"{stored_cold_entries(hf)} entries stay sparse over "
        f"{len(widths)} row buckets (widths {widths})"
    )
    perm = hf.row_perm
    return dataclasses.replace(
        batch,
        features=hf,
        labels=batch.labels.index_select(0, perm),
        offsets=batch.offsets.index_select(0, perm),
        weights=batch.weights.index_select(0, perm),
        mask=batch.mask.index_select(0, perm),
    )


def _pipeline_timings(timings: Dict[str, float], stats: PipelineStats, design) -> None:
    """The ingest pipeline's stage seconds, overlap and bytes into the run's
    timings (``pipeline_*``)."""
    snap = stats.snapshot()
    for key in ("decode_s", "stage_s", "transfer_s", "stall_s"):
        timings[f"pipeline_{key[:-2]}"] = snap[key]
    timings["pipeline_overlap_frac"] = snap["overlap_frac"]
    timings["pipeline_stall_frac"] = snap["stall_frac"]
    timings["pipeline_chunks"] = snap["chunks"]
    # bytes of one epoch: copied to the device once (streamed_ingest), or
    # streamed at every objective pass (out_of_core)
    timings["bytes_per_epoch"] = float(
        design.bytes_per_epoch if design is not None else snap["bytes_to_device"])


def _initial_model_path(init_path: str) -> str:
    """A run directory's best-model.avro, or the sole model in its
    models/, or an explicit .avro path."""
    if not os.path.isdir(init_path):
        return init_path
    best = os.path.join(init_path, "best-model.avro")
    if os.path.exists(best):
        return best
    mdir = os.path.join(init_path, "models")
    candidates = (
        sorted(f for f in os.listdir(mdir) if f.endswith(".avro"))
        if os.path.isdir(mdir) else []
    )
    if len(candidates) != 1:
        raise FileNotFoundError(
            f"no best-model.avro in {init_path} and {len(candidates)} "
            "candidates in models/ — point initial_model_dir at a specific .avro"
        )
    return os.path.join(mdir, candidates[0])


@dataclasses.dataclass
class GLMTrainingRun:
    """Everything a caller (or test) needs to inspect a completed run."""

    params: GLMDriverParams
    stages: List[DriverStage]
    vocab: FeatureVocabulary
    models: List[TrainedModel]
    best: Optional[TrainedModel]
    best_index: Optional[int]
    # positional, aligned with `models` (duplicate lambdas stay distinct)
    validation_metrics: List[Dict[str, float]]
    num_training_rows: int
    num_features: int
    summary: object
    device: str
    # wall-clock seconds per phase: ingest (Avro decode + ELL build + copy
    # to the device), hybridize (with hot_columns: the training batch's
    # split on the host, placed on the device), validate_data, summary
    # (device, synchronised), summary_write (feature-summary.tsv), train
    # (every solve), validate (validation ingest + margins + metrics),
    # diagnose (the diagnostic report, with diagnostics), write (the
    # fingerprint's margins and file, models, texts, vocabulary, metrics);
    # each solve's own seconds are on its model. With streamed_ingest or
    # out_of_core: the pipeline's pipeline_{decode,stage,transfer,stall}
    # seconds, pipeline_overlap_frac, pipeline_stall_frac, pipeline_chunks
    # and bytes_per_epoch; out_of_core adds pin (pinning the chunks, part
    # of ingest) and the sweeps' oocore_{sweep,transfer,consume} seconds,
    # oocore_bytes and oocore_overlap_frac (the share of the copies' and
    # passes' busy time with both running), device times from CUDA events
    # on the card, and there oocore_peak_bytes (the solves' device peak
    # above what was allocated before them)
    timings: Dict[str, float]
    # the Avro codec of each read: {"ingest": ..., "validate": ...}, each
    # "native" (the C++ codec) or "python"
    codecs: Dict[str, str]


def _join_mesh_world(params: GLMDriverParams, device) -> bool:
    """With ``mesh_shape``: join the launcher's world unless one is joined
    (NCCL for the card, gloo for ``device='cpu'``) and check that the mesh
    is the whole world. True when this call joined it."""
    if not params.mesh_shape:
        return False
    cpu = device is not None and torch.device(device).type == "cpu"
    joined_now = not torch.distributed.is_initialized() and multihost.initialize_multihost(
        backend="gloo" if cpu else None)
    size = 1
    for v in params.mesh_shape.values():
        size *= v
    n_world = parallel_mesh.world()[0]
    if size != n_world:
        if joined_now:
            multihost.shutdown_multihost()
        raise ValueError(
            f"mesh_shape {params.mesh_shape} needs a world of {size} ranks; this "
            f"world has {n_world} (launch one process per device, e.g. torchrun "
            f"--nproc-per-node {size})"
        )
    return joined_now


def run_glm_training(params, device=None) -> GLMTrainingRun:
    """Train the GLM path described by ``params`` (a GLMDriverParams, a
    dict or a JSON path). ``device=None`` means CUDA (under a mesh, this
    rank's card), and raises when no card is present."""
    params = load_params(params, GLMDriverParams)
    params.validate()
    joined_now = _join_mesh_world(params, device)
    try:
        device = (parallel_mesh.rank_device(device) if params.mesh_shape and device is None
                  else resolve_device(device))
        writer = parallel_mesh.world()[1] == 0
        if writer:
            prepare_output_dir(params.output_dir, params.overwrite)
        # the resilience envelope: a watchdog deadline on every host
        # collective and the heartbeat monitor that names a straggler
        prev_resilience = multihost.configure_collective_resilience(
            timeout_s=params.collective_timeout_s)
        prev_mode = os.environ.get(COLLECTIVE_MODE_ENV)
        if params.collective_mode is not None:
            os.environ[COLLECTIVE_MODE_ENV] = params.collective_mode
        monitor = None
        if params.heartbeat_s > 0:
            monitor = HeartbeatMonitor(interval_s=params.heartbeat_s).start()
            install_monitor(monitor)
        # metrics.json lands in trace_dir when tracing, else in the output
        # directory (the writer's) when snapshots or the report are asked for
        metrics_path = None
        if params.trace_dir is None and writer and (
                params.metrics_every > 0 or params.convergence_report):
            metrics_path = os.path.join(params.output_dir, "metrics.json")
        # per-solve tape decode even without a tracer; the aggregated report
        # lands beside the models
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
                             process_name="photon_ml_tpu_torch.train",
                             flight_dir=params.flight_dir, device=device):
                if n_world > 1:
                    # the world joined before this tracer: its barrier-backed
                    # clock.sync anchors this rank's shard for the merge
                    multihost.emit_pod_sync()
                return _run_glm_training(params, device, writer)
        finally:
            if params.quality_fingerprint:
                # normally uninstalled right after the training ingest; this
                # covers an ingest that raised, so no collector leaks into the
                # next run in this process
                quality_mod.uninstall_fingerprint_collector()
            multihost.configure_collective_resilience(
                prev_resilience.timeout_s, prev_resilience.retries)
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
                        conv_tracker.dump(
                            os.path.join(params.output_dir, "convergence-report.json"))
                    except OSError:
                        pass
                obs.uninstall_convergence_tracker()
    finally:
        if joined_now:
            multihost.shutdown_multihost()


def _run_glm_training(params: GLMDriverParams, device: torch.device,
                      writer: bool = True) -> GLMTrainingRun:
    tracker = StageTracker()
    logger = PhotonLogger(
        os.path.join(params.output_dir, "log-message.txt") if writer else os.devnull,
        level=params.log_level,
    )
    logger.info(f"GLM training driver on {device}: task={params.task} "
                f"optimizer={params.optimizer} reg={params.reg_type} "
                f"lambdas={params.reg_weights}")
    timings: Dict[str, float] = {}
    task = TaskType[params.task]
    dtype = driver_dtype(params.precision)

    # ---- PREPROCESS ------------------------------------------------------
    with timed(logger, "preprocess"):
        t0 = time.perf_counter()
        date_range = resolve_date_range(params)
        source = IngestSource(
            expand_date_paths(params.train_input, date_range), params.field_names
        )
        if params.feature_file:
            vocab = FeatureVocabulary.load(params.feature_file)
        else:
            vocab = source.build_vocab(add_intercept=params.add_intercept)
        logger.info(f"feature space: {len(vocab)} columns "
                    f"(intercept={vocab.intercept_index})")
        # the ingest paths feed the installed collector; installed for the
        # TRAINING ingest only (validation rows must not blur the baseline)
        fingerprint = None
        if params.quality_fingerprint:
            fingerprint = quality_mod.install_fingerprint_collector()
        batch = design = summary = placed = None
        stats = PipelineStats()
        # under a mesh the input stays on the host: each rank places its
        # shard alone on its card (``_mesh_place``)
        ingest_device = torch.device("cpu") if params.mesh_shape else device
        if params.out_of_core:
            # decode and stage once into host-resident uniform chunks
            # (pinned for the card); every objective pass streams them
            with IngestPipeline(
                source.files, [vocab], label_field=source.label_field,
                config=config_for(params.ingest_chunk_mb, params.decode_threads,
                                  params.prefetch_depth, params.stage_timeout_s,
                                  params.epoch_policy),
                stats=stats,
            ) as pipe:
                design = StreamedDesign.from_pipeline(pipe, dtype=dtype, device=device)
            source.codec = "native"
            timings["pin"] = design.pin_s
            logger.info(
                f"out-of-core design: {design.n} rows x {design.d} columns in "
                f"{design.num_chunks} chunks of {design.rows_per_chunk} rows "
                f"({design.bytes_per_epoch / 1e9:.2f} GB/epoch streamed; pinned in "
                f"{design.pin_s:.3f} s); sanity checks and the feature summary need the "
                "in-core batch and are skipped"
            )
        elif params.streamed_ingest:
            if params.sparse:
                raise ValueError(
                    "streamed_ingest is dense-only (padded-ELL width is "
                    "a global property; decode sparse inputs whole)"
                )
            batch, _uids, _present = source.labeled_batch_streamed(
                vocab, dtype=dtype, chunk_mb=params.ingest_chunk_mb,
                decode_threads=params.decode_threads, prefetch_depth=params.prefetch_depth,
                stage_timeout_s=params.stage_timeout_s, epoch_policy=params.epoch_policy,
                device=ingest_device, stats=stats,
            )
        else:
            batch, _uids, _present = source.labeled_batch(
                vocab, sparse=params.sparse, dtype=dtype, device=ingest_device
            )
        synchronize(device)
        timings["ingest"] = time.perf_counter() - t0
        codecs = {"ingest": source.codec}
        if params.out_of_core or params.streamed_ingest:
            _pipeline_timings(timings, stats, design)
        if batch is not None:
            logger.info(f"read {batch.labels.shape[0]} training records "
                        f"({source.codec} codec)")
            if params.hot_columns:
                t0 = time.perf_counter()
                batch = _hybridize(batch, params, logger)
                synchronize(device)
                timings["hybridize"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            sanity_check_data(batch, task, DataValidationType[params.data_validation])
            timings["validate_data"] = time.perf_counter() - t0

            if params.mesh_shape:
                t0 = time.perf_counter()
                placed = _mesh_place(params, batch, device)
                synchronize(device)
                timings["place"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            summary = (summarize_features(batch) if placed is None
                       else distributed.placed_summary(placed))
            synchronize(device)
            timings["summary"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if writer:
                write_feature_summary(
                    os.path.join(params.output_dir, "feature-summary.tsv"), summary, vocab
                )
            timings["summary_write"] = time.perf_counter() - t0
        if fingerprint is not None:
            quality_mod.uninstall_fingerprint_collector()
            logger.info(f"quality fingerprint: {fingerprint.rows} rows sketched")
    tracker.advance(DriverStage.PREPROCESSED)

    # ---- TRAIN -----------------------------------------------------------
    tracker.assert_at_least(DriverStage.PREPROCESSED)
    with timed(logger, "train"), profile_trace(
            os.path.join(params.output_dir, "profile") if params.profile else None,
            device=device, name="photon_ml_tpu_torch.train"), debug_nans(params.debug_nans):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(
            params.to_training_config(), intercept_index=vocab.intercept_index
        )
        if params.constraint_file:
            lb, ub = load_constraint_bounds(params.constraint_file, vocab)
            cfg = dataclasses.replace(cfg, lower_bounds=lb, upper_bounds=ub)
        initial = None
        if params.initial_model_dir:
            init_path = _initial_model_path(params.initial_model_dir)
            # coefficients remap by (name, term): unknown features drop,
            # new features start at 0
            initial, _ = load_glm_model(init_path, vocab, device=device)
            logger.info(f"warm-starting from {init_path}")
        if design is not None:
            logger.info(f"out-of-core solve over {design.num_chunks} streamed chunks")
            sweeps = PipelineStats()
            # the card's peak over the solves: the design's two device
            # slots and each pass's temporaries, not the design
            with (obs.hbm_watermark("io.oocore.solve", device=device)
                  if device.type == "cuda" else contextlib.nullcontext()) as wm:
                models = list(train_glm_streamed(design, cfg, initial_coefficients=initial,
                                                 stats=sweeps))
                synchronize(device)
            snap = sweeps.snapshot()
            timings.update({"oocore_sweep": snap["wall_s"],
                            "oocore_transfer": snap["transfer_s"],
                            "oocore_consume": snap["consume_s"],
                            "oocore_bytes": snap["bytes_to_device"],
                            "oocore_overlap_frac": snap["overlap_frac"]})
            if wm is not None and wm.supported:
                timings["oocore_peak_bytes"] = float(wm.peak_bytes - wm.before_bytes)
        elif placed is not None:
            logger.info(f"mesh solve over {params.mesh_shape}")
            models = list(distributed.train_placed(placed, cfg, initial_coefficients=initial))
            synchronize(device)
        else:
            models = list(train_glm(batch, cfg, initial_coefficients=initial))
            synchronize(device)
        timings["train"] = time.perf_counter() - t0
        for tm in models:
            logger.info(
                f"lambda={tm.reg_weight}: iters={tm.result.iterations} "
                f"value={float(tm.result.value):.6g} ({tm.seconds:.3f} s)"
            )
    tracker.advance(DriverStage.TRAINED)

    # ---- VALIDATE --------------------------------------------------------
    best = None
    best_index = None
    vbatch = None
    validation_metrics: List[Dict[str, float]] = []
    if params.validate_input:
        tracker.assert_at_least(DriverStage.TRAINED)
        with timed(logger, "validate"):
            t0 = time.perf_counter()
            vsource = IngestSource(
                expand_date_paths(params.validate_input, date_range),
                params.field_names,
            )
            vbatch, _vuids, _vpresent = vsource.labeled_batch(
                vocab, sparse=params.sparse, dtype=dtype, device=device)
            codecs["validate"] = vsource.codec
            if params.hot_columns:
                vbatch = _hybridize(vbatch, params, logger)
            weights = vbatch.effective_weights()
            for tm in models:
                margins = tm.model.compute_margin(vbatch.features, vbatch.offsets)
                validation_metrics.append(
                    metrics_mod.evaluate(task, vbatch.labels, margins, weights)
                )
            best, _scores = select_best_model(models, vbatch)
            best_index = next(i for i, tm in enumerate(models) if tm is best)
            logger.info(
                f"best lambda={best.reg_weight} (model #{best_index}, "
                f"metrics={validation_metrics[best_index]})"
            )
            if params.validate_per_iteration and writer:
                _write_per_iteration_metrics(params, task, models, vbatch, logger)
            timings["validate"] = time.perf_counter() - t0
        tracker.advance(DriverStage.VALIDATED)

    # the margin sketch's scores: the shipped model's margins on its own
    # training rows (under a mesh from the shards, on every rank), after
    # which the shards are dropped. In-core only: the out-of-core design
    # holds no batch to score
    fp_margins = None
    if fingerprint is not None and fingerprint.rows > 0 and models and batch is not None:
        chosen = best if best is not None else models[0]
        fp_margins = (chosen.model.compute_margin(batch.features, batch.offsets)
                      if placed is None
                      else distributed.placed_margins(placed, chosen.model.coefficients.means))
    placed = None

    # ---- DIAGNOSE (``Driver.scala:424-474``) -----------------------------
    if params.diagnostics and writer:
        tracker.assert_at_least(DriverStage.VALIDATED)
        with timed(logger, "diagnose"):
            t0 = time.perf_counter()
            report = build_diagnostic_report(
                params_dict=dataclasses.asdict(params),
                models=models,
                validation_metrics=validation_metrics,
                # under a mesh the whole batch on rank 0's card, as the
                # JAX driver's diagnostics take the unsharded batch
                train_batch=batch if not params.mesh_shape else shard_rows(batch, 1, 0, device),
                validation_batch=vbatch,
                vocab=vocab,
                summary=summary,
                training_config=cfg,
                training_diagnostics=params.training_diagnostics,
            )
            report_path = os.path.join(params.output_dir, "model-diagnostic.html")
            with open(report_path, "w", encoding="utf-8") as f:
                f.write(render_html(report))
            timings["diagnose"] = time.perf_counter() - t0
            logger.info(f"wrote diagnostic report to {report_path}")
        tracker.advance(DriverStage.DIAGNOSED)

    # ---- OUTPUT (rank 0 of a mesh's world alone) --------------------------
    with timed(logger, "write models"):
        t0 = time.perf_counter()
        if writer and fingerprint is not None and fingerprint.rows > 0:
            # margin sketch: the shipped model's score distribution on its
            # own training rows, what the serving drift monitor compares
            # live scores against; copied to the host once
            if fp_margins is not None:
                fingerprint.observe_margins(
                    fp_margins.cpu().numpy(), batch.effective_weights().cpu().numpy()
                )
            fp_path = fingerprint.save(params.output_dir)
            logger.info(f"wrote quality fingerprint to {fp_path}")
        if writer:
            _write_outputs(params, task, models, best, validation_metrics, vocab)
        timings["write"] = time.perf_counter() - t0
    logger.close()

    return GLMTrainingRun(
        params=params,
        stages=tracker.history,
        vocab=vocab,
        models=models,
        best=best,
        best_index=best_index,
        validation_metrics=validation_metrics,
        num_training_rows=design.n if design is not None else int(batch.labels.shape[0]),
        num_features=len(vocab),
        summary=summary,
        device=str(device),
        timings=timings,
        codecs=codecs,
    )


def _write_outputs(params, task, models, best, validation_metrics, vocab) -> None:
    """The vocabulary, the models (their Avro and text files) and the
    validation metrics."""
    vocab.save(os.path.join(params.output_dir, "feature-index.txt"))
    if params.model_output_mode != "NONE":
        to_write = (
            [best]
            if params.model_output_mode == "BEST" and best is not None
            else models
        )
        mdir = os.path.join(params.output_dir, "models")
        os.makedirs(mdir, exist_ok=True)
        for i, tm in enumerate(to_write):
            stem = os.path.join(mdir, f"{i}_lambda_{tm.reg_weight:g}")
            save_glm_model(stem + ".avro", tm.model.coefficients, vocab, task)
            write_model_text(stem + ".txt", tm.model.coefficients.means, vocab)
        if best is not None:
            save_glm_model(
                os.path.join(params.output_dir, "best-model.avro"),
                best.model.coefficients, vocab, task,
            )
    if validation_metrics:
        with open(os.path.join(params.output_dir, "validation-metrics.json"), "w") as f:
            json.dump(
                {
                    f"{i}_lambda_{tm.reg_weight:g}": m
                    for i, (tm, m) in enumerate(zip(models, validation_metrics))
                },
                f,
                indent=2,
            )


def _mesh_place(params, batch, device) -> "distributed.Placement":
    """The mesh branch's placement (``photon_ml_tpu/cli/train.py:426-457``):
    this rank's rows of the host batch on its card ('data'), and with
    'feature' > 1 its rows of its column block."""
    n_data = params.mesh_shape.get("data", 1)
    n_feat = params.mesh_shape.get("feature", 1)
    if n_feat > 1:
        return distributed.place_feature_shard(
            batch, parallel.make_feature_mesh(n_data, n_feat), device)
    return distributed.place_rows(batch, parallel.make_mesh(n_data), device)


def _write_per_iteration_metrics(params, task, models, vbatch, logger) -> None:
    """ModelTracker snapshots -> per-iteration validation metrics
    (``Driver.scala:293-347``) in per-iteration-metrics.json."""
    per_iter: Dict[str, List[Dict[str, float]]] = {}
    weights = vbatch.effective_weights()
    for i, tm in enumerate(models):
        if tm.result.w_history is None:
            continue
        hist = tm.result.masked_history()[2]
        rows = []
        for it in range(hist.shape[0]):
            w_it = torch.from_numpy(np.ascontiguousarray(hist[it])).to(
                vbatch.labels.device
            )
            margins = matvec(vbatch.features, w_it) + vbatch.offsets
            m = metrics_mod.evaluate(task, vbatch.labels, margins, weights)
            rows.append(m)
            logger.info(f"lambda={tm.reg_weight} iteration={it}: {m}")
        per_iter[f"{i}_lambda_{tm.reg_weight:g}"] = rows
    with open(os.path.join(params.output_dir, "per-iteration-metrics.json"), "w") as f:
        json.dump(per_iter, f, indent=2)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.train",
        description="Train GLMs (logistic/linear/Poisson/smoothed-hinge) over "
        "a regularization path on a CUDA device.",
    )
    p.add_argument("--config", help="JSON file of GLMDriverParams")
    p.add_argument("--train-input", nargs="+")
    p.add_argument("--validate-input", nargs="+")
    p.add_argument("--output-dir")
    p.add_argument("--task")
    p.add_argument("--optimizer")
    p.add_argument("--reg-type")
    p.add_argument("--reg-weights", nargs="+", type=float)
    p.add_argument("--normalization")
    p.add_argument("--max-iters", type=int)
    p.add_argument("--tolerance", type=float)
    p.add_argument("--sparse", action="store_true", default=None)
    p.add_argument(
        "--streamed-ingest", action="store_true", default=None,
        help="assemble the dense dataset on the device through the ingest "
        "pipeline (parallel decode, a pinned staging ring, copies on a side "
        "stream; the host holds the ring, not the dataset)",
    )
    p.add_argument(
        "--out-of-core", action="store_true", default=None,
        help="out-of-core training: keep the dense design on the host in "
        "uniform chunks and stream them to the device at every objective "
        "pass (the exact full-dataset objective; TRON/LBFGS, normalization NONE)",
    )
    p.add_argument(
        "--ingest-chunk-mb", type=float, default=None,
        help="ingest pipeline: target decoded-chunk size in MB (file-group "
        "planning and the uniform staged row blocks; default 64)",
    )
    p.add_argument(
        "--decode-threads", type=int, default=None,
        help="ingest pipeline: concurrent decode workers (0 = auto)",
    )
    p.add_argument(
        "--prefetch-depth", type=int, default=None,
        help="ingest pipeline: chunks decode and staging may run ahead of the "
        "consumer; also sizes the staging ring (default 2)",
    )
    p.add_argument(
        "--stage-timeout-s", type=float, default=None,
        help="ingest pipeline watchdog: a decode/stage/transfer attempt stalled "
        "past this many seconds is abandoned and run again (default: off)",
    )
    p.add_argument(
        "--epoch-policy", choices=["fail", "skip"], default=None,
        help="what an exhausted ingest retry budget does to the epoch: fail "
        "(default) raises; skip logs and counts the lost group and goes on "
        "with fewer rows",
    )
    p.add_argument("--overwrite", action="store_true", default=None)
    p.add_argument("--diagnostics", action="store_true", default=None)
    p.add_argument("--training-diagnostics", action="store_true", default=None)
    p.add_argument("--profile", action="store_true", default=None,
                   help="a torch.profiler window over the train phase, written as a "
                   "Chrome trace under <output-dir>/profile")
    p.add_argument("--debug-nans", action="store_true", default=None,
                   help="raise FloatingPointError at the first op or kernel of the "
                   "train phase that produces a NaN (reads the device after every op)")
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
        help="a torch.profiler window over the WHOLE run, written here as a "
        "Chrome trace (--profile captures only the train phase)",
    )
    p.add_argument(
        "--hbm-every", type=float, default=None,
        help="seconds between device-memory counter-track samples while "
        "tracing (0 disables; nothing off CUDA)",
    )
    p.add_argument(
        "--flight-dir", default=None,
        help="crash flight recorder output directory: flight-<reason>"
        ".json dumps on preemption/crash (default: --trace-dir)",
    )
    p.add_argument(
        "--convergence-report", action="store_true", default=None,
        help="decode each solve's tapes (reason / rate / plateau / "
        "per-iteration curves) into convergence.* metrics + events and "
        "<output-dir>/convergence-report.json",
    )
    p.add_argument(
        "--no-quality-fingerprint", dest="quality_fingerprint",
        action="store_false", default=None,
        help="skip the train-data quality fingerprint (per-feature/"
        "label/margin sketches written to quality-fingerprint.json; "
        "the drift-detection baseline)",
    )
    p.add_argument(
        "--heartbeat-s", type=float, default=None,
        help="heartbeat interval in seconds (0 = off): feeds the "
        "pod.heartbeat.* liveness gauges and the collective watchdog's "
        "straggler attribution",
    )
    p.add_argument(
        "--collective-timeout-s", type=float, default=None,
        help="watchdog deadline on host collectives: a stalled exchange "
        "times out, retries with backoff, and names the straggler instead "
        "of wedging the world (default: no watchdog)",
    )
    p.add_argument(
        "--sharded-ckpt", action="store_true", default=None,
        help="per-process sharded checkpoint writes for any durability point "
        "this driver reaches (the GLM path has none: checked, writes nothing)",
    )
    p.add_argument(
        "--collective-mode", dest="collective_mode", choices=("fused", "overlap"),
        default=None,
        help="reduction schedule of feature-sharded mesh solves: 'overlap' "
        "(default) row-balances blocked sparse designs and reduces the margins "
        "in row chunks whose all-reduces fly while the next chunk computes; "
        "'fused' is one all-reduce a pass",
    )
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; under a mesh cuda:LOCAL_RANK)")
    return p


def main(argv=None) -> None:
    args = build_arg_parser().parse_args(argv)
    base = {}
    if args.config:
        with open(args.config) as f:
            base = json.load(f)
    for key, value in vars(args).items():
        if key not in ("config", "device") and value is not None:
            base[key] = value
    try:
        run_glm_training(base, device=args.device)
    except BaseException as e:
        import sys

        # a lost peer (a collective past its watchdog budget, a lost
        # heartbeat, a failed torch.distributed collective) means "restart
        # me", not "my code failed"
        if is_host_loss(e):
            print(f"host loss: {e} — exiting {HOST_LOSS_EXIT_CODE}", file=sys.stderr)
            sys.exit(HOST_LOSS_EXIT_CODE)
        raise


if __name__ == "__main__":
    main()
