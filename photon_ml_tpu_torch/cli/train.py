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
``quality-fingerprint.json`` stores.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

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
from photon_ml_tpu_torch.io.schemas import NAME_TERM_DELIMITER
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.models.selection import select_best_model
from photon_ml_tpu_torch.models.training import TrainedModel, train_glm
from photon_ml_tpu_torch.obs import quality as quality_mod
from photon_ml_tpu_torch.ops import metrics as metrics_mod
from photon_ml_tpu_torch.ops.sparse import matvec, stored_cold_entries, to_hybrid
from photon_ml_tpu_torch.ops.stats import summarize_features
from photon_ml_tpu_torch.utils.dates import expand_date_paths
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
    # each solve's own seconds are on its model
    timings: Dict[str, float]
    # the Avro codec of each read: {"ingest": ..., "validate": ...}, each
    # "native" (the C++ codec) or "python"
    codecs: Dict[str, str]


def run_glm_training(params, device=None) -> GLMTrainingRun:
    """Train the GLM path described by ``params`` (a GLMDriverParams, a
    dict or a JSON path). ``device=None`` means CUDA, and raises when no
    card is present."""
    device = resolve_device(device)
    params = load_params(params, GLMDriverParams)
    params.validate()
    prepare_output_dir(params.output_dir, params.overwrite)
    try:
        return _run_glm_training(params, device)
    finally:
        if params.quality_fingerprint:
            # normally uninstalled right after the training ingest; this
            # covers an ingest that raised, so no collector leaks into the
            # next run in this process
            quality_mod.uninstall_fingerprint_collector()


def _run_glm_training(params: GLMDriverParams, device: torch.device) -> GLMTrainingRun:
    tracker = StageTracker()
    logger = PhotonLogger(
        os.path.join(params.output_dir, "log-message.txt"), level=params.log_level
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
        batch, _uids, _present = source.labeled_batch(
            vocab, sparse=params.sparse, dtype=dtype, device=device
        )
        synchronize(device)
        timings["ingest"] = time.perf_counter() - t0
        codecs = {"ingest": source.codec}
        logger.info(f"read {batch.labels.shape[0]} training records ({source.codec} codec)")
        if params.hot_columns:
            t0 = time.perf_counter()
            batch = _hybridize(batch, params, logger)
            synchronize(device)
            timings["hybridize"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sanity_check_data(batch, task, DataValidationType[params.data_validation])
        timings["validate_data"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        summary = summarize_features(batch)
        synchronize(device)
        timings["summary"] = time.perf_counter() - t0
        t0 = time.perf_counter()
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
    with timed(logger, "train"):
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
            if params.validate_per_iteration:
                _write_per_iteration_metrics(params, task, models, vbatch, logger)
            timings["validate"] = time.perf_counter() - t0
        tracker.advance(DriverStage.VALIDATED)

    # ---- DIAGNOSE (``Driver.scala:424-474``) -----------------------------
    if params.diagnostics:
        tracker.assert_at_least(DriverStage.VALIDATED)
        with timed(logger, "diagnose"):
            t0 = time.perf_counter()
            report = build_diagnostic_report(
                params_dict=dataclasses.asdict(params),
                models=models,
                validation_metrics=validation_metrics,
                train_batch=batch,
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

    # ---- OUTPUT ----------------------------------------------------------
    with timed(logger, "write models"):
        t0 = time.perf_counter()
        if fingerprint is not None and fingerprint.rows > 0:
            # margin sketch: the shipped model's score distribution on its
            # own training rows, what the serving drift monitor compares
            # live scores against; one margin pass, copied to the host once
            if models:
                chosen = best if best is not None else models[0]
                margins = chosen.model.compute_margin(batch.features, batch.offsets)
                fingerprint.observe_margins(
                    margins.cpu().numpy(), batch.effective_weights().cpu().numpy()
                )
            fp_path = fingerprint.save(params.output_dir)
            logger.info(f"wrote quality fingerprint to {fp_path}")
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
            with open(
                os.path.join(params.output_dir, "validation-metrics.json"), "w"
            ) as f:
                json.dump(
                    {
                        f"{i}_lambda_{tm.reg_weight:g}": m
                        for i, (tm, m) in enumerate(zip(models, validation_metrics))
                    },
                    f,
                    indent=2,
                )
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
        num_training_rows=int(batch.labels.shape[0]),
        num_features=len(vocab),
        summary=summary,
        device=str(device),
        timings=timings,
        codecs=codecs,
    )


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
    p.add_argument("--overwrite", action="store_true", default=None)
    p.add_argument("--diagnostics", action="store_true", default=None)
    p.add_argument("--training-diagnostics", action="store_true", default=None)
    p.add_argument(
        "--no-quality-fingerprint", dest="quality_fingerprint",
        action="store_false", default=None,
        help="skip the train-data quality fingerprint (per-feature/"
        "label/margin sketches written to quality-fingerprint.json; "
        "the drift-detection baseline)",
    )
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
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
    run_glm_training(base, device=args.device)


if __name__ == "__main__":
    main()
