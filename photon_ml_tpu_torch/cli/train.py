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
column-sorted reduce on the card) and the validation margins through
``ell_matvec``.
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
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.models.selection import select_best_model
from photon_ml_tpu_torch.models.training import TrainedModel, train_glm
from photon_ml_tpu_torch.ops import metrics as metrics_mod
from photon_ml_tpu_torch.ops.sparse import matvec
from photon_ml_tpu_torch.ops.stats import summarize_features
from photon_ml_tpu_torch.utils.dates import expand_date_paths
from photon_ml_tpu_torch.utils.device import resolve_device, synchronize
from photon_ml_tpu_torch.utils.logging import PhotonLogger, timed


def driver_dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def write_model_text(path: str, means, vocab: FeatureVocabulary) -> None:
    """Plain-text model (``GLMSuite.scala:355-400``): one
    "name\\tterm\\tvalue" line per nonzero coefficient, the intercept
    always."""
    values = means.detach().cpu().tolist() if torch.is_tensor(means) else list(means)
    icpt = vocab.intercept_index
    with open(path, "w", encoding="utf-8") as f:
        for i, v in enumerate(values):
            if v == 0.0 and i != icpt:
                continue
            name, term = vocab.name_term(i)
            f.write(f"{name}\t{term}\t{float(v)}\n")


SUMMARY_COLUMNS = ("mean", "variance", "min", "max", "norm_l1", "norm_l2",
                   "mean_abs", "num_nonzeros")


def write_feature_summary(path: str, summary, vocab: FeatureVocabulary) -> None:
    """Per-feature summary TSV, the JAX driver's layout (one line per
    feature; each value as ``str(float(v))``)."""
    columns = [
        getattr(summary, c).detach().to("cpu", torch.float64).tolist()
        for c in SUMMARY_COLUMNS
    ]
    with open(path, "w", encoding="utf-8") as f:
        f.write("name\tterm\t" + "\t".join(SUMMARY_COLUMNS) + "\n")
        for i, row in enumerate(zip(*columns)):
            name, term = vocab.name_term(i)
            f.write(f"{name}\t{term}\t" + "\t".join(map(str, row)) + "\n")


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
    # to the device), validate_data, summary (device, synchronised),
    # summary_write (feature-summary.tsv), train (every solve), validate
    # (validation ingest + margins + metrics), diagnose (the diagnostic
    # report, with diagnostics), write (models, texts, vocabulary,
    # metrics); each solve's own seconds are on its model
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
    return _run_glm_training(params, device)


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
            vocab = FeatureVocabulary.from_records(
                source.records(), add_intercept=params.add_intercept
            )
        logger.info(f"feature space: {len(vocab)} columns "
                    f"(intercept={vocab.intercept_index})")
        batch, _uids, _present = source.labeled_batch(
            vocab, sparse=params.sparse, dtype=dtype, device=device
        )
        synchronize(device)
        timings["ingest"] = time.perf_counter() - t0
        codecs = {"ingest": source.codec}
        logger.info(f"read {batch.labels.shape[0]} training records ({source.codec} codec)")

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
