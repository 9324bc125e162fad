"""Scoring driver: load a trained GLM or GAME model, score Avro data,
write ScoredItems (counterpart of ``photon_ml_tpu/cli/score.py``; the
reference's ``cli/game/scoring/Driver.scala:40-254``). Run as

    python -m photon_ml_tpu_torch.cli.score --config params.json

or programmatically via :func:`run_scoring`. It runs on the CUDA device
unless given another. A GLM with ``sparse``, and each GAME fixed effect on
a shard named in ``sparse_shards``, goes through the ``ell_matvec`` CUDA
kernel (one launch per fixed-effect coordinate per call).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.cli.config import (
    ScoringParams,
    load_params,
    prepare_output_dir,
    resolve_date_range,
)
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game.scoring import score_game_data
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.ingest import IngestSource
from photon_ml_tpu_torch.io.models import load_game_model_auto, load_glm_model
from photon_ml_tpu_torch.io.schemas import SCORING_RESULT_SCHEMA
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.ops import metrics as metrics_mod
from photon_ml_tpu_torch.ops.sparse import matvec
from photon_ml_tpu_torch.serving.engine import bucket_size, pad_game_data
from photon_ml_tpu_torch.utils.dates import expand_date_paths
from photon_ml_tpu_torch.utils.device import resolve_device, synchronize
from photon_ml_tpu_torch.utils.logging import PhotonLogger, timed


@dataclasses.dataclass
class ScoringRun:
    params: ScoringParams
    scores: np.ndarray
    labels: Optional[np.ndarray]
    metrics: Dict[str, float]
    output_path: str
    device: str
    # wall-clock seconds per phase: ingest (Avro read + design build; for
    # a GLM also the model load), load (GAME model), margins (device-
    # synchronised), write, evaluate
    timings: Dict[str, float]


def write_scored_items(
    out_path: str,
    scores: np.ndarray,
    uids: np.ndarray,
    labels: np.ndarray,
    label_present: np.ndarray,
) -> int:
    """ScoringResultAvro output through the Python codec. An empty-string
    uid is written as null, as the JAX package writes it."""
    write_avro_file(
        out_path,
        SCORING_RESULT_SCHEMA,
        [
            {
                "predictionScore": float(s),
                "uid": None if (u is None or u == "") else str(u),
                "label": float(l) if p else None,
                "metadataMap": None,
            }
            for s, u, l, p in zip(scores, uids, labels, label_present)
        ],
    )
    return len(scores)


def _glm_model_path(params: ScoringParams, logger: PhotonLogger) -> str:
    if params.model_path:
        if not os.path.exists(params.model_path):
            raise FileNotFoundError(
                f"model_path {params.model_path!r} does not exist"
            )
        return params.model_path
    model_path = os.path.join(params.model_dir, "best-model.avro")
    if os.path.exists(model_path):
        return model_path
    mdir = os.path.join(params.model_dir, "models")
    candidates = sorted(f for f in os.listdir(mdir) if f.endswith(".avro"))
    if len(candidates) != 1:
        raise FileNotFoundError(
            f"no best-model.avro in {params.model_dir} and "
            f"{len(candidates)} candidates in models/ — set model_path to "
            f"the .avro you want scored: {candidates}"
        )
    logger.warn(
        f"best-model.avro absent; using the only model in models/: "
        f"{candidates[0]}"
    )
    return os.path.join(mdir, candidates[0])


def _glm_margins(params, source, device, logger, timings):
    """-> (margins, labels, weights, uids, label_present, model task) of a
    GLM, the columns as tensors on ``device``."""
    t0 = time.perf_counter()
    vocab = FeatureVocabulary.load(os.path.join(params.model_dir, "feature-index.txt"))
    coefficients, model_task = load_glm_model(
        _glm_model_path(params, logger), vocab, device=device
    )
    batch, uids, label_present = source.labeled_batch(
        vocab, sparse=params.sparse, dtype=torch.float64,
        allow_null_labels=True, device=device,
    )
    synchronize(device)
    t1 = time.perf_counter()
    margins = matvec(batch.features, coefficients.means.to(torch.float64)) + batch.offsets
    synchronize(device)
    timings["ingest"] = t1 - t0
    timings["margins"] = time.perf_counter() - t1
    return (margins, batch.labels, batch.effective_weights(), uids, label_present,
            model_task)


def _game_margins(params, source, device, timings):
    """-> (margins, labels, weights, uids, label_present, None) of the GAME
    model directory: load the model (entity vocabularies merged per
    random-effect type), ingest the shards it names, pad to the
    power-of-two bucket (pad rows: zero features, entity -1) and score on
    ``device``, sliced back to the real rows."""
    t0 = time.perf_counter()
    model_params, shards, random_effects, shard_vocabs, re_vocabs = (
        load_game_model_auto(params.model_dir)
    )
    t1 = time.perf_counter()
    data, _, uids, label_present = source.game_data(
        shard_vocabs,
        sorted(re_vocabs),
        entity_vocabs=re_vocabs,
        allow_null_labels=True,
        sparse_shards=set(params.sparse_shards),
    )
    t2 = time.perf_counter()
    n = data.num_rows
    padded = pad_game_data(data, bucket_size(n))
    margins = score_game_data(
        model_params, shards, random_effects, padded, device=device
    ) + torch.from_numpy(padded.offsets).to(device)
    margins = margins[:n]
    synchronize(device)
    timings["load"] = t1 - t0
    timings["ingest"] = t2 - t1
    timings["margins"] = time.perf_counter() - t2
    columns = [torch.from_numpy(c).to(device) for c in (data.labels, data.weights)]
    return (margins, *columns, uids, label_present, None)


def run_scoring(params, device=None) -> ScoringRun:
    """Score ``params.input`` with the GLM or GAME model in
    ``params.model_dir``.

    ``device=None`` means CUDA, and raises when no card is present."""
    device = resolve_device(device)
    params = load_params(params, ScoringParams)
    params.validate()
    prepare_output_dir(params.output_dir, params.overwrite)
    logger = PhotonLogger(
        os.path.join(params.output_dir, "log-message.txt"), level=params.log_level
    )
    timings: Dict[str, float] = {}
    task = TaskType[params.task]
    source = IngestSource(
        expand_date_paths(params.input, resolve_date_range(params)),
        params.field_names,
    )
    logger.info(
        f"scoring records with {params.model_kind} model from "
        f"{params.model_dir} on {device}"
    )

    with timed(logger, "score"):
        if params.model_kind == "glm":
            out = _glm_margins(params, source, device, logger, timings)
        else:
            out = _game_margins(params, source, device, timings)
        margins, labels_t, weights_t, uids, label_present, model_task = out
        if model_task is not None:
            task = model_task
        scores = margins.cpu().numpy()
        labels = labels_t.cpu().numpy()

    # ---- write ScoredItems (``ScoredItem.scala`` / scoring Driver) -------
    t0 = time.perf_counter()
    out_path = os.path.join(params.output_dir, "scores", "part-00000.avro")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    has_labels = bool(label_present.any())
    n_out = write_scored_items(out_path, scores, uids, labels, label_present)
    timings["write"] = time.perf_counter() - t0
    logger.info(f"wrote {n_out} scored items to {out_path}")

    # ---- optional evaluation (Driver.scala:166-185) ----------------------
    eval_metrics: Dict[str, float] = {}
    if params.evaluate:
        if not has_labels:
            raise ValueError("evaluate=True but input records carry no labels")
        t0 = time.perf_counter()
        ev_labels, ev_margins, ev_weights = labels_t, margins, weights_t
        if not label_present.all():
            # unlabeled rows carry a coerced 0.0 label: drop them
            logger.warn(
                f"{int((~label_present).sum())} of {len(label_present)} records "
                "have no label; excluding them from evaluation"
            )
            keep = torch.from_numpy(label_present).to(device)
            ev_labels = ev_labels[keep]
            ev_margins = ev_margins[keep]
            ev_weights = ev_weights[keep]
        eval_metrics = metrics_mod.evaluate(task, ev_labels, ev_margins, ev_weights)
        timings["evaluate"] = time.perf_counter() - t0
        with open(os.path.join(params.output_dir, "metrics.json"), "w") as f:
            json.dump(eval_metrics, f, indent=2)
        logger.info(f"evaluation: {eval_metrics}")
    logger.close()

    return ScoringRun(
        params=params,
        scores=scores,
        labels=labels if has_labels else None,
        metrics=eval_metrics,
        output_path=out_path,
        device=str(device),
        timings=timings,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.score",
        description="Score data with a trained GLM or GAME model on a CUDA device.",
    )
    p.add_argument("--config", required=True, help="JSON ScoringParams")
    p.add_argument("--overwrite", action="store_true", default=None)
    p.add_argument(
        "--device", default=None, help="torch device (default: cuda)"
    )
    args = p.parse_args(argv)
    with open(args.config) as f:
        base = json.load(f)
    if args.overwrite is not None:
        base["overwrite"] = args.overwrite
    run_scoring(base, device=args.device)


if __name__ == "__main__":
    main()
