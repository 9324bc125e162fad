"""GLM model persistence, wire-compatible with the reference and with
``photon_ml_tpu/io/models.py`` (its GLM half): one BayesianLinearModelAvro
record holding means and optional variances as (name, term, value) triples
(``avro/AvroUtils.scala:53-225``). A model saved by either package loads in
the other. The GAME directory layout is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import Coefficients
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_SCHEMA
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary

# reference loss-function class names (BayesianLinearModelAvro.lossFunction)
_LOSS_CLASS = {
    TaskType.LOGISTIC_REGRESSION: "com.linkedin.photon.ml.function.LogisticLossFunction",
    TaskType.LINEAR_REGRESSION: "com.linkedin.photon.ml.function.SquaredLossFunction",
    TaskType.POISSON_REGRESSION: "com.linkedin.photon.ml.function.PoissonLossFunction",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: "com.linkedin.photon.ml.function.SmoothedHingeLossFunction",
}
_CLASS_LOSS = {v: k for k, v in _LOSS_CLASS.items()}


def _coefficients_to_record(
    model_id: str,
    means: np.ndarray,
    variances: Optional[np.ndarray],
    vocab: FeatureVocabulary,
    task: Optional[TaskType],
    sparsify: bool = True,
) -> dict:
    def triples(vec):
        out = []
        for i, v in enumerate(vec):
            if sparsify and v == 0.0 and i != vocab.intercept_index:
                continue
            name, term = vocab.name_term(i)
            out.append({"name": name, "term": term, "value": float(v)})
        return out

    return {
        "modelId": model_id,
        "means": triples(means),
        "variances": None if variances is None else triples(variances),
        "lossFunction": _LOSS_CLASS.get(task) if task else None,
    }


def _record_to_coefficients(
    rec: dict, vocab: FeatureVocabulary
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    d = len(vocab)
    means = np.zeros(d)
    for t in rec["means"]:
        idx = vocab.get(t["name"], t["term"])
        if idx is not None:
            means[idx] = t["value"]
    variances = None
    if rec.get("variances"):
        variances = np.zeros(d)
        for t in rec["variances"]:
            idx = vocab.get(t["name"], t["term"])
            if idx is not None:
                variances[idx] = t["value"]
    return means, variances


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def save_glm_model(
    path: str,
    coefficients: Coefficients,
    vocab: FeatureVocabulary,
    task: Optional[TaskType] = None,
    model_id: str = "",
):
    variances = (
        None if coefficients.variances is None else _host_numpy(coefficients.variances)
    )
    write_avro_file(
        path,
        BAYESIAN_LINEAR_MODEL_SCHEMA,
        [
            _coefficients_to_record(
                model_id, _host_numpy(coefficients.means), variances, vocab, task
            )
        ],
    )


def load_glm_model(
    path: str, vocab: FeatureVocabulary, device="cpu"
) -> Tuple[Coefficients, Optional[TaskType]]:
    """-> (float64 Coefficients on ``device``, task named by the file)."""
    _, records = read_avro_file(path)
    if len(records) != 1:
        raise ValueError(f"{path}: expected 1 model record, got {len(records)}")
    means, variances = _record_to_coefficients(records[0], vocab)
    task = _CLASS_LOSS.get(records[0].get("lossFunction"))
    device = torch.device(device)
    return (
        Coefficients(
            means=torch.from_numpy(means).to(device),
            variances=None if variances is None else torch.from_numpy(variances).to(device),
        ),
        task,
    )
