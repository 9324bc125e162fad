"""Driver-side diagnostic orchestration (counterpart of
``photon_ml_tpu/diagnostics/driver.py``; the reference's
``Driver.diagnose()``, ``Driver.scala:424-474``, and its
``writeDiagnostics`` HTML, ``Driver.scala:549-569``): per trained model,
prediction-error independence, both feature importances and (logistic
models) Hosmer–Lemeshow on the VALIDATION data; with training diagnostics,
the learning-curve fitting diagnostic and bootstrap intervals over the
TRAINING data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.diagnostics.bootstrap_diag import bootstrap_diagnostic
from photon_ml_tpu_torch.diagnostics.fitting import fitting_diagnostic
from photon_ml_tpu_torch.diagnostics.hl import hosmer_lemeshow
from photon_ml_tpu_torch.diagnostics.importance import feature_importance
from photon_ml_tpu_torch.diagnostics.independence import prediction_error_independence
from photon_ml_tpu_torch.diagnostics.reports import (
    DiagnosticReport,
    ModelDiagnosticReport,
    SystemReport,
)
from photon_ml_tpu_torch.utils.device import to_numpy

# beyond this many features the per-feature summary table is left out of
# the report (the numbers stay in feature-summary.tsv)
MAX_SUMMARY_FEATURES = 200


def build_diagnostic_report(
    params_dict: Dict[str, object],
    models,  # Sequence[TrainedModel]
    validation_metrics: List[Dict[str, float]],
    train_batch,
    validation_batch,
    vocab,
    summary,
    training_config,
    training_diagnostics: bool = False,
    seed: int = 0,
) -> DiagnosticReport:
    """The full DiagnosticReport of a completed training run."""
    task: TaskType = training_config.task

    summary_table = None
    feature_names = None
    if summary is not None and len(vocab) <= MAX_SUMMARY_FEATURES:
        cols = ("mean", "variance", "min", "max", "mean_abs", "num_nonzeros")
        summary_table = {
            c: [float(v) for v in to_numpy(getattr(summary, c))] for c in cols
        }
        # "name / term" with thin spaces (U+2009) around the slash
        feature_names = ["{}\u2009/\u2009{}".format(*vocab.name_term(i))
                         for i in range(len(vocab))]

    report = DiagnosticReport(system=SystemReport(
        params=params_dict,
        num_features=len(vocab),
        summary_table=summary_table,
        feature_names=feature_names,
    ))

    fit_by_lambda = {}
    if training_diagnostics:
        fit_by_lambda = fitting_diagnostic(train_batch, training_config, seed=seed)

    vweights = to_numpy(validation_batch.effective_weights(), np.float64)
    vlabels = to_numpy(validation_batch.labels, np.float64)
    for i, tm in enumerate(models):
        means = to_numpy(
            tm.model.compute_mean(validation_batch.features, validation_batch.offsets),
            np.float64,
        )
        coef = to_numpy(tm.model.coefficients.means, np.float64)
        hl = None
        if task == TaskType.LOGISTIC_REGRESSION:
            hl = hosmer_lemeshow(vlabels, means, num_dimensions=len(vocab), weights=vweights)
        bootstrap = None
        if training_diagnostics:
            single = dataclasses.replace(training_config, reg_weights=(tm.reg_weight,))
            bootstrap = bootstrap_diagnostic(
                train_batch, single, coef, vocab, summary=summary,
                evaluation_batch=validation_batch, seed=seed,
            )
        report.models.append(ModelDiagnosticReport(
            model_description=f"{task.name} @ lambda = {tm.reg_weight:g}",
            reg_weight=tm.reg_weight,
            metrics=validation_metrics[i] if i < len(validation_metrics) else {},
            prediction_error_independence=prediction_error_independence(
                vlabels, means, weights=vweights, seed=seed
            ),
            hosmer_lemeshow=hl,
            mean_impact_importance=feature_importance(
                coef, vocab, summary, kind="EXPECTED_MAGNITUDE"
            ),
            variance_impact_importance=feature_importance(
                coef, vocab, summary, kind="VARIANCE"
            ),
            fit_report=fit_by_lambda.get(tm.reg_weight),
            bootstrap_report=bootstrap,
        ))
    return report
