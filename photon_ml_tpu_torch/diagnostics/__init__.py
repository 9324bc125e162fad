"""Model diagnostics (counterpart of ``photon_ml_tpu/diagnostics``; the
reference's ``diagnostics/**``): Hosmer–Lemeshow calibration, Kendall-tau
prediction/error independence, expected-magnitude and variance feature
importances, cumulative-portion learning curves with warm starts,
bootstrap intervals, and the HTML diagnostic report. Everything but the
refits works on numpy copies of margins, means and coefficients.
"""

from photon_ml_tpu_torch.diagnostics.bootstrap_diag import (
    BootstrapDiagnosticReport,
    bootstrap_diagnostic,
)
from photon_ml_tpu_torch.diagnostics.fitting import FittingReport, fitting_diagnostic
from photon_ml_tpu_torch.diagnostics.hl import HosmerLemeshowReport, hosmer_lemeshow
from photon_ml_tpu_torch.diagnostics.html import render_html
from photon_ml_tpu_torch.diagnostics.importance import (
    FeatureImportanceReport,
    feature_importance,
)
from photon_ml_tpu_torch.diagnostics.independence import (
    KendallTauReport,
    PredictionErrorIndependenceReport,
    kendall_tau,
    prediction_error_independence,
)
from photon_ml_tpu_torch.diagnostics.reports import (
    DiagnosticReport,
    ModelDiagnosticReport,
    SystemReport,
)

__all__ = [
    "HosmerLemeshowReport",
    "hosmer_lemeshow",
    "FeatureImportanceReport",
    "feature_importance",
    "KendallTauReport",
    "PredictionErrorIndependenceReport",
    "kendall_tau",
    "prediction_error_independence",
    "FittingReport",
    "fitting_diagnostic",
    "BootstrapDiagnosticReport",
    "bootstrap_diagnostic",
    "DiagnosticReport",
    "ModelDiagnosticReport",
    "SystemReport",
    "render_html",
]
