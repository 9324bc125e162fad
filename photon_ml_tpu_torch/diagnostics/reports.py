"""Logical diagnostic report structures (counterpart of
``photon_ml_tpu/diagnostics/reports.py``).

Rebuild of ``diagnostics/reporting/reports/{combined,model,system}/*.scala``:
the reference separates logical reports (what was measured) from physical
reports (sections/tables/plots) from rendering (HTML/text). Python needs no
three-layer class hierarchy — the logical layer is these dataclasses and
the physical+render layers collapse into :mod:`photon_ml_tpu_torch.diagnostics.html`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from photon_ml_tpu_torch.diagnostics.bootstrap_diag import BootstrapDiagnosticReport
from photon_ml_tpu_torch.diagnostics.fitting import FittingReport
from photon_ml_tpu_torch.diagnostics.hl import HosmerLemeshowReport
from photon_ml_tpu_torch.diagnostics.importance import FeatureImportanceReport
from photon_ml_tpu_torch.diagnostics.independence import (
    PredictionErrorIndependenceReport,
)


@dataclasses.dataclass
class SystemReport:
    """``reports/system/SystemReport.scala``: driver params + the feature
    summary, common to every model in the run."""

    params: Dict[str, object]
    num_features: int
    summary_table: Optional[Dict[str, List[float]]] = None
    feature_names: Optional[List[str]] = None


@dataclasses.dataclass
class ModelDiagnosticReport:
    """``reports/model/ModelDiagnosticReport.scala``: everything measured
    about one (lambda, model)."""

    model_description: str
    reg_weight: float
    metrics: Dict[str, float]
    prediction_error_independence: Optional[
        PredictionErrorIndependenceReport
    ] = None
    hosmer_lemeshow: Optional[HosmerLemeshowReport] = None
    mean_impact_importance: Optional[FeatureImportanceReport] = None
    variance_impact_importance: Optional[FeatureImportanceReport] = None
    fit_report: Optional[FittingReport] = None
    bootstrap_report: Optional[BootstrapDiagnosticReport] = None


@dataclasses.dataclass
class DiagnosticReport:
    """``reports/combined/DiagnosticReport.scala``."""

    system: SystemReport
    models: List[ModelDiagnosticReport] = dataclasses.field(
        default_factory=list
    )
