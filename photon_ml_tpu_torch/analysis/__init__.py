"""photon-lint for the port: the static analyzer that gates this repo's
runtime bug classes over ``photon_ml_tpu_torch/`` (counterpart of
``photon_ml_tpu/analysis``, each rule in its torch form).

Each class the repo has ACTUALLY shipped is a build-time gate; the rules
that validate literals read the port's own tables (its fault registry,
its obs taxonomy, its native handle types), never the JAX package's:

====== ============================ =========================================
rule   name                         what it looks for in the port
====== ============================ =========================================
PL001  spmd-collective-divergence   a torch.distributed collective (or a
                                    parallel/mesh, parallel/multihost,
                                    pod-sync or sharded-checkpoint wrapper)
                                    in an except handler or under a branch
                                    on get_rank()/process_index()
PL002  exception-match-by-name      type(e).__name__ / str(e) matching
                                    instead of isinstance
PL003  unknown-fault-site           fire()/FaultSpec()/PHOTON_FAULTS
                                    literals outside the port's KNOWN_SITES
PL004  trace-unsafe-host-op         .item()/.tolist()/.cpu()/.numpy(),
                                    float()/int()/bool() of a tensor
                                    parameter, time.*, print, np.asarray
                                    inside a torch.cuda.graph capture, a
                                    make_graphed_callables or torch.compile
                                    function (one call level down too)
PL005  unmanaged-native-handle      NativeAvroReader / NativeVocabSet
                                    built without a static owner
PL006  obs-taxonomy                 span/metric names outside the port's
                                    obs.taxonomy
PL007  swallowed-retryable          broad swallows around OSError-shaped
                                    I/O that belongs on the retry seam
PL008  span-context-drop            a hand-off (thread, executor, task)
                                    that drops the request's trace id
====== ============================ =========================================

``photon-lint check`` (``python -m photon_ml_tpu_torch.cli.lint``) runs
the registry over a tree, subtracts the committed ratchet baseline
(``photon_ml_tpu_torch/analysis/baseline.json``), and exits 1 on anything
new; ``tests/test_torch_analysis.py::test_tree_is_clean`` runs it over
``photon_ml_tpu_torch/`` in tier-1.
"""

from __future__ import annotations

from typing import List

from photon_ml_tpu_torch.analysis.core import (
    AnalysisResult,
    Analyzer,
    Finding,
    ModuleContext,
    Rule,
    iter_py_files,
)
from photon_ml_tpu_torch.analysis.baseline import (
    EMPTY_BASELINE_RULES,
    Baseline,
    BaselineEntry,
    default_baseline_path,
)

__all__ = [
    "AnalysisResult",
    "Analyzer",
    "Finding",
    "ModuleContext",
    "Rule",
    "iter_py_files",
    "Baseline",
    "BaselineEntry",
    "EMPTY_BASELINE_RULES",
    "default_baseline_path",
    "default_rules",
    "rule_catalog",
]


def default_rules() -> List[Rule]:
    """Fresh instances of the full rule registry (rules carry per-run
    scan state, so every Analyzer gets its own)."""
    from photon_ml_tpu_torch.analysis.rules_errors import (
        ExceptionMatchByName,
        SwallowedRetryable,
    )
    from photon_ml_tpu_torch.analysis.rules_faults import UnknownFaultSiteRule
    from photon_ml_tpu_torch.analysis.rules_handles import UnmanagedNativeHandle
    from photon_ml_tpu_torch.analysis.rules_obs import ObsTaxonomyRule
    from photon_ml_tpu_torch.analysis.rules_reqtrace import SpanContextDrop
    from photon_ml_tpu_torch.analysis.rules_spmd import SpmdCollectiveDivergence
    from photon_ml_tpu_torch.analysis.rules_trace import TraceUnsafeHostOp

    return [
        SpmdCollectiveDivergence(),
        ExceptionMatchByName(),
        UnknownFaultSiteRule(),
        TraceUnsafeHostOp(),
        UnmanagedNativeHandle(),
        ObsTaxonomyRule(),
        SwallowedRetryable(),
        SpanContextDrop(),
    ]


def rule_catalog() -> List[Rule]:
    """The registry in id order (for ``photon-lint explain`` and docs)."""
    return sorted(default_rules(), key=lambda r: r.id)
