"""A fixture for the observability tests of the port: every process-wide
object the observe envelope installs (the tracer, the metrics registry,
the flight recorder and its ``sys.excepthook``, the convergence tracker,
the process identity, the cost book, the kernels' NaN output check), in
both packages, is put back after each test, so that the files that run
after it in the same xdist worker see a clean process. Each test starts
with a fresh registry in each package.

Use it with ``from torch_obs_hygiene import clean_obs`` and
``pytestmark = pytest.mark.usefixtures("clean_obs")``.
"""

import importlib
import sys

import pytest


def _state(pkg: str) -> dict:
    trace = importlib.import_module(f"{pkg}.obs.trace")
    metrics = importlib.import_module(f"{pkg}.obs.metrics")
    flight = importlib.import_module(f"{pkg}.obs.flight")
    conv = importlib.import_module(f"{pkg}.obs.convergence")
    dist = importlib.import_module(f"{pkg}.obs.dist")
    cost = importlib.import_module(f"{pkg}.obs.cost" if pkg.endswith("_torch")
                                   else f"{pkg}.obs.xla_cost")
    return {"trace": trace, "metrics": metrics, "flight": flight, "conv": conv,
            "dist": dist, "cost": cost}


@pytest.fixture
def clean_obs():
    from photon_ml_tpu_torch.kernels import dispatch

    saved = []
    for pkg in ("photon_ml_tpu", "photon_ml_tpu_torch"):
        m = _state(pkg)
        saved.append((m, {
            "tracer": m["trace"].get_tracer(),
            "registry": m["metrics"].set_registry(m["metrics"].MetricsRegistry()),
            "recorder": m["flight"]._recorder,
            "prev_hook": m["flight"]._prev_excepthook,
            "tracker": m["conv"]._tracker,
            "identity": m["dist"]._identity,
            "book": m["cost"].set_cost_book(m["cost"].CostBook()),
        }))
    hook = sys.excepthook
    check = dispatch.set_output_check(False)
    try:
        yield
    finally:
        dispatch.set_output_check(check)
        sys.excepthook = hook
        for m, s in saved:
            m["trace"].set_tracer(s["tracer"])
            m["metrics"].set_registry(s["registry"])
            m["flight"]._recorder = s["recorder"]
            m["flight"]._prev_excepthook = s["prev_hook"]
            m["conv"]._tracker = s["tracker"]
            m["dist"]._identity = s["identity"]
            m["cost"].set_cost_book(s["book"])
