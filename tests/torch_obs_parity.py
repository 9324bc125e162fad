"""Comparisons the observability parity tests share: a traced driver run of
the port against the JAX driver's on the same fixture (span names and
counts in ``trace.json``, the deterministic counters of ``metrics.json``,
``convergence-report.json`` within 1e-10, the files written).

Names that differ between the packages by design, each with its reason:

- ``xla.compile`` (JAX only): ``jax.monitoring``'s backend compiles; the
  port compiles no programs at run time.
- ``kernels.launch_plan`` (port only): a kernel wrapper's new launch plan
  (``obs.build_events``), which stands where the JAX package counts
  compiles.
- ``xla.cost_record`` / ``kernels.cost_record``: the cost book's record,
  from XLA's cost analysis in JAX and from the kernels' analytic costs in
  the port (one record per design shape in both).
- counters ``xla.compiles`` (JAX) and ``kernels.launch_plans`` (port):
  the two build counters.
"""

import json
import os
from collections import Counter

import numpy as np

JAX_ONLY_NAMES = {"xla.compile", "xla.cost_record"}
PORT_ONLY_NAMES = {"kernels.launch_plan", "kernels.cost_record"}
JAX_ONLY_COUNTERS = {"xla.compiles"}
PORT_ONLY_COUNTERS = {"kernels.launch_plans"}


def close(got, want, what):
    """Floats within 1e-10 relative (1e-12 absolute); a ``rate`` estimate
    (a geometric mean of ratios of gradient norms at rounding noise at the
    end of a solve) within 1e-6 relative."""
    rtol = 1e-6 if what.endswith(".rate") else 1e-10
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=rtol, atol=1e-12, err_msg=what)


def assert_same_report(got, want, what: str = "report") -> None:
    """Two convergence documents (a ``ConvergenceReport.to_dict()`` or a
    tracker report): equal keys, equal strings and integers, floats within
    the :func:`close` tolerances."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
        for k in want:
            assert_same_report(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        if want and all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in want):
            close(got, want, what)
        else:
            for i, (g, w) in enumerate(zip(got, want)):
                assert_same_report(g, w, f"{what}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        if np.isnan(want):
            assert np.isnan(got), what
        else:
            close(got, want, what)
    else:
        assert got == want, (what, got, want)


def span_counts(trace_dir: str) -> Counter:
    """(name, phase) -> count of a ``trace.json``'s events, metadata and
    the names that differ by design aside."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        doc = json.load(f)
    return Counter((e["name"], e["ph"]) for e in doc["traceEvents"]
                   if e["ph"] != "M" and e["name"] not in JAX_ONLY_NAMES | PORT_ONLY_NAMES)


def assert_same_spans(port_dir: str, jax_dir: str) -> Counter:
    got, want = span_counts(port_dir), span_counts(jax_dir)
    assert got == want, (sorted((got - want).items()), sorted((want - got).items()))
    return got


def counters(path: str) -> dict:
    with open(path) as f:
        return json.load(f)["counters"]


def assert_same_counters(port_path: str, jax_path: str) -> dict:
    """The deterministic counters of two ``metrics.json``: every counter
    equal, the build counters aside."""
    got = {k: v for k, v in counters(port_path).items() if k not in PORT_ONLY_COUNTERS}
    want = {k: v for k, v in counters(jax_path).items() if k not in JAX_ONLY_COUNTERS}
    assert got == want
    return got


def assert_same_report_files(port_path: str, jax_path: str) -> dict:
    docs = []
    for p in (port_path, jax_path):
        with open(p) as f:
            docs.append(json.load(f))
    assert_same_report(*docs, "convergence-report")
    return docs[0]


def files_under(root: str, collapse=("profile",)) -> list:
    """The files under ``root``, each directory of ``collapse`` (a profile,
    whose format differs by design: an xplane in JAX, a Chrome trace in
    the port) as one entry."""
    out = set()
    for d, _, files in os.walk(root):
        rel = os.path.relpath(d, root)
        top = rel.split(os.sep)[0]
        if top in collapse:
            out.add(top + "/")
            continue
        out.update(os.path.normpath(os.path.join(rel, f)) for f in files)
    return sorted(out)
