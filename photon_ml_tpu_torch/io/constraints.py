"""Coefficient box-constraint JSON, with wildcard rules (counterpart of
``photon_ml_tpu/io/constraints.py``; the reference's
``io/GLMSuite.createConstraintMap``, ``GLMSuite.scala:202-281``).

The constraint file is a JSON array of
``{"name": ..., "term": ..., "lowerBound": x, "upperBound": y}`` entries
(bounds optional; a missing side is unbounded). Wildcards:

  - ``term == "*"``: the bound applies to every feature with that name;
  - ``name == "*" and term == "*"``: the bound applies to every feature not
    covered by a more specific entry (any other ``*`` name is refused, as
    in the reference);
  - the intercept is never constrained.

Exact (name, term) entries override name wildcards, which override the
global wildcard. The result is the per-index (lower, upper) pair of (d,)
float64 arrays the solvers clip against
(``OptimizationUtils.projectCoefficientsToHypercube``).
"""

from __future__ import annotations

import json
import math
from typing import List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.io.vocab import FeatureVocabulary

WILDCARD = "*"


def parse_constraint_string(text: str) -> List[dict]:
    """Parse and validate the JSON constraint array."""
    data = json.loads(text)
    if not isinstance(data, list):
        raise ValueError("constraint JSON must be an array of objects")
    out = []
    for entry in data:
        if not isinstance(entry, dict) or "name" not in entry:
            raise ValueError(f"bad constraint entry: {entry!r}")
        name = entry["name"]
        term = entry.get("term", "")
        if name == WILDCARD and term != WILDCARD:
            raise ValueError(
                f"a wildcard name requires a wildcard term: {entry!r} "
                "(reference GLMSuite.scala:202-281)"
            )
        lb = entry.get("lowerBound")
        ub = entry.get("upperBound")
        lb = -math.inf if lb is None else float(lb)
        ub = math.inf if ub is None else float(ub)
        if lb > ub:
            raise ValueError(f"lowerBound > upperBound in {entry!r}")
        out.append({"name": name, "term": term, "lower": lb, "upper": ub})
    return out


def constraint_bounds(
    entries: List[dict], vocab: FeatureVocabulary
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Parsed entries applied to a vocabulary -> (lower, upper) (d,) arrays,
    or (None, None) when nothing is constrained."""
    if not entries:
        return None, None
    d = len(vocab)
    lower = np.full(d, -np.inf)
    upper = np.full(d, np.inf)
    icpt = vocab.intercept_index
    # name wildcards look their columns up once
    names = None
    if any(e["term"] == WILDCARD and e["name"] != WILDCARD for e in entries):
        names = [vocab.name_term(i)[0] for i in range(d)]

    # precedence: the global wildcard, then name wildcards, then exact entries
    for tier in ("global", "name", "exact"):
        for e in entries:
            is_global = e["name"] == WILDCARD and e["term"] == WILDCARD
            is_name_wild = e["term"] == WILDCARD and not is_global
            if (
                (tier == "global" and not is_global)
                or (tier == "name" and not is_name_wild)
                or (tier == "exact" and (is_global or is_name_wild))
            ):
                continue
            if is_global:
                idxs = range(d)
            elif is_name_wild:
                idxs = [i for i in range(d) if names[i] == e["name"]]
            else:
                j = vocab.get(e["name"], e["term"])
                idxs = [] if j is None else [j]
            for i in idxs:
                if i == icpt:
                    continue
                lower[i] = e["lower"]
                upper[i] = e["upper"]
    if icpt is not None:
        lower[icpt] = -np.inf
        upper[icpt] = np.inf
    if not np.isfinite(lower).any() and not np.isfinite(upper).any():
        return None, None  # nothing constrained anything
    return lower, upper


def load_constraint_bounds(
    path: str, vocab: FeatureVocabulary
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    with open(path, encoding="utf-8") as f:
        return constraint_bounds(parse_constraint_string(f.read()), vocab)
