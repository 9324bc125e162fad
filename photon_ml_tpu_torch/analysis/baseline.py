"""The ratchet baseline: existing findings grandfathered, new ones fail
(counterpart of ``photon_ml_tpu/analysis/baseline.py``).

A static analyzer retrofitted onto a living tree faces a cold-start
problem: day one it reports every pre-existing occurrence, and "fix 40
findings before the gate turns on" means the gate never turns on. The
baseline solves it the way large-repo linters do — a committed JSON
file (``photon_ml_tpu_torch/analysis/baseline.json``) enumerating the
findings that existed when the rule shipped. ``photon-lint check``
fails only on findings NOT in the baseline, so the count can only
ratchet down:

- fixing a baselined finding makes its entry STALE (reported, and
  ``photon-lint baseline --prune`` deletes it so it cannot mask a
  future regression at the same spot);
- new code must be clean from its first commit.

Entries match by ``(rule, path, stripped source-line text)`` — not by
line number — so unrelated edits that shift lines don't resurrect
grandfathered findings, while EDITING the offending line (you were
there; fix it) un-grandfathers it. Duplicate texts in one file are
matched as a multiset: adding a second identical violation to a file
that had one baselined is still a new finding.

PL001/PL002/PL003/PL008 ship with ZERO baseline entries by policy:
those classes (collective divergence, by-name exception matching,
unknown fault sites, dropped span contexts) each caused a real hang or
masked-bug in this repo's history and are cheap to fix on contact;
``tests/test_torch_analysis.py`` enforces the policy for the port's
baseline, which holds only findings of the port's own tree.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Sequence, Tuple

from photon_ml_tpu_torch.analysis.core import Finding

__all__ = [
    "BaselineEntry",
    "Baseline",
    "default_baseline_path",
    "EMPTY_BASELINE_RULES",
]

# rules whose baseline must stay empty (enforced by tests and by
# `photon-lint baseline`, which refuses to grandfather them). PL008
# joins the policy from birth: the trace seam it guards shipped clean
# in the same PR, so there is nothing to grandfather — and a dropped
# span context is always cheap to fix on contact (forward one value).
EMPTY_BASELINE_RULES = ("PL001", "PL002", "PL003", "PL008")

VERSION = 1


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    line: int  # advisory (drifts); identity is (rule, path, text)
    text: str

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.text)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Baseline:
    """The committed grandfather list plus the matching logic."""

    def __init__(self, entries: Sequence[BaselineEntry] = ()):
        self.entries: List[BaselineEntry] = list(entries)

    # -- persistence ----------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "Baseline":
        """Missing file = empty baseline (a fresh tree is all-new). A
        corrupt file raises: silently linting against nothing would
        report every grandfathered finding as new and train people to
        ignore the gate."""
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except FileNotFoundError:
            return cls()
        if not isinstance(doc, dict) or "entries" not in doc:
            raise ValueError(
                f"baseline {path!r} is not a photon-lint baseline "
                "(expected an object with an 'entries' list)"
            )
        entries = [
            BaselineEntry(
                rule=str(e["rule"]),
                path=str(e["path"]),
                line=int(e.get("line", 0)),
                text=str(e.get("text", "")),
            )
            for e in doc["entries"]
        ]
        return cls(entries)

    def save(self, path: str) -> None:
        doc = {
            "version": VERSION,
            "entries": [
                e.to_json()
                for e in sorted(
                    self.entries, key=lambda e: (e.path, e.line, e.rule)
                )
            ],
        }
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)

    # -- matching -------------------------------------------------------

    def split(
        self, findings: Sequence[Finding]
    ) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
        """(new, grandfathered, stale_entries) for a finding set.

        Multiset semantics per (rule, path, text): N baseline entries
        absorb at most N identical findings."""
        budget: Dict[Tuple[str, str, str], int] = {}
        for e in self.entries:
            budget[e.key()] = budget.get(e.key(), 0) + 1
        new: List[Finding] = []
        old: List[Finding] = []
        for f in findings:
            key = (f.rule, f.path, f.text)
            if budget.get(key, 0) > 0:
                budget[key] -= 1
                old.append(f)
            else:
                new.append(f)
        stale: List[BaselineEntry] = []
        remaining = dict(budget)
        for e in self.entries:
            if remaining.get(e.key(), 0) > 0:
                remaining[e.key()] -= 1
                stale.append(e)
        return new, old, stale

    # -- updates --------------------------------------------------------

    @classmethod
    def from_findings(cls, findings: Sequence[Finding]) -> "Baseline":
        """A full regenerate — grandfather everything CURRENT except the
        empty-by-policy rules (those must be fixed, not baselined)."""
        return cls(
            [
                BaselineEntry(
                    rule=f.rule, path=f.path, line=f.line, text=f.text
                )
                for f in findings
                if f.rule not in EMPTY_BASELINE_RULES
            ]
        )

    def pruned(self, findings: Sequence[Finding]) -> "Baseline":
        """Drop stale entries (no matching current finding — the code
        was fixed or deleted) WITHOUT grandfathering anything new. Kept
        entries get their advisory line refreshed to the current match."""
        _, grandfathered, _ = self.split(findings)
        return Baseline(
            [
                BaselineEntry(
                    rule=f.rule, path=f.path, line=f.line, text=f.text
                )
                for f in grandfathered
            ]
        )
