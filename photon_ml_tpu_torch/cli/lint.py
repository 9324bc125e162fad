"""photon-lint for the port: the build-time gate over the repo's runtime
bug classes, run over ``photon_ml_tpu_torch/`` (counterpart of
``photon_ml_tpu/cli/lint.py``; the rules are ``photon_ml_tpu_torch.analysis``'s).

    # gate the tree (exit 1 on findings not in the committed baseline)
    python -m photon_ml_tpu_torch.cli.lint check photon_ml_tpu_torch/

    # machine-readable output (CI annotations, dashboards)
    python -m photon_ml_tpu_torch.cli.lint check photon_ml_tpu_torch/ --json

    # why does a rule exist, and how do I fix/suppress it
    python -m photon_ml_tpu_torch.cli.lint explain PL001

    # re-grandfather the current findings (ratchet reset — PL001/PL002/
    # PL003/PL008 are refused by policy and must be fixed instead)
    python -m photon_ml_tpu_torch.cli.lint baseline photon_ml_tpu_torch/

    # drop baseline entries whose finding no longer exists (fixed or
    # deleted code) WITHOUT grandfathering anything new
    python -m photon_ml_tpu_torch.cli.lint baseline photon_ml_tpu_torch/ --prune

Suppression is inline and must carry a reason::

    faults.fire(site)  # photon-lint: disable=PL003 site validated above

A reasonless ``disable=`` is inert: the finding still reports, plus a
note that the comment suppresses nothing. Exit codes: 0 clean (or all
findings baselined), 1 new findings, 2 usage/config errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

DEFAULT_TARGET = "photon_ml_tpu_torch"


def _make_analyzer(base: str):
    from photon_ml_tpu_torch.analysis import Analyzer

    return Analyzer(base=base)


def _base_for(paths: List[str]) -> str:
    """The directory finding paths are made relative to. For the
    common one-directory invocation the base is that directory's
    PARENT, so `photon-lint check /anywhere/repo/photon_ml_tpu_torch` yields
    the same `photon_ml_tpu_torch/...` paths the committed baseline stores no
    matter where it runs from; multi-path runs fall back to the cwd
    (run those from the repo root)."""
    if len(paths) == 1 and os.path.isdir(paths[0]):
        return os.path.dirname(os.path.abspath(paths[0]))
    return os.getcwd()


def _paths(args) -> List[str]:
    paths = args.paths or [DEFAULT_TARGET]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(
            f"photon-lint: no such path: {', '.join(missing)}",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return paths


def _cmd_check(args) -> int:
    from photon_ml_tpu_torch.analysis import Baseline, default_baseline_path

    paths = _paths(args)
    analyzer = _make_analyzer(base=_base_for(paths))
    result = analyzer.run(paths)
    baseline_path = args.baseline or default_baseline_path()
    baseline = (
        Baseline() if args.no_baseline else Baseline.load(baseline_path)
    )
    new, grandfathered, stale = baseline.split(result.findings)

    if args.json:
        print(
            json.dumps(
                {
                    "files": result.files,
                    "wall_s": round(result.wall_s, 4),
                    "findings_total": len(result.findings),
                    "new": [f.to_json() for f in new],
                    "grandfathered": len(grandfathered),
                    "stale_baseline_entries": [
                        e.to_json() for e in stale
                    ],
                    "suppressed": result.suppressed,
                    "bare_suppressions": [
                        {"path": p, "line": ln}
                        for p, ln in result.bare_suppressions
                    ],
                },
                indent=2,
            )
        )
    else:
        for f in new:
            print(f.render())
        for path, line in result.bare_suppressions:
            print(
                f"{path}:{line}: note: photon-lint disable comment has "
                "no reason — it suppresses nothing (syntax: "
                "# photon-lint: disable=PLxxx <reason>)"
            )
        if stale:
            print(
                f"note: {len(stale)} stale baseline entr"
                f"{'y' if len(stale) == 1 else 'ies'} (finding fixed or "
                "code deleted) — run `photon-lint baseline --prune` "
                "to drop:"
            )
            for e in stale[:10]:
                print(f"    {e.rule} {e.path}:{e.line}  {e.text[:60]}")
        summary = (
            f"photon-lint: {result.files} files, "
            f"{len(result.findings)} findings "
            f"({len(new)} new, {len(grandfathered)} baselined, "
            f"{result.suppressed} suppressed) in {result.wall_s:.2f}s"
        )
        print(summary)
    return 1 if new else 0


def _cmd_baseline(args) -> int:
    from photon_ml_tpu_torch.analysis import (
        EMPTY_BASELINE_RULES,
        Baseline,
        default_baseline_path,
    )

    paths = _paths(args)
    analyzer = _make_analyzer(base=_base_for(paths))
    result = analyzer.run(paths)
    baseline_path = args.baseline or default_baseline_path()
    before = Baseline.load(baseline_path)
    if args.prune:
        updated = before.pruned(result.findings)
        action = "pruned"
    else:
        updated = Baseline.from_findings(result.findings)
        action = "regenerated"
        refused = [
            f
            for f in result.findings
            if f.rule in EMPTY_BASELINE_RULES
        ]
        if refused:
            print(
                f"photon-lint: REFUSING to grandfather "
                f"{len(refused)} PL001/PL002/PL003/PL008 findings — these "
                "classes ship with an empty baseline by policy "
                "(EMPTY_BASELINE_RULES); fix them:",
                file=sys.stderr,
            )
            for f in refused:
                print(f"    {f.render()}", file=sys.stderr)
            return 1
    updated.save(baseline_path)
    print(
        f"photon-lint: baseline {action}: "
        f"{len(before.entries)} -> {len(updated.entries)} entries "
        f"({baseline_path})"
    )
    return 0


def _cmd_explain(args) -> int:
    from photon_ml_tpu_torch.analysis import rule_catalog

    catalog = {r.id: r for r in rule_catalog()}
    ids = args.rules or sorted(catalog)
    unknown = [r for r in ids if r not in catalog]
    if unknown:
        print(
            f"photon-lint: unknown rule(s) {', '.join(unknown)}; "
            f"known: {', '.join(sorted(catalog))}",
            file=sys.stderr,
        )
        return 2
    for rid in ids:
        r = catalog[rid]
        print(f"{r.id} {r.name} [{r.severity}]")
        print(f"  origin: {r.origin}")
        print(f"  fix:    {r.hint}")
        print(
            f"  suppress: # photon-lint: disable={r.id} <reason> "
            "(reason required)"
        )
        print()
    return 0


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="photon-lint",
        description="torch.distributed-aware static analyzer gating this "
        "repo's historical runtime bug classes over the PyTorch/CUDA port "
        "at build time (photon-lint explain prints each rule).",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser(
        "check", help="lint paths; exit 1 on non-baselined findings"
    )
    pc.add_argument("paths", nargs="*", help=f"default: {DEFAULT_TARGET}/")
    pc.add_argument("--json", action="store_true", help="JSON report")
    pc.add_argument("--baseline", help="baseline file (default: the "
                    "committed photon_ml_tpu_torch/analysis/baseline.json)")
    pc.add_argument("--no-baseline", action="store_true",
                    help="report every finding as new (baseline ignored)")

    pb = sub.add_parser(
        "baseline", help="regenerate (or --prune) the ratchet baseline"
    )
    pb.add_argument("paths", nargs="*", help=f"default: {DEFAULT_TARGET}/")
    pb.add_argument("--baseline", help="baseline file to write")
    pb.add_argument(
        "--prune", action="store_true",
        help="only DROP stale entries (fixed/deleted findings); never "
        "grandfathers new ones",
    )

    pe = sub.add_parser(
        "explain", help="print a rule's origin story and fix guidance"
    )
    pe.add_argument("rules", nargs="*", help="rule ids (default: all)")

    args = p.parse_args(argv)
    rc = {
        "check": _cmd_check,
        "baseline": _cmd_baseline,
        "explain": _cmd_explain,
    }[args.cmd](args)
    if rc:
        sys.exit(rc)


if __name__ == "__main__":
    main()
