"""photon-lint core for the port: findings, rule registry, module
contexts, engine (counterpart of ``photon_ml_tpu/analysis/core.py``).

The analyzer is pure stdlib-``ast`` (no new dependencies, no imports of
the analyzed modules except the two registries it validates literals
against: the port's ``resilience.faults.registered_sites()`` and
``obs.taxonomy``). Each rule distills one bug class the repo shipped and
later caught at runtime or in review; ``photon-lint explain PLxxx``
prints its origin and its fix.

Mechanics:

- every analyzed file parses ONCE into a :class:`ModuleContext`
  (AST + parent links + suppression comments + per-scope indexes);
- rules run in two phases: ``scan`` (collect cross-file facts, e.g.
  ``register_site("...")`` literals for PL003) then ``check`` (emit
  :class:`Finding`\\ s);
- inline suppression is ``# photon-lint: disable=PLxxx <reason>`` on
  the finding's line — the reason is REQUIRED (a bare disable is
  ignored and reported, so "shut it up" always leaves a paper trail);
- the committed ratchet baseline (:mod:`.baseline`) grandfathers
  existing findings by (rule, path, source-line text) so line drift
  doesn't resurrect them; anything not in the baseline fails the build.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

__all__ = [
    "Finding",
    "Rule",
    "ModuleContext",
    "Analyzer",
    "AnalysisResult",
    "iter_py_files",
    "dotted_name",
    "call_name",
    "SUPPRESS_RE",
]

SEVERITIES = ("error", "warning")

# `# photon-lint: disable=PL001,PL004 <reason>` — reason required for
# the suppression to take effect
SUPPRESS_RE = re.compile(
    r"#\s*photon-lint:\s*disable=(?P<rules>PL\d{3}(?:\s*,\s*PL\d{3})*)"
    r"(?P<reason>.*)$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str  # "PL001"
    path: str  # repo-relative, forward slashes
    line: int  # 1-based
    col: int  # 0-based
    severity: str  # error | warning
    message: str
    hint: str  # how to fix it
    text: str = ""  # stripped source line (baseline identity)

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"[{self.severity}] {self.message}\n    fix: {self.hint}"
        )


class Rule:
    """One lint rule. Subclasses set the class attributes and implement
    :meth:`check`; :meth:`scan` is the optional cross-file collect phase
    (runs over EVERY module before any check)."""

    id: str = "PL000"
    name: str = "unnamed"
    severity: str = "error"
    hint: str = ""
    # the bug that taught us the rule (photon-lint explain / docs)
    origin: str = ""

    def scan(self, ctx: "ModuleContext") -> None:
        return None

    def check(self, ctx: "ModuleContext") -> Iterator[Finding]:
        return iter(())

    def finding(
        self,
        ctx: "ModuleContext",
        node: ast.AST,
        message: str,
        hint: Optional[str] = None,
    ) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=self.id,
            path=ctx.rel_path,
            line=line,
            col=getattr(node, "col_offset", 0),
            severity=self.severity,
            message=message,
            hint=hint if hint is not None else self.hint,
            text=ctx.line_text(line),
        )


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains; Call heads keep their name
    with ``()`` appended (``obs.registry()``); anything else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    if isinstance(node, ast.Call):
        base = dotted_name(node.func)
        return f"{base}()" if base else None
    return None


def call_name(call: ast.Call) -> Tuple[Optional[str], Optional[str]]:
    """(last component, full dotted form) of a call's callee."""
    full = dotted_name(call.func)
    if full is None:
        return None, None
    return full.rsplit(".", 1)[-1], full


class ModuleContext:
    """One parsed module plus the indexes every rule needs."""

    def __init__(self, path: str, rel_path: str, source: str):
        self.path = path
        self.rel_path = rel_path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._parents: Dict[int, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[id(child)] = parent
        # line -> {rule_id: reason}; reasonless disables are recorded
        # with reason None (they do NOT suppress — see engine)
        self.suppressions: Dict[int, Dict[str, Optional[str]]] = {}
        self._parse_suppressions()

    # -- suppressions ---------------------------------------------------

    def _parse_suppressions(self) -> None:
        for i, raw in enumerate(self.lines, start=1):
            if "photon-lint" not in raw:
                continue
            m = SUPPRESS_RE.search(raw)
            if not m:
                continue
            reason = m.group("reason").strip() or None
            for rule_id in re.split(r"\s*,\s*", m.group("rules")):
                self.suppressions.setdefault(i, {})[rule_id] = reason

    def suppression_reason(
        self, line: int, rule_id: str
    ) -> Tuple[bool, Optional[str]]:
        """(has_disable_comment, reason) for ``rule_id`` on ``line``."""
        per = self.suppressions.get(line)
        if per is None or rule_id not in per:
            return False, None
        return True, per[rule_id]

    # -- tree navigation ------------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    def ancestry(
        self, node: ast.AST
    ) -> Iterator[Tuple[ast.AST, ast.AST]]:
        """(ancestor, child-we-came-through) pairs, innermost first."""
        child = node
        parent = self.parent(child)
        while parent is not None:
            yield parent, child
            child = parent
            parent = self.parent(child)

    def enclosing_function(
        self, node: ast.AST
    ) -> Optional[ast.AST]:
        for anc, _ in self.ancestry(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def walk_calls(self) -> Iterator[ast.Call]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                yield node

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def docstring_nodes(self) -> set:
        """ids of Constant nodes that are docstrings (skipped by rules
        that scan raw string literals)."""
        out = set()
        for node in ast.walk(self.tree):
            if isinstance(
                node,
                (
                    ast.Module,
                    ast.FunctionDef,
                    ast.AsyncFunctionDef,
                    ast.ClassDef,
                ),
            ):
                body = getattr(node, "body", [])
                if (
                    body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)
                ):
                    out.add(id(body[0].value))
        return out


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]
    files: int
    wall_s: float
    suppressed: int
    # reasonless `disable=` comments found (they suppress nothing)
    bare_suppressions: List[Tuple[str, int]]
    parse_errors: List[Finding]

    def by_rule(self) -> Dict[str, List[Finding]]:
        out: Dict[str, List[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    """Expand files/directories into sorted .py file paths. Build
    artifacts and caches are skipped."""
    skip_dirs = {"__pycache__", ".git", "_build", ".pytest_cache"}
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in skip_dirs)
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


class Analyzer:
    """Run a rule set over a file tree: parse once, scan phase, check
    phase, suppression accounting."""

    def __init__(self, rules: Optional[List[Rule]] = None, base: str = "."):
        if rules is None:
            from photon_ml_tpu_torch.analysis import default_rules

            rules = default_rules()
        self.rules = rules
        self.base = os.path.abspath(base)

    def rule(self, rule_id: str) -> Optional[Rule]:
        for r in self.rules:
            if r.id == rule_id:
                return r
        return None

    def _rel(self, path: str) -> str:
        ap = os.path.abspath(path)
        try:
            rel = os.path.relpath(ap, self.base)
        except ValueError:  # different drive (windows) — keep absolute
            return ap.replace(os.sep, "/")
        if rel.startswith(".."):
            return ap.replace(os.sep, "/")
        return rel.replace(os.sep, "/")

    def run(self, paths: Iterable[str]) -> AnalysisResult:
        t0 = time.perf_counter()
        contexts: List[ModuleContext] = []
        parse_errors: List[Finding] = []
        files = 0
        for path in iter_py_files(paths):
            files += 1
            try:
                with open(path, encoding="utf-8") as f:
                    source = f.read()
                contexts.append(
                    ModuleContext(path, self._rel(path), source)
                )
            except (SyntaxError, ValueError, OSError) as e:
                # an unparseable file can hide anything — surface it as
                # a finding instead of silently narrowing coverage
                parse_errors.append(
                    Finding(
                        rule="PL000",
                        path=self._rel(path),
                        line=getattr(e, "lineno", 1) or 1,
                        col=0,
                        severity="error",
                        message=f"file does not parse: {e}",
                        hint="fix the syntax error; photon-lint cannot "
                        "analyze what ast.parse cannot read",
                        text="",
                    )
                )
        for rule in self.rules:
            for ctx in contexts:
                rule.scan(ctx)
        findings: List[Finding] = []
        suppressed = 0
        bare: List[Tuple[str, int]] = []
        for ctx in contexts:
            for rule in self.rules:
                for finding in rule.check(ctx):
                    has, reason = ctx.suppression_reason(
                        finding.line, finding.rule
                    )
                    if has and reason:
                        suppressed += 1
                        continue
                    if has and not reason:
                        # recorded once per (file, line): the disable is
                        # inert until it says WHY
                        bare.append((ctx.rel_path, finding.line))
                    findings.append(finding)
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return AnalysisResult(
            findings=findings + parse_errors,
            files=files,
            wall_s=time.perf_counter() - t0,
            suppressed=suppressed,
            bare_suppressions=sorted(set(bare)),
            parse_errors=parse_errors,
        )
