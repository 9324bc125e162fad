"""PL003 unknown-fault-site: fault-site literals checked at LINT time
(counterpart of ``photon_ml_tpu/analysis/rules_faults.py``, reading the
port's own registry, ``photon_ml_tpu_torch.resilience.faults``).

Origin: before PR 10's arm-time validation, a typo'd drill site sat
inert in the injector and the drill "passed" by testing nothing.
Arm-time validation (``UnknownFaultSite``) closed that for RUNTIME
arming — but a typo'd ``fire("serving.scoer")`` probe in production
code, or a bad ``PHOTON_FAULTS`` schedule literal, still waits for an
execution path to notice. This rule moves the same check to the build:
every ``fire("...")`` / ``FaultSpec("...")`` / schedule-string literal
is validated against the port's ``resilience.faults.registered_sites()``
(``KNOWN_SITES``, the registry the port's arm-time validator binds),
plus any ``register_site("...")`` literals the analyzed tree itself
declares.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional, Set

from photon_ml_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    call_name,
)

__all__ = ["UnknownFaultSiteRule"]

# a PHOTON_FAULTS schedule fragment: site:mode@args
_SCHEDULE_RE = re.compile(
    r"^[a-z0-9_.]+:(raise|corrupt|delay)(@|$)", re.IGNORECASE
)


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class UnknownFaultSiteRule(Rule):
    id = "PL003"
    name = "unknown-fault-site"
    severity = "error"
    hint = (
        "use a site from photon_ml_tpu_torch.resilience.faults."
        "registered_sites() (KNOWN_SITES), or declare the new seam with "
        "faults.register_site(...) next to the code that probes it"
    )
    origin = (
        "Pre-PR-10, a typo'd fault site armed nothing and the drill "
        "passed by testing nothing; arm-time validation "
        "(UnknownFaultSite) fixed the runtime half. The lint half "
        "catches the probe side — a fire()/FaultSpec()/PHOTON_FAULTS "
        "literal naming a site no registry knows — before anything "
        "runs."
    )

    def __init__(self, extra_sites: Optional[Set[str]] = None):
        self._declared: Set[str] = set(extra_sites or ())
        self._known: Optional[Set[str]] = None

    def _known_sites(self) -> Set[str]:
        if self._known is None:
            from photon_ml_tpu_torch.resilience.faults import registered_sites

            self._known = set(registered_sites())
        return self._known | self._declared

    # -- phase 1: collect register_site("...") declarations -------------

    def scan(self, ctx: ModuleContext) -> None:
        for call in ctx.walk_calls():
            last, _ = call_name(call)
            if last == "register_site" and call.args:
                lit = _literal_str(call.args[0])
                if lit:
                    self._declared.add(lit)

    # -- phase 2: validate probe/arm/schedule literals -------------------

    def _site_of_call(self, call: ast.Call) -> Optional[ast.AST]:
        """The site-literal node of a fire()/FaultSpec() call, if any."""
        last, _ = call_name(call)
        if last == "fire" and call.args:
            return call.args[0]
        if last == "FaultSpec":
            if call.args:
                return call.args[0]
            for kw in call.keywords:
                if kw.arg == "site":
                    return kw.value
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        known = self._known_sites()
        docstrings = ctx.docstring_nodes()
        seen: Set[int] = set()
        for call in ctx.walk_calls():
            site_node = self._site_of_call(call)
            if site_node is None:
                continue
            site = _literal_str(site_node)
            if site is None or site in known:
                continue
            seen.add(id(site_node))
            yield self.finding(
                ctx,
                call,
                f"fault site {site!r} is not in "
                "resilience.faults.registered_sites(): this probe/arm "
                "would raise UnknownFaultSite at runtime (or, pre-"
                "validation, silently drill nothing)",
            )
        # PHOTON_FAULTS schedule literals outside docstrings: validate
        # each ;-segment's site against the registry
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
            ):
                continue
            if id(node) in docstrings or id(node) in seen:
                continue
            text = node.value
            segments = [s.strip() for s in text.split(";") if s.strip()]
            if not segments or not all(
                _SCHEDULE_RE.match(s) for s in segments
            ):
                continue
            for seg in segments:
                site = seg.split(":", 1)[0]
                if site not in known:
                    yield self.finding(
                        ctx,
                        node,
                        f"PHOTON_FAULTS schedule names unknown site "
                        f"{site!r}: arming it raises UnknownFaultSite "
                        "before the job starts",
                    )
