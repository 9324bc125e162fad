"""PL006 obs-taxonomy: span/event/metric name literals must be
documented names (counterpart of ``photon_ml_tpu/analysis/rules_obs.py``,
bound to the port's ``photon_ml_tpu_torch.obs.taxonomy``, which adds the
port's ``kernels.builds``, ``kernels.launch_plans`` and ``kernels.cost.*``).

Origin: the observability layer records ANY dotted name happily —
``reg.inc("sevring.request_ms")`` compiles, runs, and silently orphans
its dashboard panel, its Prometheus series, and its sentinel direction
rule. The taxonomy that makes the obs surface navigable lived in
docs/OBSERVABILITY.md prose; ``obs.taxonomy`` (the machine-readable
registry this rule binds) turned it into code, and this rule makes a
name outside it a build-time error.

Checked call shapes:

- ``obs.span("...")`` / ``span("...")`` and ``obs.emit_event`` — the
  tracer surface;
- registry instrument calls — ``.inc`` / ``.set_gauge`` / ``.observe``
  / ``.counter`` / ``.gauge`` / ``.histogram`` on a receiver that is
  recognizably a metrics registry (``reg``, ``registry()``,
  ``obs.registry()``, ``self._registry``, ...).

f-string names validate their STATIC prefix (``f"hbm.{label}.peak"``
passes via the ``hbm.`` subsystem); fully-dynamic names are skipped —
the rule gates what it can see, not what it can't.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from photon_ml_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    call_name,
    dotted_name,
)

__all__ = ["ObsTaxonomyRule"]

_TRACER_FNS = frozenset({"span", "emit_event"})
_REGISTRY_METHODS = frozenset(
    {"inc", "set_gauge", "observe", "counter", "gauge", "histogram"}
)
# receivers that denote a metrics registry: the canonical accessor
# (…registry()) or a conventional binding of it
_REGISTRY_RECEIVER_RE = re.compile(
    r"(^|\.)(registry\(\)|_?reg|_registry|metrics_registry)$"
)


def _static_name(node: ast.AST) -> Optional[str]:
    """The literal name, or the static PREFIX of an f-string name
    (marked with a trailing '{'), or None when fully dynamic."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        head = []
        for part in node.values:
            if isinstance(part, ast.Constant) and isinstance(
                part.value, str
            ):
                head.append(part.value)
            else:
                prefix = "".join(head)
                return prefix + "{" if prefix else None
        return "".join(head)
    return None


class ObsTaxonomyRule(Rule):
    id = "PL006"
    name = "obs-taxonomy"
    severity = "warning"
    hint = (
        "use a documented <subsystem>.<thing> name (the port's "
        "obs.taxonomy lists the subsystems) or, for a genuinely new "
        "subsystem, add its entry to obs.taxonomy.TAXONOMY alongside "
        "its blurb"
    )
    origin = (
        "Metric/span names are the JOIN KEY between the code, the "
        "dashboards, photon-obs merge, Prometheus, and the bench "
        "sentinel's direction rules — and the registry accepts any "
        "string. A typo'd subsystem records forever and renders "
        "nowhere; the taxonomy existed only as prose until "
        "obs.taxonomy made it checkable."
    )

    def _name_arg(self, call: ast.Call) -> Optional[ast.AST]:
        last, full = call_name(call)
        if last in _TRACER_FNS:
            # plain span()/emit_event() or obs.span()/tracer-qualified
            if call.args:
                return call.args[0]
            return None
        if last in _REGISTRY_METHODS and full and "." in full:
            receiver = full.rsplit(".", 1)[0]
            if _REGISTRY_RECEIVER_RE.search(receiver):
                if call.args:
                    return call.args[0]
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        from photon_ml_tpu_torch.obs import taxonomy

        for call in ctx.walk_calls():
            name_node = self._name_arg(call)
            if name_node is None:
                continue
            name = _static_name(name_node)
            if name is None:
                continue
            if name.endswith("{"):
                prefix = name[:-1]
                if taxonomy.valid_prefix(prefix):
                    continue
                shown = prefix + "…"
            else:
                if taxonomy.matches(name):
                    continue
                shown = name
            yield self.finding(
                ctx,
                call,
                f"obs name {shown!r} is outside the documented "
                "taxonomy (the port's obs.taxonomy): it "
                "will record but never render — dashboards, merge "
                "output, and sentinel rules key on documented "
                "subsystem prefixes",
            )
