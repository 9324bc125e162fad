"""PL008 span-context-drop: spawned work that loses its trace id
(counterpart of ``photon_ml_tpu/analysis/rules_reqtrace.py``).

The request-causality layer (the port's obs/reqtrace.py and frontend/)
only works because every layer that accepts a trace id passes it to the
next one: wire frame -> tenant envelope -> batcher item -> retro-span.
The chain has a single failure mode, and it is silent: a function that
RECEIVES the context (a ``trace``/``trace_id``/``span_ctx`` parameter)
and then hands work to another thread of control — ``threading.Thread``,
an executor ``.submit``, ``loop.create_task``, ``ensure_future``,
``run_in_executor`` — without the context in the hand-off. Nothing
crashes. The request still scores. But every span the spawned work emits
is orphaned: ``photon-obs request`` shows a timeline that ends at the
hand-off, the failover/degraded keep-classes in obs/exemplars.py never
see the request, and the ``trace_loss`` drill's zero-orphan assertion is
the only thing that would ever notice.

Detection is scoped to functions that visibly hold a context parameter
(one of the conventional names below) — the one case where dropping it
is unambiguous. The spawn call is clean when its argument subtree
references the context by name (``args=(trace,)``, ``trace=trace``), or
forwards a locally-defined function/lambda that closes over it, or
forwards opaque ``*args``/``**kwargs`` (we cannot see inside; the
ratchet stays quiet rather than guessing).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from photon_ml_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    call_name,
)

__all__ = ["SpanContextDrop"]

# the conventional trace/span-context parameter names (the repo's own
# seam uses `trace`; the rest are the usual suspects in ported code)
_CTX_PARAM_NAMES = frozenset(
    {"trace", "trace_id", "span_ctx", "span_context", "trace_ctx"}
)

# hand-off sinks: (last callee component) -> what it spawns
_SPAWN_SINKS = {
    "Thread": "a thread (threading.Thread)",
    "submit": "executor work (.submit)",
    "create_task": "an event-loop task (create_task)",
    "ensure_future": "an event-loop task (ensure_future)",
    "run_in_executor": "executor work (run_in_executor)",
}


def _param_names(fn: ast.AST) -> Set[str]:
    a = fn.args
    names: Set[str] = set()
    for group in (a.posonlyargs, a.args, a.kwonlyargs):
        names.update(p.arg for p in group)
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


def _body_references(fn: ast.AST, names: Set[str]) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id in names:
            return True
    return False


class SpanContextDrop(Rule):
    id = "PL008"
    name = "span-context-drop"
    severity = "warning"
    hint = (
        "forward the context into the spawned work: pass it in "
        "args=/kwargs (Thread(target=fn, args=(trace,)), "
        "pool.submit(fn, trace)), thread it through the submit "
        "keyword (batcher.submit(req, trace=trace)), or close over "
        "it in a locally-defined worker function"
    )
    origin = (
        "The PR 19 trace seam: a request's id rides wire frame -> "
        "tenant envelope -> batcher item -> retro-span, and every hop "
        "is a hand-off to another thread of control. Dropping the id "
        "at any hop fails silently — scoring still works, but the "
        "spawned work's spans are orphans, `photon-obs request` shows "
        "a timeline truncated at the hand-off, and the exemplar "
        "keep-classes (error/failover/degraded) never see the "
        "request. Only the trace_loss drill's zero-orphan assertion "
        "catches it at runtime; this rule catches it in review."
    )

    def _spawn_drops_context(
        self, call: ast.Call, carriers: Set[str]
    ) -> Optional[str]:
        """The sink description when this call is a hand-off that
        references NO carrier name, else None."""
        last, _ = call_name(call)
        desc = _SPAWN_SINKS.get(last or "")
        if desc is None:
            return None
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            for node in ast.walk(arg):
                if isinstance(node, ast.Name) and node.id in carriers:
                    return None
        # opaque forwarding — *args / **kwargs may carry the context;
        # stay quiet rather than guess
        if any(isinstance(a, ast.Starred) for a in call.args):
            return None
        if any(kw.arg is None for kw in call.keywords):
            return None
        return desc

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            ctx_params = _param_names(fn) & _CTX_PARAM_NAMES
            if not ctx_params:
                continue
            # names that carry the context forward: the parameters
            # themselves, plus locally-defined functions whose bodies
            # close over one (Thread(target=worker) with `worker`
            # reading `trace` IS forwarding)
            carriers = set(ctx_params)
            for node in ast.walk(fn):
                if (
                    isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef)
                    )
                    and node is not fn
                    and _body_references(node, ctx_params)
                ):
                    carriers.add(node.name)
                elif isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Lambda
                ):
                    if _body_references(node.value, ctx_params):
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                carriers.add(tgt.id)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                # nested defs report against their own ctx params when
                # they have them; a spawn inside a nested def that holds
                # no context itself is the OUTER function's hand-off
                # only if the call is lexically inside fn — ast.walk
                # gives us that for free, and double-reporting is
                # prevented because the nested def without ctx params
                # is skipped by the `ctx_params` gate above
                desc = self._spawn_drops_context(node, carriers)
                if desc is not None:
                    yield self.finding(
                        ctx,
                        node,
                        f"{fn.name}() holds a trace context "
                        f"({', '.join(sorted(ctx_params))}) but spawns "
                        f"{desc} without forwarding it — the spawned "
                        "work's spans will be orphaned from the "
                        "request timeline",
                    )
