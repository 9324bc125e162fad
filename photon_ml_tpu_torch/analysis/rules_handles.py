"""PL005 unmanaged-native-handle: native handles need static ownership
(counterpart of ``photon_ml_tpu/analysis/rules_handles.py``).

Origin: the PR 9 handle census. ``NativeAvroReader`` /
``NativeVocabSet`` own C++-side buffers and shared vocab hash maps; a
leaked reader held the maps alive (and, with the PR 10 watchdogs, a
freed-under-a-stray-thread map segfaulted the process). PR 9 converted
every entry point to ``with``-style and added the runtime census
(``live_native_handles`` == 0 after every entry point, drilled in
tier-1). This rule is the census's static form: every construction must
have a visible owner AT THE CONSTRUCTION SITE —

- the context expression of a ``with`` (directly, or via
  ``contextlib.closing`` / ``ExitStack.enter_context``);
- a local that the SAME function later manages (``with vocabset:``,
  ``enter_context(vocabset)``, or a ``finally:``-reachable
  ``vocabset.close()``);
- an attribute of an object that itself defines ``close``/``__exit__``
  (ownership transferred to a managed container, e.g. the ingest
  pipeline's ``self._vocabset``).

Anything else is a handle whose lifetime depends on the garbage
collector and whoever reads the code next.

The port's handle types are the classes its census counts
(``io/native.live_native_handles``): ``NativeAvroReader`` and
``NativeVocabSet``, which own the C++ codec's buffers and vocab maps.
``io/pipeline.IngestPipeline`` has ``close``/``__exit__`` but the census
does not count it (it owns threads and pinned staging, and its native
handles are the readers it opens in ``with``), so it is not listed.
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

__all__ = ["UnmanagedNativeHandle", "NATIVE_HANDLE_TYPES"]

NATIVE_HANDLE_TYPES = frozenset({"NativeAvroReader", "NativeVocabSet"})

_MANAGER_WRAPPERS = frozenset({"closing", "enter_context", "push"})


class UnmanagedNativeHandle(Rule):
    id = "PL005"
    name = "unmanaged-native-handle"
    severity = "error"
    hint = (
        "construct the handle in a `with` statement (or hand it "
        "straight to contextlib.closing / ExitStack.enter_context), "
        "manage the local with `with handle:` / try-finally close(), "
        "or store it on an object that itself defines close()/__exit__ "
        "and is managed by its owner"
    )
    origin = (
        "PR 9's native-handle census: leaked NativeAvroReader handles "
        "kept shared C++ vocab maps alive, and PR 10 found close() "
        "freeing those maps under a watchdog-abandoned decode thread "
        "(a real segfault). The runtime census asserts zero live "
        "handles after every entry point; this rule asserts the same "
        "ownership discipline statically, at the construction site."
    )

    def _assigned_name(self, ctx: ModuleContext, call: ast.Call):
        """(kind, name) when the call's value is bound: ('local', n) for
        `n = C()`, ('attr', attr) for `self.x = C()`, else (None, None)."""
        parent = ctx.parent(call)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            target = parent.targets[0]
        elif isinstance(parent, (ast.AnnAssign,)) and parent.value is call:
            target = parent.target
        else:
            return None, None
        if isinstance(target, ast.Name):
            return "local", target.id
        if isinstance(target, ast.Attribute) and isinstance(
            target.value, ast.Name
        ):
            if target.value.id == "self":
                return "attr", target.attr
        return None, None

    def _in_with_item(self, ctx: ModuleContext, call: ast.Call) -> bool:
        """The call (possibly wrapped in closing()/enter_context()) is a
        with-statement context expression or a manager-wrapper arg."""
        node: ast.AST = call
        parent = ctx.parent(node)
        while parent is not None:
            if isinstance(parent, ast.withitem):
                return True
            if isinstance(parent, ast.Call):
                last, _ = call_name(parent)
                if last in _MANAGER_WRAPPERS:
                    return True
            if not isinstance(parent, (ast.Call, ast.Starred)):
                break
            node = parent
            parent = ctx.parent(node)
        return False

    def _scope_manages_local(
        self, ctx: ModuleContext, call: ast.Call, name: str
    ) -> bool:
        scope = ctx.enclosing_function(call) or ctx.tree
        for node in ast.walk(scope):
            if isinstance(node, ast.withitem):
                expr = node.context_expr
                if isinstance(expr, ast.Name) and expr.id == name:
                    return True
            if isinstance(node, ast.Call):
                last, _ = call_name(node)
                if last in _MANAGER_WRAPPERS and any(
                    isinstance(a, ast.Name) and a.id == name
                    for a in node.args
                ):
                    return True
            if isinstance(node, ast.Try) and node.finalbody:
                for fin in node.finalbody:
                    for sub in ast.walk(fin):
                        if isinstance(sub, ast.Call):
                            _, full = call_name(sub)
                            if full in (
                                f"{name}.close",
                                f"{name}.free",
                            ):
                                return True
        return False

    def _owner_class_manages(
        self, ctx: ModuleContext, call: ast.Call
    ) -> bool:
        for anc, _ in ctx.ancestry(call):
            if isinstance(anc, ast.ClassDef):
                methods: Set[str] = {
                    n.name
                    for n in anc.body
                    if isinstance(
                        n, (ast.FunctionDef, ast.AsyncFunctionDef)
                    )
                }
                return bool({"close", "__exit__"} & methods)
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for call in ctx.walk_calls():
            last, _ = call_name(call)
            if last not in NATIVE_HANDLE_TYPES:
                continue
            if self._in_with_item(ctx, call):
                continue
            kind, name = self._assigned_name(ctx, call)
            if kind == "local" and name and self._scope_manages_local(
                ctx, call, name
            ):
                continue
            if kind == "attr" and self._owner_class_manages(ctx, call):
                continue
            yield self.finding(
                ctx,
                call,
                f"{last}() constructed without a static owner: no "
                "`with`, no enter_context/closing, no finally-close in "
                "this scope, and no managed container — the C++ buffers "
                "this handle owns now free whenever the GC feels like "
                "it (the bug class PR 9's runtime handle census exists "
                "to catch)",
            )
