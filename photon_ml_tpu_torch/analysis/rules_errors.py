"""PL002 exception-match-by-name and PL007 swallowed-retryable
(counterpart of ``photon_ml_tpu/analysis/rules_errors.py``; both rules
read no table, so the port's are the JAX rules as they stand).

Two exception-handling bug classes from this repo's own history:

- **PL002**: classifying an exception by its type NAME
  (``type(e).__name__ == "CollectiveTimeout"``) or by message
  containment (``"..." in str(e)``) instead of ``isinstance``. The
  ``is_host_loss`` bug (PR 11 review #5): a foreign library's
  same-named error anywhere in a cause chain triggered the restart-me
  exit 43.

- **PL007**: an ``except Exception/OSError/bare: pass``-or-log-only
  handler wrapping calls the resilience layer classifies as transient
  (OSError-shaped durability I/O). The retry seam
  (``resilience.retry.retry_call``) exists precisely for those calls;
  swallowing them hides real turbulence from the retry budget, the
  obs counters, and the chaos drills.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from photon_ml_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    call_name,
    dotted_name,
)

__all__ = ["ExceptionMatchByName", "SwallowedRetryable"]


def _is_type_name_expr(node: ast.AST) -> bool:
    """``type(x).__name__`` or ``x.__class__.__name__``."""
    if not (isinstance(node, ast.Attribute) and node.attr == "__name__"):
        return False
    base = node.value
    if isinstance(base, ast.Call):
        last, _ = call_name(base)
        return last == "type"
    return isinstance(base, ast.Attribute) and base.attr == "__class__"


def _is_str_of(node: ast.AST, names: Set[str]) -> bool:
    """``str(x)`` where x is one of ``names``."""
    if not isinstance(node, ast.Call):
        return False
    last, _ = call_name(node)
    if last != "str" or len(node.args) != 1:
        return False
    arg = node.args[0]
    return isinstance(arg, ast.Name) and arg.id in names


class ExceptionMatchByName(Rule):
    id = "PL002"
    name = "exception-match-by-name"
    severity = "error"
    hint = (
        "classify with isinstance() against the real class (lazy-import "
        "it if the dependency direction is awkward — see "
        "resilience.hostloss.is_host_loss), or attach structured fields "
        "to the exception and match those; type names and message text "
        "are neither unique nor stable"
    )
    origin = (
        "PR 11 review #5: is_host_loss matched 'CollectiveTimeout' by "
        "type NAME anywhere in the cause chain, so an unrelated "
        "library's same-named error mapped to the host-loss restart "
        "exit (43) and restarted runs that should have failed loudly. "
        "Fixed by lazy-importing the real classes and matching with "
        "isinstance."
    )

    def _except_bound_names(self, ctx: ModuleContext) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) and node.name:
                names.add(node.name)
        return names

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        exc_names = self._except_bound_names(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Compare):
                continue
            operands = [node.left] + list(node.comparators)
            if any(_is_type_name_expr(op) for op in operands):
                yield self.finding(
                    ctx,
                    node,
                    "exception classified by type NAME "
                    "(type(e).__name__ / __class__.__name__ "
                    "comparison): any library can define a class with "
                    "the same name, and renames break the match "
                    "silently",
                )
                continue
            # `<lit> in str(e)` / `str(e) == <lit>` on an except-bound
            # name: message-text matching is the same trap one step
            # further (messages are not API)
            if any(_is_str_of(op, exc_names) for op in operands):
                yield self.finding(
                    ctx,
                    node,
                    "exception classified by MESSAGE text "
                    "(str(e) comparison/containment): messages are "
                    "not a stable API and collide across libraries",
                )


# os/shutil/file-object operations that raise OSError and that the
# resilience layer (resilience.retry.DEFAULT_RETRY_ON) classifies as
# transient — the calls a swallow-only handler most often hides
_RETRYABLE_CALL_NAMES = frozenset(
    {
        "open",
        "remove",
        "unlink",
        "rename",
        "replace",
        "makedirs",
        "mkdir",
        "rmdir",
        "listdir",
        "rmtree",
        "copyfile",
        "copytree",
        "move",
        "feed_file",
        "read_columnar",
        "save_checkpoint",
        "save_checkpoint_sharded",
        "dump",
    }
)

_BROAD_HANDLER_TYPES = frozenset(
    {"Exception", "BaseException", "OSError", "IOError"}
)

def _is_log_call(call: ast.Call) -> bool:
    """print/warn calls, or any method on a logger-ish receiver. The
    receiver must LOOK like a logger — matching bare method names like
    .error()/.info() would classify `findings.append(error)`-shaped
    bookkeeping as logging."""
    last, full = call_name(call)
    if last in ("print", "warn", "warning"):
        return True
    if (last or "").lstrip("_") == "log":
        return True
    receiver = (
        full.rsplit(".", 1)[0].lower() if full and "." in full else ""
    )
    return "log" in receiver or "warn" in receiver


def _handler_is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare except
        return True
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for ty in types:
        name = dotted_name(ty)
        if name and name.rsplit(".", 1)[-1] in _BROAD_HANDLER_TYPES:
            return True
    return False


def _body_only_swallows(handler: ast.ExceptHandler) -> bool:
    """True when the handler body is pass/continue/log-only: nothing is
    re-raised, returned, recorded in state, or recovered."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            if _is_log_call(stmt.value):
                continue
            return False
        return False
    return True


class SwallowedRetryable(Rule):
    id = "PL007"
    name = "swallowed-retryable"
    severity = "warning"
    hint = (
        "route the call through resilience.retry.retry_call (it "
        "backs off, records resilience.retries, and surfaces "
        "RetryBudgetExceeded), or catch the SPECIFIC terminal "
        "exception you mean to tolerate (e.g. FileNotFoundError) "
        "instead of a broad swallow"
    )
    origin = (
        "The PR 1 resilience layer exists because durability I/O fails "
        "transiently and MUST be retried against a budget, not "
        "swallowed: a try/except-pass around a checkpoint write 'works' "
        "in every test and then loses the only copy of a 40-minute "
        "run's state in production. Every broad swallow around "
        "OSError-shaped I/O found since was either a real durability "
        "hole or deserved an explicit suppression explaining why "
        "best-effort is correct there."
    )

    def _retryable_call(self, try_node: ast.Try) -> Optional[ast.Call]:
        for stmt in try_node.body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    last, _ = call_name(node)
                    if last in _RETRYABLE_CALL_NAMES:
                        return node
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            culprit = self._retryable_call(node)
            if culprit is None:
                continue
            last, _ = call_name(culprit)
            for handler in node.handlers:
                if not _handler_is_broad(handler):
                    continue
                if not _body_only_swallows(handler):
                    continue
                yield self.finding(
                    ctx,
                    handler,
                    f"broad except swallows {last}() — a call the "
                    "resilience layer classifies as transient "
                    "(OSError-shaped I/O): failures here never reach "
                    "the retry seam, its budget, or the "
                    "resilience.retries counters",
                )
