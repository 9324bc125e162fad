"""PL004 trace-unsafe-host-op: host operations inside regions that
record once and replay, in the port's PyTorch form (counterpart of
``photon_ml_tpu/analysis/rules_trace.py``).

Eager PyTorch has no trace: a host read in plain port code runs every
time, as written, and costs a sync at worst. The bug class survives in
the regions PyTorch captures ONCE and replays:

- the body of a ``with torch.cuda.graph(g):`` capture — the kernels it
  launches are recorded into the graph and ``g.replay()`` reruns only
  them;
- a function passed to ``torch.cuda.make_graphed_callables`` — captured
  the same way, forward and backward;
- a function passed to, or decorated with, ``torch.compile`` — traced
  by dynamo into a graph, where a host read breaks the graph (or
  freezes a trace-time value into a guard).

Inside such a region a host read (``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``float()``/``int()``/``bool()`` of a tensor
parameter) syncs the card in the middle of a capture, which CUDA forbids
(the capture fails) or, under ``torch.compile``, splits the graph at
that line; ``time.*`` reads the host clock once at capture time and
never again; ``print`` fires at capture only; ``np.asarray`` pulls a
tensor to the host. None of it is what the author meant.

Detection is one level interprocedural, as in the JAX rule: a local
function called by plain name from a region is checked too. The JAX
rule exempts functions handed to its sanctioned host escapes
(``jax.pure_callback`` / ``io_callback`` / ``jax.debug.callback``);
PyTorch has no host callback inside a CUDA graph, so the port's form has
no exemption: host work belongs before the capture or after the replay.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from photon_ml_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    call_name,
    dotted_name,
)

__all__ = ["TraceUnsafeHostOp"]

# method-shaped host reads: fire on ANY receiver (state[0].item() has no
# resolvable dotted name but is exactly the bug)
_HOST_METHODS = {
    "item": ".item() reads a device scalar on the host (a sync)",
    "tolist": ".tolist() copies the tensor to the host (a sync)",
    "cpu": ".cpu() copies the tensor to the host (a sync)",
    "numpy": ".numpy() needs a host tensor (a sync and a copy)",
}
_NUMPY_BASES = frozenset({"np", "numpy", "onp"})


def _is_cuda_graph(call: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` / ``cuda.graph(...)``."""
    if not isinstance(call, ast.Call):
        return False
    _, full = call_name(call)
    return full in ("torch.cuda.graph", "cuda.graph")


def _is_torch_compile(node: ast.AST) -> bool:
    """``torch.compile`` as a name, a call, or ``partial(torch.compile,
    ...)`` (decorator shapes)."""
    if isinstance(node, ast.Call):
        _, full = call_name(node)
        if full == "torch.compile":
            return True
        if full in ("partial", "functools.partial") and node.args:
            return dotted_name(node.args[0]) == "torch.compile"
        return False
    return dotted_name(node) == "torch.compile"


def _is_graphed_callables(call: ast.Call) -> bool:
    last, _ = call_name(call)
    return last == "make_graphed_callables"


class TraceUnsafeHostOp(Rule):
    id = "PL004"
    name = "trace-unsafe-host-op"
    severity = "warning"
    hint = (
        "keep the captured region device-only: read scalars, copy to "
        "the host, time and print before the capture or after "
        "g.replay() / the compiled call returns; carry values in device "
        "tensors instead of .item()/float() reads"
    )
    origin = (
        "The JAX package paid for host ops inside traced bodies (PR 9's "
        "streamed solver fell back to disable_jit; PR 8's device loops "
        "exist because every host read in the solve path forced a round "
        "trip). The port's planned CUDA graphs — one per CG step "
        "(ROADMAP target 2) and one per serving bucket (target 10) — and "
        "any torch.compile region record once and replay: a host read "
        "inside one fails the capture or splits the graph, a host clock "
        "or print fires once at capture, and np.asarray pulls the tensor "
        "to the host."
    )

    def _module_functions(
        self, ctx: ModuleContext
    ) -> Dict[str, ast.AST]:
        fns: Dict[str, ast.AST] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns.setdefault(node.name, node)
        return fns

    def _regions(
        self, ctx: ModuleContext, fns: Dict[str, ast.AST]
    ) -> List[Tuple[ast.AST, List[ast.AST], str, Set[str]]]:
        """[(owner node, statements/expressions of the region, why,
        tensor parameter names)]."""
        regions: List[Tuple[ast.AST, List[ast.AST], str, Set[str]]] = []
        seen: Set[int] = set()

        def add_fn(fn_node: ast.AST, why: str) -> None:
            if id(fn_node) not in seen:
                seen.add(id(fn_node))
                body = (
                    [fn_node.body] if isinstance(fn_node, ast.Lambda)
                    else list(fn_node.body)
                )
                regions.append((fn_node, body, why, self._params_of(fn_node)))

        def add_arg(arg: ast.AST, why: str) -> None:
            if isinstance(arg, (ast.Tuple, ast.List)):
                for elt in arg.elts:
                    add_arg(elt, why)
                return
            if isinstance(arg, ast.Lambda):
                add_fn(arg, why)
                return
            name = dotted_name(arg)
            fn_node = fns.get(name.rsplit(".", 1)[-1]) if name else None
            if fn_node is not None:
                add_fn(fn_node, why)

        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_torch_compile(d) for d in node.decorator_list):
                    add_fn(node, "decorated with torch.compile")
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                if any(_is_cuda_graph(i.context_expr) for i in node.items):
                    fn = ctx.enclosing_function(node)
                    regions.append((
                        node, list(node.body),
                        f"inside the torch.cuda.graph capture opened at "
                        f"line {node.lineno}",
                        self._params_of(fn) if fn is not None else set(),
                    ))
            elif isinstance(node, ast.Call) and node.args:
                if _is_torch_compile(node):
                    add_arg(node.args[0], "passed to torch.compile()")
                elif _is_graphed_callables(node):
                    add_arg(node.args[0], "passed to make_graphed_callables()")
        return regions

    def _params_of(self, fn: ast.AST) -> Set[str]:
        if not isinstance(
            fn, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            return set()
        a = fn.args
        names = set()
        for group in (a.posonlyargs, a.args, a.kwonlyargs):
            names.update(p.arg for p in group)
        if a.vararg:
            names.add(a.vararg.arg)
        if a.kwarg:
            names.add(a.kwarg.arg)
        names.discard("self")
        return names

    def _host_op(
        self, call: ast.Call, params: Set[str]
    ) -> Optional[str]:
        """A description of the host op, or None."""
        if isinstance(call.func, ast.Attribute) and not call.args:
            desc = _HOST_METHODS.get(call.func.attr)
            if desc is not None:
                return desc
        last, full = call_name(call)
        if last is None:
            return None
        base = full.rsplit(".", 1)[0] if full and "." in full else ""
        if full == "print":
            return "print() fires once at capture, never on replay"
        if base.rsplit(".", 1)[-1] == "time":
            return (
                f"time.{last}() reads the HOST clock once at capture and "
                "never on replay"
            )
        if last in ("asarray", "array") and base.rsplit(".", 1)[-1] in (
            _NUMPY_BASES
        ):
            return (
                f"{base}.{last}() pulls a tensor to the host (a sync "
                "inside the captured region)"
            )
        if full in ("float", "int", "bool") and len(call.args) == 1:
            arg = call.args[0]
            if isinstance(arg, ast.Name) and arg.id in params:
                return (
                    f"{last}() of a tensor parameter reads it on the "
                    "host (a sync inside the captured region)"
                )
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        fns = self._module_functions(ctx)
        regions = self._regions(ctx, fns)
        if not regions:
            return
        # one interprocedural level: local functions called by plain name
        # from a region (obj.method() is not resolved — a last-name match
        # would bind any same-named method of any class in the module)
        seen_ids: Set[int] = {id(owner) for owner, _, _, _ in regions}
        second_level = []
        for owner, body, why, _ in regions:
            for stmt in body:
                for node in ast.walk(stmt):
                    if not (
                        isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                    ):
                        continue
                    callee = fns.get(node.func.id)
                    if callee is not None and id(callee) not in seen_ids:
                        seen_ids.add(id(callee))
                        owner_name = getattr(owner, "name", None)
                        where = (
                            f"called from {owner_name}() ({why})"
                            if owner_name else f"called {why}"
                        )
                        second_level.append((
                            callee, list(callee.body), where,
                            self._params_of(callee),
                        ))
        reported: Set[int] = set()
        for _, body, why, params in regions + second_level:
            stack = list(body)
            while stack:
                node = stack.pop()
                if isinstance(node, ast.Call) and id(node) not in reported:
                    desc = self._host_op(node, params)
                    if desc is not None:
                        reported.add(id(node))
                        yield self.finding(
                            ctx,
                            node,
                            f"host op in a region that records once and "
                            f"replays ({why}): {desc}",
                        )
                stack.extend(ast.iter_child_nodes(node))
