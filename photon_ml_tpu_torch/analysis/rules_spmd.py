"""PL001 spmd-collective-divergence: collectives under per-process
control flow, in the port's ``torch.distributed`` form (counterpart of
``photon_ml_tpu/analysis/rules_spmd.py``).

Origin: the PR 11 review's HIGH finding. The host-loss FINAL checkpoint
ran the normal pod writer — whose digest allgather and completion
barrier include the peer just declared dead — from the recovery path,
so the survivors' "final save" hung forever (or burned the whole retry
budget) and the promised shard set never landed. The general shape: a
collective is only safe when EVERY process reaches it in the same
order. In the port every rank is one process of a ``torch.distributed``
world (NCCL on the cards, gloo on the CPU), and the same two static
contexts break that guarantee:

- an ``except`` handler: only the ranks that saw the exception enter
  it, so a collective there desyncs the process group (survivors wait
  on a peer that never calls; NCCL then hangs until its watchdog);
- a branch whose condition depends on ``get_rank()`` /
  ``process_index()`` / ``process_id``: by construction different ranks
  take different arms (branching on ``get_world_size`` /
  ``process_count`` is uniform and fine).

One level of the call graph is followed: a local function that
(directly) calls a collective is itself treated as collective-calling,
so hiding the all_gather one ``def`` down doesn't evade the rule.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set, Tuple

from photon_ml_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    call_name,
)

__all__ = ["SpmdCollectiveDivergence", "COLLECTIVE_NAMES"]

# the port's collective seam: the torch.distributed collectives the port
# calls (and their siblings), parallel/mesh's labelled reductions, the
# host exchanges of parallel/multihost (allgather_host and every helper
# that rides it), the obs pod barrier, and the sharded checkpoint writer
# (whose digest exchange + completion barrier are full-world
# collectives — the literal PR-11 bug)
COLLECTIVE_NAMES = frozenset(
    {
        # torch.distributed
        "all_reduce",
        "all_gather",
        "all_gather_object",
        "all_gather_into_tensor",
        "broadcast",
        "broadcast_object_list",
        "barrier",
        "monitored_barrier",
        "reduce_scatter",
        "reduce_scatter_tensor",
        "all_to_all",
        "all_to_all_single",
        # parallel/mesh.py (all_reduce, all_gather, reduce_scatter above)
        "data_sum",
        "feature_sum",
        # parallel/multihost.py
        "allgather_host",
        "allgather_objects",
        "allgather_strings",
        "global_entity_space",
        "gather_rows_to_host",
        "make_global_re_design",
        "make_global_batch",
        "hierarchical_psum",
        "emit_pod_sync",
        # io/checkpoint.py
        "save_checkpoint_sharded",
    }
)

_PER_PROCESS_NAMES = frozenset({"process_index", "process_id", "get_rank"})


def _test_is_per_process(test: ast.AST) -> bool:
    """True when a branch condition references get_rank/process_index/
    process_id (call, bare name, or attribute: ``dist.get_rank()``) —
    different ranks evaluate it differently."""
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id in _PER_PROCESS_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _PER_PROCESS_NAMES:
            return True
    return False


class SpmdCollectiveDivergence(Rule):
    id = "PL001"
    name = "spmd-collective-divergence"
    severity = "error"
    hint = (
        "hoist the collective out of the divergent arm so every rank "
        "reaches it unconditionally; for recovery paths use a "
        "collective-free protocol (io/checkpoint's "
        "save_checkpoint_sharded_final single-publisher pattern) or gate "
        "on uniform state (get_world_size, a pre-exchanged flag) instead "
        "of get_rank()/process_index()"
    )
    origin = (
        "PR 11 review (HIGH): the host-loss final save ran the pod "
        "checkpoint writer — digest allgather + completion barrier "
        "including the dead peer — from the except-handler recovery "
        "path; survivors hung forever waiting for a process that would "
        "never join the exchange. Fixed by the collective-free "
        "single-publisher final writer, which the port's "
        "io/checkpoint.py keeps. In a torch.distributed world the same "
        "shape hangs the NCCL or gloo process group; this rule makes the "
        "whole class (collectives reachable from per-rank control flow) "
        "a build-time error."
    )

    def __init__(self):
        # module path -> local function names that call a collective
        # directly (the one-level call graph)
        self._collective_fns: Dict[str, Set[str]] = {}

    # -- phase 1: collect local collective-calling functions ------------

    def scan(self, ctx: ModuleContext) -> None:
        local: Set[str] = set()
        for call in ctx.walk_calls():
            last, _ = call_name(call)
            if last in COLLECTIVE_NAMES:
                fn = ctx.enclosing_function(call)
                if fn is not None:
                    local.add(fn.name)
        self._collective_fns[ctx.rel_path] = local

    # -- phase 2: flag collectives in divergent contexts ----------------

    def _divergent_context(
        self, ctx: ModuleContext, node: ast.AST
    ) -> Optional[Tuple[str, int]]:
        """(description, line) of the innermost divergent construct the
        node sits in, or None. Walking up stops at the enclosing
        function boundary: a collective inside a nested ``def`` is
        attributed when that function is CALLED, not where it's
        defined."""
        for anc, child in ctx.ancestry(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None
            if isinstance(anc, ast.ExceptHandler):
                return ("an except handler", anc.lineno)
            if isinstance(anc, (ast.If, ast.While)):
                in_branch = child is not anc.test
                if in_branch and _test_is_per_process(anc.test):
                    return (
                        "a rank-dependent branch (get_rank/process_index)",
                        anc.lineno,
                    )
            if isinstance(anc, ast.IfExp):
                in_branch = child is not anc.test
                if in_branch and _test_is_per_process(anc.test):
                    return (
                        "a rank-dependent conditional expression "
                        "(get_rank/process_index)",
                        anc.lineno,
                    )
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        local_collective_fns = self._collective_fns.get(ctx.rel_path, set())
        for call in ctx.walk_calls():
            last, full = call_name(call)
            if last is None:
                continue
            via: Optional[str] = None
            if last in COLLECTIVE_NAMES:
                what = f"collective {last}()"
            elif last in local_collective_fns:
                via = last
                what = (
                    f"{last}(), which calls a collective (one call-graph "
                    "level down)"
                )
            else:
                continue
            where = self._divergent_context(ctx, call)
            if where is None:
                continue
            desc, ctx_line = where
            yield self.finding(
                ctx,
                call,
                f"{what} is reached inside {desc} (opened at line "
                f"{ctx_line}): ranks that don't take this arm never "
                "join the exchange, so the process group's collectives "
                "desync or hang",
            )
