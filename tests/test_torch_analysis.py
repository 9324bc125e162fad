"""The port's photon-lint (``photon_ml_tpu_torch.analysis`` and
``photon_ml_tpu_torch.cli.lint``) against the JAX package's, on the CPU.

Every framework-neutral fixture of ``tests/test_analysis.py`` (PL002,
PL003, PL005-PL008, the suppressions) is written to ``tmp_path`` with its
imports pointed at each package in turn and run through both packages'
``Analyzer``: the ``(rule, line, severity)`` sets are equal, and equal to
the JAX test's expectation. PL001 and PL004 have torch forms: each JAX
fixture of ``TestPL001`` / ``TestPL004`` is rewritten with
``torch.distributed`` / CUDA-graph and ``torch.compile`` regions on the
same lines, and the port's rule flags the lines the JAX rule flags on the
JAX fixture; near misses stay silent. The baseline's matching logic and
the CLI's exit codes and JSON are held to the JAX package's, and the
self-hosting gate runs the port's lint over ``photon_ml_tpu_torch/``.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import types

import pytest

import photon_ml_tpu.analysis as jax_analysis
import photon_ml_tpu.analysis.core as jax_core
import photon_ml_tpu.cli.lint as jax_lint
import photon_ml_tpu_torch.analysis as port_analysis
import photon_ml_tpu_torch.analysis.core as port_core
import photon_ml_tpu_torch.cli.lint as port_lint

pytestmark = pytest.mark.analysis

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO_ROOT, "photon_ml_tpu_torch")

ALL_RULES = (
    "PL001", "PL002", "PL003", "PL004", "PL005", "PL006", "PL007",
    "PL008",
)

PKGS = {
    "jax": types.SimpleNamespace(name="photon_ml_tpu", analysis=jax_analysis,
                                 core=jax_core, lint=jax_lint),
    "port": types.SimpleNamespace(name="photon_ml_tpu_torch", analysis=port_analysis,
                                  core=port_core, lint=port_lint),
}


def lint_files(pkg, tmp_path, files):
    """Run ``pkg``'s Analyzer over ``{name: code}`` written under
    ``tmp_path/<package>``; ``PKG`` in the code names the package."""
    root = tmp_path / pkg.name
    root.mkdir()
    paths = []
    for name, code in files.items():
        path = root / name
        path.write_text(textwrap.dedent(code).replace("PKG", pkg.name))
        paths.append(str(path))
    return pkg.analysis.Analyzer(base=str(root)).run(paths)


def located(result):
    return sorted((f.rule, f.line, f.severity) for f in result.findings)


# ---------------------------------------------------------------------------
# framework-neutral fixtures: (files, the JAX test's expected rules)
# ---------------------------------------------------------------------------

SUPPRESSED = """
from PKG.resilience.faults import fire

def probe():
    fire("made.up.site")  {comment}
"""

NEUTRAL = {
    # PL002
    "pl002_type_name": ("""
        def is_timeout(exc):
            return type(exc).__name__ == "CollectiveTimeout"
        """, ["PL002"]),
    "pl002_dunder_class_name": ("""
        def classify(exc):
            return exc.__class__.__name__ in ("Timeout", "Stall")
        """, ["PL002"]),
    "pl002_message_containment": ("""
        def run(fn):
            try:
                fn()
            except Exception as e:
                if "deadline" in str(e):
                    return True
                raise
        """, ["PL002"]),
    "pl002_isinstance_silent": ("""
        def describe(fn):
            try:
                fn()
            except ValueError as e:
                msg = f"{type(e).__name__}: {e}"
                if isinstance(e, ValueError):
                    return msg
                raise
        """, []),
    # PL003
    "pl003_fire_typo": ("""
        from PKG.resilience.faults import fire

        def probe():
            fire("serving.scoer")
        """, ["PL003"]),
    "pl003_faultspec_and_schedule": ("""
        from PKG.resilience.faults import FaultSpec

        SPEC = FaultSpec(site="bogus.site", mode="raise", nth=1)
        SCHEDULE = "nosuch.seam:raise@n=2"
        """, ["PL003", "PL003"]),
    "pl003_register_across_files": ({
        "a.py": 'from PKG.resilience.faults import register_site\n'
                'register_site("custom.seam")\n',
        "b.py": 'from PKG.resilience.faults import fire\n'
                'def f():\n'
                '    fire("custom.seam")\n'
                '    fire("checkpoint.save")\n',
    }, []),
    "pl003_docstring_skipped": ('''
        def doc():
            """Example: PHOTON_FAULTS="made.up:raise@n=1"."""
            return None
        ''', []),
    # PL005
    "pl005_unowned": ("""
        from PKG.io.native import NativeAvroReader

        def leak(prog, desc, vocab):
            reader = NativeAvroReader(prog, desc, vocab, ())
            return reader.num_records
        """, ["PL005"]),
    "pl005_with_and_deferred_with": ("""
        from PKG.io.native import (
            NativeAvroReader,
            NativeVocabSet,
        )

        def scan(prog, desc, paths):
            vocabset = NativeVocabSet([], [])
            with vocabset:
                with NativeAvroReader(prog, desc, vocabset, ()) as r:
                    return r.num_records
        """, []),
    "pl005_managed_container": ("""
        from PKG.io.native import NativeVocabSet

        class Pipeline:
            def __init__(self):
                self._vocabset = NativeVocabSet([], [])

            def close(self):
                self._vocabset.close()
        """, []),
    "pl005_unmanaged_container": ("""
        from PKG.io.native import NativeVocabSet

        class Holder:
            def __init__(self):
                self.vocab = NativeVocabSet([], [])
        """, ["PL005"]),
    # PL006
    "pl006_typod_metric": ("""
        from PKG import obs

        def record():
            obs.registry().inc("sevring.requests")
        """, ["PL006"]),
    "pl006_unknown_span": ("""
        from PKG import obs

        def work():
            with obs.span("bogus.phase"):
                return 1
        """, ["PL006"]),
    "pl006_documented_and_prefixes": ("""
        from PKG import obs

        def record(site, reg):
            obs.emit_event("resilience.fault_injected", site=site)
            reg.inc(f"resilience.faults_injected.{site}")
            with obs.span("game.pass", cat="game"):
                reg.observe("serving.request_ms", 1.0)
        """, []),
    "pl006_dynamic_skipped": ("""
        def record(reg, name):
            reg.inc(name)
            reg.inc(f"{name}.count")
        """, []),
    # PL007
    "pl007_swallowed_open": ("""
        def read(path):
            try:
                with open(path) as f:
                    return f.read()
            except Exception:
                pass
        """, ["PL007"]),
    "pl007_log_only": ("""
        import os

        def cleanup(path, logger):
            try:
                os.remove(path)
            except OSError:
                logger.warning("cleanup failed")
        """, ["PL007"]),
    "pl007_specific_or_handled": ("""
        import os

        def cleanup(path, seen):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            try:
                os.rmdir(path)
            except OSError as e:
                seen.append(e)
                raise
        """, []),
    # PL008
    "pl008_thread_drops_trace": ("""
        import threading

        def handle(request, trace):
            t = threading.Thread(target=score, args=(request,))
            t.start()
        """, ["PL008"]),
    "pl008_submit_drops_trace_id": ("""
        def enqueue(pool, request, trace_id):
            return pool.submit(score, request)
        """, ["PL008"]),
    "pl008_create_task_drops_span_ctx": ("""
        async def dispatch(loop, request, span_ctx):
            loop.create_task(reply(request))
        """, ["PL008"]),
    "pl008_forwarding_silent": ("""
        import threading

        def positional(request, trace):
            t = threading.Thread(target=score, args=(request, trace))
            t.start()

        def keyword(batcher, request, trace):
            return batcher.submit(request, trace=trace)

        async def task_arg(loop, conn, request, trace):
            loop.create_task(reply(conn, request, trace))
        """, []),
    "pl008_closure_silent": ("""
        import threading

        def handle(request, trace):
            def worker():
                emit(trace, score(request))

            threading.Thread(target=worker).start()
        """, []),
    "pl008_opaque_kwargs_silent": ("""
        def relay(batcher, request, trace, kw):
            return batcher.submit(request, **kw)
        """, []),
    "pl008_no_context_silent": ("""
        import threading

        def start_worker(fn):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            return t
        """, []),
    # suppressions
    "suppress_with_reason": (SUPPRESSED.format(
        comment="# photon-lint: disable=PL003 drill arms a typo on purpose"), []),
    "suppress_bare_is_inert": (SUPPRESSED.format(
        comment="# photon-lint: disable=PL003"), ["PL003"]),
    "suppress_wrong_rule": (SUPPRESSED.format(
        comment="# photon-lint: disable=PL001 wrong rule"), ["PL003"]),
}


@pytest.mark.parametrize("case", sorted(NEUTRAL))
def test_neutral_fixture_parity(case, tmp_path):
    files, want_rules = NEUTRAL[case]
    if isinstance(files, str):
        files = {"snippet.py": files}
    results = {}
    for name, pkg in PKGS.items():
        (tmp_path / name).mkdir()
        results[name] = lint_files(pkg, tmp_path / name, files)
    assert located(results["port"]) == located(results["jax"])
    assert sorted(f.rule for f in results["port"].findings) == want_rules
    for attr in ("suppressed", "bare_suppressions"):
        assert getattr(results["port"], attr) == getattr(results["jax"], attr)
    if case == "suppress_with_reason":
        assert results["port"].suppressed == 1
    if case == "suppress_bare_is_inert":
        assert results["port"].bare_suppressions == [("snippet.py", 5)]


# ---------------------------------------------------------------------------
# PL001 and PL004: each JAX fixture beside its torch form (same lines)
# ---------------------------------------------------------------------------

TORCH_FORMS = {
    "pl001_collective_in_except": ("""
        from photon_ml_tpu.parallel.multihost import allgather_host

        def boundary(x):
            try:
                x = x + 1
            except Exception:
                allgather_host(x)
            return x
        """, """
        import torch.distributed as dist

        def boundary(x):
            try:
                x = x + 1
            except Exception:
                dist.all_reduce(x)
            return x
        """, "except handler"),
    "pl001_collective_under_rank_branch": ("""
        import jax
        from photon_ml_tpu.parallel import allgather_strings

        def publish(entries):
            if jax.process_index() == 0:
                return allgather_strings(entries)
            return []
        """, """
        import torch.distributed as dist
        from photon_ml_tpu_torch.parallel.multihost import allgather_strings

        def publish(entries):
            if dist.get_rank() == 0:
                return dist.broadcast_object_list(entries)
            return []
        """, "get_rank"),
    "pl001_wrapper_under_rank_branch": ("""
        import jax
        from photon_ml_tpu.io.checkpoint import save_checkpoint_sharded

        def final_save(d, step, params, key):
            if jax.process_index() == 0:
                save_checkpoint_sharded(d, step, params, key)
            return d
        """, """
        from photon_ml_tpu_torch.parallel.multihost import process_index
        from photon_ml_tpu_torch.io.checkpoint import save_checkpoint_sharded

        def final_save(d, step, params, key):
            if process_index() == 0:
                save_checkpoint_sharded(d, step, params, key)
            return d
        """, "save_checkpoint_sharded"),
    "pl001_one_level_call_graph": ("""
        from photon_ml_tpu.parallel.multihost import emit_pod_sync

        def sync_obs():
            emit_pod_sync()

        def recover():
            try:
                pass
            except OSError:
                sync_obs()
        """, """
        import torch.distributed as dist

        def sync_obs():
            dist.barrier()

        def recover():
            try:
                pass
            except OSError:
                sync_obs()
        """, "sync_obs"),
    "pl001_near_misses": ("""
        import jax
        from photon_ml_tpu.parallel.multihost import allgather_host

        def exchange(x):
            if jax.process_count() == 1:
                return x
            try:
                out = allgather_host(x)
            finally:
                x = None
            return out
        """, """
        import torch.distributed as dist
        from photon_ml_tpu_torch.io.models import save_glm_model

        def exchange(x, path):
            if dist.get_world_size() == 1:
                return x
            try:
                dist.all_reduce(x)
            finally:
                if dist.get_rank() == 0:
                    save_glm_model(path, x)
            return x
        """, None),
    "pl004_print_in_compiled_fn": ("""
        import jax

        @jax.jit
        def step(x):
            print(x)
            return x + 1
        """, """
        import torch

        @torch.compile
        def step(x):
            print(x)
            return x + 1
        """, "torch.compile"),
    "pl004_host_clock_in_graphed_callable": ("""
        import time
        import jax

        def body(carry, x):
            return carry + x, time.time()

        def run(xs):
            return jax.lax.scan(body, 0.0, xs)
        """, """
        import time
        import torch

        def body(carry, x):
            return carry + x, time.time()

        def run(xs):
            return torch.cuda.make_graphed_callables(body, (xs, xs))
        """, "make_graphed_callables"),
    "pl004_item_and_float_under_graph_capture": ("""
        from jax import lax

        def cond(state):
            return state[0].item() > 0

        def body(state):
            return (state[0] - float(state), state[1])

        def solve(state):
            return lax.while_loop(cond, body, state)
        """, """
        import torch

        def cond(state):
            return state[0].item() > 0

        def body(state):
            return (state[0] - float(state), state[1])

        def solve(g, state):
            with torch.cuda.graph(g):
                return body(state) if cond(state) else state
        """, "torch.cuda.graph"),
    "pl004_host_work_outside_region_silent": ("""
        import numpy as np
        import jax

        def host_sweep(w):
            return np.asarray(w).sum()

        @jax.jit
        def value(w):
            return jax.pure_callback(host_sweep, w.dtype, w)
        """, """
        import numpy as np
        import torch

        def host_sweep(w):
            return np.asarray(w).sum()

        @torch.compile
        def value(w):
            return (w * w).sum()
        """, None),
    "pl004_untraced_host_ops_silent": ("""
        import time
        import numpy as np

        def bench(fn, x):
            t0 = time.perf_counter()
            out = np.asarray(fn(x))
            print(out)
            return time.perf_counter() - t0
        """, """
        import time
        import numpy as np

        def bench(fn, x):
            t0 = time.perf_counter()
            out = np.asarray(fn(x).cpu())
            print(out.item())
            return time.perf_counter() - t0
        """, None),
}

# torch-only shapes with no JAX twin: (code, expected (rule, line) list)
TORCH_ONLY = {
    "pl004_compile_call_form_and_tolist": ("""
        import torch

        def step(x):
            return x.tolist()

        fast = torch.compile(step, mode="reduce-overhead")
        """, [("PL004", 5)]),
    "pl004_replay_then_read_silent": ("""
        import re
        import torch

        PATTERN = re.compile("x")

        def run(g, static_in, x):
            with torch.cuda.graph(g):
                y = static_in * 2
            static_in.copy_(x)
            g.replay()
            return y.sum().item(), y.cpu().numpy()
        """, []),
    "pl004_capture_body_reads": ("""
        import numpy as np
        import torch

        def capture(g, model, x, n):
            with torch.cuda.stream(torch.cuda.Stream()), torch.cuda.graph(g):
                y = model(x)
                k = int(n)
                host = np.asarray(y)
            return y, k, host
        """, [("PL004", 8), ("PL004", 9)]),
    "pl001_rank_conditional_expression": ("""
        import torch.distributed as dist

        def gather(x, out):
            return dist.all_gather(out, x) if dist.get_rank() else None
        """, [("PL001", 5)]),
    "pl001_rank_zero_write_silent": ("""
        import torch.distributed as dist

        def save(model, path, write):
            dist.barrier()
            if dist.get_rank() == 0:
                write(model, path)
            dist.barrier()
        """, []),
}


@pytest.mark.parametrize("case", sorted(TORCH_FORMS))
def test_torch_form_flags_the_jax_lines(case, tmp_path):
    jax_code, torch_code, needle = TORCH_FORMS[case]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = lint_files(PKGS["jax"], tmp_path / "jax", {"snippet.py": jax_code})
    got = lint_files(PKGS["port"], tmp_path / "port", {"snippet.py": torch_code})
    assert located(got) == located(want)
    if needle is None:
        assert got.findings == []
    else:
        assert got.findings, case
        assert all(needle in f.message for f in got.findings), [
            f.message for f in got.findings]


@pytest.mark.parametrize("case", sorted(TORCH_ONLY))
def test_torch_only_shapes(case, tmp_path):
    code, want = TORCH_ONLY[case]
    got = lint_files(PKGS["port"], tmp_path, {"snippet.py": code})
    assert [(f.rule, f.line) for f in got.findings] == want


# ---------------------------------------------------------------------------
# the baseline's matching logic, both packages on the same findings
# ---------------------------------------------------------------------------


def _finding(pkg, rule="PL007", path="pkg/a.py", line=3, text="except Exception:"):
    return pkg.core.Finding(rule=rule, path=path, line=line, col=0, severity="warning",
                            message="m", hint="h", text=text)


def _entry(pkg, *args):
    return pkg.analysis.BaselineEntry(*args)


def _entries(pkg, *rows):
    return pkg.analysis.Baseline([_entry(pkg, *r) for r in rows])


A = ("PL007", "pkg/a.py", 3, "except Exception:")
GONE = ("PL007", "pkg/gone.py", 9, "except OSError:")


def _split(pkg, base, findings):
    new, old, stale = base.split(findings)
    return ([(f.path, f.line) for f in new], [(f.path, f.line) for f in old],
            [e.path for e in stale])


BASELINE_CASES = {
    "split_new_grandfathered_stale": (
        lambda p: _split(p, _entries(p, A, GONE), [_finding(p), _finding(p, path="pkg/b.py")]),
        ([("pkg/b.py", 3)], [("pkg/a.py", 3)], ["pkg/gone.py"])),
    "line_drift_does_not_resurrect": (
        lambda p: _split(p, _entries(p, A), [_finding(p, line=40)]),
        ([], [("pkg/a.py", 40)], [])),
    "multiset_semantics": (
        lambda p: _split(p, _entries(p, A), [_finding(p, line=3), _finding(p, line=30)]),
        ([("pkg/a.py", 30)], [("pkg/a.py", 3)], [])),
    "prune_drops_stale_keeps_matched": (
        lambda p: [e.to_json() for e in _entries(p, A, GONE).pruned([_finding(p, line=17)]).entries],
        [{"rule": "PL007", "path": "pkg/a.py", "line": 17, "text": "except Exception:"}]),
    "from_findings_refuses_policy_rules": (
        lambda p: [e.rule for e in p.analysis.Baseline.from_findings(
            [_finding(p, rule=r) for r in ALL_RULES]).entries],
        ["PL004", "PL005", "PL006", "PL007"]),
}


@pytest.mark.parametrize("case", sorted(BASELINE_CASES))
def test_baseline_parity(case):
    fn, want = BASELINE_CASES[case]
    got = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"] == want


def test_baseline_save_load_roundtrip_matches_jax(tmp_path):
    docs = {}
    for name, pkg in PKGS.items():
        path = str(tmp_path / f"{name}.json")
        base = _entries(pkg, A, GONE)
        base.save(path)
        loaded = pkg.analysis.Baseline.load(path)
        assert [e.to_json() for e in loaded.entries] == [e.to_json() for e in base.entries]
        assert pkg.analysis.Baseline.load(str(tmp_path / "missing.json")).entries == []
        docs[name] = (tmp_path / f"{name}.json").read_text()
    assert docs["port"] == docs["jax"]
    (tmp_path / "bad.json").write_text("[]")
    with pytest.raises(ValueError):
        port_analysis.Baseline.load(str(tmp_path / "bad.json"))


# ---------------------------------------------------------------------------
# the CLI: exit codes, JSON and messages against the JAX CLI
# ---------------------------------------------------------------------------


def _cli(pkg, argv, capsys):
    try:
        pkg.lint.main(argv)
        rc = 0
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def _cli_tree(tmp_path, name, code):
    pkg = tmp_path / name
    pkg.mkdir(parents=True, exist_ok=True)
    (pkg / "mod.py").write_text(code)
    return str(pkg)


def test_cli_exit_codes_and_json_match_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    outs = {}
    for name, pkg in PKGS.items():
        root = tmp_path / name
        bad = _cli_tree(root, "pkg", f"from {pkg.name}.resilience.faults import fire\n"
                                     "def probe():\n"
                                     '    fire("made.up.site")\n')
        base = str(root / "baseline.json")
        rc, out, _ = _cli(pkg, ["check", bad, "--json", "--baseline", base], capsys)
        doc = json.loads(out)
        # the policy rule cannot be grandfathered
        rc_b, _, err_b = _cli(pkg, ["baseline", bad, "--baseline", base], capsys)
        # a PL007 can; fixing it leaves a stale entry that --prune drops
        (root / "pkg" / "mod.py").write_text(
            "def read(path):\n    try:\n        return open(path).read()\n"
            "    except Exception:\n        pass\n")
        rc_g, _, _ = _cli(pkg, ["baseline", bad, "--baseline", base], capsys)
        rc_c, out_c, _ = _cli(pkg, ["check", bad, "--baseline", base], capsys)
        (root / "pkg" / "mod.py").write_text("def read(path):\n    return 1\n")
        rc_s, out_s, _ = _cli(pkg, ["check", bad, "--json", "--baseline", base], capsys)
        stale = json.loads(out_s)["stale_baseline_entries"]
        rc_p, _, _ = _cli(pkg, ["baseline", bad, "--prune", "--baseline", base], capsys)
        with open(base) as f:
            pruned = json.load(f)["entries"]
        rc_m, _, err_m = _cli(pkg, ["check", str(root / "nosuch_dir")], capsys)
        outs[name] = {
            "check": (rc, [(f["rule"], f["path"], f["line"], f["severity"], f["text"])
                           for f in doc["new"]],
                      {k: doc[k] for k in ("files", "findings_total", "grandfathered",
                                           "stale_baseline_entries", "suppressed",
                                           "bare_suppressions")}),
            "baseline_refused": (rc_b, "REFUSING" in err_b),
            "grandfathered": (rc_g, rc_c, "1 baselined" in out_c),
            "stale": (rc_s, stale), "pruned": (rc_p, pruned),
            "missing_path": (rc_m, "no such path" in err_m),
        }
    assert outs["port"] == outs["jax"]
    assert outs["port"]["check"][0] == 1
    assert outs["port"]["check"][1] == [("PL003", "pkg/mod.py", 3, "error",
                                         'fire("made.up.site")')]
    assert outs["port"]["baseline_refused"] == (1, True)
    assert outs["port"]["grandfathered"] == (0, 0, True)
    assert outs["port"]["pruned"] == (0, [])
    assert outs["port"]["missing_path"] == (2, True)


def test_cli_explain(capsys):
    rc, out, _ = _cli(PKGS["port"], ["explain", "PL001", "PL004"], capsys)
    assert rc == 0
    assert "spmd-collective-divergence" in out and "PR 11" in out
    assert "torch.distributed" in out and "CUDA graph" in out
    rc, _, err = _cli(PKGS["port"], ["explain", "PL999"], capsys)
    assert rc == 2 and "unknown rule" in err


# ---------------------------------------------------------------------------
# the self-hosting gate + seeded-violation sweep over the port
# ---------------------------------------------------------------------------


def run_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.lint", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_tree_is_clean():
    """photon-lint over the port's tree exits 0: every finding fixed,
    suppressed with a reason, or in the port's committed baseline."""
    proc = run_cli(["check", "photon_ml_tpu_torch", "--json"], cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["new"] == []
    assert doc["stale_baseline_entries"] == []
    assert doc["bare_suppressions"] == []
    assert doc["files"] > 50


def test_empty_baseline_policy_rules():
    """The port's baseline holds only its own tree's findings, none of
    the empty-by-policy rules, and paths under photon_ml_tpu_torch/."""
    assert port_analysis.EMPTY_BASELINE_RULES == jax_analysis.EMPTY_BASELINE_RULES
    path = port_analysis.default_baseline_path()
    assert os.path.dirname(path) == os.path.join(PACKAGE, "analysis")
    base = port_analysis.Baseline.load(path)
    assert base.entries, "committed baseline should exist and be non-empty"
    assert [e for e in base.entries if e.rule in port_analysis.EMPTY_BASELINE_RULES] == []
    assert all(e.path.startswith("photon_ml_tpu_torch/") for e in base.entries)


def test_rule_catalog_is_complete():
    catalog = port_analysis.rule_catalog()
    assert tuple(r.id for r in catalog) == ALL_RULES
    jax_catalog = {r.id: r for r in jax_analysis.rule_catalog()}
    for r in catalog:
        assert r.origin, f"{r.id} must tell its origin story"
        assert r.hint, f"{r.id} must say how to fix"
        assert (r.name, r.severity) == (jax_catalog[r.id].name, jax_catalog[r.id].severity)


SEEDS = {
    "PL001": (
        "import torch.distributed as dist\n"
        "def boundary(x):\n"
        "    try:\n"
        "        x = x + 1\n"
        "    except Exception:\n"
        "        dist.all_reduce(x)\n",
        6,
    ),
    "PL002": (
        "def classify(exc):\n"
        '    return type(exc).__name__ == "CollectiveTimeout"\n',
        2,
    ),
    "PL003": (
        "from photon_ml_tpu_torch.resilience.faults import fire\n"
        "def probe():\n"
        '    fire("serving.scoer")\n',
        3,
    ),
    "PL004": (
        "import torch\n"
        "@torch.compile\n"
        "def step(x):\n"
        "    print(x)\n"
        "    return x + 1\n",
        4,
    ),
    "PL005": (
        "from photon_ml_tpu_torch.io.native import NativeAvroReader\n"
        "def leak(prog, desc, vocab):\n"
        "    reader = NativeAvroReader(prog, desc, vocab, ())\n"
        "    return reader.num_records\n",
        3,
    ),
    "PL006": (
        "from photon_ml_tpu_torch import obs\n"
        "def record():\n"
        '    obs.registry().inc("sevring.requests")\n',
        3,
    ),
    "PL007": (
        "def read(path):\n"
        "    try:\n"
        "        return open(path).read()\n"
        "    except Exception:\n"
        "        pass\n",
        4,
    ),
    "PL008": (
        "import threading\n"
        "def handle(request, trace):\n"
        "    threading.Thread(target=request).start()\n",
        3,
    ),
}


def test_seeded_violations_fail_scratch_copy(tmp_path):
    """A copy of photon_ml_tpu_torch/ (only) with one seeded violation of
    EACH rule: photon-lint exits 1 naming every rule at its file:line, and
    nothing else of the copy is new under the committed baseline."""
    scratch = tmp_path / "photon_ml_tpu_torch"
    shutil.copytree(
        PACKAGE, scratch,
        ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "_build", "*.so"),
    )
    for rule, (code, _) in SEEDS.items():
        (scratch / f"seed_{rule.lower()}.py").write_text(code)
    proc = run_cli(
        ["check", "photon_ml_tpu_torch", "--json", "--baseline",
         port_analysis.default_baseline_path()],
        cwd=str(tmp_path),
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    found = {(f["rule"], f["path"], f["line"]) for f in doc["new"]}
    for rule, (_, line) in SEEDS.items():
        expected = (rule, f"photon_ml_tpu_torch/seed_{rule.lower()}.py", line)
        assert expected in found, f"{rule} not found at {expected}; got {sorted(found)}"
    assert len(found) == len(SEEDS)


def test_full_tree_lint_is_fast():
    """The gate stays cheap enough for tier-1: the port's whole tree in
    under 30 s here."""
    result = port_analysis.Analyzer(base=REPO_ROOT).run([PACKAGE])
    assert result.wall_s < 30.0
    assert result.files > 50
