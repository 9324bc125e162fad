"""The port's observability layer (``photon_ml_tpu_torch.obs`` and
``utils.debug``) against the JAX package's, on the CPU: the stdlib copies
(``obs.dist``'s shard merges, the taxonomy, the flight recorder, the
collective keys and records) on the same inputs; ``observe`` (all-None a
no-op, ``trace_dir``'s three files, ``metrics_every`` on schedule with a
final dump, ``flight-crash.json`` on an exception, ``profile_dir``'s
Chrome trace); ``debug_nans`` on the JAX package's own case; the cost
book (no share off an H100, the H100's peaks by dtype on one); kernel
launch counting, the build counter and the HBM sampler off CUDA.
"""

import glob
import importlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu import obs as jax_obs
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.kernels import dispatch, launch
from photon_ml_tpu_torch.utils import debug as port_debug
from torch_obs_hygiene import clean_obs  # noqa: F401

pytestmark = [pytest.mark.obs, pytest.mark.usefixtures("clean_obs")]

jax_dist = importlib.import_module("photon_ml_tpu.obs.dist")
port_dist = importlib.import_module("photon_ml_tpu_torch.obs.dist")
port_flight = importlib.import_module("photon_ml_tpu_torch.obs.flight")


# ---------------------------------------------------------------------------
# obs.dist: identity and the shard merges
# ---------------------------------------------------------------------------


def _shard(index, count, epoch, sync_ts, events, sync_id="startup"):
    evs = [{"ph": "M", "name": "process_name", "pid": 99, "tid": 0, "ts": 0,
            "args": {"name": f"photon_ml_tpu_torch host.{index}"}}]
    if sync_ts is not None:
        evs.append({"ph": "i", "name": "clock.sync", "pid": 99, "tid": 1, "ts": sync_ts,
                    "s": "p", "args": {"sync_id": sync_id}})
    evs += events
    return {"traceEvents": evs, "displayTimeUnit": "ms",
            "metadata": {"process_index": index, "process_count": count,
                         "epoch_unix": epoch}}


def _events(rng, n, name="game.update"):
    return [{"ph": "X", "name": name, "pid": 99, "tid": 1, "ts": float(t),
             "dur": float(d), "cat": "game", "args": {"iteration": int(i)}}
            for i, (t, d) in enumerate(zip(np.sort(rng.uniform(0, 1e6, n)),
                                           rng.uniform(1, 500, n)))]


@pytest.mark.parametrize("case", ["sync", "epoch", "partial_sync", "duplicates", "empty"])
def test_merge_trace_shards_matches_jax(case):
    rng = np.random.default_rng(11)
    a = _shard(0, 2, 1000.0, 500.0, _events(rng, 20))
    b = _shard(1, 2, 1000.25, 120.0, _events(rng, 15, "glm.solve"))
    if case == "epoch":
        a = _shard(0, 2, 1000.0, None, _events(rng, 20))
        b = _shard(1, 2, 1000.25, None, _events(rng, 15))
    elif case == "partial_sync":
        b = _shard(1, 3, 1000.5, None, _events(rng, 15))
    elif case == "duplicates":
        b = json.loads(json.dumps(a))
        b["metadata"]["process_index"] = 1
        a["traceEvents"] += a["traceEvents"][3:6]
    shards = [] if case == "empty" else [(a, "a.json"), (b, "b.json")]
    assert obs.merge_trace_shards(shards) == jax_obs.merge_trace_shards(shards)


def test_merge_events_and_metrics_shards_match_jax(tmp_path):
    paths = []
    for idx in range(2):
        path = tmp_path / f"events-{idx}.jsonl"
        lines = [json.dumps({"kind": "event", "name": "clock.sync", "time_unix": 5.0 + idx})]
        lines += [json.dumps({"kind": "span", "name": "game.pass", "time_unix": 3.0 * idx + i,
                              "duration_ms": 1.5}) for i in range(4)]
        lines.insert(2, '{"torn": ')
        path.write_text("\n".join(lines) + "\n")
        paths.append((str(path), idx))
    paths.append((str(tmp_path / "missing.jsonl"), 2))
    assert port_dist.merge_events_shards(paths) == jax_dist.merge_events_shards(paths)
    snaps = [({"counters": {"collective.value_grad.w2.count": 3.0 + i, "game.passes": 2.0},
               "gauges": {"game.objective": 1.5 * i}, "histograms": {"game.pass_ms": {"n": 2}}},
              i) for i in range(2)]
    assert port_dist.merge_metrics_shards(snaps) == jax_dist.merge_metrics_shards(snaps)


def test_identity_and_clock_sync_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_PROCESS_INDEX", "1")
    monkeypatch.setenv("PHOTON_PROCESS_COUNT", "3")
    assert obs.process_identity() == jax_obs.process_identity() == (1, 3)
    assert obs.host_metric_prefix() == jax_obs.host_metric_prefix() == "host.1."
    obs.set_process_identity(0, 2)
    assert obs.process_identity() == (0, 2) and obs.host_metric_prefix() == "host.0."
    with pytest.raises(ValueError):
        obs.set_process_identity(2, 2)
    docs = []
    for o, d in ((jax_obs, "jax"), (obs, "port")):
        with o.trace(str(tmp_path / d)):
            o.emit_clock_sync(sync_id="x")
        with open(tmp_path / d / "trace.json") as f:
            docs.append(json.load(f))
    syncs = [[{k: v for k, v in e["args"].items() if k != "unix_time"}
              for e in doc["traceEvents"] if e["name"] == "clock.sync"] for doc in docs]
    assert syncs[1] == [{"sync_id": "x", "process_index": 0, "process_count": 2}]
    port_dist.reset_process_identity()
    assert obs.process_identity() == (1, 3)


# ---------------------------------------------------------------------------
# the taxonomy
# ---------------------------------------------------------------------------

# every metric, span and event name this slice adds to the port (the
# drivers' own and the layer's), with the dynamic parts filled in
SLICE_NAMES = [
    "kernels.builds", "kernels.launch_plans", "kernels.build", "kernels.launch_plan",
    "kernels.cost_record", "kernels.cost.glm.objective_pass.300x8x41.float64.flops",
    "kernels.cost.glm.objective_pass.300x41.float32.roofline_bytes",
    "collective.value_grad.w2.count", "collective.hvp.w4.bytes",
    "collective.allgather_host.w2.wall_ms", "collective.gather.w2.wall_frac",
    "hbm.d0.bytes_in_use", "hbm.d0.peak_bytes_in_use", "hbm.d0.bytes_reserved", "hbm.d0",
    "game.updates", "game.passes", "game.pass_ms", "game.update_ms", "game.objective",
    "game.solver_iterations", "game.validation_metric", "game.dispatches",
    "game.superpasses", "game.update", "game.pass", "game.superpass", "game.converged",
    "glm.solve", "glm.solve_path", "solver.tron.iterations", "solver.tron.cg_iterations",
    "solver.lbfgs.evals", "solver.owlqn.solves", "solver.newton.iterations",
    "solver.iterations", "convergence.solves", "convergence.reason.MAX_ITERATIONS",
    "convergence.iters", "convergence.nonconverged", "convergence.rate",
    "convergence.per_user.median_iters", "convergence.solve", "convergence.fleet",
    "convergence.precursor", "convergence.precursors", "resilience.preemptions",
    "resilience.preemption_requested", "resilience.rollback", "resilience.rollbacks",
    "resilience.freeze", "resilience.frozen_coordinates", "resilience.superpass_guard",
    "clock.sync", "pod.collective.value_grad.w2.count", "host.1.game.passes",
]


def _probe_names():
    """Names that exercise every taxonomy entry: each pattern's subsystem
    with a few leaves, and some that match nothing."""
    names = list(SLICE_NAMES)
    for sub, _, _ in jax_obs.taxonomy.TAXONOMY:
        names += [sub, f"{sub}.x", f"{sub}.a_b", f"{sub}.a.b.c", f"{sub}.A", f"{sub}.1.x"]
    return names + ["sevring.request_ms", "glm.solve.inner", "preprocess", "", "xla.cost.a"]


def test_taxonomy_matches_jax():
    port_tax = importlib.import_module("photon_ml_tpu_torch.obs.taxonomy")
    jax_tax = jax_obs.taxonomy
    assert [(s, p) for s, p, _ in port_tax.TAXONOMY] == [(s, p) for s, p, _ in jax_tax.TAXONOMY]
    assert port_tax.subsystems() == jax_tax.subsystems()
    for name in _probe_names():
        assert port_tax.matches(name) == jax_tax.matches(name), name
        assert port_tax.subsystem_of(name) == jax_tax.subsystem_of(name), name
        assert port_tax.valid_prefix(name) == jax_tax.valid_prefix(name), name
    assert [n for n in SLICE_NAMES if not port_tax.matches(n)] == []


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def _strip_times(doc):
    if isinstance(doc, dict):
        return {k: _strip_times(v) for k, v in doc.items()
                if k not in ("time_unix", "pid", "ts", "dur", "duration_ms")}
    if isinstance(doc, list):
        return [_strip_times(v) for v in doc]
    return doc


def _fly(o, tmp_path, tag):
    reg = o.MetricsRegistry()
    prev = o.set_registry(reg)
    try:
        # the ring-only tracer observe installs with a flight_dir alone
        tracer = o.Tracer(None, process_name="p", keep_events=False)
        prev_tracer = o.set_tracer(tracer)
        rec = o.install_flight_recorder(capacity=6, flight_dir=str(tmp_path / tag))
        assert o.flight_recorder() is rec and tracer.recorder is rec
        for i in range(5):
            with o.span("game.update", cat="game", iteration=i):
                reg.inc("game.updates")
            o.emit_event("resilience.rollback", cat="resilience", iteration=i)
        reg.inc("resilience.rollbacks", 2)
        paths = [o.flight_dump("divergence"), o.flight_dump("divergence")]
        o.uninstall_flight_recorder()
        assert o.flight_dump("divergence") is None and tracer.recorder is None
        o.set_tracer(prev_tracer)
    finally:
        o.set_registry(prev)
    docs = []
    for p in paths:
        with open(p) as f:
            docs.append(json.load(f))
    return [os.path.basename(p) for p in paths], docs


def test_flight_dumps_match_jax_timestamps_aside(tmp_path):
    jnames, jdocs = _fly(jax_obs, tmp_path, "jax")
    pnames, pdocs = _fly(obs, tmp_path, "port")
    assert pnames == jnames == ["flight-divergence.json", "flight-divergence-2.json"]
    assert _strip_times(pdocs) == _strip_times(jdocs)
    assert pdocs[0]["records_dropped"] > 0 and pdocs[0]["capacity"] == 6


def test_crash_excepthook_dumps_and_restores(tmp_path):
    hook = sys.excepthook
    seen = []
    sys.excepthook = lambda *a: seen.append(a[0])
    try:
        rec = obs.install_flight_recorder(flight_dir=str(tmp_path))
        assert sys.excepthook is port_flight._crash_excepthook
        try:
            raise KeyError("boom")
        except KeyError:
            sys.excepthook(*sys.exc_info())
        assert seen == [KeyError]
        with open(tmp_path / "flight-crash.json") as f:
            doc = json.load(f)
        assert doc["records"][-1]["exception"] == "KeyError: 'boom'"
        assert rec is not None
        obs.uninstall_flight_recorder()
        assert sys.excepthook is not port_flight._crash_excepthook
    finally:
        sys.excepthook = hook


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def test_collective_records_match_jax():
    snaps = []
    for o in (jax_obs, obs):
        c = o.collectives
        assert c.collective_metric_key("value_grad", 2) == "collective.value_grad.w2"
        reg = o.MetricsRegistry()
        c.record_collective("value_grad", mesh_width=2, nbytes=80, registry=reg)
        c.record_collective("value_grad", mesh_width=2, count=3, nbytes=0, wall_s=0.002,
                            registry=reg)
        frac = c.record_collective_share("hvp", 4, 0.25, 1.0, registry=reg)
        assert frac == 0.25
        snaps.append({k: v for k, v in reg.snapshot().items() if k != "histograms"})
    assert snaps[1] == snaps[0]
    for name in ("value_grad", "hvp", "gather"):
        for w in (1, 2, 8):
            assert obs.collectives.collective_metric_key(name, w) == \
                jax_obs.collectives.collective_metric_key(name, w)
    t = [torch.zeros(3), {"a": torch.zeros((2, 2), dtype=torch.float64)}, 5]
    assert obs.collectives.tree_bytes(t) == 12 + 32


def test_collective_span_records_blocked_wall(tmp_path):
    reg = obs.MetricsRegistry()
    with obs.trace(str(tmp_path)):
        with obs.collective_span("allgather_host", mesh_width=2, nbytes=64, registry=reg):
            time.sleep(0.002)
    snap = reg.snapshot()
    assert snap["counters"]["collective.allgather_host.w2.count"] == 1.0
    assert snap["counters"]["collective.allgather_host.w2.bytes"] == 64.0
    assert snap["histograms"]["collective.allgather_host.w2.wall_ms"]["count"] == 1
    with open(tmp_path / "trace.json") as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    assert "collective.allgather_host" in names


# ---------------------------------------------------------------------------
# observe
# ---------------------------------------------------------------------------


def test_observe_all_none_is_a_noop(tmp_path):
    before = (obs.get_tracer(), obs.flight_recorder(), sys.excepthook, sorted(os.listdir(tmp_path)))
    with obs.observe():
        assert obs.get_tracer() is None and obs.flight_recorder() is None
        with obs.span("glm.solve") as sp:
            sp.set(x=1)
    assert (obs.get_tracer(), obs.flight_recorder(), sys.excepthook,
            sorted(os.listdir(tmp_path))) == before


def test_observe_trace_dir_writes_three_files_like_jax(tmp_path):
    """trace.json, events.jsonl and metrics.json, as the JAX envelope
    writes them, with the same span and event names."""
    names = {}
    for o, tag in ((jax_obs, "jax"), (obs, "port")):
        d = tmp_path / tag
        with o.observe(trace_dir=str(d)):
            assert o.get_tracer() is not None and o.flight_recorder() is not None
            with o.span("glm.solve", cat="solver", reg_weight=1.0):
                o.registry().inc("solver.iterations", 3)
            o.emit_event("resilience.rollback", cat="resilience")
        assert sorted(os.listdir(d)) == ["events.jsonl", "metrics.json", "trace.json"]
        assert o.get_tracer() is None and o.flight_recorder() is None
        with open(d / "trace.json") as f:
            names[tag] = sorted({e["name"] for e in json.load(f)["traceEvents"]
                                 if e["ph"] != "M"})
        with open(d / "metrics.json") as f:
            assert json.load(f)["counters"]["solver.iterations"] == 3.0
    assert names["port"] == names["jax"]


def test_observe_metrics_every_dumps_on_schedule(tmp_path):
    path = str(tmp_path / "m" / "metrics.json")
    seen = []
    with obs.observe(metrics_path=path, metrics_every=0.02):
        assert obs.get_tracer() is None
        obs.registry().inc("game.passes")
        deadline = time.monotonic() + 10
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.005)
        with open(path) as f:
            seen.append(json.load(f)["counters"].get("game.passes"))
        obs.registry().inc("game.passes", 4)
    with open(path) as f:
        final = json.load(f)["counters"]["game.passes"]
    assert seen == [1.0] and final == 5.0


def test_observe_exception_writes_flight_crash(tmp_path):
    flight = tmp_path / "flight"
    with pytest.raises(ZeroDivisionError):
        with obs.observe(flight_dir=str(flight)):
            assert obs.get_tracer() is not None  # the ring-only tracer
            with obs.span("game.update", coordinate="global"):
                pass
            1 / 0
    with open(flight / "flight-crash.json") as f:
        doc = json.load(f)
    assert doc["reason"] == "crash"
    names = [r.get("name") for r in doc["records"]]
    assert "game.update" in names and names[-1] == "crash"
    assert doc["records"][-1]["exception"].startswith("ZeroDivisionError")
    assert obs.get_tracer() is None and obs.flight_recorder() is None
    # a deliberate exit is no crash
    with pytest.raises(SystemExit):
        with obs.observe(flight_dir=str(tmp_path / "exit")):
            raise SystemExit(0)
    assert not os.path.exists(tmp_path / "exit" / "flight-crash.json")


def test_observe_profile_dir_writes_a_chrome_trace(tmp_path):
    with obs.observe(profile_dir=str(tmp_path / "prof"), device="cpu"):
        torch.ones(64).cumsum(0)
        with pytest.raises(RuntimeError, match="one profile"):
            with port_debug.profile_trace(str(tmp_path / "inner")):
                pass
    (path,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert any("cumsum" in str(e.get("name", "")) for e in doc["traceEvents"])
    # a window may open again once the first is closed
    with port_debug.profile_trace(str(tmp_path / "again"), device="cpu"):
        pass
    assert glob.glob(str(tmp_path / "again" / "*.pt.trace.json"))


# ---------------------------------------------------------------------------
# debug
# ---------------------------------------------------------------------------


def test_debug_nans_raises_at_the_producer_like_jax():
    import jax
    import jax.numpy as jnp

    from photon_ml_tpu.utils.debug import debug_nans as jax_debug_nans

    with jax_debug_nans(True):
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x) * 0 + jnp.sqrt(x))(jnp.asarray(-1.0))
    with port_debug.debug_nans(True):
        with pytest.raises(FloatingPointError, match="log"):
            x = torch.tensor(-1.0, dtype=torch.float64)
            torch.log(x) * 0 + torch.sqrt(x)
        # no NaN, no error; an uninitialized allocation is not a NaN
        torch.empty(1000)
        (torch.ones(3) * 2).sum()
        assert dispatch._output_check
    # off afterwards, in both packages
    assert bool(torch.isnan(torch.sqrt(torch.tensor(-1.0))))
    assert bool(jnp.isnan(jnp.sqrt(jnp.asarray(-1.0))))
    assert not dispatch._output_check
    with port_debug.debug_nans(False):
        assert bool(torch.isnan(torch.log(torch.tensor(-1.0))))


def test_debug_nans_checks_kernel_outputs():
    """A kernel launch is invisible to dispatch: the wrappers check their
    outputs themselves while the mode is on."""
    out = torch.tensor([1.0, float("nan")])
    dispatch.check_outputs("ell_matvec", out)  # off: nothing
    prev = dispatch.set_output_check(True)
    try:
        with pytest.raises(FloatingPointError, match="ell_matvec"):
            dispatch.check_outputs("ell_matvec", out)
        dispatch.check_outputs("ell_matvec", torch.ones(3), torch.arange(3))
    finally:
        dispatch.set_output_check(prev)


def test_assert_all_finite_names_the_path_like_jax():
    import jax.numpy as jnp

    from photon_ml_tpu.utils.debug import assert_all_finite as jax_finite

    port_debug.assert_all_finite({"a": torch.ones(3), "b": [torch.zeros(2)], "c": None}, "m")
    bad = {"a": torch.ones(3), "b": [torch.tensor([1.0, float("nan")])]}
    with pytest.raises(FloatingPointError, match=r"model\['b'\]\[0\]: 1 non-finite"):
        port_debug.assert_all_finite(bad, "model")
    with pytest.raises(FloatingPointError, match=r"model\['b'\]\[0\]: 1 non-finite"):
        jax_finite({"a": jnp.ones(3), "b": [jnp.asarray([1.0, float("nan")])]}, "model")


# ---------------------------------------------------------------------------
# the cost book
# ---------------------------------------------------------------------------


def test_cost_book_gives_no_share_off_an_h100(monkeypatch):
    from photon_ml_tpu_torch.obs import cost

    rec = obs.CostRecord(name="glm.objective_pass", bucket="b", flops=4e9,
                         bytes_accessed=2e9, roofline_bytes=1e9, dtype="float64")
    got = rec.achieved(0.5, passes=3)
    assert got == {"flops": 1.2e10, "achieved_tflops": 0.024, "bytes_per_s": 6e9}
    assert cost.peaks_for("cpu", torch.float64) == (None, None)
    # a card of another name: no share either
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: "NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(cost, "_peaks_cache", {})
    assert cost.peaks_for("cuda:0", torch.float32) == (None, None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(cost, "_peaks_cache", {})
    assert cost.peaks_for("cuda:0", torch.float32) == (67e12, 3.35e12)
    assert cost.peaks_for("cuda:0", torch.float64) == (34e12, 3.35e12)

    class Span:
        args = {}

        def set(self, **kw):
            self.args.update(kw)

    sp = Span()
    obs.annotate_span(sp, rec, seconds=0.5, passes=3, device="cuda:0")
    assert sp.args["mfu"] == pytest.approx(1.2e10 / 0.5 / 34e12, rel=1e-3)
    assert sp.args["hbm_util"] == pytest.approx(6e9 / 3.35e12, rel=1e-3)
    assert "H100" in cost.__doc__ and "700 W" in cost.__doc__


def test_pass_record_reads_the_kernel_cost_and_dense_count():
    from photon_ml_tpu_torch.obs.cost import pass_record
    from photon_ml_tpu_torch.ops.sparse import SparseFeatures

    n, k, d = 50, 6, 30
    g = torch.Generator().manual_seed(5)
    x = SparseFeatures(indices=torch.randint(0, d, (n, k), generator=g, dtype=torch.int32),
                       values=torch.randn(n, k, generator=g, dtype=torch.float64), d=d)
    assert pass_record(x, torch.float64) is None  # no pass yet, no record
    dispatch.record_kernel_cost("fused_vgc", n, k, d, 8, flops_per_slot=4.0, extra_bytes=7.0)
    rec = pass_record(x, torch.float64)
    assert rec.flops == 4.0 * n * k and rec.roofline_bytes == n * k * 12.0
    assert rec.dtype == "float64"
    assert obs.cost_book().lookup("glm.objective_pass", rec.bucket) is rec
    dense = pass_record(torch.zeros((n, d), dtype=torch.float32), torch.float32)
    assert dense.flops == 4.0 * n * d and dense.roofline_bytes == n * d * 4.0
    assert sorted(obs.cost_book().snapshot()) == sorted(
        f"glm.objective_pass.{b}" for b in (rec.bucket, dense.bucket))


# ---------------------------------------------------------------------------
# kernel launches, builds, device memory
# ---------------------------------------------------------------------------


def test_count_dispatches_counts_launches_by_kernel():
    with obs.count_dispatches() as outer:
        dispatch.count_launch("fused_vgc")
        with obs.count_dispatches() as inner:
            dispatch.count_launch("fused_hvp")
            dispatch.count_launch("fused_hvp")
        dispatch.count_launch("colsort_reduce")
        assert outer.for_program("fused_*") == 3
    assert inner.snapshot() == {"fused_hvp": 2}
    assert outer.snapshot() == {"fused_vgc": 1, "fused_hvp": 2, "colsort_reduce": 1}
    outer.assert_program("fused_hvp", 2)
    with pytest.raises(AssertionError, match="expected 1"):
        inner.assert_program("fused_hvp", 1)
    with obs.count_dispatches() as none:
        torch.ones(3).sum()
    assert none.total() == 0


def test_build_counter_counts_launch_plans(tmp_path):
    from photon_ml_tpu_torch.kernels.ell import ell_matvec

    before = obs.kernel_build_events()["launch_plans"]
    g = torch.Generator().manual_seed(2)
    idx = torch.randint(0, 9, (7, 3), generator=g, dtype=torch.int32)
    vals = torch.randn(7, 3, generator=g, dtype=torch.float64)
    with obs.trace(str(tmp_path)):
        for d in (9, 9, 10):
            ell_matvec(idx, vals, torch.ones(d, dtype=torch.float64), d)
    assert obs.kernel_build_events()["launch_plans"] - before == 2
    assert obs.registry().snapshot()["counters"]["kernels.launch_plans"] == 2.0
    with open(tmp_path / "trace.json") as f:
        plans = [e for e in json.load(f)["traceEvents"] if e["name"] == "kernels.launch_plan"]
    assert [e["args"]["kernel"] for e in plans] == ["ell_matvec", "ell_matvec"]
    plans_dict = {}
    launch.keep("ell_matvec", plans_dict, ("k",), launch.PLAIN)
    assert plans_dict == {("k",): launch.PLAIN}


def test_hbm_sampler_is_a_noop_off_cuda(monkeypatch):
    from photon_ml_tpu_torch.obs import device as dev

    assert obs.sample_hbm() == {} or torch.cuda.is_available()
    assert obs.sample_hbm(device="cpu") == {}
    assert not obs.hbm_supported("cpu")
    sampler = obs.HbmSampler(0.01, device="cpu").start()
    assert sampler._thread is None
    sampler.stop()
    # a scripted card: gauges and a counter track per sample, the device
    # passed to every read (never the sampler thread's current device)
    reads = []
    monkeypatch.setattr(dev, "_devices", lambda device=None: [torch.device("cuda", 3)])
    monkeypatch.setattr(dev, "read_memory_stats", lambda device=None: reads.append(device) or {
        "bytes_in_use": 10, "peak_bytes_in_use": 20, "bytes_reserved": 32})
    reg = obs.MetricsRegistry()
    assert obs.sample_hbm(registry=reg) == {
        "d3": {"bytes_in_use": 10, "peak_bytes_in_use": 20, "bytes_reserved": 32}}
    assert reg.snapshot()["gauges"]["hbm.d3.bytes_reserved"] == 32
    sampler = obs.HbmSampler(0.005, registry=reg, device="cuda:3").start()
    assert sampler._thread is not None
    time.sleep(0.05)
    sampler.stop()
    assert len(reads) > 2 and {str(d) for d in reads} == {"cuda:3"}
