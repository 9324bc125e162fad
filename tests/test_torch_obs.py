"""The port's copies of the JAX package's observability modules
(``photon_ml_tpu_torch.obs``) held to the originals on the same inputs:
``MetricsRegistry`` (equal snapshots and Prometheus text),
``LatencyHistogram``, ``HistogramSketch`` (equal quantiles, merges and
summaries), the exemplar rings and ``reqtrace`` (equal contents and
timelines), and the ``Tracer`` (equal event names, categories and
arguments, timestamps aside), and the micro-batcher's request spans under
a tracer. Also ``hbm_watermark`` and ``Span.sync`` off CUDA.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu import obs as jax_obs
from photon_ml_tpu.obs import exemplars as jax_exemplars
from photon_ml_tpu.obs import metrics as jax_metrics
from photon_ml_tpu.obs import reqtrace as jax_reqtrace
from photon_ml_tpu.obs import sketches as jax_sketches
from photon_ml_tpu.serving import MicroBatcher as JaxMicroBatcher
from photon_ml_tpu_torch import obs as port_obs
from photon_ml_tpu_torch.obs import exemplars as port_exemplars
from photon_ml_tpu_torch.obs import metrics as port_metrics
from photon_ml_tpu_torch.obs import reqtrace as port_reqtrace
from photon_ml_tpu_torch.obs import sketches as port_sketches
from photon_ml_tpu_torch.serving import MicroBatcher

pytestmark = pytest.mark.obs

# the modules (each package's ``obs.trace`` attribute is the function)
jax_trace = importlib.import_module("photon_ml_tpu.obs.trace")
port_trace = importlib.import_module("photon_ml_tpu_torch.obs.trace")

BOTH = {"jax": (jax_metrics, jax_sketches, jax_exemplars, jax_reqtrace, jax_trace),
        "port": (port_metrics, port_sketches, port_exemplars, port_reqtrace, port_trace)}


def _both(case, *args):
    return tuple(case(*BOTH[p], *args) for p in ("jax", "port"))


def _latencies(seed=11, n=400):
    rng = np.random.default_rng(seed)
    return np.exp(rng.normal(0.0, 1.5, size=n)).tolist()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _fill_registry(metrics, *_):
    reg = metrics.MetricsRegistry()
    for i, ms in enumerate(_latencies()):
        reg.inc("serving.requests")
        reg.inc(f"serving.bucket.{8 << (i % 4)}", 2.0)
        reg.observe("serving.request_ms", ms)
        reg.observe(f"serving.bucket_ms.{8 << (i % 3)}", ms * 0.5)
        if i % 7 == 0:
            reg.set_gauge("serving.queue_depth", i % 13)
    reg.set_gauge("hbm.serving.warmup.peak_bytes", 123456789)
    reg.gauge("weird name-with/chars").set(-0.5)
    reg.histogram("empty_ms")
    snap = reg.snapshot()
    return reg.to_prometheus(), json.dumps(snap, sort_keys=True), reg.names("serving.bucket")


def _histogram_readout(metrics, *_):
    h = metrics.LatencyHistogram()
    for ms in _latencies(seed=3) + [0.0, 1e-9, 1e9]:
        h.record(ms)
    return ([h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)], h.snapshot(),
            [h.bucket_index(ms) for ms in (1e-4, 1.0, 55.0, 1e6)])


@pytest.mark.parametrize("case", [_fill_registry, _histogram_readout],
                         ids=lambda c: c.__name__.strip("_"))
def test_metrics_equal_jax(case):
    jax_out, port_out = _both(case)
    assert port_out == jax_out


def test_default_registry_is_process_wide():
    reg = port_metrics.MetricsRegistry()
    prev = port_obs.set_registry(reg)
    try:
        assert port_obs.registry() is reg
    finally:
        port_obs.set_registry(prev)
    assert port_obs.registry() is prev


# ---------------------------------------------------------------------------
# sketches
# ---------------------------------------------------------------------------


def _sketch_case(_m, sketches, *_):
    rng = np.random.default_rng(5)
    a = sketches.HistogramSketch.for_scores().add(rng.normal(0, 3, 500))
    b = sketches.HistogramSketch.for_scores().add(rng.normal(1, 2, 300),
                                                   weights=rng.uniform(0.5, 2, 300))
    c = sketches.HistogramSketch(lo=-1.0, hi=1.0, bins=16).add([-5.0, 0.1, 0.2, 7.0, np.nan])
    merged = sketches.HistogramSketch.from_dict(a.to_dict()).merge(b)
    return ([a.quantile(q) for q in (0.01, 0.5, 0.99)], merged.summary(),
            [merged.quantile(q) for q in (0.1, 0.5, 0.9)], merged.to_dict(), c.to_dict(),
            sketches.psi(a, b), sketches.js_divergence(a, b),
            sketches.MomentSketch().add(rng.normal(size=50)).to_dict())


def test_sketches_equal_jax():
    jax_out, port_out = _both(_sketch_case)
    assert json.dumps(port_out, default=str) == json.dumps(jax_out, default=str)


def test_merge_refuses_other_bins():
    a = port_sketches.HistogramSketch(lo=0.0, hi=1.0, bins=4)
    with pytest.raises(ValueError):
        a.merge(port_sketches.HistogramSketch(lo=0.0, hi=2.0, bins=4))


# ---------------------------------------------------------------------------
# exemplars and request traces
# ---------------------------------------------------------------------------


def _exemplar_case(_m, _s, exemplars, *_):
    st = exemplars.ExemplarStore(fast_fraction=0.1, ring_size=4, window=64)
    outcomes = ["ok"] * 17 + ["error", "expired", "shed"]
    kept = []
    for i, ms in enumerate(_latencies(seed=9, n=300)):
        kept.append(st.record(f"t{i}" if i % 11 else None, ms,
                              outcome=outcomes[i % len(outcomes)],
                              degraded=i % 23 == 0, failover=i % 31 == 0))
    return (kept, st.snapshot(), st.lookup(ge_ms=5.0), st.lookup(cls="error"),
            st.lookup(cls="slow"))


def test_exemplar_rings_equal_jax():
    jax_out, port_out = _both(_exemplar_case)
    assert port_out == jax_out


def test_exemplar_store_install():
    prev = port_exemplars.set_store(None)
    try:
        st = port_exemplars.install_store(fast_fraction=0.5)
        assert port_exemplars.store() is st and st.fast_fraction == 0.5
    finally:
        port_exemplars.set_store(prev)


def _records():
    """A JSONL stream as the tracer writes it: two batches, the request
    spans, their score spans, a cache miss and a promotion."""
    return [
        {"kind": "span", "name": "frontend.read", "trace": "a1", "duration_ms": 0.2,
         "time_unix": 1.0},
        {"kind": "span", "name": "serving.request", "trace": "a1", "batch_id": 7,
         "request_id": 7, "queue_wait_ms": 0.5, "assembly_ms": 1.0, "device_ms": 2.0,
         "wire_read_ms": 0.2, "duration_ms": 3.5, "time_unix": 1.001},
        {"kind": "span", "name": "serving.request", "trace": "b2", "batch_id": 7,
         "request_id": 8, "queue_wait_ms": 0.1, "assembly_ms": 1.0, "device_ms": 2.0,
         "duration_ms": 3.1, "time_unix": 1.002},
        {"kind": "span", "name": "serving.score", "batch_id": 7, "bucket": 8, "rows": 2,
         "duration_ms": 1.9, "time_unix": 1.0015},
        {"kind": "event", "name": "serving.cache.miss", "batch_id": 7, "re_key": "userId",
         "misses": 1, "time_unix": 1.0012},
        {"kind": "span", "name": "serving.request", "trace": "c3", "batch_id": 9,
         "request_id": 9, "error": "RuntimeError", "duration_ms": 1.0, "time_unix": 2.0},
        {"kind": "span", "name": "serving.score", "batch_id": 11, "duration_ms": 1.0,
         "time_unix": 3.0},
    ]


def _reqtrace_case(_m, _s, _e, reqtrace, *_):
    recs = _records()
    timelines = [reqtrace.reconstruct_timeline(recs, t) for t in reqtrace.trace_ids(recs)]
    with reqtrace.collect_notes() as notes:
        reqtrace.note(replica="r0", error=False)
        with reqtrace.collect_notes() as inner:
            reqtrace.note(replica="r1")
        reqtrace.note(replica="r2", error=True)
    return (reqtrace.trace_ids(recs), timelines, reqtrace.find_orphans(recs, timelines),
            reqtrace.reconstruct_timeline(recs, "zzz"), notes, inner,
            [reqtrace.valid_trace_id(x) for x in ("ok-1", "", "a" * 65, "bad id", 3)],
            reqtrace.ensure_trace_id("keep.me"))


def test_reqtrace_equal_jax():
    jax_out, port_out = _both(_reqtrace_case)
    assert port_out == jax_out
    issued, fresh = port_reqtrace.ensure_trace_id("not valid!")
    assert fresh and port_reqtrace.valid_trace_id(issued)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def _strip(ev):
    """An event without its clock and thread/process placement (and the
    measured ``device_wait_ms`` of a synced span)."""
    out = {k: v for k, v in ev.items() if k not in ("ts", "dur", "pid", "tid")}
    if "device_wait_ms" in out.get("args", {}):
        out["args"] = {k: v for k, v in out["args"].items() if k != "device_wait_ms"}
    return out


def _strip_jsonl(rec):
    return {k: v for k, v in rec.items() if k not in ("time_unix", "duration_ms")}


def _tracer_case(_m, _s, _e, _r, trace, tmp_path, sync_value):
    d = os.path.join(str(tmp_path), trace.__name__.split(".")[0])
    with trace.trace(d, process_name="photon") as tracer:
        with trace.span("train", cat="app", combo=0):
            with trace.span_context(batch_id=3, batch_size=2):
                with trace.span("serving.score", cat="serving", bucket=8) as sp:
                    sp.set(rows=2)
                    sp.sync(sync_value)
                assert trace.current_span_context() == {"batch_id": 3, "batch_size": 2}
            trace.emit_event("resilience.fault_injected", cat="resilience", site="x", call=1)
        try:
            with trace.span("doomed"):
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        tracer.add_span("serving.request", 10.0, 5.0, cat="serving", args={"request_id": 1})
        tracer.add_instant("serving.cache.miss", cat="serving", args={"misses": 2},
                           flush=False)
        tracer.add_counter("hbm", {"bytes": 4.0})
        events = [_strip(e) for e in tracer.events()]
    assert trace.get_tracer() is None
    with open(os.path.join(d, "events.jsonl")) as f:
        jsonl = [_strip_jsonl(json.loads(line)) for line in f]
    for r in jsonl:
        assert r.pop("device_wait_ms", 0.0) >= 0.0
    with open(os.path.join(d, "trace.json")) as f:
        exported = sorted(json.dumps(_strip(e), sort_keys=True)
                          for e in json.load(f)["traceEvents"])
    return events, jsonl, exported


def test_tracer_equals_jax(tmp_path):
    import jax.numpy as jnp

    jax_out = _tracer_case(*BOTH["jax"], tmp_path, jnp.ones(3))
    port_out = _tracer_case(*BOTH["port"], tmp_path, torch.ones(3))
    assert port_out == jax_out
    names = [e["name"] for e in port_out[0]]
    assert names == ["process_name", "serving.score", "resilience.fault_injected", "train",
                     "doomed", "serving.request", "serving.cache.miss", "hbm"]
    assert port_out[0][4]["args"] == {"error": True}
    assert port_out[0][1]["args"] == {"batch_id": 3, "batch_size": 2, "bucket": 8, "rows": 2}


def test_disabled_tracer_is_a_shared_no_op():
    assert port_trace.get_tracer() is None
    a, b = port_obs.span("x", k=1), port_obs.span("y")
    assert a is b
    with a as sp:
        sp.set(z=2)
        assert sp.sync(torch.ones(2)).sum() == 2
    port_obs.emit_event("nothing")  # no tracer: nothing happens


def test_process_identity_from_the_environment(monkeypatch):
    monkeypatch.setenv("PHOTON_PROCESS_INDEX", "2")
    monkeypatch.setenv("PHOTON_PROCESS_COUNT", "4")
    assert port_trace.process_identity() == jax_obs.process_identity() == (2, 4)
    tracer = port_trace.Tracer(None, process_name="p")
    assert tracer.events()[0]["pid"] == 2 and tracer.events()[1]["args"] == {"sort_index": 2}
    monkeypatch.setenv("PHOTON_PROCESS_COUNT", "1")
    assert port_trace.process_identity() == (0, 1)


def test_batcher_request_spans_equal_jax(tmp_path):
    """The micro-batcher's per-request retro-spans and the ambient batch
    context, under a tracer, in both packages: the same names, categories,
    argument keys and ids; the error path's spans too."""

    def run(batcher_cls, trace, label):
        def score_fn(reqs):
            if 99 in reqs:
                raise RuntimeError("bad batch")
            with trace.span("serving.score", cat="serving", rows=len(reqs)):
                return np.asarray([float(r) for r in reqs])

        d = str(tmp_path / label)
        with trace.trace(d, process_name="photon") as tracer:
            b = batcher_cls(score_fn, max_batch=4, max_wait_ms=1.0, auto_start=False)
            futs = [b.submit(i, trace=f"t{i}") for i in range(6)]
            b.start()
            assert [f.result(timeout=10) for f in futs] == [float(i) for i in range(6)]
            assert b.drain()
            b2 = batcher_cls(score_fn, max_batch=4, auto_start=False)
            bad = b2.submit(99, trace="t99")
            b2.start()
            with pytest.raises(RuntimeError):
                bad.result(timeout=10)
            assert b2.drain()
            base = b.instance_id << 32
            base2 = b2.instance_id << 32
            out = []
            for e in tracer.events():
                if e["ph"] != "X":
                    continue
                args = dict(e["args"])
                for k in ("request_id", "batch_id"):
                    if k in args:
                        args[k] -= base2 if args[k] >= base2 else base
                out.append((e["name"], e["cat"], sorted(args),
                            {k: args[k] for k in ("request_id", "batch_id", "trace", "error",
                                                  "degraded", "failover") if k in args}))
        return out

    jax_out = run(JaxMicroBatcher, jax_trace, "jax")
    port_out = run(MicroBatcher, port_trace, "port")
    assert port_out == jax_out
    assert sum(1 for e in port_out if e[0] == "serving.request") == 7


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------


def test_hbm_watermark_off_cuda_records_nothing():
    reg = port_metrics.MetricsRegistry()
    with port_obs.hbm_watermark("serving.warmup", registry=reg, device="cpu") as wm:
        torch.ones(10)
    assert not wm.supported and wm.peak_bytes is None and wm.delta_bytes is None
    assert reg.names("hbm.") == []
    from photon_ml_tpu_torch.obs.device import read_memory_stats

    assert read_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert read_memory_stats() is None
