"""The port's serving fabric (``photon_ml_tpu_torch.frontend``) against the
JAX package's (``photon_ml_tpu.frontend``), on the CPU.

Every router, tenant and server case of ``tests/test_frontend.py`` runs on
both packages under the same fault schedules (each package's own fault
registry, the same specs): the outcomes, the replies (less their random
trace ids) and the counters are equal, and hold the JAX test's own
assertions. Then one export, built with numpy from a seed, is served
through both packages' front ends (two tenants, each behind a router of two
registries, over JSON lines and binary frames): the scores agree within
1e-10 * max(1, |s|), the port's shared scorer cache builds one engine's
ladder for all four registries, and a traced ``serving.score`` span
carries the cost book's attribution (no hardware share on the CPU). Every
socket binds an ephemeral 127.0.0.1 port, every client has its own
timeout, and every thread is joined with one.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.frontend as jax_frontend
import photon_ml_tpu.obs as jax_obs
import photon_ml_tpu.resilience.faults as jax_faults
import photon_ml_tpu.serving as jax_serving
import photon_ml_tpu_torch.frontend as port_frontend
import photon_ml_tpu_torch.obs as port_obs
import photon_ml_tpu_torch.resilience.faults as port_faults
import photon_ml_tpu_torch.serving as port_serving
from photon_ml_tpu_torch.game.factored import FactoredParams
from photon_ml_tpu_torch.io import models as port_models
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary, feature_key

pytestmark = pytest.mark.frontend

TIMEOUT = 10.0


def _pkg(frontend, obs, faults, serving, registry_kw):
    return types.SimpleNamespace(
        **{n: getattr(frontend, n) for n in frontend.__all__},
        obs=obs, faults=faults, FaultSpec=faults.FaultSpec, inject=faults.inject,
        Backpressure=serving.Backpressure, DeadlineExceeded=serving.DeadlineExceeded,
        SharedCompileCache=serving.SharedCompileCache, ModelRegistry=serving.ModelRegistry,
        ScoreRequest=serving.ScoreRequest, registry_kw=registry_kw,
    )


PKGS = {
    "jax": _pkg(jax_frontend, jax_obs, jax_faults, jax_serving, {"dtype": jnp.float64}),
    "port": _pkg(port_frontend, port_obs, port_faults, port_serving,
                 {"dtype": torch.float64, "device": "cpu"}),
}


def _both(case):
    """Run ``case(pkg)`` on each package with a fresh default metrics
    registry; returns {"jax": outcome, "port": outcome}."""
    out = {}
    for name, pkg in PKGS.items():
        prev = pkg.obs.set_registry(pkg.obs.MetricsRegistry())
        try:
            out[name] = case(pkg)
        finally:
            pkg.obs.set_registry(prev)
    return out


def _counters(pkg, prefix):
    snap = pkg.obs.registry().snapshot()
    return {k: v for k, v in sorted(snap.get("counters", {}).items()) if k.startswith(prefix)}


def echo_score(batch):
    return np.asarray([r.offset for r in batch])


def offset_times(k):
    def f(batch):
        return np.asarray([k * r.offset for r in batch])

    return f


class _Req:
    def __init__(self, offset=1.0):
        self.offset = offset


def _health(router):
    """A router's health less its clock readings."""
    h = router.health()
    return {
        "up": h["up"],
        "failovers": h["failovers"],
        "failed_over": h["last_failover_s"] is not None,
        "replicas": {n: {k: v for k, v in r.items() if k not in ("backoff_s", "open_for_s")}
                     for n, r in h["replicas"].items()},
    }


def _join(threads, timeout=30.0):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), f"thread {t.name} did not finish"


# ---------------------------------------------------------------------------
# replica router
# ---------------------------------------------------------------------------


class TestReplicaRouter:
    def test_serialized_submits_spread_over_ties(self):
        def case(pkg):
            calls = {"a": 0, "b": 0}

            def mk(name):
                def f(batch):
                    calls[name] += 1
                    return np.ones(len(batch))

                return f

            router = pkg.ReplicaRouter([("a", mk("a")), ("b", mk("b"))])
            for _ in range(10):
                router.score([_Req()])
            return {"calls": calls, "health": _health(router),
                    "counters": _counters(pkg, "replica.")}

        out = _both(case)
        assert out["port"] == out["jax"]
        assert out["port"]["calls"] == {"a": 5, "b": 5}

    def test_failover_answers_every_batch(self):
        def case(pkg):
            def dead(batch):
                raise OSError("replica died")

            router = pkg.ReplicaRouter([("r0", dead), ("r1", offset_times(1.0))],
                                       failure_threshold=2, backoff_s=60.0)
            scores = [float(router.score([_Req(3.0)])[0]) for _ in range(6)]
            return {"scores": scores, "health": _health(router),
                    "counters": _counters(pkg, "replica.")}

        out = _both(case)
        assert out["port"] == out["jax"]
        h = out["port"]["health"]
        assert out["port"]["scores"] == [3.0] * 6
        assert h["failovers"] >= 1 and h["replicas"]["r0"]["state"] == "open"
        assert h["up"] == 1 and h["failed_over"]

    def test_all_replicas_down_raises(self):
        def case(pkg):
            def dead(batch):
                raise OSError("dead")

            router = pkg.ReplicaRouter([("r0", dead), ("r1", dead)])
            with pytest.raises(pkg.AllReplicasDown) as exc:
                router.score([_Req()])
            return {"error": str(exc.value), "cause": type(exc.value.__cause__).__name__,
                    "counters": _counters(pkg, "replica.")}

        out = _both(case)
        assert out["port"] == out["jax"]
        assert out["port"]["counters"]["replica.exhausted"] == 1

    def test_breaker_recovers_after_backoff(self):
        def case(pkg):
            alive = threading.Event()

            def flaky(batch):
                if not alive.is_set():
                    raise OSError("down")
                return np.zeros(len(batch))

            router = pkg.ReplicaRouter([("r0", flaky), ("r1", offset_times(1.0))],
                                       failure_threshold=1, backoff_s=0.05)
            router.score([_Req()])
            states = [router.health()["replicas"]["r0"]["state"]]
            alive.set()
            time.sleep(0.06)
            for _ in range(4):
                router.score([_Req()])
            states.append(router.health()["replicas"]["r0"]["state"])
            return {"states": states, "health": _health(router)}

        out = _both(case)
        assert out["port"] == out["jax"]
        assert out["port"]["states"] == ["open", "closed"]

    def test_on_failover_hook(self):
        def case(pkg):
            seen = []

            def dead(batch):
                raise OSError("died")

            router = pkg.ReplicaRouter(
                [("r0", dead), ("r1", offset_times(1.0))],
                on_failover=lambda f, t, e: seen.append((f, t, type(e).__name__)))
            router.score([_Req()])
            return seen

        out = _both(case)
        assert out["port"] == out["jax"] == [("r0", "r1", "OSError")]

    def test_unique_names_and_replica_instances(self):
        def case(pkg):
            with pytest.raises(ValueError, match="unique") as exc:
                pkg.ReplicaRouter([("r0", echo_score), ("r0", echo_score)])
            with pytest.raises(ValueError) as empty:
                pkg.ReplicaRouter([])
            rep = pkg.Replica("solo", offset_times(2.0))
            router = pkg.ReplicaRouter([rep])
            return {"unique": str(exc.value), "empty": str(empty.value),
                    "score": float(router.score([_Req(2.0)])[0]),
                    "same": router.replicas[0] is rep, "snapshot": rep.snapshot()}

        out = _both(case)
        assert out["port"] == out["jax"]
        assert out["port"]["score"] == 4.0 and out["port"]["same"]

    @pytest.mark.parametrize("mode", ["raise", "delay"])
    def test_route_fault_site_drives_failover(self, mode):
        """``replica.route`` keyed to r0: raise-mode fails r0 over to r1 and
        opens its breaker; delay-mode slows r0 and fails nothing."""

        def case(pkg):
            router = pkg.ReplicaRouter([("r0", offset_times(1.0)), ("r1", offset_times(1.0))],
                                       failure_threshold=1, backoff_s=60.0)
            with pkg.inject(pkg.FaultSpec(site="replica.route", mode=mode, nth=1, count=-1,
                                          key="r0", delay=0.001)):
                scores = [float(router.score([_Req(1.5)])[0]) for _ in range(5)]
            return {"scores": scores, "health": _health(router),
                    "counters": _counters(pkg, "replica.")}

        out = _both(case)
        assert out["port"] == out["jax"]
        assert out["port"]["scores"] == [1.5] * 5
        state = out["port"]["health"]["replicas"]["r0"]["state"]
        assert state == ("open" if mode == "raise" else "closed")


# ---------------------------------------------------------------------------
# tenant manager
# ---------------------------------------------------------------------------


class TestTenantManager:
    def test_routes_each_tenant_to_its_own_scorer(self):
        def case(pkg):
            tm = pkg.TenantManager(max_batch=16, max_wait_ms=20.0, auto_start=False,
                                   compile_cache=pkg.SharedCompileCache())
            tm.add_tenant("x2", offset_times(2.0))
            tm.add_tenant("x3", offset_times(3.0))
            try:
                futs = [tm.submit("x2", _Req(1.0)), tm.submit("x3", _Req(1.0)),
                        tm.submit("x2", _Req(5.0)), tm.submit("x3", _Req(5.0))]
                tm.batcher.start()
                got = [f.result(timeout=TIMEOUT) for f in futs]
            finally:
                assert tm.drain(timeout=TIMEOUT)
            return {"got": got, "counters": _counters(pkg, "tenant.")}

        out = _both(case)
        assert out["port"] == out["jax"]
        assert out["port"]["got"] == [2.0, 3.0, 10.0, 15.0]

    def test_unknown_tenant(self):
        def case(pkg):
            tm = pkg.TenantManager(auto_start=False, compile_cache=pkg.SharedCompileCache())
            with pytest.raises(pkg.UnknownTenant) as exc:
                tm.submit("nobody", _Req())
            tm.add_tenant("a", echo_score)
            with pytest.raises(ValueError, match="already registered") as dup:
                tm.add_tenant("a", echo_score)
            return {"unknown": str(exc.value), "dup": str(dup.value),
                    "key_error": isinstance(exc.value, KeyError)}

        out = _both(case)
        assert out["port"] == out["jax"]

    def test_quota_marks_over_quota_submissions(self):
        def case(pkg):
            gate = threading.Event()

            def slow(batch):
                gate.wait(TIMEOUT)
                return np.zeros(len(batch))

            tm = pkg.TenantManager(max_batch=4, max_wait_ms=0.1,
                                   compile_cache=pkg.SharedCompileCache())
            st = tm.add_tenant("q", slow, max_outstanding=1)
            try:
                f1 = tm.submit("q", _Req())
                deadline = time.time() + 5
                while st.outstanding < 1 and time.time() < deadline:
                    time.sleep(0.005)
                f2 = tm.submit("q", _Req())
                over = st.over_quota_submits
                gate.set()
                f1.result(timeout=TIMEOUT)
                f2.result(timeout=TIMEOUT)
                snap = {k: v for k, v in st.snapshot().items() if k != "slo"}
            finally:
                gate.set()
                assert tm.drain(timeout=TIMEOUT)
            return {"over": over, "snapshot": snap}

        out = _both(case)
        assert out["port"] == out["jax"]
        assert out["port"]["over"] == 1
        assert out["port"]["snapshot"]["completed"] == 2
        assert out["port"]["snapshot"]["outstanding"] == 0

    def test_per_request_deadline_override(self):
        def case(pkg):
            tm = pkg.TenantManager(max_batch=4, max_wait_ms=0.1, auto_start=False,
                                   compile_cache=pkg.SharedCompileCache())
            tm.add_tenant("t", echo_score)
            fut = tm.submit("t", _Req(), deadline_ms=0.01)
            time.sleep(0.05)
            tm.batcher.start()
            with pytest.raises(pkg.DeadlineExceeded):
                fut.result(timeout=TIMEOUT)
            assert tm.drain(timeout=TIMEOUT)
            return {k: v for k, v in tm.tenant("t").snapshot().items() if k != "slo"}

        out = _both(case)
        assert out["port"] == out["jax"]
        assert out["port"]["failed"] == 1

    @pytest.mark.parametrize("mode", ["raise", "corrupt"])
    def test_quota_fault_fails_closed(self, mode):
        """``tenant.quota``: raise-mode rejects the request (fails closed);
        corrupt-mode admits it marked over quota."""

        def case(pkg):
            tm = pkg.TenantManager(max_batch=4, max_wait_ms=0.1,
                                   compile_cache=pkg.SharedCompileCache())
            st = tm.add_tenant("t", echo_score)
            try:
                with pkg.inject(pkg.FaultSpec(site="tenant.quota", mode=mode, nth=1,
                                              count=-1, key="t")):
                    if mode == "raise":
                        with pytest.raises(pkg.Backpressure, match="failed closed") as exc:
                            tm.submit("t", _Req())
                        result = str(exc.value)
                    else:
                        result = tm.submit("t", _Req(2.0)).result(timeout=TIMEOUT)
            finally:
                assert tm.drain(timeout=TIMEOUT)
            return {"result": result,
                    "snapshot": {k: v for k, v in st.snapshot().items() if k != "slo"},
                    "counters": _counters(pkg, "tenant.")}

        out = _both(case)
        assert out["port"] == out["jax"]
        snap = out["port"]["snapshot"]
        if mode == "raise":
            assert snap["rejected"] == 1 and snap["submitted"] == 0
        else:
            assert out["port"]["result"] == 2.0 and snap["over_quota_submits"] == 1

    def test_slo_and_snapshot_shape(self):
        def case(pkg):
            tm = pkg.TenantManager(max_batch=4, max_wait_ms=0.1,
                                   compile_cache=pkg.SharedCompileCache())
            tm.add_tenant("gold", echo_score, priority=2, deadline_ms=500,
                          max_outstanding=32, target_p99_ms=5.0)
            try:
                tm.submit("gold", _Req(4.0)).result(timeout=TIMEOUT)
            finally:
                assert tm.drain(timeout=TIMEOUT)
            snap = tm.snapshot()
            g = snap["tenants"]["gold"]
            return {"tenant": {k: v for k, v in g.items() if k != "slo"},
                    "slo_keys": sorted(g["slo"]),
                    "slo_total": g["slo"]["total_requests"],
                    "compile_cache": snap["compile_cache"],
                    "queue_keys": sorted(snap["queue"]),
                    "slo_snapshot": tm.slo_snapshot()["gold"]["total_requests"]}

        out = _both(case)
        assert out["port"] == out["jax"]
        assert out["port"]["tenant"]["priority"] == 2
        assert out["port"]["compile_cache"] == {"entries": 0, "hits": 0, "compiles": 0}
        assert out["port"]["slo_total"] == out["port"]["slo_snapshot"] == 1

    def test_process_compile_cache_is_one_object(self):
        assert port_frontend.process_compile_cache() is port_frontend.process_compile_cache()
        assert isinstance(port_frontend.process_compile_cache(), port_serving.SharedCompileCache)


# ---------------------------------------------------------------------------
# the front end (sockets, framing, multiplexing)
# ---------------------------------------------------------------------------


def _fabric(pkg, **tenant_kw):
    tm = pkg.TenantManager(max_batch=8, max_wait_ms=0.5, compile_cache=pkg.SharedCompileCache())
    tm.add_tenant("a", offset_times(1.0), **tenant_kw)
    tm.add_tenant("b", offset_times(10.0))
    srv = pkg.FrontendServer(tm.submit, default_tenant="a")
    srv.start()
    return tm, srv


def _untraced(msg):
    assert "trace" not in msg or isinstance(msg["trace"], str)
    return {k: v for k, v in msg.items() if k != "trace"}


def _serve_case(body, **tenant_kw):
    """``body(pkg, srv)`` against a running echo fabric on each package."""

    def case(pkg):
        tm, srv = _fabric(pkg, **tenant_kw)
        try:
            result = body(pkg, srv)
        finally:
            srv.stop()
            assert tm.drain(timeout=TIMEOUT)
        return {"result": result, "counters": _counters(pkg, "frontend.")}

    return _both(case)


def _same_counters(out, *skip):
    """Counters equal but for byte counts (the JSON of a reply carries a
    random trace id) and ``skip``."""
    drop = ("frontend.bytes_in", "frontend.bytes_out") + skip
    j, p = ({k: v for k, v in out[n]["counters"].items() if k not in drop}
            for n in ("jax", "port"))
    assert p == j


class TestFrontendServer:
    def test_single_and_batch_json_lines(self):
        def body(pkg, srv):
            with pkg.FrontendClient("127.0.0.1", srv.port, timeout=TIMEOUT) as c:
                return [_untraced(c.call({"tenant": "a", "offset": 2.5})),
                        _untraced(c.call({"tenant": "b", "batch": [{"offset": 1.0},
                                                                   {"offset": 2.0}]})),
                        _untraced(c.call({"offset": 7.0}))]

        out = _serve_case(body)
        assert out["port"]["result"] == out["jax"]["result"]
        _same_counters(out)
        r = out["port"]["result"]
        assert r[0]["score"] == 2.5 and r[1]["scores"] == [10.0, 20.0] and r[2]["score"] == 7.0

    def test_binary_framing(self):
        def body(pkg, srv):
            with pkg.FrontendClient("127.0.0.1", srv.port, binary=True, timeout=TIMEOUT) as c:
                return [_untraced(c.call({"offset": 3.0})),
                        _untraced(c.call({"tenant": "b", "batch": [{"offset": 0.5}]}))]

        out = _serve_case(body)
        assert out["port"]["result"] == out["jax"]["result"]
        _same_counters(out)
        assert out["port"]["result"][0]["score"] == 3.0
        assert out["port"]["result"][1]["scores"] == [5.0]

    def test_streaming_batch(self):
        def body(pkg, srv):
            with pkg.FrontendClient("127.0.0.1", srv.port, timeout=TIMEOUT) as c:
                rid = c.submit({"tenant": "a", "stream": True,
                                "batch": [{"offset": float(i)} for i in range(4)]})
                rows, done = {}, None
                while done is None:
                    msg = c.recv()
                    assert msg["id"] == rid
                    if "done" in msg:
                        done = msg["done"]
                    else:
                        rows[msg["seq"]] = msg["score"]
                return {"done": done, "rows": sorted(rows.items())}

        out = _serve_case(body)
        assert out["port"]["result"] == out["jax"]["result"]
        _same_counters(out)
        assert out["port"]["result"] == {"done": 4, "rows": [(i, float(i)) for i in range(4)]}

    def test_multiplexed_replies_matched_by_id(self):
        def body(pkg, srv):
            with pkg.FrontendClient("127.0.0.1", srv.port, timeout=TIMEOUT) as c:
                ids = [c.submit({"offset": float(i)}) for i in range(8)]
                got = {}
                for _ in ids:
                    msg = c.recv()
                    got[msg["id"]] = msg["score"]
                return sorted(got.items()) == [(rid, float(i)) for i, rid in enumerate(ids)]

        out = _serve_case(body)
        assert out["port"]["result"] is out["jax"]["result"] is True
        _same_counters(out)

    def test_unknown_tenant_is_invalid_argument(self):
        def body(pkg, srv):
            with pkg.FrontendClient("127.0.0.1", srv.port, timeout=TIMEOUT) as c:
                return _untraced(c.call({"tenant": "ghost", "offset": 1.0}))

        out = _serve_case(body)
        assert out["port"]["result"] == out["jax"]["result"]
        _same_counters(out)
        assert out["port"]["result"]["code"] == "INVALID_ARGUMENT"

    def test_backpressure_is_resource_exhausted_not_a_drop(self):
        def case(pkg):
            def refuse(tenant, request, **kw):
                raise pkg.Backpressure("queue full")

            srv = pkg.FrontendServer(refuse)
            srv.start()
            try:
                with pkg.FrontendClient("127.0.0.1", srv.port, timeout=TIMEOUT) as c:
                    replies = [_untraced(c.call({"offset": 1.0})),
                               _untraced(c.call({"offset": 2.0}))]
            finally:
                srv.stop()
            return {"result": replies, "counters": _counters(pkg, "frontend.")}

        out = _both(case)
        assert out["port"]["result"] == out["jax"]["result"]
        _same_counters(out)
        assert [r["code"] for r in out["port"]["result"]] == ["RESOURCE_EXHAUSTED"] * 2

    def test_admin_passthrough(self):
        def body(pkg, srv):
            srv.admin_fn = lambda obj: {"pong": obj["cmd"]}
            with pkg.FrontendClient("127.0.0.1", srv.port, timeout=TIMEOUT) as c:
                first = c.call({"cmd": "anything"})
            srv.admin_fn = None
            with pkg.FrontendClient("127.0.0.1", srv.port, timeout=TIMEOUT) as c:
                return [first, c.call({"cmd": "stats"})]

        out = _serve_case(body)
        assert out["port"]["result"] == out["jax"]["result"]
        assert out["port"]["result"][0]["pong"] == "anything"
        assert out["port"]["result"][1]["code"] == "INVALID_ARGUMENT"

    def test_bad_frame_answered_not_dropped(self):
        def body(pkg, srv):
            s = socket.create_connection(("127.0.0.1", srv.port), timeout=TIMEOUT)
            try:
                f = s.makefile("rwb")
                f.write(b"{not json}\n")
                f.flush()
                bad = json.loads(f.readline())
                f.write(json.dumps({"id": 1, "offset": 9.0}).encode() + b"\n")
                f.flush()
                good = _untraced(json.loads(f.readline()))
            finally:
                s.close()
            return [bad["code"], bad["error"].split(":")[0], good]

        out = _serve_case(body)
        assert out["port"]["result"] == out["jax"]["result"]
        _same_counters(out)
        assert out["port"]["result"][0] == "INVALID_ARGUMENT"
        assert out["port"]["result"][2]["score"] == 9.0

    def test_oversized_binary_frame_refused(self):
        def body(pkg, srv):
            srv.max_frame_bytes = 1024
            s = socket.create_connection(("127.0.0.1", srv.port), timeout=TIMEOUT)
            try:
                s.sendall((1 << 30).to_bytes(4, "big"))
                f = s.makefile("rb")
                n = int.from_bytes(f.read(4), "big")
                return json.loads(f.read(n))
            finally:
                s.close()

        out = _serve_case(body)
        assert out["port"]["result"] == out["jax"]["result"]
        assert out["port"]["result"]["code"] == "INVALID_ARGUMENT"

    def test_accept_fault_drops_one_connection_listener_survives(self):
        def body(pkg, srv):
            with pkg.inject(pkg.FaultSpec(site="frontend.accept", mode="raise", nth=1,
                                          count=1)):
                dropped = socket.create_connection(("127.0.0.1", srv.port), timeout=TIMEOUT)
                dropped.settimeout(5)
                closed = dropped.recv(1) == b""
                dropped.close()
            with pkg.FrontendClient("127.0.0.1", srv.port, timeout=TIMEOUT) as c:
                return [closed, _untraced(c.call({"offset": 1.0}))]

        out = _serve_case(body)
        assert out["port"]["result"] == out["jax"]["result"]
        _same_counters(out)
        assert out["port"]["result"] == [True, {"id": 1, "score": 1.0}]
        assert out["port"]["counters"]["frontend.accept_rejected"] == 1

    def test_context_manager_and_restart_idempotent(self):
        tm = port_frontend.TenantManager(max_batch=4, max_wait_ms=0.5,
                                         compile_cache=port_serving.SharedCompileCache())
        tm.add_tenant("a", echo_score)
        try:
            with port_frontend.FrontendServer(tm.submit, default_tenant="a") as srv:
                assert srv.start() is srv
                with port_frontend.FrontendClient("127.0.0.1", srv.port,
                                                  timeout=TIMEOUT) as c:
                    assert c.call({"offset": 4.0})["score"] == 4.0
            assert not srv._thread.is_alive()
        finally:
            assert tm.drain(timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# one export through both packages' front ends
# ---------------------------------------------------------------------------


def _seeded_export(root, seed=20261018):
    """A two-shard GAME export made with numpy: an intercept on each
    shard, a sparse per-user table, a per-ad table and a factored per-ad
    effect; written by the port, manifest included."""
    rng = np.random.default_rng(seed)
    g_vocab = FeatureVocabulary([feature_key("g", str(j)) for j in range(7)], add_intercept=True)
    a_vocab = FeatureVocabulary([feature_key("a", str(j)) for j in range(3)], add_intercept=True)
    user = rng.normal(size=(5, len(g_vocab))) * (rng.uniform(size=(5, len(g_vocab))) < 0.4)
    port_models.save_game_model(
        root,
        params={"global": rng.normal(size=len(g_vocab)), "per-user": user,
                "per-ad": rng.normal(size=(4, len(a_vocab))),
                "per-ad-latent": FactoredParams(torch.from_numpy(rng.normal(size=(3, 2))),
                                                torch.from_numpy(rng.normal(
                                                    size=(len(a_vocab), 2))))},
        shards={"global": "g", "per-user": "g", "per-ad": "a", "per-ad-latent": "a"},
        vocabs={"global": g_vocab, "per-user": g_vocab, "per-ad": a_vocab,
                "per-ad-latent": a_vocab},
        entity_vocabs={"per-user": {f"user{u}": u for u in range(5)},
                       "per-ad": {"ad0": 0, "ad1": 1, "ad2": 2, "ad5": 3},
                       "per-ad-latent": {"ad5": 0, "ad1": 1, "ad7": 2}},
        random_effects={"global": None, "per-user": "userId", "per-ad": "adId",
                        "per-ad-latent": "adId"},
    )
    g_vocab.save(os.path.join(root, "feature-index-g.txt"))
    a_vocab.save(os.path.join(root, "feature-index-a.txt"))
    port_models.write_model_manifest(root)
    return root


def _seeded_requests(n=48, seed=7):
    """Request dicts in both wire forms of a feature key, with unknown
    users and ads and integer-looking ids."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        feats = {f"g\x01{j}": float(rng.normal()) for j in rng.choice(7, 3, replace=False)}
        feats[f"a\x01{i % 3}"] = float(rng.normal())
        ents = {"userId": f"user{i % 7}"}
        if i % 6 != 4:
            ents["adId"] = f"ad{i % 9}"
        out.append({"features": feats, "entities": ents, "offset": float(i % 3) * 0.25})
    return out


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(1.0, np.abs(want))
    assert np.all(np.abs(got - want) <= 1e-10 * scale), np.max(np.abs(got - want) / scale)


def _serve_export(pkg, root, requests, on_server=None):
    """``root`` behind ``pkg``'s fabric: tenants gold (priority 2, quota 256)
    and free (priority 0, quota 64), each behind a router of two registries
    sharing one scorer cache; the requests alternate tenants, half sent as
    JSON lines and half as binary frames, singles and batches of 5, from
    one thread per connection. Returns (scores by request, the registries,
    the cache, the tenant manager's snapshot)."""
    cache = pkg.SharedCompileCache()
    regs = {}
    tm = pkg.TenantManager(max_batch=8, max_wait_ms=1.0, compile_cache=cache)
    for tenant, prio, quota in (("gold", 2, 256), ("free", 0, 64)):
        regs[tenant] = []
        for _ in range(2):
            reg = pkg.ModelRegistry(warmup_max_batch=8, compile_cache=cache, **pkg.registry_kw)
            reg.load(root)
            regs[tenant].append(reg)
        router = pkg.ReplicaRouter([(f"{tenant}/r{i}", r.score)
                                    for i, r in enumerate(regs[tenant])])
        tm.add_tenant(tenant, router.score, priority=prio, max_outstanding=quota)
    srv = pkg.FrontendServer(tm.submit, default_tenant="gold").start()
    scores = [None] * len(requests)
    errors = []

    def client(binary, idx):
        try:
            with pkg.FrontendClient("127.0.0.1", srv.port, binary=binary,
                                    timeout=TIMEOUT) as c:
                k = 0
                while k < len(idx):
                    chunk = idx[k:k + (1 if k % 2 == 0 else 5)]
                    tenant = "gold" if (k // 2) % 2 == 0 else "free"
                    if len(chunk) == 1:
                        reply = c.call({"tenant": tenant, **requests[chunk[0]]})
                        scores[chunk[0]] = reply["score"]
                    else:
                        reply = c.call({"tenant": tenant,
                                        "batch": [requests[i] for i in chunk]})
                        for i, s in zip(chunk, reply["scores"]):
                            scores[i] = s
                    k += len(chunk)
        except Exception as e:  # noqa: BLE001 — reported by the test
            errors.append(e)

    half = len(requests) // 2
    threads = [threading.Thread(target=client, args=(b, list(range(lo, lo + half))),
                                name=f"client-{b}")
               for b, lo in ((False, 0), (True, half))]
    try:
        for t in threads:
            t.start()
        _join(threads)
        if on_server is not None:
            on_server(srv)
    finally:
        srv.stop()
        assert tm.drain(timeout=TIMEOUT)
    assert not errors, errors
    return scores, regs, cache, tm.snapshot()


class TestSeededExportThroughBothFrontEnds:
    def test_scores_agree_over_both_framings(self, tmp_path):
        root = _seeded_export(str(tmp_path / "m"))
        requests = _seeded_requests()
        j_scores, _, _, j_snap = _serve_export(PKGS["jax"], root, requests)
        p_scores, p_regs, p_cache, p_snap = _serve_export(PKGS["port"], root, requests)
        assert None not in p_scores and None not in j_scores
        _close(p_scores, j_scores)
        # and the port's engine on the same requests, no fabric
        engine = port_serving.ScoringEngine.from_model_dir(root, device="cpu")
        want = engine.score([port_serving.ScoreRequest(r["features"], r["entities"],
                                                       r["offset"]) for r in requests])
        _close(p_scores, want)
        for snap in (j_snap, p_snap):
            assert {t: (s["completed"], s["failed"], s["rejected"])
                    for t, s in snap["tenants"].items()} == {"gold": (24, 0, 0),
                                                              "free": (24, 0, 0)}
        # four registries, one ladder: the first engine built every bucket
        # scorer (the warmup's and the degraded ones, none here), the three
        # others built none
        engines = [reg.current.engine for regs in p_regs.values() for reg in regs]
        assert engines[0].compile_count == p_cache.compiles > 0
        assert [e.compile_count for e in engines[1:]] == [0, 0, 0]
        assert p_cache.snapshot() == {"entries": p_cache.compiles,
                                      "hits": 3 * p_cache.compiles,
                                      "compiles": p_cache.compiles}

    def test_failover_mid_stream_loses_nothing(self, tmp_path):
        """``replica.route`` raising on gold/r0 for the whole stream: every
        request is answered, on gold/r1, with the same scores."""
        root = _seeded_export(str(tmp_path / "m"))
        requests = _seeded_requests(24)
        out = {}
        for name, pkg in PKGS.items():
            with pkg.inject(pkg.FaultSpec(site="replica.route", mode="raise", nth=2, count=-1,
                                          key="gold/r0")):
                out[name] = _serve_export(pkg, root, requests)[0]
        _close(out["port"], out["jax"])

    def test_score_spans_carry_the_cost_book(self, tmp_path):
        """A traced ``serving.score`` span on the port: the bucket's cost
        record's FLOPs and bytes over the call's window, and no hardware
        share off an H100. The cost book holds one record per built bucket
        scorer, under the JAX engine's keys."""
        root = _seeded_export(str(tmp_path / "m"))
        book = port_obs.CostBook()
        prev_book = port_obs.set_cost_book(book)
        tracer = port_obs.Tracer()
        prev = port_obs.set_tracer(tracer)
        try:
            engine = port_serving.ScoringEngine.from_model_dir(root, device="cpu")
            engine.warmup(max_batch=16, include_degraded=True)
            reqs = [port_serving.ScoreRequest(r["features"], r["entities"], r["offset"])
                    for r in _seeded_requests(12)]
            engine.score(reqs)
            engine.score(reqs[:3], fixed_only=True)
        finally:
            port_obs.set_tracer(prev)
            port_obs.set_cost_book(prev_book)
        assert book.names() == [("serving.score", b) for b in ("16", "16-fixed", "8", "8-fixed")]
        spans = [e for e in tracer.events() if e.get("name") == "serving.score"]
        assert len(spans) == 2
        for sp, bucket in zip(spans, ("16", "8-fixed")):
            rec = book.lookup("serving.score", bucket)
            args = sp["args"]
            assert args["flops"] == rec.flops > 0
            assert args["bytes_per_s"] > 0 and args["achieved_tflops"] >= 0
            assert "hbm_util" not in args and "mfu" not in args
        # the fixed-only ladder reads fewer bytes than the full one
        assert (book.lookup("serving.score", "16-fixed").roofline_bytes
                < book.lookup("serving.score", "16").roofline_bytes)

    def test_cost_book_keys_equal_jax_engine(self, tmp_path):
        root = _seeded_export(str(tmp_path / "m"))
        books = {}
        for name, pkg in PKGS.items():
            book = pkg.obs.CostBook() if name == "port" else None
            if name == "jax":
                from photon_ml_tpu.obs.xla_cost import CostBook as JaxCostBook
                from photon_ml_tpu.obs.xla_cost import set_cost_book as jax_set

                book = JaxCostBook()
                prev = jax_set(book)
            else:
                prev = port_obs.set_cost_book(book)
            try:
                reg = pkg.ModelRegistry(warmup_max_batch=16, warmup_degraded=True,
                                        **pkg.registry_kw)
                reg.load(root)
            finally:
                (jax_set if name == "jax" else port_obs.set_cost_book)(prev)
            books[name] = sorted(book.names())
        assert books["port"] == books["jax"]
