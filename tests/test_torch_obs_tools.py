"""The port's photon-obs (``photon_ml_tpu_torch.cli.obs_tools``) against
the JAX package's (``photon_ml_tpu.cli.obs_tools``), on the CPU.

Every input is made by the port itself — rank shards from its tracer,
metrics registry and quality fingerprint, convergence events from its
solver and convergence layer, a failover request's events from its
serving fabric — and both packages' ``main`` read the same files: the
merged trace, events, metrics and folded fingerprint are equal as JSON,
the summary lines, renderings and exit codes equal. That the JAX CLI
reads the port's artifacts shows the on-disk layouts are shared.
``top --once --json`` against the port's ``FrontendServer`` (two tenants,
each behind a router of two replicas, the admin channel ``cli.serve``
wires) matches the JAX ``collect_fleet_snapshot`` polling the same
server, key for key, less rates and latencies. Every socket binds an
ephemeral 127.0.0.1 port and every client has its own timeout.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import photon_ml_tpu.cli.obs_tools as jax_tools
import photon_ml_tpu_torch.cli.obs_tools as port_tools
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.cli.serve import make_admin_handler
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.frontend import (
    FrontendClient,
    FrontendServer,
    ReplicaRouter,
    TenantManager,
)
from photon_ml_tpu_torch.interop import labeled_batch_from_numpy, sparse_from_numpy
from photon_ml_tpu_torch.models.training import GLMTrainingConfig, OptimizerType, train_glm
from photon_ml_tpu_torch.obs.exemplars import ExemplarStore, set_store
from photon_ml_tpu_torch.obs.quality import BaselineFingerprint
from photon_ml_tpu_torch.ops.objective import RegularizationContext
from photon_ml_tpu_torch.resilience.faults import FaultSpec, inject
from torch_obs_hygiene import clean_obs  # noqa: F401

pytestmark = [pytest.mark.obs, pytest.mark.frontend, pytest.mark.usefixtures("clean_obs")]

SEED = 20261019
TIMEOUT = 10.0
TOOLS = {"jax": jax_tools, "port": port_tools}


def _both(argv_for, capsys):
    """``{pkg: (rc, summary line or None, stderr)}`` of each package's
    ``main`` on ``argv_for(pkg)``."""
    out = {}
    for name, tools in TOOLS.items():
        rc = tools.main(argv_for(name))
        cap = capsys.readouterr()
        lines = cap.out.strip().splitlines()
        out[name] = (rc, json.loads(lines[-1]) if lines else None, cap.err)
    return out


# ---------------------------------------------------------------------------
# merge: the port's rank shards, a torn and a missing shard
# ---------------------------------------------------------------------------


def _rank_shard(d, rank, world, rng):
    obs.set_process_identity(rank, world)
    prev = obs.set_registry(obs.MetricsRegistry())
    try:
        with obs.trace(str(d)):
            obs.emit_clock_sync()
            for step in range(3):
                with obs.span("game.pass", cat="game", iteration=step):
                    obs.registry().inc("solver.tron.iterations", 2 + rank)
            obs.emit_event("resilience.fault_injected", site="descent.update")
            obs.registry().set_gauge("serving.queue_depth", float(rank))
        obs.registry().dump(os.path.join(str(d), "metrics.json"))
    finally:
        obs.set_registry(prev)
    fp = BaselineFingerprint(max_features=3)
    x = rng.normal(size=(300 + 40 * rank, 3))
    fp.observe_batch(x, (rng.uniform(size=len(x)) < 0.3).astype(float), shard="s")
    fp.observe_margins(rng.normal(size=len(x)))
    fp.save(str(d))


@pytest.fixture
def rank_shards(tmp_path):
    rng = np.random.default_rng(SEED)
    dirs = []
    for rank in range(2):
        d = tmp_path / f"trace-r{rank}"
        _rank_shard(d, rank, 2, rng)
        dirs.append(str(d))
    # rank 1's log ends mid-write; rank 2's trace.json is torn; rank 3's
    # directory never appeared
    with open(os.path.join(dirs[1], "events.jsonl"), "a") as f:
        f.write('{"kind": "span", "name": "torn-mid-wr')
    torn = tmp_path / "trace-r2"
    torn.mkdir()
    (torn / "trace.json").write_text('{"traceEvents": [{"name": "x", "ph"')
    return dirs + [str(torn), str(tmp_path / "trace-r3")]


def _read(out_dir, name):
    path = os.path.join(out_dir, name)
    with open(path) as f:
        if name.endswith(".jsonl"):
            return [json.loads(line) for line in f]
        return json.load(f)


def test_merge_matches_jax(rank_shards, tmp_path, capsys):
    outs = {name: str(tmp_path / f"pod-{name}") for name in TOOLS}
    got = _both(lambda pkg: ["merge", "--out", outs[pkg]] + rank_shards, capsys)
    (rc_j, line_j, err_j), (rc_p, line_p, err_p) = got["jax"], got["port"]
    assert rc_p == rc_j == 0
    assert err_p == err_j
    for line, pkg in ((line_j, "jax"), (line_p, "port")):
        assert line["extra"].pop("out") == os.path.join(outs[pkg], "trace.json")
    assert line_p == line_j
    extra = line_p["extra"]
    assert line_p["value"] == 2 and extra["skipped"] == 2
    assert extra["aligned_by"] == "sync" and extra["fingerprint_shards"] == 2
    assert extra["metrics_shards"] == 2 and extra["events_jsonl"] > 0
    assert "torn" in err_p and "trace-r3" in err_p
    for name in ("trace.json", "events.jsonl", "metrics.json",
                 "quality-fingerprint.json"):
        assert _read(outs["port"], name) == _read(outs["jax"], name), name
    trace = _read(outs["port"], "trace.json")
    assert {e["pid"] for e in trace["traceEvents"]
            if e.get("name") == "game.pass"} == {0, 1}
    metrics = _read(outs["port"], "metrics.json")
    assert metrics["counters"]["pod.solver.tron.iterations"] == 3 * 2 + 3 * 3
    assert metrics["gauges"]["host.1.serving.queue_depth"] == 1.0
    # the folded fingerprint is the exact merge of the two ranks'
    want = BaselineFingerprint.load(rank_shards[0])
    want.merge(BaselineFingerprint.load(rank_shards[1]))
    merged = BaselineFingerprint.load(outs["port"])
    assert merged.to_dict() == want.to_dict()


def test_merge_without_readable_shards_exits_2(rank_shards, tmp_path, capsys):
    got = _both(lambda pkg: ["merge", "--out", str(tmp_path / pkg)] + rank_shards[2:], capsys)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2 and "no readable trace shards" in got["port"][2]


# ---------------------------------------------------------------------------
# convergence: the port's solves and fleet updates
# ---------------------------------------------------------------------------


def _converged_run(trace_dir):
    rng = np.random.default_rng(SEED + 1)
    n, d = 160, 12
    x = rng.standard_normal((n, d)) * (rng.uniform(size=(n, d)) < 0.5)
    x[:, -1] = 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ rng.standard_normal(d)))).astype(float)
    cols = np.tile(np.arange(d), (n, 1))
    batch = labeled_batch_from_numpy(sparse_from_numpy(cols, x, d), y, np.zeros(n),
                                     np.ones(n), np.ones(n))
    cfg = GLMTrainingConfig(task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType.TRON,
                            regularization=RegularizationContext("L2"),
                            reg_weights=(4.0, 0.5), max_iters=60, tolerance=1e-7)
    with obs.trace(trace_dir):
        # the solver notes each lambda's solve itself
        assert len(train_glm(batch, cfg)) == 2
        reasons = np.array([2, 2, 0, 1, 2, 2, 2, 0])
        for it in range(3):
            obs.convergence.note_update("per-user", it, reasons, np.arange(8) + it,
                                        np.linspace(1e-9, 1e-3, 8) * (it + 1), np.arange(8))
    with open(os.path.join(trace_dir, "events.jsonl"), "a") as f:
        f.write('{"kind": "event", "name": "convergence.so')


def test_convergence_matches_jax(tmp_path, capsys):
    trace_dir = str(tmp_path / "trace")
    _converged_run(trace_dir)
    got = _both(lambda pkg: ["convergence", trace_dir, "--last", "4"], capsys)
    assert got["port"] == got["jax"]
    rc, line, err = got["port"]
    assert rc == 0
    assert line["metric"] == "obs_convergence"
    assert line["extra"]["solves"] == 2 and line["extra"]["fleet_updates"] == 3
    assert line["extra"]["coordinates"] == ["per-user"] and line["extra"]["warnings"] == 1
    assert "lambda=4" in err and "per-user: 3 updates x 8 entities" in err


def test_convergence_without_records_exits_2(tmp_path, capsys):
    (tmp_path / "events.jsonl").write_text('{"kind": "event", "name": "other"}\n')
    got = _both(lambda pkg: ["convergence", str(tmp_path)], capsys)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2 and got["port"][1] is None


# ---------------------------------------------------------------------------
# drift: a planted and an unplanted pair of the port's fingerprints
# ---------------------------------------------------------------------------


def _fingerprint(path, rng, shift=0.0, rows=3000):
    os.makedirs(path)
    fp = BaselineFingerprint(max_features=3)
    fp.observe_batch(rng.normal(size=(rows, 3)) + shift * np.array([1.0, 0.0, 0.0]),
                     (rng.uniform(size=rows) < 0.4).astype(float), shard="s",
                     names=["a", "b", "c"])
    fp.observe_margins(rng.normal(size=rows) + shift)
    fp.save(path)
    return path


@pytest.mark.parametrize("planted", [False, True])
def test_drift_matches_jax(planted, tmp_path, capsys):
    rng = np.random.default_rng(SEED + 2)
    base = _fingerprint(str(tmp_path / "base"), rng)
    cur = _fingerprint(str(tmp_path / "cur"), rng, shift=4.0 if planted else 0.0)
    got = _both(lambda pkg: ["drift", base, cur, "--top", "3"], capsys)
    assert got["port"] == got["jax"]
    rc, line, err = got["port"]
    assert rc == (1 if planted else 0)
    assert line["extra"]["alarm"] is planted
    assert (line["extra"]["flagged"] == ["s.0"]) is planted
    assert ("DRIFT ALARM" in err) is planted
    # the same fingerprint against itself: no drift at all
    same = _both(lambda pkg: ["drift", base, base], capsys)
    assert same["port"] == same["jax"] and same["port"][0] == 0
    assert same["port"][1]["value"] == 0.0


def test_drift_unreadable_exits_2(tmp_path, capsys):
    got = _both(lambda pkg: ["drift", str(tmp_path), str(tmp_path)], capsys)
    assert got["port"] == got["jax"] and got["port"][0] == 2


# ---------------------------------------------------------------------------
# request: a failover request through the port's fabric
# ---------------------------------------------------------------------------


def echo_score(batch):
    return np.asarray([r.offset for r in batch])


@pytest.fixture
def failover_trace(tmp_path):
    td = str(tmp_path / "trace")
    prev = set_store(ExemplarStore(fast_fraction=1.0))
    try:
        with obs.trace(td):
            router = ReplicaRouter([("r0", echo_score), ("r1", echo_score)],
                                   failure_threshold=2, backoff_s=30.0)
            tm = TenantManager(max_batch=4, max_wait_ms=0.5)
            tm.add_tenant("t0", router.score)
            with FrontendServer(tm.submit, default_tenant="t0") as srv:
                with FrontendClient("127.0.0.1", srv.port, timeout=TIMEOUT) as cli:
                    # r0 dies on contact: the first batch fails over
                    with inject(FaultSpec("replica.route", "raise", nth=1, count=-1,
                                          key="r0")):
                        r = cli.call({"trace": "req-e2e-1", "offset": 42.0})
                    r_ok = cli.call({"trace": "req-plain-1", "offset": 7.0})
            assert r["score"] == 42.0 and r["trace"] == "req-e2e-1"
            assert r_ok["score"] == 7.0
            assert tm.drain(timeout=TIMEOUT)
    finally:
        set_store(prev)
    return os.path.join(td, "events.jsonl")


def test_request_matches_jax(failover_trace, capsys):
    got = _both(lambda pkg: ["request", "req-e2e-1", failover_trace], capsys)
    assert got["port"] == got["jax"]
    rc, line, err = got["port"]
    assert rc == 0 and line["metric"] == "obs_request"
    extra = line["extra"]
    assert extra["trace"] == "req-e2e-1" and extra["complete"] and not extra["truncated"]
    assert extra["failover"] and extra["hops"] == 2
    for seg in ("wire_read_ms", "queue_wait_ms", "assembly_ms", "device_ms",
                "reply_write_ms"):
        assert seg in extra["segments"], extra["segments"]
    assert "replica=r0" in err and "FAILED" in err and "replica=r1" in err


def test_request_unknown_id_exits_2(failover_trace, capsys):
    got = _both(lambda pkg: ["request", "no-such-trace", failover_trace, "--last", "2"],
                capsys)
    assert got["port"] == got["jax"]
    rc, line, err = got["port"]
    assert rc == 2 and line is None
    assert "not found" in err and "req-e2e-1" in err


# ---------------------------------------------------------------------------
# top: the port's front end, two tenants each behind two replicas
# ---------------------------------------------------------------------------


def _fabric():
    """The shape ``cli.serve --frontend-port`` wires: a TenantManager,
    a ReplicaRouter of two replicas per tenant, and the admin channel."""
    routers = {t: ReplicaRouter([(f"r{i}", echo_score) for i in range(2)])
               for t in ("gold", "free")}
    tm = TenantManager(max_batch=4, max_wait_ms=0.5)
    for name, router in routers.items():
        tm.add_tenant(name, router.score)
    srv = FrontendServer(
        tm.submit,
        admin_fn=make_admin_handler(tm.batcher, stats=tm.stats, tenants=tm, replicas=routers),
        default_tenant="gold",
    )
    srv.start()
    return srv, tm


# rates and latencies move between two polls; every other key is compared
_VOLATILE = {"qps", "p99_ms", "worst_p99_ms", "violation_rate", "slo_met"}


def _stable(snap):
    if isinstance(snap, dict):
        return {k: _stable(v) for k, v in snap.items() if k not in _VOLATILE}
    return snap


def test_top_once_json_matches_jax_snapshot(tmp_path, capsys):
    srv, tm = _fabric()
    try:
        with FrontendClient("127.0.0.1", srv.port, timeout=TIMEOUT) as cli:
            for tenant in ("gold", "free"):
                for k in range(3):
                    assert cli.call({"tenant": tenant, "offset": 5.0 + k})["score"] == 5.0 + k
            # every admin command of a fleet poll answers on the port's
            # channel: with its surface, or naming the surface this fabric
            # lacks (no SLO tracker on the shared batcher, no drift monitor)
            answers = {cmd: cli.call({"cmd": cmd})
                       for cmd in port_tools._TOP_CMDS + ("metrics",)}
        ep = f"127.0.0.1:{srv.port}"
        raw = port_tools.poll_endpoint(ep, timeout=TIMEOUT)
        out_path = str(tmp_path / "fleet-snapshot.json")
        rc = port_tools.main(["top", "--endpoint", ep, "--once", "--json", "--out", out_path,
                              "--timeout", str(TIMEOUT)])
        port_snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        jax_snap = jax_tools.collect_fleet_snapshot([ep], timeout=TIMEOUT)
        binary = port_tools.collect_fleet_snapshot([ep], binary=True, timeout=TIMEOUT)
        rc_h = port_tools.main(["top", "--endpoint", ep, "--once", "--timeout", str(TIMEOUT)])
        human = capsys.readouterr()
    finally:
        srv.stop()
        assert tm.drain(timeout=TIMEOUT)
    assert rc == 0 and rc_h == 0
    assert port_tools._TOP_CMDS == jax_tools._TOP_CMDS
    assert all(isinstance(a, dict) for a in answers.values())
    assert sorted(c for c, a in answers.items() if "error" in a) == ["drift", "slo"]
    assert "no SLO tracker" in answers["slo"]["error"]
    assert "no drift monitor" in answers["drift"]["error"]
    assert "photon_" in answers["metrics"]["prometheus"]
    assert raw["reachable"] and raw["error"] is None
    assert {c: raw[c] is not None for c in port_tools._TOP_CMDS} == {
        c: "error" not in answers[c] for c in port_tools._TOP_CMDS}
    assert raw["lifecycle_alarm_latched"] is False
    assert _stable(port_snap) == _stable(jax_snap)
    assert _stable(binary) == _stable(jax_snap)
    assert set(port_snap) == set(jax_snap)
    assert port_snap["endpoints"] == port_snap["reachable"] == 1
    assert set(port_snap["tenants"]) == {"gold", "free"}
    for ten in port_snap["tenants"].values():
        assert ten["submitted"] == ten["completed"] == 3
    rep = port_snap["replicas"][ep]
    assert sorted(rep["breakers"]) == ["free/r0", "free/r1", "gold/r0", "gold/r1"]
    assert {b["state"] for b in rep["breakers"].values()} == {"closed"}
    assert port_snap["fleet"]["requests"] >= 6
    with open(out_path) as f:
        assert _stable(json.load(f)) == _stable(port_snap)
    line = json.loads(human.out.strip().splitlines()[-1])
    assert line["metric"] == "obs_top" and line["value"] == 1
    assert line["extra"]["tenants"] == ["free", "gold"]
    assert "breaker gold/r0: closed" in human.err


def test_top_unreachable_endpoint_is_schema_stable(capsys):
    srv, tm = _fabric()
    try:
        eps = [f"127.0.0.1:{srv.port}", "127.0.0.1:1"]
        port_snap = port_tools.collect_fleet_snapshot(eps, timeout=2.0)
        jax_snap = jax_tools.collect_fleet_snapshot(eps, timeout=2.0)
        rc = port_tools.main(["top", "--endpoint", "127.0.0.1:1", "--once", "--json",
                              "--timeout", "2"])
        capsys.readouterr()
    finally:
        srv.stop()
        assert tm.drain(timeout=TIMEOUT)
    assert _stable(port_snap) == _stable(jax_snap)
    assert port_snap["endpoints"] == 2 and port_snap["reachable"] == 1
    dead = port_snap["replicas"]["127.0.0.1:1"]
    assert not dead["reachable"] and dead["error"]
    assert set(dead) == set(port_snap["replicas"][eps[0]])
    assert rc == 2
