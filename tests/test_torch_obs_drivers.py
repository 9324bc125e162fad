"""The observability settings of both training drivers against the JAX
drivers, on the CPU in float64, on the drivers' own test fixtures: each of
the twelve settings the port used to refuse (GLM: ``profile``,
``debug_nans``, ``trace_dir``, ``metrics_every``, ``profile_dir``,
``flight_dir``, ``convergence_report``; GAME: the last five) runs in the
port's driver and the JAX driver with the setting on, and they write the
same files (the profile's format aside), the same models (w and tables
within 1e-10), the same span names and counts in ``trace.json``, the same
deterministic counters in ``metrics.json`` and ``convergence-report.json``
within 1e-10 (``torch_obs_parity`` lists the names that differ by design).
The pins of ``test_torch_train.py`` and ``test_torch_game_train.py`` run
the same comparisons under their old ids.

Also: an untraced run records no cost and no convergence entry and ends
with the traced run's bits; a SIGTERM to a traced training subprocess
leaves ``flight-preemption.json`` and a flushed trace; and a gloo world of
2 ranks, each with its own ``trace_dir``, merges into one pod trace aligned
by the barrier-backed clock sync, its metrics under ``host.<i>.`` and
``pod.`` with the collective counters of each rank.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu import obs as jax_obs
from photon_ml_tpu.cli.game_train import run_game_training as jax_game
from photon_ml_tpu.cli.train import run_glm_training as jax_glm
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.cli import game_train as tgame
from photon_ml_tpu_torch.cli import train as ttrain
from photon_ml_tpu_torch.kernels import dispatch
from torch_obs_hygiene import clean_obs  # noqa: F401
from torch_obs_parity import (
    assert_same_counters,
    assert_same_report_files,
    assert_same_spans,
    files_under,
)

pytestmark = [pytest.mark.obs, pytest.mark.usefixtures("clean_obs")]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh_registries():
    return jax_obs.set_registry(jax_obs.MetricsRegistry()), obs.set_registry(obs.MetricsRegistry())


def _restore_registries(prev):
    jax_obs.set_registry(prev[0])
    obs.set_registry(prev[1])


def _w_within(got, ref, tol=1e-10):
    for g, r in zip(got.models, ref.models):
        np.testing.assert_allclose(g.model.coefficients.means.numpy(),
                                   np.asarray(r.model.coefficients.means), atol=tol, rtol=0)


def _crash_records(path):
    """(kind, name) of a flight dump's span and event records, the names
    that differ by design aside, and the crash's exception type."""
    from torch_obs_parity import JAX_ONLY_NAMES, PORT_ONLY_NAMES

    with open(path) as f:
        doc = json.load(f)
    recs = [(r.get("kind"), r.get("name")) for r in doc["records"]
            if r.get("kind") in ("span", "event")
            and r.get("name") not in JAX_ONLY_NAMES | PORT_ONLY_NAMES]
    return doc["reason"], recs, doc["records"][-1].get("exception", "").split(":")[0]


# ---------------------------------------------------------------------------
# GLM
# ---------------------------------------------------------------------------

def glm_obs_parity(fixture, setting: str) -> None:
    """The port's GLM driver against the JAX driver with ``setting`` on
    (sparse TRON, two lambdas, validation)."""
    from test_torch_train import _assert_same_runs, _params

    runs, outs, extras = {}, {}, {}
    for pkg in ("jax", "port"):
        out = str(fixture["tmp"] / f"obs-{pkg}-{setting}")
        extra = {
            "profile": {"profile": True},
            "debug_nans": {"debug_nans": True},
            "trace_dir": {"trace_dir": out + "-trace"},
            "metrics_every": {"metrics_every": 0.01},
            "profile_dir": {"profile_dir": out + "-profile"},
            # a malformed constraint file fails the train stage inside the
            # envelope: the crash dump
            "flight_dir": {"flight_dir": out + "-flight",
                           "constraint_file": str(fixture["tmp"] / "bad-constraints.json")},
            "convergence_report": {"convergence_report": True},
        }[setting]
        params = {**_params(fixture, os.path.basename(out), optimizer="TRON", sparse=True,
                            **extra), "quality_fingerprint": True}
        outs[pkg], extras[pkg] = out, extra
        prev = _fresh_registries()
        try:
            if setting == "flight_dir":
                (fixture["tmp"] / "bad-constraints.json").write_text("[{not json")
                with pytest.raises(Exception) as err:
                    (jax_glm(params) if pkg == "jax"
                     else ttrain.run_glm_training(params, device="cpu"))
                runs[pkg] = err.value
            else:
                runs[pkg] = (jax_glm(params) if pkg == "jax"
                             else ttrain.run_glm_training(params, device="cpu"))
        finally:
            _restore_registries(prev)
    assert obs.get_tracer() is None and obs.flight_recorder() is None
    assert obs.convergence_tracker() is None and not dispatch._output_check
    if setting == "flight_dir":
        assert type(runs["port"]).__name__ == type(runs["jax"]).__name__
        dumps = {pkg: sorted(os.listdir(extras[pkg]["flight_dir"])) for pkg in outs}
        assert dumps["port"] == dumps["jax"] == ["flight-crash.json"]
        got, want = (_crash_records(os.path.join(extras[pkg]["flight_dir"],
                                                 "flight-crash.json")) for pkg in ("port", "jax"))
        assert got == want and got[0] == "crash" and got[1]
        return
    got, ref = runs["port"], runs["jax"]
    _assert_same_runs(got, ref)
    _w_within(got, ref)
    assert files_under(outs["port"]) == files_under(outs["jax"])
    if setting in ("trace_dir", "metrics_every", "convergence_report"):
        mdir = extras["port"].get("trace_dir", outs["port"])
        jdir = extras["jax"].get("trace_dir", outs["jax"])
        if setting == "trace_dir":
            assert sorted(os.listdir(mdir)) == sorted(os.listdir(jdir)) == [
                "events.jsonl", "metrics.json", "trace.json"]
            spans = assert_same_spans(mdir, jdir)
            assert spans[("glm.solve", "X")] == 2 and spans[("glm.solve_path", "X")] == 1
            with open(os.path.join(mdir, "trace.json")) as f:
                solves = [e for e in json.load(f)["traceEvents"] if e["name"] == "glm.solve"]
            for e in solves:
                assert e["args"]["flops"] > 0 and e["args"]["bytes_per_s"] > 0
                # the CPU is not an H100: no share
                assert "mfu" not in e["args"] and "hbm_util" not in e["args"]
        c = assert_same_counters(os.path.join(mdir, "metrics.json"),
                                 os.path.join(jdir, "metrics.json"))
        if setting != "metrics_every":
            assert c["solver.tron.iterations"] == sum(tm.result.iterations for tm in got.models)
            assert c["solver.tron.cg_iterations"] == sum(
                tm.result.cg_iterations for tm in got.models)
            assert c["solver.iterations"] == c["solver.tron.iterations"]
        else:
            assert not any(k.startswith(("solver.", "convergence.")) for k in c)
    if setting == "convergence_report":
        doc = assert_same_report_files(os.path.join(outs["port"], "convergence-report.json"),
                                       os.path.join(outs["jax"], "convergence-report.json"))
        assert doc["solves"] == 2 and len(doc["last_solves"]) == 2
    if setting in ("profile", "profile_dir"):
        pdir = (os.path.join(outs["port"], "profile") if setting == "profile"
                else extras["port"]["profile_dir"])
        (path,) = glob.glob(os.path.join(pdir, "*.pt.trace.json"))
        with open(path) as f:
            assert json.load(f)["traceEvents"]
        jdir = (os.path.join(outs["jax"], "profile") if setting == "profile"
                else extras["jax"]["profile_dir"])
        assert any(files for _, _, files in os.walk(jdir))


@pytest.mark.parametrize("setting", ["debug_nans", "metrics_every", "profile_dir", "flight_dir"])
def test_glm_driver_setting_matches_jax(glm_fixture, setting):
    """The GLM settings without a pin of their own (the others run under
    ``test_torch_train.py``'s old ids)."""
    glm_obs_parity(glm_fixture, setting)


@pytest.fixture(scope="module")
def glm_fixture(tmp_path_factory):
    from photon_ml_tpu.io.avro import write_avro_file
    from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
    from test_torch_train import D, _records

    rng = np.random.default_rng(20261016)
    tmp = tmp_path_factory.mktemp("torch_obs_glm")
    w_true = rng.normal(size=D) * 0.4
    write_avro_file(str(tmp / "train.avro"), TRAINING_EXAMPLE_SCHEMA, _records(rng, 300, w_true))
    write_avro_file(str(tmp / "valid.avro"), TRAINING_EXAMPLE_SCHEMA, _records(rng, 200, w_true))
    return {"train": str(tmp / "train.avro"), "valid": str(tmp / "valid.avro"), "tmp": tmp}


def test_debug_nans_names_the_producing_op_in_the_driver(glm_fixture, monkeypatch):
    """A NaN produced inside the train stage fails the port's driver at
    the op that produced it, as ``jax_debug_nans`` fails the JAX driver's."""
    from photon_ml_tpu_torch.ops import objective as objective_mod
    from test_torch_train import _params

    real = objective_mod.GLMObjective.value_grad_curvature

    def poisoned(self, w, batch):
        torch.sqrt(torch.full((1,), -1.0, dtype=w.dtype))  # the producer
        return real(self, w, batch)

    monkeypatch.setattr(objective_mod.GLMObjective, "value_grad_curvature", poisoned)
    params = _params(glm_fixture, "obs-port-nans-poisoned", optimizer="TRON", sparse=True,
                     debug_nans=True, quality_fingerprint=False)
    with pytest.raises(FloatingPointError, match="sqrt"):
        ttrain.run_glm_training(params, device="cpu")
    assert not dispatch._output_check
    # without the setting the same run ends (the NaN is never used)
    params = {**params, "debug_nans": False, "output_dir": params["output_dir"] + "-off"}
    assert ttrain.run_glm_training(params, device="cpu").models


def test_untraced_glm_run_records_no_cost_and_keeps_its_bits(glm_fixture):
    """No tracer and no tracker: the cost book stays empty, no solver or
    convergence entry is recorded, and w is bit for bit the traced run's."""
    from test_torch_train import _params

    kw = dict(optimizer="TRON", sparse=True, quality_fingerprint=False)
    plain = ttrain.run_glm_training(_params(glm_fixture, "obs-untraced", **kw), device="cpu")
    assert obs.cost_book().names() == []
    names = obs.registry().snapshot()["counters"]
    assert not any(k.startswith(("solver.", "convergence.")) for k in names)
    traced = ttrain.run_glm_training(
        _params(glm_fixture, "obs-traced", trace_dir=str(glm_fixture["tmp"] / "obs-tr"),
                convergence_report=True, **kw), device="cpu")
    assert obs.cost_book().names() != []
    for a, b in zip(plain.models, traced.models):
        assert torch.equal(a.model.coefficients.means, b.model.coefficients.means)
        assert a.result.iterations == b.result.iterations


# ---------------------------------------------------------------------------
# GAME
# ---------------------------------------------------------------------------

def game_obs_parity(inputs, setting: str) -> None:
    """The port's GAME driver against the JAX driver with ``setting`` on
    (a global fixed effect and a per-user random effect, two combos,
    validation after every update; ``flight_dir`` with the divergence
    guard and a corrupted per-user update, which both packages roll back
    and dump)."""
    from photon_ml_tpu.resilience import faults as jfaults
    from photon_ml_tpu_torch.resilience import faults as pfaults
    from test_torch_game_train import _assert_same_runs, _params

    runs, outs, extras = {}, {}, {}
    for pkg in ("jax", "port"):
        out = str(inputs["tmp"] / f"obs-{pkg}-{setting}")
        extra = {
            "trace_dir": {"trace_dir": out + "-trace"},
            "metrics_every": {"metrics_every": 0.01},
            "profile_dir": {"profile_dir": out + "-profile"},
            "flight_dir": {"flight_dir": out + "-flight", "divergence_guard": True},
            "convergence_report": {"convergence_report": True},
        }[setting]
        params = _params(inputs, os.path.basename(out), num_iterations=2,
                         quality_fingerprint=False, **extra)
        outs[pkg], extras[pkg] = out, extra
        faults = jfaults if pkg == "jax" else pfaults
        armed = ([faults.FaultSpec("descent.update", "corrupt", nth=2, count=1,
                                   key="per-user")] if setting == "flight_dir" else [])
        prev = _fresh_registries()
        try:
            with faults.inject(*armed):
                runs[pkg] = (jax_game(params) if pkg == "jax"
                             else tgame.run_game_training(params, device="cpu"))
        finally:
            _restore_registries(prev)
    assert obs.get_tracer() is None and obs.flight_recorder() is None
    assert obs.convergence_tracker() is None
    got, ref = runs["port"], runs["jax"]
    _assert_same_runs(got, ref)
    for g, r in zip(got.sweep, ref.sweep):
        for name, p in r["model"].params.items():
            np.testing.assert_allclose(g["model"].params[name].numpy(), np.asarray(p),
                                       rtol=0, atol=1e-10, err_msg=name)
    assert files_under(outs["port"]) == files_under(outs["jax"])
    if setting in ("trace_dir", "metrics_every", "convergence_report"):
        mdir = extras["port"].get("trace_dir", outs["port"])
        jdir = extras["jax"].get("trace_dir", outs["jax"])
        if setting == "trace_dir":
            spans = assert_same_spans(mdir, jdir)
            assert spans[("game.update", "X")] == 8 and spans[("game.pass", "X")] == 4
        c = assert_same_counters(os.path.join(mdir, "metrics.json"),
                                 os.path.join(jdir, "metrics.json"))
        assert c["game.updates"] == 8 and c["game.passes"] == 4
    if setting == "convergence_report":
        doc = assert_same_report_files(os.path.join(outs["port"], "convergence-report.json"),
                                       os.path.join(outs["jax"], "convergence-report.json"))
        assert doc["updates"] == 8 and set(doc["coordinates"]) == {"global", "per-user"}
    if setting == "profile_dir":
        (path,) = glob.glob(os.path.join(extras["port"]["profile_dir"], "*.pt.trace.json"))
        assert any(files for _, _, files in os.walk(extras["jax"]["profile_dir"]))
    if setting == "flight_dir":
        dumps = {pkg: sorted(os.listdir(extras[pkg]["flight_dir"])) for pkg in outs}
        assert dumps["port"] == dumps["jax"] == ["flight-divergence.json"]
        assert [h.event for s in got.sweep for h in s["history"]] == [
            h.event for s in ref.sweep for h in s["history"]]
        got_recs, want_recs = (
            _crash_records(os.path.join(extras[pkg]["flight_dir"], "flight-divergence.json"))
            for pkg in ("port", "jax"))
        assert got_recs[:2] == want_recs[:2] and got_recs[0] == "divergence"
        assert ("event", "resilience.rollback") in got_recs[1]


def test_untraced_game_run_records_no_cost_and_keeps_its_bits(tmp_path):
    """No tracer and no tracker (an ELL global effect, so that the traced
    run has a pass record): the cost book stays empty, no convergence
    entry is recorded, and the tables are bit for bit the traced run's;
    the traced run's fixed-effect update spans carry attribution."""
    from test_torch_checkpoint import _write_driver_inputs
    from test_torch_game_train import _params

    _write_driver_inputs(tmp_path)
    inputs = {"train": str(tmp_path / "train.avro"), "validate": str(tmp_path / "validate.avro"),
              "shards": {s: str(tmp_path / f"{s}.txt") for s in ("gshard", "ushard")},
              "tmp": tmp_path}
    kw = dict(sparse_shards=("gshard",), num_iterations=2, quality_fingerprint=False)
    plain = tgame.run_game_training(_params(inputs, "plain", **kw), device="cpu")
    assert obs.cost_book().names() == []
    assert not any(k.startswith("convergence.")
                   for k in obs.registry().snapshot()["counters"])
    traced = tgame.run_game_training(
        _params(inputs, "traced", trace_dir=str(tmp_path / "tr"), convergence_report=True, **kw),
        device="cpu")
    assert obs.cost_book().names() != []
    for a, b in zip(plain.sweep, traced.sweep):
        assert [h.objective for h in a["history"]] == [h.objective for h in b["history"]]
        for name, p in a["model"].params.items():
            q = b["model"].params[name]
            pairs = ([(p.gamma, q.gamma), (p.projection, q.projection)]
                     if hasattr(p, "gamma") else [(p, q)])
            for x, y in pairs:
                assert torch.equal(x, y), name
    with open(tmp_path / "tr" / "trace.json") as f:
        updates = [e for e in json.load(f)["traceEvents"] if e["name"] == "game.update"]
    fixed = [e for e in updates if e["args"]["coordinate"] == "global"]
    assert fixed and all(e["args"]["flops"] > 0 and e["args"]["timing"] == "wall"
                         for e in fixed)


# the subprocess: the GAME driver's CLI, traced and with a flight
# directory, its fixed-effect updates slowed so that a SIGTERM lands mid-run
_SIGTERM_CLI = """
import sys, time
from photon_ml_tpu_torch.cli import game_train
from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate
update = FixedEffectCoordinate.update_and_score
def slow(self, *a, **k):
    time.sleep(0.3)
    return update(self, *a, **k)
FixedEffectCoordinate.update_and_score = slow
game_train.main(["--config", sys.argv[1], "--device", "cpu", "--trace-dir", sys.argv[2],
                 "--flight-dir", sys.argv[3]])
"""


def test_sigterm_dumps_the_flight_recorder_and_flushes_the_trace(tmp_path):
    from test_torch_checkpoint import _driver_params, _write_driver_inputs

    _write_driver_inputs(tmp_path)
    params = _driver_params(tmp_path, "killed")
    cfg = str(tmp_path / "killed.json")
    with open(cfg, "w") as f:
        json.dump(params, f)
    trace_dir, flight_dir = str(tmp_path / "trace"), str(tmp_path / "flight")
    ckdir = os.path.join(params["output_dir"], "checkpoints", "combo-0")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.Popen([sys.executable, "-c", _SIGTERM_CLI, cfg, trace_dir, flight_dir],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not os.path.isdir(os.path.join(ckdir, "step-1")):
            assert proc.poll() is None, proc.stdout.read().decode()[-2000:]
            assert time.monotonic() < deadline, "no checkpoint within 120 s"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0].decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-2000:]
    assert os.path.exists(os.path.join(ckdir, "preempted.json"))
    with open(os.path.join(flight_dir, "flight-preemption.json")) as f:
        doc = json.load(f)
    assert doc["reason"] == "preemption"
    names = [r.get("name") for r in doc["records"]]
    assert "game.update" in names and "resilience.preemption_requested" in names
    with open(os.path.join(trace_dir, "events.jsonl")) as f:
        events = [json.loads(line)["name"] for line in f if line.strip()]
    assert "resilience.preemption_requested" in events and "game.update" in events
    with open(os.path.join(trace_dir, "metrics.json")) as f:
        assert json.load(f)["counters"]["resilience.preemptions"] == 1.0


# ---------------------------------------------------------------------------
# a world of two ranks
# ---------------------------------------------------------------------------


def test_rank_traces_merge_aligned_by_the_clock_sync(glm_fixture, tmp_path):
    """``mesh_shape {"data": 2}`` in a gloo world of 2, each rank with its
    own ``trace_dir``: the shards merge aligned by the barrier-backed
    ``clock.sync``, one pid per rank, and the merged metrics carry each
    rank's collective counters under the JAX package's key
    (``collective.<label>.w2``), equal to the rank's own counts. (The JAX
    package's sharded path fails on this box's jax, so the names are held
    to its key functions and the values to the port's counts.)"""
    from photon_ml_tpu_torch.obs import dist as port_dist
    from test_torch_train import _params
    from torch_worlds import run_world

    params = _params(glm_fixture, "obs-world", optimizer="TRON", sparse=True,
                     mesh_shape={"data": 2}, quality_fingerprint=False)
    root = str(tmp_path / "traces")
    ranks = run_world(tmp_path, 2, "traced_driver_world", params=params, trace_root=root)
    shards = []
    for r in range(2):
        doc, warn = port_dist.load_trace_shard(os.path.join(root, f"rank-{r}"))
        assert warn is None
        assert doc["metadata"]["process_index"] == r and doc["metadata"]["process_count"] == 2
        shards.append((doc, f"rank-{r}"))
    merged, info = obs.merge_trace_shards(shards)
    assert info["aligned_by"] == "sync" and info["shards"] == 2 and not info["warnings"]
    assert merged["metadata"]["sync_id"] == "startup"
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}
    snaps = []
    for r in range(2):
        with open(os.path.join(root, f"rank-{r}", "metrics.json")) as f:
            snaps.append((json.load(f), r))
    pod = port_dist.merge_metrics_shards(snaps)
    assert pod == jax_obs.dist.merge_metrics_shards(snaps)
    for r, rank in enumerate(ranks):
        assert rank["counts"], "the rank issued no collective"
        for label, c in rank["counts"].items():
            key = jax_obs.collectives.collective_metric_key(label, 2)
            assert pod["counters"][f"host.{r}.{key}.count"] == c["count"], label
            assert pod["counters"][f"host.{r}.{key}.bytes"] == c["bytes"], label
    key = jax_obs.collectives.collective_metric_key("value_grad", 2)
    assert pod["counters"][f"pod.{key}.count"] == sum(
        rank["counts"]["value_grad"]["count"] for rank in ranks)
    # gloo blocks: every collective's wall time is recorded
    assert all(pod["histograms"][f"host.{r}.{key}.wall_ms"]["count"] > 0 for r in range(2))
    for a, b in zip(ranks[0]["w"], ranks[1]["w"]):
        assert np.array_equal(a, b)
