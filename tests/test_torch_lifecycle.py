"""The port's lifecycle loop (``photon_ml_tpu_torch.lifecycle`` and
``cli/retrain.py``) against the JAX package's, on the CPU.

The version-directory, orchestrator, breaker-scope and warm-start cases of
``tests/test_lifecycle.py`` run on both packages with the same seeded
exports and the same fake retrain, reload and verify functions: the
``CycleResult`` stage lists (name, outcome, attempts, error type), the
latch, the backoff and the plans are equal. An export written by either
package loads in the other through ``load_warm_start``, and the
``retrain.warm_start`` corrupt seam poisons the same element of a plain
and of a factored table with the same refusal. Then
``python -m photon_ml_tpu_torch.cli.retrain once --always --device cpu``
on a small GAME config is held to the JAX ``cli.retrain`` run on the same
watch root (the tolerance of ``tests/test_torch_game_train.py``), and a
GAME driver export (its model under ``best/``) warm-starts the port's
retrain leg and serves as the fingerprint trigger's baseline.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import photon_ml_tpu.io.models as jax_models
import photon_ml_tpu.io.vocab as jax_vocab
import photon_ml_tpu.lifecycle as jax_lifecycle
import photon_ml_tpu.obs as jax_obs
import photon_ml_tpu.resilience.faults as jax_faults
import photon_ml_tpu.serving as jax_serving
import photon_ml_tpu_torch.io.models as port_models
import photon_ml_tpu_torch.io.vocab as port_vocab
import photon_ml_tpu_torch.lifecycle as port_lifecycle
import photon_ml_tpu_torch.obs as port_obs
import photon_ml_tpu_torch.resilience.faults as port_faults
import photon_ml_tpu_torch.serving as port_serving
from photon_ml_tpu.cli import retrain as jax_retrain
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.cli import retrain as port_retrain
from photon_ml_tpu_torch.game.factored import FactoredParams

pytestmark = pytest.mark.lifecycle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261018


def _pkg(lifecycle, models, vocab, faults, serving, obs, registry_kw):
    return types.SimpleNamespace(
        **{n: getattr(lifecycle, n) for n in lifecycle.__all__},
        models=models, FeatureVocabulary=vocab.FeatureVocabulary, feature_key=vocab.feature_key,
        FaultSpec=faults.FaultSpec, inject=faults.inject, corrupt_file=faults.corrupt_file,
        ModelRegistry=serving.ModelRegistry, obs=obs, registry_kw=registry_kw,
    )


PKGS = {
    "jax": _pkg(jax_lifecycle, jax_models, jax_vocab, jax_faults, jax_serving, jax_obs, {}),
    "port": _pkg(port_lifecycle, port_models, port_vocab, port_faults, port_serving, port_obs,
                 {"device": "cpu"}),
}


def _both(case, tmp_path):
    """``case(pkg, rng, tmp)`` on each package: the same seed, its own
    directory, a fresh default metrics registry."""
    out = {}
    for name, pkg in PKGS.items():
        prev = pkg.obs.set_registry(pkg.obs.MetricsRegistry())
        try:
            tmp = tmp_path / name
            tmp.mkdir()
            out[name] = case(pkg, np.random.default_rng(SEED), tmp)
        finally:
            pkg.obs.set_registry(prev)
    return out


def _export(pkg, root, rng, d=3, users=("u0", "u1", "u2"), scale=1.0):
    """tests/test_lifecycle.py's sealed GAME export, by ``pkg``."""
    vocab = pkg.FeatureVocabulary([pkg.feature_key(f"f{j}", "") for j in range(d)])
    return pkg.export_retrained_model(
        root,
        params={"global": scale * np.arange(1.0, d + 1),
                "per-user": scale * rng.normal(size=(len(users), d))},
        shards={"global": "s", "per-user": "s"},
        vocabs={"global": vocab, "per-user": vocab},
        entity_vocabs={"per-user": {u: i for i, u in enumerate(users)}},
        random_effects={"global": None, "per-user": "userId"},
    )


def _tear(pkg, export_dir):
    for base, _, files in sorted(os.walk(export_dir)):
        for f in sorted(files):
            if f != pkg.models.MODEL_MANIFEST:
                pkg.corrupt_file(os.path.join(base, f))
                return
    raise AssertionError("no payload file to corrupt")


def _rel(path, tmp):
    return None if path is None else os.path.relpath(path, tmp)


def _result(res, tmp):
    """A CycleResult without its clock readings and with paths relative."""
    return {
        "ok": res.ok, "triggered": res.triggered, "skipped": res.skipped, "stage": res.stage,
        "stages": [(s.name, s.ok, s.attempts, None if s.error is None else s.error.split("(")[0])
                   for s in res.stages],
        "export_dir": _rel(res.export_dir, tmp), "version": res.version,
        "retry": res.next_retry_s is not None and res.next_retry_s > 0,
        "plan": None if res.plan is None else {
            **res.plan.to_dict(), "warm_start_dir": _rel(res.plan.warm_start_dir, tmp)},
    }


def _orchestrator(pkg, watch, retrain_fn, reload_fn, trigger=None, **kw):
    return pkg.RetrainOrchestrator(
        trigger=trigger or (lambda: {"source": "test"}), retrain_fn=retrain_fn,
        reload_fn=reload_fn, watch_root=watch, stage_backoff_s=0.0, cycle_backoff_s=0.05,
        max_cycle_backoff_s=0.4, **kw)


def _lifecycle_counters(pkg):
    snap = pkg.obs.registry().snapshot()
    return ({k: v for k, v in snap["counters"].items() if k.startswith("lifecycle.")},
            {k: v for k, v in snap["gauges"].items() if k == "lifecycle.alarm_latched"})


# ---------------------------------------------------------------------------
# version directories
# ---------------------------------------------------------------------------


class TestVersionDirs:
    def test_partials_burn_numbers_but_stay_invisible(self, tmp_path):
        def case(pkg, rng, tmp):
            watch = str(tmp / "watch")
            _export(pkg, os.path.join(watch, "v0001"), rng)
            os.makedirs(os.path.join(watch, "v0002"))
            return _rel(pkg.next_version_dir(watch), tmp), _rel(pkg.latest_version_dir(watch), tmp)

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"] == (os.path.join("watch", "v0003"),
                                             os.path.join("watch", "v0001"))

    def test_verified_resolver_skips_torn_export(self, tmp_path):
        def case(pkg, rng, tmp):
            watch = str(tmp / "watch")
            _export(pkg, os.path.join(watch, "v0001"), rng)
            _tear(pkg, _export(pkg, os.path.join(watch, "v0002"), rng))
            return (_rel(pkg.latest_version_dir(watch), tmp),
                    _rel(pkg.latest_version_dir(watch, verified=True), tmp))

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"] == (os.path.join("watch", "v0002"),
                                             os.path.join("watch", "v0001"))

    def test_empty_watch_root(self, tmp_path):
        def case(pkg, rng, tmp):
            watch = str(tmp / "nothing")
            return (pkg.latest_version_dir(watch), pkg.latest_version_dir(watch, verified=True),
                    _rel(pkg.next_version_dir(watch), tmp),
                    os.path.basename(pkg.next_version_dir(watch, prefix="r")))

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"] == (None, None, os.path.join("nothing", "v0001"),
                                             "r0001")


# ---------------------------------------------------------------------------
# the orchestrator: stage semantics and degraded outcomes
# ---------------------------------------------------------------------------


class TestOrchestrator:
    def test_untriggered_cycle_is_a_noop(self, tmp_path):
        def case(pkg, rng, tmp):
            calls = []
            orch = _orchestrator(pkg, str(tmp / "watch"), retrain_fn=calls.append,
                                 reload_fn=calls.append, trigger=lambda: None)
            res = orch.run_cycle()
            return _result(res, tmp), calls, orch.alarm_latched, _lifecycle_counters(pkg)

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"]
        res, calls, latched, _ = out["port"]
        assert res["ok"] and not res["triggered"] and not calls and not latched

    def test_happy_cycle_warm_starts_from_verified_export(self, tmp_path):
        def case(pkg, rng, tmp):
            watch = str(tmp / "watch")
            _export(pkg, os.path.join(watch, "v0001"), rng)
            _tear(pkg, _export(pkg, os.path.join(watch, "v0002"), rng))

            def retrain(plan):
                return _export(pkg, pkg.next_version_dir(watch), rng, scale=2.0)

            orch = _orchestrator(pkg, watch, retrain, lambda d: os.path.basename(d))
            res = orch.run_cycle()
            return (_result(res, tmp), orch.alarm_latched, orch.consecutive_failures,
                    _lifecycle_counters(pkg))

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"]
        res, latched, failures, _ = out["port"]
        assert [s[0] for s in res["stages"]] == ["trigger", "plan", "retrain", "export_gate",
                                                 "reload", "verify"]
        assert res["plan"]["warm_start_dir"] == os.path.join("watch", "v0001")
        assert res["version"] == "v0003" and not latched and failures == 0

    def test_failed_retrain_latches_backs_off_then_recovers(self, tmp_path):
        def case(pkg, rng, tmp):
            watch = str(tmp / "watch")
            _export(pkg, os.path.join(watch, "v0001"), rng)
            healthy = {"on": False}

            def retrain(plan):
                if not healthy["on"]:
                    raise OSError("training cluster unreachable")
                return _export(pkg, pkg.next_version_dir(watch), rng)

            orch = _orchestrator(pkg, watch, retrain, lambda d: os.path.basename(d),
                                 max_stage_attempts=2)
            r1 = _result(orch.run_cycle(), tmp)
            latched1 = orch.alarm_latched
            r2 = _result(orch.run_cycle(), tmp)
            healthy["on"] = True
            r3 = _result(orch.run_cycle(force=True), tmp)
            return (r1, latched1, r2, r3, orch.alarm_latched, orch.consecutive_failures,
                    _lifecycle_counters(pkg))

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"]
        r1, latched1, r2, r3, latched, failures, _ = out["port"]
        assert not r1["ok"] and r1["stage"] == "retrain" and r1["stages"][-1][2] == 2
        assert latched1 and r1["retry"]
        assert r2["skipped"] and not r2["ok"] and r2["retry"]
        assert r3["ok"] and r3["version"] == "v0002" and not latched and failures == 0

    def test_export_gate_rejects_torn_export_before_reload(self, tmp_path):
        def case(pkg, rng, tmp):
            watch = str(tmp / "watch")
            _export(pkg, os.path.join(watch, "v0001"), rng)
            reloads = []

            def retrain(plan):
                out = _export(pkg, pkg.next_version_dir(watch), rng)
                _tear(pkg, out)
                return out

            orch = _orchestrator(pkg, watch, retrain, reloads.append)
            return _result(orch.run_cycle(), tmp), reloads, orch.alarm_latched

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"]
        res, reloads, latched = out["port"]
        assert not res["ok"] and res["stage"] == "export_gate" and not reloads and latched

    def test_post_reload_verify_failure_keeps_latch(self, tmp_path):
        def case(pkg, rng, tmp):
            watch = str(tmp / "watch")
            _export(pkg, os.path.join(watch, "v0001"), rng)
            orch = _orchestrator(pkg, watch,
                                 lambda plan: _export(pkg, pkg.next_version_dir(watch), rng),
                                 lambda d: os.path.basename(d),
                                 verify_fn=lambda: {"alarm": True, "psi_max": 9.9})
            return _result(orch.run_cycle(), tmp), orch.alarm_latched

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"]
        assert out["port"][0]["stage"] == "verify" and out["port"][1]

    def test_warm_start_fault_site_fails_retrain_stage(self, tmp_path):
        def case(pkg, rng, tmp):
            watch = str(tmp / "watch")
            _export(pkg, os.path.join(watch, "v0001"), rng)

            def retrain(plan):
                pkg.load_warm_start(plan.warm_start_dir)
                raise AssertionError("warm start should have failed")

            orch = _orchestrator(pkg, watch, retrain, lambda d: d, max_stage_attempts=1)
            with pkg.inject(pkg.FaultSpec("retrain.warm_start", "corrupt", nth=1, count=-1)):
                res = orch.run_cycle()
            return _result(res, tmp), _rel(pkg.latest_version_dir(watch), tmp)

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"]
        res, latest = out["port"]
        assert res["stage"] == "retrain" and res["stages"][-1][3] == "WarmStartError"
        assert latest == os.path.join("watch", "v0001")

    @pytest.mark.parametrize("mode", ["raise", "corrupt"])
    def test_export_fault_site(self, tmp_path, mode):
        """``retrain.export``: raise-mode leaves a partial directory with no
        manifest (invisible, its number burned); corrupt-mode seals a torn
        export that the orchestrator's gate refuses."""

        def case(pkg, rng, tmp):
            watch = str(tmp / "watch")
            _export(pkg, os.path.join(watch, "v0001"), rng)
            orch = _orchestrator(pkg, watch,
                                 lambda plan: _export(pkg, pkg.next_version_dir(watch), rng),
                                 lambda d: os.path.basename(d), max_stage_attempts=1)
            with pkg.inject(pkg.FaultSpec("retrain.export", mode, nth=1, count=-1)):
                res = orch.run_cycle()
            return (_result(res, tmp), _rel(pkg.latest_version_dir(watch), tmp),
                    _rel(pkg.next_version_dir(watch), tmp), sorted(os.listdir(watch)))

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"]
        res, latest, nxt, listing = out["port"]
        assert res["stage"] == ("retrain" if mode == "raise" else "export_gate")
        assert listing == ["v0001", "v0002"] and nxt == os.path.join("watch", "v0003")
        assert latest == os.path.join("watch", "v0001" if mode == "raise" else "v0002")

    def test_watch_counts_retrains_and_plans_admissions(self, tmp_path):
        """``watch`` over three probes (the trigger fires on the second),
        and a plan that promotes repeat-missed entities and freezes the
        converged coordinates of a convergence report."""

        def case(pkg, rng, tmp):
            watch = str(tmp / "watch")
            _export(pkg, os.path.join(watch, "v0001"), rng)
            adm = str(tmp / "adm.json")
            with open(adm, "w") as f:
                json.dump({"version": 1, "entries": {"userId": {
                    "a": {"misses": 3, "last_seen": 1.0},
                    "b": {"misses": 1, "last_seen": 2.0},
                    "c": {"misses": 2, "last_seen": 3.0}}}}, f)
            report = str(tmp / "convergence-report.json")
            with open(report, "w") as f:
                json.dump({"coordinates": {
                    "global": {"nonconverged_frac": 0.0},
                    "per-user": {"nonconverged_frac": 0.5, "worst_entities": [3, 1, 2]}}}, f)
            probes = iter([None, {"source": "test"}, None])
            plans, sleeps = [], []
            orch = _orchestrator(
                pkg, watch,
                lambda plan: plans.append(plan) or _export(pkg, pkg.next_version_dir(watch),
                                                           rng),
                lambda d: os.path.basename(d), trigger=lambda: next(probes),
                admission_log_path=adm, convergence_report_path=report)
            orch._sleep = sleeps.append
            retrains = orch.watch(poll_s=7.0, max_cycles=3)
            plan = plans[0].to_dict()
            plan["warm_start_dir"] = _rel(plan["warm_start_dir"], tmp)
            return retrains, sleeps, plan, _result(orch.last_result, tmp)

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"]
        retrains, sleeps, plan, _ = out["port"]
        assert retrains == 1 and sleeps == [7.0, 7.0]
        assert plan["admitted"] == {"userId": ["a", "c"]}
        assert plan["retrain_coordinates"] == ["per-user"]
        assert plan["freeze_coordinates"] == ["global"]


# ---------------------------------------------------------------------------
# breaker scope
# ---------------------------------------------------------------------------


class TestBreakerScope:
    def test_quarantined_export_does_not_block_subsequent_good_one(self, tmp_path):
        def case(pkg, rng, tmp):
            watch = str(tmp / "watch")
            v1 = _export(pkg, os.path.join(watch, "v0001"), rng)
            reg = pkg.ModelRegistry(warmup_max_batch=8, breaker_threshold=2,
                                    breaker_backoff_s=300.0, **pkg.registry_kw)
            reg.load(v1, version_id="v0001")
            v2 = _export(pkg, os.path.join(watch, "v0002"), rng)
            _tear(pkg, v2)
            polls = [reg.poll(watch) for _ in range(2)]
            states = [reg.breaker.state(v2), reg.version()]
            _export(pkg, os.path.join(watch, "v0003"), rng, scale=2.0)
            polls.append(reg.poll(watch))
            states += [reg.version(), reg.breaker.state(v2)]
            return polls, states

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"]
        assert out["port"] == ([None, None, "v0003"], ["open", "v0001", "v0003", "open"])


# ---------------------------------------------------------------------------
# exports across packages and the warm-start gate
# ---------------------------------------------------------------------------


class TestWarmStartRoundtrip:
    def test_export_then_load_preserves_entity_keys(self, tmp_path):
        def case(pkg, rng, tmp):
            root = _export(pkg, str(tmp / "v0001"), rng, users=("zeta", "alpha", "mid"))
            params, shards, res, shard_vocabs, re_vocabs = pkg.load_warm_start(root)
            return (sorted(re_vocabs["userId"].items()), res, shards,
                    {n: np.asarray(p).tolist() for n, p in sorted(params.items())})

        out = _both(case, tmp_path)
        assert out["port"] == out["jax"]
        assert {k for k, _ in out["port"][0]} == {"zeta", "alpha", "mid"}

    @pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
    def test_export_written_by_either_package_loads_in_the_other(self, tmp_path, writer,
                                                                  reader):
        rng = np.random.default_rng(SEED)
        root = _export(PKGS[writer], str(tmp_path / "v0001"), rng, users=("b", "a", "c"))
        PKGS[reader].models.verify_model_manifest(root)
        got = PKGS[reader].load_warm_start(root)
        want = PKGS[writer].load_warm_start(root)
        assert got[1:3] == want[1:3]
        assert got[4] == want[4]
        for name in want[0]:
            np.testing.assert_array_equal(np.asarray(got[0][name]), np.asarray(want[0][name]))
        # and it serves in the reader's registry
        reg = PKGS[reader].ModelRegistry(warmup_max_batch=8, **PKGS[reader].registry_kw)
        assert reg.load(root).version_id == "v0001"

    @pytest.mark.parametrize("factored", [False, True], ids=["plain", "factored"])
    def test_corrupt_seam_poisons_the_same_element(self, tmp_path, factored):
        """The ``retrain.warm_start`` corrupt seam and the finiteness gate
        on an export whose first coordinate is a factored table (the port
        loads its leaves as tensors) or a plain one: the same refusal in
        both packages; unarmed, both load."""
        rng = np.random.default_rng(SEED)
        vocab = port_vocab.FeatureVocabulary([port_vocab.feature_key(f"f{j}", "")
                                              for j in range(3)])
        first = (FactoredParams(torch.from_numpy(rng.normal(size=(3, 2))),
                                torch.from_numpy(rng.normal(size=(3, 2))))
                 if factored else rng.normal(size=(3, 3)))
        root = port_lifecycle.export_retrained_model(
            str(tmp_path / "v0001"),
            params={"a-first": first, "global": np.arange(1.0, 4.0)},
            shards={"a-first": "s", "global": "s"},
            vocabs={"a-first": vocab, "global": vocab},
            entity_vocabs={"a-first": {"u0": 0, "u1": 1, "u2": 2}},
            random_effects={"a-first": "userId", "global": None},
        )
        errors = {}
        for name, pkg in PKGS.items():
            pkg.load_warm_start(root)
            with pkg.inject(pkg.FaultSpec("retrain.warm_start", "corrupt", nth=1)):
                with pytest.raises(pkg.WarmStartError) as exc:
                    pkg.load_warm_start(root)
            errors[name] = str(exc.value)
        assert errors["port"] == errors["jax"]
        assert "'a-first' has non-finite values" in errors["port"]

    def test_unreadable_warm_start_raises_from_the_seam(self, tmp_path):
        rng = np.random.default_rng(SEED)
        root = _export(PKGS["port"], str(tmp_path / "v0001"), rng)
        for pkg in PKGS.values():
            with pkg.inject(pkg.FaultSpec("retrain.warm_start", "raise", nth=1)):
                with pytest.raises(OSError):
                    pkg.load_warm_start(root)


# ---------------------------------------------------------------------------
# cli.retrain: the GAME retrain leg against the JAX CLI's
# ---------------------------------------------------------------------------

N_USERS, D_G, D_U = 9, 4, 2


def _records(rng, n, truth):
    w_g, w_u = truth
    recs = []
    for i in range(n):
        u = int(rng.integers(0, N_USERS))
        xg, xu = rng.normal(size=D_G), rng.normal(size=D_U)
        margin = xg @ w_g + xu @ w_u[u]
        recs.append({
            "uid": f"row{i}",
            "label": float(rng.uniform() < 1 / (1 + np.exp(-margin))),
            "features": ([{"name": f"g{j}", "term": "", "value": float(xg[j])}
                          for j in range(D_G)]
                         + [{"name": f"u{j}", "term": "", "value": float(xu[j])}
                            for j in range(D_U)]),
            "metadataMap": {"userId": f"user{u}"},
            "weight": None,
            "offset": float(rng.normal(0, 0.2)) if i % 3 else None,
        })
    return recs


@pytest.fixture(scope="module")
def game_inputs(tmp_path_factory):
    """Small GAME inputs, a driver config, and a flat sealed v0001 export
    of the same coordinates (the warm start both CLIs read)."""
    rng = np.random.default_rng(SEED)
    tmp = tmp_path_factory.mktemp("torch_lifecycle_retrain")
    truth = (rng.normal(size=D_G), rng.normal(size=(N_USERS, D_U)) * 1.5)
    train, validate = str(tmp / "train.avro"), str(tmp / "validate.avro")
    write_avro_file(train, TRAINING_EXAMPLE_SCHEMA, _records(rng, 240, truth))
    write_avro_file(validate, TRAINING_EXAMPLE_SCHEMA, _records(rng, 100, truth))
    shards, vocabs = {}, {}
    for shard, keys in (("gshard", [f"g{j}" for j in range(D_G)]),
                        ("ushard", [f"u{j}" for j in range(D_U)])):
        shards[shard] = str(tmp / f"{shard}.txt")
        vocabs[shard] = port_vocab.FeatureVocabulary(
            [port_vocab.feature_key(k, "") for k in keys], add_intercept=True)
        vocabs[shard].save(shards[shard])
    coord = {"optimizer": "TRON", "max_iters": 30, "tolerance": 1e-6}
    config = str(tmp / "game.json")
    with open(config, "w") as f:
        json.dump({
            "train_input": [train], "validate_input": [validate],
            "output_dir": str(tmp / "ignored"), "task": "LOGISTIC_REGRESSION",
            "num_iterations": 2, "updating_sequence": ["global", "per-user"],
            "feature_shards": shards,
            "coordinates": {
                "global": {"shard": "gshard", "reg_weights": [0.5], **coord},
                "per-user": {"shard": "ushard", "random_effect": "userId",
                             "reg_weights": [1.0], **coord}},
            "model_output_mode": "BEST", "precision": "float64",
        }, f)
    v1 = str(tmp / "v1-flat")
    # the prior model: half the truth, and users 0-5 only (the retrain's
    # other users start cold, the prior's rows carry by id)
    port_lifecycle.export_retrained_model(
        v1,
        params={"global": np.concatenate([truth[0] * 0.5, [0.1]]),
                "per-user": np.concatenate([truth[1][:6] * 0.5, np.zeros((6, 1))], axis=1)},
        shards={"global": "gshard", "per-user": "ushard"},
        vocabs={"global": vocabs["gshard"], "per-user": vocabs["ushard"]},
        entity_vocabs={"per-user": {f"user{u}": i for i, u in enumerate([5, 3, 0, 1, 2, 4])}},
        random_effects={"global": None, "per-user": "userId"},
    )
    return {"tmp": tmp, "config": config, "v1": v1, "vocabs": vocabs}


def _watch_with(v1, watch):
    shutil.copytree(v1, os.path.join(watch, "v0001"))
    return watch


def _tables(export):
    params, _, _, _, re_vocabs = port_models.load_game_model_auto(export)
    users = re_vocabs["userId"]
    table = np.asarray(params["per-user"])
    return (np.asarray(params["global"]),
            {u: table[i] for u, i in sorted(users.items())})


class TestRetrainCli:
    def test_once_always_on_the_cpu_equals_jax_cli(self, game_inputs):
        tmp = game_inputs["tmp"]
        p_watch = _watch_with(game_inputs["v1"], str(tmp / "watch-port"))
        j_watch = _watch_with(game_inputs["v1"], str(tmp / "watch-jax"))
        proc = subprocess.run(
            [sys.executable, "-m", "photon_ml_tpu_torch.cli.retrain", "once", "--always",
             "--device", "cpu", "--config", game_inputs["config"], "--watch-root", p_watch],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": ROOT},
        )
        assert proc.returncode == 0, proc.stderr
        p_out = json.loads(proc.stdout)
        # the JAX CLI's parser, orchestrator and GAME leg on the same inputs
        args = jax_retrain.build_arg_parser().parse_args(
            ["once", "--always", "--config", game_inputs["config"], "--watch-root", j_watch])
        j_res = jax_retrain._build_orchestrator(args).run_cycle()
        assert j_res.ok
        assert [(s["name"], s["ok"], s["attempts"]) for s in p_out["stages"]] == [
            (s.name, s.ok, s.attempts) for s in j_res.stages]
        assert p_out["version"] == j_res.version == "v0002"
        assert p_out["failed_stage"] is None and p_out["triggered"]
        for watch in (p_watch, j_watch):
            with open(os.path.join(watch, "v0002", "retrain-plan.json")) as f:
                plan = json.load(f)
            assert plan["warm_start_dir"] == os.path.join(watch, "v0001")
        p_w, p_t = _tables(os.path.join(p_watch, "v0002"))
        j_w, j_t = _tables(os.path.join(j_watch, "v0002"))
        np.testing.assert_allclose(p_w, j_w, rtol=0, atol=1e-8)
        assert sorted(p_t) == sorted(j_t)
        for u in j_t:
            np.testing.assert_allclose(p_t[u], j_t[u], rtol=0, atol=1e-8, err_msg=u)
        # a warm-started run is not the cold one: the prior's rows moved it
        cold = port_retrain._game_retrain_fn(game_inputs["config"], str(tmp / "cold"), "cpu")(
            port_lifecycle.RetrainPlan({}, {}, None, [], {}, None))
        c_w, _ = _tables(cold)
        assert np.max(np.abs(c_w - p_w)) > 1e-8

    def test_game_driver_export_warm_starts_and_is_the_baseline(self, game_inputs, tmp_path):
        """A GAME driver's export keeps its model and fingerprint under
        ``best/``: the port's retrain leg warm-starts from that model and
        the trigger reads that fingerprint (a divergence by design: the
        JAX CLI reads only the export's root there)."""
        from photon_ml_tpu_torch.cli.game_train import run_game_training
        from photon_ml_tpu_torch.obs import quality as tq

        with open(game_inputs["config"]) as f:
            cfg = json.load(f)
        watch = str(tmp_path / "watch")
        run_game_training({**cfg, "output_dir": os.path.join(watch, "v0001")}, device="cpu")
        v1 = os.path.join(watch, "v0001")
        assert not os.path.exists(os.path.join(v1, tq.QUALITY_FINGERPRINT))
        assert port_retrain._baseline_dir(v1) == os.path.join(v1, "best")
        assert port_retrain._baseline_dir(None) is None
        # the fingerprint trigger: a shifted traffic window alarms against
        # v0001's best/ fingerprint
        base = tq.BaselineFingerprint.load(os.path.join(v1, "best"))
        cur = tq.BaselineFingerprint()
        shard, cols = sorted(base.shards.items())[0]
        rng = np.random.default_rng(SEED)
        cur.observe_rows(shard, rng.normal(size=(400, len(cols))) * 4.0 + 3.0)
        cur_dir = str(tmp_path / "traffic")
        os.makedirs(cur_dir)
        cur.save(cur_dir)
        args = port_retrain.build_arg_parser().parse_args(
            ["once", "--config", game_inputs["config"], "--watch-root", watch,
             "--current-fp", cur_dir, "--device", "cpu"])
        check, verify = port_retrain._make_trigger(args)
        reason = check()
        assert reason is not None and reason["source"] == "fingerprint" and reason["alarm"]
        # the retrain leg warm-starts from best/ (the training log names
        # the coordinates it loaded)
        plan = port_lifecycle.RetrainPlan(reason, {}, None, [], {}, v1)
        out = port_retrain._game_retrain_fn(game_inputs["config"], watch, "cpu")(plan)
        with open(os.path.join(out, "log-message.txt")) as f:
            log = f.read()
        assert (f"warm-starting coordinates ['global', 'per-user'] from "
                f"{os.path.join(v1, 'best')}") in log
        port_models.verify_model_manifest(out)
        assert os.path.exists(os.path.join(out, "best", tq.QUALITY_FINGERPRINT))
        # the verify stage reads the retrained export's own fingerprint
        # (best/), which the shifted window still alarms against
        report = verify()
        assert report is not None and report["alarm"] and report["baseline_rows"] == 240

    def test_warm_start_fault_fails_the_cli_cycle(self, game_inputs, capsys):
        """``retrain.warm_start`` corrupt in the CLI's GAME leg: the cycle
        fails at the retrain stage, exit 1, no new version published."""
        watch = _watch_with(game_inputs["v1"], str(game_inputs["tmp"] / "watch-fault"))
        with port_faults.inject(port_faults.FaultSpec("retrain.warm_start", "corrupt", nth=1,
                                                      count=-1)):
            with pytest.raises(SystemExit) as exc:
                port_retrain.main(["once", "--always", "--device", "cpu", "--config",
                                   game_inputs["config"], "--watch-root", watch,
                                   "--max-stage-attempts", "1"])
        assert exc.value.code == 1
        out = json.loads(capsys.readouterr().out)
        assert out["failed_stage"] == "retrain" and "WarmStartError" in out["stages"][-1]["error"]
        assert sorted(os.listdir(watch)) == ["v0001"]

    def test_plan_subcommand_equals_jax_cli(self, game_inputs, capsys):
        watch = _watch_with(game_inputs["v1"], str(game_inputs["tmp"] / "watch-plan"))
        argv = ["plan", "--watch-root", watch]
        outs = []
        for mod in (port_retrain, jax_retrain):
            mod.main(argv)
            outs.append(json.loads(capsys.readouterr().out))
        assert outs[0] == outs[1]
        assert outs[0]["next_export_dir"] == os.path.join(watch, "v0002")

    def test_game_train_warm_from_watch_root(self, game_inputs, tmp_path, capsys,
                                             monkeypatch):
        """``cli.game_train --warm-from-watch-root``: the newest export of
        the root is the warm start; an empty root is refused as the JAX
        CLI refuses it (its process-wide compilation cache and multi-host
        join, which run before the refusal, stubbed out)."""
        import photon_ml_tpu.parallel as jax_parallel
        import photon_ml_tpu.utils as jax_utils
        from photon_ml_tpu.cli import game_train as jax_game_train
        from photon_ml_tpu_torch.cli import game_train as port_game_train

        monkeypatch.setattr(jax_utils, "enable_compilation_cache", lambda: None)
        monkeypatch.setattr(jax_parallel, "initialize_multihost", lambda: None)

        errs = []
        for mod, extra in ((port_game_train, ["--device", "cpu"]), (jax_game_train, [])):
            with pytest.raises(SystemExit) as exc:
                mod.main(["--config", game_inputs["config"], "--warm-from-watch-root",
                          str(tmp_path / "empty"), *extra])
            assert exc.value.code == 2
            errs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1])
        assert errs[0] == errs[1]
        watch = _watch_with(game_inputs["v1"], str(tmp_path / "watch"))
        with open(game_inputs["config"]) as f:
            cfg = json.load(f)
        config = str(tmp_path / "game.json")
        with open(config, "w") as f:
            json.dump({**cfg, "output_dir": str(tmp_path / "out")}, f)
        port_game_train.main(["--config", config, "--warm-from-watch-root", watch,
                              "--device", "cpu"])
        with open(tmp_path / "out" / "log-message.txt") as f:
            log = f.read()
        assert (f"warm-starting coordinates ['global', 'per-user'] from "
                f"{os.path.join(watch, 'v0001')}") in log

    def test_no_trigger_chosen_is_refused(self, game_inputs):
        for mod in (port_retrain, jax_retrain):
            args = mod.build_arg_parser().parse_args(
                ["once", "--config", game_inputs["config"], "--watch-root", "w"])
            with pytest.raises(SystemExit, match="choose a trigger"):
                mod._make_trigger(args)
