"""The port's fault registry (``photon_ml_tpu_torch.resilience.faults``)
and the fault sites it gives the checkpoint store and coordinate descent,
held to the JAX package's: every case runs the same fault spec through
both packages and holds the outcomes equal.

Mirrors ``tests/test_resilience.py``: ``TestFaultRegistry`` (the triggers,
key filters, seeded draws, the env grammar, ``corrupt_file``), the fault
cases of ``TestCheckpointIntegrity`` (``checkpoint.save`` raising between
the write and the swap, a transient write retried, a torn write caught by
its digest, ``checkpoint.load`` falling back) and ``TestDivergenceGuard``
(``descent.update`` corrupting an update: the damped retry recovers, a
persistent fault freezes the coordinate, unguarded NaN spreads), the last
on ``tests/test_torch_game_descent.py``'s two-coordinate GAME in float64
(objectives within 1e-10).
"""

import os

import numpy as np
import pytest

from photon_ml_tpu.io import checkpoint as jax_ckpt
from photon_ml_tpu.resilience import faults as jax_faults
from photon_ml_tpu_torch.io import checkpoint as port_ckpt
from photon_ml_tpu_torch.resilience import faults as port_faults
from photon_ml_tpu_torch.resilience import RetryBudgetExceeded as PortRetryBudgetExceeded
from photon_ml_tpu.resilience import RetryBudgetExceeded as JaxRetryBudgetExceeded
from test_torch_game_descent import _assert_same_run, _data, _jax_descent, _torch_descent

pytestmark = pytest.mark.faults

PACKAGES = {"jax": (jax_faults, jax_ckpt, JaxRetryBudgetExceeded),
            "port": (port_faults, port_ckpt, PortRetryBudgetExceeded)}


def _both(case, *args):
    """``case(faults, checkpoint, RetryBudgetExceeded, *args)`` in each
    package -> (JAX outcome, port outcome)."""
    return tuple(case(*PACKAGES[p], *args) for p in ("jax", "port"))


def _outcome(fn):
    """What a probe did: "raise", True (corrupt) or False (clean)."""
    try:
        return bool(fn())
    except OSError as e:
        assert type(e).__name__ == "InjectedFault"
        return "raise"


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _nth_and_count(f, *_):
    with f.inject(f.FaultSpec("checkpoint.save", "raise", nth=2, count=2)):
        return [_outcome(lambda: f.registry.fire("checkpoint.save")) for _ in range(5)]


def _count_forever(f, *_):
    with f.inject(f.FaultSpec("ingest.read", "raise", nth=1, count=-1)):
        return [_outcome(lambda: f.registry.fire("ingest.read")) for _ in range(4)]


def _key_filter(f, *_):
    with f.inject(f.FaultSpec("descent.update", "corrupt", nth=1, count=-1, key="re")):
        return [_outcome(lambda k=k: f.registry.fire("descent.update", key=k))
                for k in ("fixed", "re", "re", None, "re")]


def _seeded_probability(f, *_):
    with f.inject(f.FaultSpec("ingest.read", "corrupt", p=0.5, seed=7)):
        return [f.registry.fire("ingest.read").corrupt for _ in range(40)]


def _inject_restores(f, *_):
    before = f.registry.calls("checkpoint.save")
    with f.inject(f.FaultSpec("checkpoint.save", "delay", nth=1, delay=0.0)):
        f.registry.fire("checkpoint.save")
        inside = f.registry.calls("checkpoint.save")
    return [inside, f.registry.active(), f.registry.calls("checkpoint.save") - before]


def _parse_env_spec(f, *_):
    specs = f.parse_spec(
        "checkpoint.save:raise@n=2;"
        "ingest.read:delay@p=0.1,seed=7,delay=0.2;"
        "descent.update:corrupt@n=3,count=-1,key=per-user"
    )
    return [(s.site, s.mode, s.nth, s.count, s.p, s.seed, s.delay, s.key) for s in specs]


def _parse_rejects_garbage(f, *_):
    out = []
    for text in ("checkpoint.save:explode@n=1", "checkpoint.save:raise@n=1,p=0.5",
                 "checkpoint.save:raise@n=1,bogus=2"):
        try:
            f.parse_spec(text)
            out.append("accepted")
        except ValueError as e:
            out.append(str(e))
    return out


def _unknown_site(f, *_):
    try:
        f.registry.arm(f.FaultSpec("no.such.site", "raise", nth=1))
        return "armed"
    except f.UnknownFaultSite as e:
        return str(e)


def _arm_from_env(f, *_):
    injector = f.FaultInjector()
    os.environ["PHOTON_FAULTS"] = "serving.score:corrupt@n=2;serving.reload:raise@n=1"
    try:
        armed = f.arm_from_env(injector)
    finally:
        del os.environ["PHOTON_FAULTS"]
    return [armed, injector.fire("serving.score").corrupt, injector.fire("serving.score").corrupt,
            _outcome(lambda: injector.fire("serving.reload"))]


def _corrupt_file(f, _ck, _rb, tmp_path):
    path = os.path.join(str(tmp_path), f"blob-{f.__name__}")
    with open(path, "wb") as fh:
        fh.write(bytes(range(64)))
    f.corrupt_file(path)
    f.corrupt_file(path, offset=3, nbytes=2)
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("case", [_nth_and_count, _count_forever, _key_filter,
                                  _seeded_probability, _inject_restores, _parse_env_spec,
                                  _parse_rejects_garbage, _unknown_site, _arm_from_env],
                         ids=lambda c: c.__name__.strip("_"))
def test_registry_equals_jax(case):
    jax_out, port_out = _both(case)
    assert port_out == jax_out


def test_registry_outcomes():
    """The port's outcomes are the ones ``tests/test_resilience.py``
    asserts of the JAX package."""
    f = port_faults
    assert _nth_and_count(f) == [False, "raise", "raise", False, False]
    assert _count_forever(f) == ["raise"] * 4
    assert _key_filter(f) == [False, True, True, False, True]
    draws = _seeded_probability(f)
    assert draws == _seeded_probability(f) and any(draws) and not all(draws)
    assert _inject_restores(f) == [1, False, 0]
    assert set(f.KNOWN_SITES) == set(jax_faults.KNOWN_SITES)
    assert {"descent.update", "checkpoint.save", "checkpoint.load", "serving.score",
            "serving.reload", "serving.cache_tier", "cache.admission_log"} <= set(f.KNOWN_SITES)


def test_corrupt_file_equals_jax(tmp_path):
    jax_out, port_out = _both(_corrupt_file, tmp_path)
    assert port_out == jax_out and port_out != bytes(range(64))


def test_injection_is_recorded_in_obs():
    from photon_ml_tpu_torch import obs

    before = obs.registry().counter("resilience.faults_injected.serving.score").value
    with port_faults.inject(port_faults.FaultSpec("serving.score", "corrupt", nth=1)):
        assert port_faults.fire("serving.score", key="8").corrupt
    assert obs.registry().counter("resilience.faults_injected.serving.score").value == before + 1


# ---------------------------------------------------------------------------
# the checkpoint store's sites
# ---------------------------------------------------------------------------


def _save_steps(ck, d, steps, keep=10):
    for s in steps:
        ck.save_checkpoint(d, s, {"w": np.full(3, float(s))}, np.zeros(2, np.uint32), keep=keep)


def _state(ck, d):
    latest = ck.latest_checkpoint(d)
    return (None if latest is None else (latest.step, latest.params["w"].tolist()),
            sorted(os.listdir(d)))


def _crash_between_write_and_swap(f, ck, retry_exc, tmp_path):
    d = os.path.join(str(tmp_path), f"crash-{f.__name__}")
    _save_steps(ck, d, [1])
    with f.inject(f.FaultSpec("checkpoint.save", "raise", nth=1, count=-1)):
        with pytest.raises(retry_exc):
            ck.save_checkpoint(d, 2, {"w": np.full(3, 2.0)}, np.zeros(2, np.uint32), retries=1)
    after_crash = _state(ck, d)
    _save_steps(ck, d, [2])  # the next clean save prunes the torn temp dir
    return after_crash, _state(ck, d)


def _transient_write_retried(f, ck, _rb, tmp_path):
    d = os.path.join(str(tmp_path), f"transient-{f.__name__}")
    with f.inject(f.FaultSpec("checkpoint.save", "raise", nth=1, count=1)):
        ck.save_checkpoint(d, 1, {"w": np.ones(3)}, np.zeros(2, np.uint32))
        calls = f.registry.calls("checkpoint.save")
    return calls, _state(ck, d)


def _torn_write_detected(f, ck, _rb, tmp_path):
    d = os.path.join(str(tmp_path), f"torn-{f.__name__}")
    _save_steps(ck, d, [1])
    with f.inject(f.FaultSpec("checkpoint.save", "corrupt", nth=1)):
        ck.save_checkpoint(d, 2, {"w": np.full(3, 2.0)}, np.zeros(2, np.uint32))
    try:
        ck.verify_checkpoint(d, 2)
        verified = "clean"
    except ck.CheckpointCorrupted as e:
        verified = "digest mismatch" in str(e)
    return verified, _state(ck, d)


def _load_fault_falls_back(f, ck, _rb, tmp_path):
    d = os.path.join(str(tmp_path), f"load-{f.__name__}")
    _save_steps(ck, d, [1, 2, 3])
    out = []
    for spec in (f.FaultSpec("checkpoint.load", "raise", nth=1),
                 f.FaultSpec("checkpoint.load", "raise", nth=1, count=2),
                 f.FaultSpec("checkpoint.load", "raise", nth=1, count=-1)):
        with f.inject(spec):
            out.append((_state(ck, d)[0], f.registry.calls("checkpoint.load")))
    return out


@pytest.mark.parametrize("case", [_crash_between_write_and_swap, _transient_write_retried,
                                  _torn_write_detected, _load_fault_falls_back],
                         ids=lambda c: c.__name__.strip("_"))
def test_checkpoint_fault_equals_jax(case, tmp_path):
    jax_out, port_out = _both(case, tmp_path)
    assert port_out == jax_out
    if case is _crash_between_write_and_swap:
        assert port_out[0] == ((1, [1.0] * 3), ["step-1", "step-2.tmp"])
        assert port_out[1] == ((2, [2.0] * 3), ["step-1", "step-2"])
    elif case is _transient_write_retried:
        assert port_out == (2, ((1, [1.0] * 3), ["step-1"]))
    elif case is _torn_write_detected:
        assert port_out == (True, ((1, [1.0] * 3), ["step-1", "step-2"]))
    else:
        assert port_out == [((2, [2.0] * 3), 2), ((1, [1.0] * 3), 3), (None, 3)]


def test_port_checkpoint_fault_loads_in_jax(tmp_path):
    """A step the port tore under ``checkpoint.save:corrupt`` is refused by
    the JAX package's loader too (the digests are the shared layout's)."""
    d = str(tmp_path / "ck")
    _save_steps(port_ckpt, d, [1])
    with port_faults.inject(port_faults.FaultSpec("checkpoint.save", "corrupt", nth=1)):
        port_ckpt.save_checkpoint(d, 2, {"w": np.full(3, 2.0)}, np.zeros(2, np.uint32))
    assert jax_ckpt.latest_checkpoint(d).step == 1
    with pytest.raises(jax_ckpt.CheckpointCorrupted):
        jax_ckpt.verify_checkpoint(d, 2)


# ---------------------------------------------------------------------------
# the divergence guard's site
# ---------------------------------------------------------------------------

# fire order per pass: global, per-user
DESCENT_CASES = [
    # pass 2's per-user update poisoned once: the damped retry recovers
    ("recovered", dict(nth=4, count=1, key="per-user"), True, 3),
    # poisoned from pass 2 on: per-user freezes, global trains on
    ("frozen", dict(nth=4, count=-1, key="per-user"), True, 4),
    # the fixed effect poisoned from its first update on (one pass: with
    # the fixed effect frozen, a second per-user solve starts at its own
    # optimum, where the stopping test reads rounding noise)
    ("frozen-global", dict(nth=1, count=-1, key="global"), True, 1),
    # a poisoned update and its retry, then clean: frozen after one pass
    ("frozen-once", dict(nth=2, count=2), True, 2),
    # no guard: the NaN spreads through the rest of the run
    ("unguarded", dict(nth=4, count=1, key="per-user"), False, 2),
]


@pytest.mark.parametrize("label,spec,guard,passes", DESCENT_CASES,
                         ids=[c[0] for c in DESCENT_CASES])
def test_descent_update_fault_equals_jax(label, spec, guard, passes):
    jd, td = _data()
    with jax_faults.inject(jax_faults.FaultSpec("descent.update", "corrupt", **spec)):
        ref = _jax_descent(jd, False).run(passes, divergence_guard=guard)
        jax_calls = jax_faults.registry.calls("descent.update")
    with port_faults.inject(port_faults.FaultSpec("descent.update", "corrupt", **spec)):
        got = _torch_descent(td).run(passes, divergence_guard=guard)
        assert port_faults.registry.calls("descent.update") == jax_calls
    _assert_same_run(got, ref)
    events = [(h.iteration, h.coordinate, h.event) for h in got[1] if h.event]
    objectives = [h.objective for h in got[1]]
    if label == "recovered":
        assert events == [(1, "per-user", "recovered")] and len(got[1]) == 6
        assert np.all(np.isfinite(objectives))
    elif label == "frozen":
        assert events == [(1, "per-user", "frozen")]
        assert [h.coordinate for h in got[1] if h.iteration >= 2] == ["global", "global"]
        assert np.all(np.isfinite(objectives))
    elif label == "frozen-global":
        assert events == [(0, "global", "frozen")]
        assert [h.coordinate for h in got[1]] == ["global", "per-user"]
        assert not np.any(got[0].params["global"].numpy())
    elif label == "frozen-once":
        assert events == [(0, "per-user", "frozen")]
    else:
        assert not events and np.isnan(objectives[-1])
        assert all(np.all(np.isnan(p.numpy())) for p in [got[0].params["per-user"]])
