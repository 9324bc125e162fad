"""The port's combo grid, lambda path and dispatch chunks against the JAX
package's on the CPU in float64: ``run_grid`` over 3 combos (a dense, a
padded-ELL and a down-sampled fixed effect, a bucketed random effect with
padding lanes; cold and warm-started) against JAX ``run_grid`` and the
port's own ``cd.run`` per combo; its refusals, the same-object audit and
the design read once for every combo; ``run_lambda_path`` against JAX
with ``scan`` True and False, its continuation and refusals; and
``cd.run`` with ``passes_per_dispatch`` > 1 and a convergence tolerance
against JAX ``cd.run``: where the tolerance fires, chunks shrunk by the
checkpoint cadence, validation that makes the tolerance inert, the
divergence guard's replay, and a stop at a chunk boundary."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.tasks import TaskType as JTask
from photon_ml_tpu.game import coordinates as jcoords
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.game import descent as jdescent
from photon_ml_tpu.models.training import OptimizerType as JOpt
from photon_ml_tpu.ops.sparse import from_dense as jax_from_dense
from photon_ml_tpu.solvers.common import SolverResult as JSolverResult
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.game import coordinates as tcoords
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game import descent as tdescent
from photon_ml_tpu_torch.game.factored import FactoredRandomEffectCoordinate
from photon_ml_tpu_torch.game.projected import ProjectedRandomEffectCoordinate
from photon_ml_tpu_torch.models.training import OptimizerType
from photon_ml_tpu_torch.ops.sparse import from_dense
from photon_ml_tpu_torch.solvers.common import SolverResult

N, D_G, D_U, E = 600, 5, 3, 24
NAMES = ["global", "per-user"]
COMBOS = [
    {"global": 0.5, "per-user": 2.0},
    {"global": 1.0, "per-user": 1.0},
    {"global": 2.0, "per-user": 0.5},
]
VARIANTS = ["dense", "ell", "downsampled"]


def _data(seed=21, n=N, d_user=D_U):
    """Global features with zeros, user features, Zipf users with some
    rows of no user, offsets and weights: the arrays both packages' GameData
    take."""
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(n, D_G))
    xg[rng.uniform(size=xg.shape) < 0.3] = 0.0
    xg[:, -1] = 1.0
    xu = rng.normal(size=(n, d_user))
    xu[:, -1] = 1.0
    ents = (rng.zipf(1.5, n) - 1) % E
    ents[::13] = -1
    w_u = rng.normal(size=(E, d_user)) * 1.5
    margin = xg @ rng.normal(size=D_G) + np.einsum("nd,nd->n", xu, w_u[np.maximum(ents, 0)])
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(float)
    return ({"g": xg, "u": xu}, labels, rng.normal(size=n) * 0.2, rng.uniform(0.5, 2.0, n),
            {"uid": ents})


def _common(variant):
    rate = {"down_sampling_rate": 0.5} if variant == "downsampled" else {}
    return dict(max_iters=30, tolerance=1e-7), rate


def _jax_cd(args, variant="dense", fe_reg=1.0, re_reg=1.0, extra=None):
    jd = jdata.GameData.create(*args)
    if variant == "ell":
        jd.features["g"] = jax_from_dense(np.asarray(jd.features["g"]), dtype=jnp.float64)
    common, rate = _common(variant)
    common = dict(task=JTask.LOGISTIC_REGRESSION, optimizer=JOpt.TRON, **common)
    fe = jcoords.FixedEffectCoordinate(
        jd.fixed_effect_batch("g", jnp.float64),
        jcoords.CoordinateConfig(shard="g", reg_weight=fe_reg, **common, **rate))
    des = jdata.build_bucketed_random_effect_design(jd, "uid", "u", E, num_buckets=2,
                                                    dtype=jnp.float64, entity_multiple=4)
    re = jcoords.RandomEffectCoordinate(
        des, jnp.asarray(jd.features["u"]), jnp.asarray(jd.entity_ids["uid"]),
        jnp.asarray(jd.offsets), jcoords.CoordinateConfig(
            shard="u", random_effect="uid", reg_weight=re_reg, **common))
    coords = {"global": fe, "per-user": re, **(extra or {})}
    return jdescent.CoordinateDescent(
        coords, jnp.asarray(jd.labels), jnp.asarray(jd.offsets), jnp.asarray(jd.weights),
        JTask.LOGISTIC_REGRESSION)


def _torch_cd(args, variant="dense", fe_reg=1.0, re_reg=1.0, extra=None):
    td = tdata.GameData.create(*args)
    if variant == "ell":
        td.features["g"] = from_dense(np.asarray(td.features["g"]), dtype=torch.float64)
    common, rate = _common(variant)
    common = dict(task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType.TRON, **common)
    fe = tcoords.FixedEffectCoordinate(
        td.fixed_effect_batch("g", torch.float64),
        tcoords.CoordinateConfig(shard="g", reg_weight=fe_reg, **common, **rate))
    des = tdata.build_bucketed_random_effect_design(td, "uid", "u", E, num_buckets=2,
                                                    dtype=torch.float64, entity_multiple=4)
    re = tcoords.RandomEffectCoordinate(
        des, torch.from_numpy(np.asarray(td.features["u"])),
        torch.from_numpy(td.entity_ids["uid"].astype(np.int64)),
        torch.from_numpy(td.offsets), tcoords.CoordinateConfig(
            shard="u", random_effect="uid", reg_weight=re_reg, **common))
    coords = {"global": fe, "per-user": re, **(extra or {})}
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    return tdescent.CoordinateDescent(coords, t(td.labels), t(td.offsets), t(td.weights),
                                      TaskType.LOGISTIC_REGRESSION)


def _jax_draws(seed, passes, names, n=N):
    """The uniforms JAX's runs draw for the fixed effect: one key split
    per update, in the updating sequence."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(passes):
        for name in names:
            key, sub = jax.random.split(key)
            if name == "global":
                out.append(np.asarray(jax.random.uniform(sub, (n,))))
    return out


def _feed_draws(monkeypatch, draws):
    """The port's down-sampling takes JAX's uniforms: each generator state
    a draw starts from names the next of ``draws`` the first time it is
    seen, so runs seeded alike, and the combos of one grid update, read
    the same uniforms."""
    seen = {}

    def uniforms(generator, like):
        token = int(torch.randint(0, 2**62, (1,), generator=generator))
        seen.setdefault(token, len(seen))
        return torch.from_numpy(draws[seen[token]]).to(like)

    monkeypatch.setattr(tcoords, "_uniform_draws", uniforms)


def _np(p):
    return p.numpy() if torch.is_tensor(p) else np.asarray(p)


def _assert_same(got, ref, params_atol=1e-10, seconds=True):
    """Same records (iteration, coordinate, event, histogram), objectives
    within 1e-10 relative, params within ``params_atol``; with
    ``seconds`` the same records carry seconds."""
    (gm, gh), (rm, rh) = got, ref
    assert [(h.iteration, h.coordinate, h.event) for h in gh] == [
        (h.iteration, h.coordinate, h.event) for h in rh]
    for a, b in zip(gh, rh):
        if np.isfinite(b.objective):
            np.testing.assert_allclose(a.objective, b.objective, rtol=1e-10)
        assert a.convergence_histogram == b.convergence_histogram
        assert a.validation_metric == b.validation_metric
    if seconds:
        assert [h.seconds is None for h in gh] == [h.seconds is None for h in rh]
    for name, p in rm.params.items():
        np.testing.assert_allclose(_np(gm.params[name]), _np(p), rtol=0, atol=params_atol,
                                   err_msg=name)


# -- run_grid ------------------------------------------------------------------


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_run_grid_equals_jax_and_each_combos_run(variant, warm, monkeypatch):
    args = _data()
    if variant == "downsampled":
        _feed_draws(monkeypatch, _jax_draws(3, 2, NAMES))
    init = None
    if warm:
        rng = np.random.default_rng(8)
        init = {"global": rng.normal(size=D_G) * 0.1, "per-user": rng.normal(size=(E, D_U)) * 0.2}
    models, history = tdescent.run_grid(
        _torch_cd(args, variant), COMBOS, 2, seed=3,
        initial_model=None if init is None else tdescent.GameModel(
            {n: torch.from_numpy(p) for n, p in init.items()}))
    jmodels, jhistory = jdescent.run_grid(
        _jax_cd(args, variant), COMBOS, 2, seed=3,
        initial_model=None if init is None else jdescent.GameModel(
            {n: jnp.asarray(p) for n, p in init.items()}))
    assert len(models) == len(history) == 3
    for c, combo in enumerate(COMBOS):
        got = (models[c], history[c])
        _assert_same(got, (jmodels[c], jhistory[c]))
        one = _torch_cd(args, variant, fe_reg=combo["global"], re_reg=combo["per-user"]).run(
            2, seed=3, initial_model=init)
        _assert_same(got, one, seconds=False)
        # seconds on each pass's first record only; no validation
        assert [h.seconds is None for h in history[c]] == [False, True, False, True]
        assert all(h.validation_metric is None for h in history[c])
        re_rec = [h for h in history[c] if h.coordinate == "per-user"]
        assert all(h.entity_iterations.size == sum(h.convergence_histogram.values())
                   for h in re_rec)
        assert history[c][0].cg_iterations == one[1][0].cg_iterations > 0


def test_run_grid_reads_one_design_for_every_combo(monkeypatch):
    """Each combo's solve of a bucket reads the bucket's own design tensor:
    nothing of the design's size is allocated per combo."""
    seen = []

    class Recording(tcoords._BatchedObjective):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(tcoords, "_BatchedObjective", Recording)
    cd = _torch_cd(_data())
    buckets = cd.coordinates["per-user"].design.buckets
    tdescent.run_grid(cd, COMBOS, 1, seed=3)
    # one solve per bucket and combo, combo by combo
    assert len(seen) == len(COMBOS) * len(buckets)
    for c in range(len(COMBOS)):
        for obj, bucket in zip(seen[c * len(buckets):], buckets):
            assert obj.features is bucket.features
            assert obj.features.data_ptr() == bucket.features.data_ptr()
            assert obj.labels.data_ptr() == bucket.labels.data_ptr()
            assert obj.l2.shape[0] == bucket.features.shape[0]


def test_run_grid_stops_after_the_pass_its_stop_check_ends():
    args = _data()
    polls = []

    def stop():
        polls.append(1)
        return len(polls) == 1

    models, history = tdescent.run_grid(_torch_cd(args), COMBOS[:2], 3, seed=3,
                                        stop_check=stop)
    ref = tdescent.run_grid(_torch_cd(args), COMBOS[:2], 1, seed=3)
    assert len(polls) == 1
    for got, one in zip(zip(models, history), zip(*ref)):
        _assert_same(got, one, seconds=False)


def test_run_grid_refusals():
    args = _data()
    with pytest.raises(ValueError, match=">= 2 combos"):
        tdescent.run_grid(_torch_cd(args), COMBOS[:1], 1)
    cd = _torch_cd(args)
    re = cd.coordinates["per-user"]
    cd.coordinates["per-user"] = tcoords.RandomEffectCoordinate(
        re.design, re.row_features, re.row_entities, re.full_offsets_base, re.config,
        reg_weights=np.linspace(0.5, 2.0, E))
    with pytest.raises(ValueError, match="CUSTOM per-entity"):
        tdescent.run_grid(cd, COMBOS, 1)
    for kind in (ProjectedRandomEffectCoordinate, FactoredRandomEffectCoordinate):
        cd = _torch_cd(args)
        cd.coordinates["per-user"] = object.__new__(kind)
        with pytest.raises(ValueError, match=f"{kind.__name__} does not support grid "
                                             "vmapping \\(no fused_state_for_reg\\)"):
            tdescent.run_grid(cd, COMBOS, 1)
        with pytest.raises(ValueError, match="does not support the lambda path"):
            tdescent.run_lambda_path(cd, COMBOS, 1)


def test_grid_state_keeps_its_pieces_and_takes_the_jax_dtypes():
    cd = _torch_cd(_data(), "ell")
    fe, re = cd.coordinates["global"], cd.coordinates["per-user"]
    a, b = fe.fused_state_for_reg(0.5), fe.fused_state_for_reg(0.25)
    assert all(x is y for x, y in zip(a[:3], b[:3]))
    assert a[3].dtype == torch.float64 and float(a[3]) == 0.5
    assert fe.with_fused_state(b)._reg_weight == 0.25 and fe._reg_weight == 1.0
    a, b = re.fused_state_for_reg(0.5), re.fused_state_for_reg(0.25)
    assert a[0].dtype == torch.float32 and a[0].shape == (E,)
    assert a[1] is b[1] and a[3] is b[3] and a[4] is b[4]
    assert all(x is y for x, y in zip(a[2], b[2]))
    live = re.with_fused_state(b)
    assert float(live.reg_weights[0]) == 0.25 and float(re.reg_weights[0]) == 1.0
    # a hybrid fixed effect keeps the surface, its permutations included
    hy = tcoords.FixedEffectCoordinate(fe.batch, fe.config, hot_columns=2)
    a, b = hy.fused_state_for_reg(1.0), hy.fused_state_for_reg(2.0)
    assert a[1] is b[1] is hy._row_perm and a[2] is b[2] is hy._inv_perm


def test_run_grid_on_a_hybrid_fixed_effect_equals_each_combos_run():
    args = _data()
    cd = _torch_cd(args, "ell")
    fe = cd.coordinates["global"]
    cd.coordinates["global"] = tcoords.FixedEffectCoordinate(fe.batch, fe.config, hot_columns=2)
    models, history = tdescent.run_grid(cd, COMBOS[:2], 2, seed=3)
    for c, combo in enumerate(COMBOS[:2]):
        one = _torch_cd(args, "ell", fe_reg=combo["global"], re_reg=combo["per-user"])
        base = one.coordinates["global"]
        one.coordinates["global"] = tcoords.FixedEffectCoordinate(base.batch, base.config,
                                                                  hot_columns=2)
        _assert_same((models[c], history[c]), one.run(2, seed=3), seconds=False)


def test_audit_warns_on_a_fresh_equal_piece_of_a_megabyte(monkeypatch):
    """A coordinate that hands back a fresh copy of an invariant piece
    trains as before, and the grid warns with the JAX text when the
    copies come to 1 MB or more."""
    args = _data(n=1200, d_user=40)
    ref = tdescent.run_grid(_torch_cd(args), COMBOS, 1, seed=3)
    plain = tcoords.RandomEffectCoordinate.fused_state_for_reg

    def fresh_rows(self, reg_weight):
        lam, offsets, buckets, rows, ents = plain(self, reg_weight)
        return lam, offsets, buckets, rows.clone(), ents

    monkeypatch.setattr(tcoords.RandomEffectCoordinate, "fused_state_for_reg", fresh_rows)
    assert 3 * 1200 * 40 * 8 >= tdescent._GRID_STACK_WARN_BYTES
    with pytest.warns(RuntimeWarning, match=r"run_grid: leaf \['per-user'\]\[3\] \(1\.2 MB "
                                            r"stacked\) is value-identical .* stacked x3"):
        got = tdescent.run_grid(_torch_cd(args), COMBOS, 1, seed=3)
    for (gm, gh), (rm, rh) in zip(zip(*got), zip(*ref)):
        _assert_same((gm, gh), (rm, rh), params_atol=0)
    # below the threshold, the same miss is quiet
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdescent.run_grid(_torch_cd(_data()), COMBOS, 1, seed=3)


def test_audit_checks_size_and_value():
    big = torch.zeros(1 << 17, dtype=torch.float64)  # 1 MB
    states = [{"c": (big, torch.ones(1))}, {"c": (big.clone(), torch.ones(1))}]
    with pytest.warns(RuntimeWarning, match=r"leaf \['c'\]\[0\] \(2\.1 MB stacked\)"):
        tdescent._audit_grid_states(states, ["c"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdescent._audit_grid_states([{"c": (big,)}, {"c": (big,)}], ["c"])
        tdescent._audit_grid_states([{"c": (big,)}, {"c": (big + 1,)}], ["c"])
        tdescent._audit_grid_states([{"c": (big[:1000],)}, {"c": (big[:1000].clone(),)}],
                                    ["c"])


# -- run_lambda_path -----------------------------------------------------------

PATH = [{"global": 2.0, "per-user": 4.0}, {"global": 0.5, "per-user": 1.0}]


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "loop"])
def test_lambda_path_equals_jax(scan):
    args = _data(seed=5)
    got = tdescent.run_lambda_path(_torch_cd(args), PATH, 2, seed=3, scan=scan)
    ref = jdescent.run_lambda_path(_jax_cd(args), PATH, 2, seed=3, scan=scan)
    assert len(got[0]) == len(got[1]) == 2
    for c in range(2):
        _assert_same((got[0][c], got[1][c]), (ref[0][c], ref[1][c]))
        assert [h.seconds is None for h in got[1][c]] == [False, True, True, True]


def test_lambda_path_continues_from_its_models():
    """Combo c + 1 starts from combo c's model: the path's last combo run
    alone from its second-to-last model, or as ``cd.run`` warm-started
    there, ends where the path does."""
    args = _data(seed=5)
    models, history = tdescent.run_lambda_path(_torch_cd(args), PATH, 2, seed=3)
    resumed, rh = tdescent.run_lambda_path(_torch_cd(args), PATH[1:], 2, seed=3,
                                           initial_model=models[0])
    for k in models[-1].params:
        np.testing.assert_allclose(models[-1].params[k].numpy(), resumed[0].params[k].numpy(),
                                   rtol=0, atol=1e-12)
    one = _torch_cd(args, fe_reg=PATH[1]["global"], re_reg=PATH[1]["per-user"]).run(
        2, seed=3, initial_model=models[0])
    _assert_same((models[1], history[1]), one, params_atol=1e-12, seconds=False)


def test_lambda_path_refusals():
    cd = _torch_cd(_data(seed=5))
    bad = tdescent.GameModel({"global": torch.zeros(D_G),
                              "per-user": torch.zeros(E + 3, D_U)})
    with pytest.raises(ValueError, match="re-key by entity id"):
        tdescent.run_lambda_path(cd, PATH[:1], 1, initial_model=bad)
    with pytest.raises(ValueError, match="needs >= 1 combo"):
        tdescent.run_lambda_path(cd, [], 1)


# -- passes_per_dispatch with a convergence tolerance ------------------------


@pytest.mark.parametrize("k", [2, 3])
def test_tolerance_stops_where_jax_stops(k):
    """K in {2, 3}: a tolerance that fires in the middle of a chunk ends
    both runs after the same pass with the same records, objectives,
    params and seconds on each chunk's first record."""
    args = _data()
    tol = 1.2e-4
    ref = _jax_cd(args).run(8, seed=3, passes_per_dispatch=k, convergence_tolerance=tol)
    got = _torch_cd(args).run(8, seed=3, passes_per_dispatch=k, convergence_tolerance=tol)
    _assert_same(got, ref)
    passes = len(got[1]) // 2
    assert passes == 5 and passes % k, passes
    # the same run without the tolerance runs every pass
    full = _torch_cd(args).run(8, seed=3, passes_per_dispatch=k)
    assert len(full[1]) == 16
    _assert_same(full, _jax_cd(args).run(8, seed=3, passes_per_dispatch=k))


def test_chunks_shrink_to_the_checkpoint_cadence(tmp_path):
    from photon_ml_tpu_torch.io.checkpoint import latest_checkpoint

    args = _data()
    kw = dict(seed=3, passes_per_dispatch=3, checkpoint_every=2)
    ref = _jax_cd(args).run(5, checkpoint_dir=str(tmp_path / "jax"), **kw)
    got = _torch_cd(args).run(5, checkpoint_dir=str(tmp_path / "port"), **kw)
    _assert_same(got, ref)
    # chunks of 2, 2 and 1 passes: seconds on records 0, 4 and 8
    assert [i for i, h in enumerate(got[1]) if h.seconds is not None] == [0, 4, 8]
    steps = {pkg: sorted(os.listdir(tmp_path / pkg)) for pkg in ("jax", "port")}
    assert steps["port"] == steps["jax"]
    assert latest_checkpoint(str(tmp_path / "port")).step == 4


def test_validation_makes_the_tolerance_inert():
    args = _data()
    kw = dict(seed=3, passes_per_dispatch=3, convergence_tolerance=0.5)
    ref = _jax_cd(args).run(4, validation_fn=lambda m: 0.25, **kw)
    got = _torch_cd(args).run(4, validation_fn=lambda m: 0.25, **kw)
    _assert_same(got, ref)
    assert len(got[1]) == 8 and all(h.seconds is not None for h in got[1])


class _Diverging:
    """The JAX package's diverging drill (``tests/test_device_loops.py``):
    params scale by 1e100 per update, so the second update's penalty
    overflows and the damped retry cannot save it."""

    def __init__(self, n_rows):
        self.n_rows = n_rows

    def initial_params(self):
        return torch.ones((2,), dtype=torch.float64)

    def score(self, w):
        return torch.zeros((self.n_rows,), dtype=torch.float64)

    def reg_term(self, w):
        return 0.5 * torch.dot(w, w)

    def update_and_score(self, w, partial_scores, generator=None):
        p = w * 1e100
        value = 0.5 * torch.dot(p, p)
        result = SolverResult(w=p, value=value, grad=torch.zeros_like(p),
                              iterations=torch.tensor(1, dtype=torch.int32),
                              reason=torch.tensor(1, dtype=torch.int32),
                              values=value[None], grad_norms=torch.linalg.norm(p)[None])
        return p, result, self.score(p)


class _JaxDiverging:
    def __init__(self, n_rows):
        self.n_rows = n_rows

    def initial_params(self):
        return jnp.ones((2,), jnp.float64)

    def fused_state(self):
        return (jnp.zeros((), jnp.float64),)

    def with_fused_state(self, state):
        return self

    def wrap_tracker(self, tracker):
        return tracker

    def score(self, w):
        return jnp.zeros((self.n_rows,), jnp.float64) + 0.0 * jnp.sum(w)

    def reg_term(self, w):
        return 0.5 * jnp.vdot(w, w)

    def update_step(self, w, partial_scores, key=None):
        p = w * 1e100
        value = 0.5 * jnp.vdot(p, p)
        tracker = JSolverResult(w=p, value=value, grad=jnp.zeros_like(p),
                                iterations=jnp.int32(1), reason=jnp.int32(1),
                                values=value[None], grad_norms=jnp.linalg.norm(p)[None])
        return p, tracker, self.score(p)

    def update_and_score(self, w, partial_scores, key=None):
        return self.update_step(w, partial_scores, key)


def test_guard_replays_the_failing_pass_and_starts_a_new_chunk():
    """Pass 2 overflows: the chunk keeps pass 1, the failing pass replays
    through the guarded loop (which freezes the coordinate), and the run
    goes on pass by pass, as the JAX superpass does; the result is the
    guarded loop's."""
    args = _data()
    got = _torch_cd(args, extra={"bad": _Diverging(N)}).run(
        4, seed=3, passes_per_dispatch=3, divergence_guard=True)
    ref = _jax_cd(args, extra={"bad": _JaxDiverging(N)}).run(
        4, seed=3, passes_per_dispatch=3, divergence_guard=True)
    _assert_same(got, ref)
    frozen = [h for h in got[1] if h.event == "frozen"]
    assert [(h.iteration, h.coordinate) for h in frozen] == [(1, "bad")]
    assert [len([h for h in got[1] if h.iteration == i]) for i in range(4)] == [3, 3, 2, 2]
    guarded = _torch_cd(args, extra={"bad": _Diverging(N)}).run(
        4, seed=3, divergence_guard=True)
    _assert_same(got, guarded, seconds=False)
    # unguarded, the chunk keeps the non-finite passes and runs them all
    loose = _torch_cd(args, extra={"bad": _Diverging(N)}).run(4, seed=3, passes_per_dispatch=3)
    assert len(loose[1]) == 12 and not np.isfinite(loose[1][-1].objective)


def test_stop_check_falls_on_a_chunk_boundary(tmp_path):
    from photon_ml_tpu_torch.io.checkpoint import latest_checkpoint

    class StopAfterFirst:
        def __init__(self):
            self.polls = 0

        def __call__(self):
            self.polls += 1
            return True

    args = _data()
    stop = StopAfterFirst()
    got = _torch_cd(args).run(6, seed=3, passes_per_dispatch=3, stop_check=stop,
                              checkpoint_dir=str(tmp_path / "port"), checkpoint_every=5)
    jstop = StopAfterFirst()
    ref = _jax_cd(args).run(6, seed=3, passes_per_dispatch=3, stop_check=jstop,
                            checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=5)
    _assert_same(got, ref)
    assert stop.polls == jstop.polls == 1 and len(got[1]) == 6
    assert latest_checkpoint(str(tmp_path / "port")).step == 3
    assert os.path.exists(tmp_path / "port" / "preempted.json")


def test_dispatch_settings_outside_chunks_change_nothing():
    """A frozen set, or K = 1, keeps the per-update loop: the tolerance
    changes nothing there, as in the JAX package."""
    args = _data()
    base = _torch_cd(args).run(3, seed=3, freeze=["global"])
    chunked = _torch_cd(args).run(3, seed=3, freeze=["global"], passes_per_dispatch=3,
                                  convergence_tolerance=0.5)
    _assert_same(chunked, base, params_atol=0)
    one = _torch_cd(args).run(3, seed=3, convergence_tolerance=0.5)
    _assert_same(one, _torch_cd(args).run(3, seed=3), params_atol=0)

