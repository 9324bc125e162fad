"""Hybrid designs (``ops.sparse.HybridFeatures``): the port against the
JAX package on the CPU, on seeded power-law designs in the shapes of
``tests/test_hybrid.py`` (128 rows, 80 columns, 6 Zipf(1.3) entries a
row).

Tolerances: ``to_hybrid`` equal exactly (hot ids, row permutation,
segment bounds, each segment's ids and values, the slab); the hybrid
contractions, ``pad_rows``, ``row_density``, ``to_dense`` and
``cold_as_single_ell`` within 1e-12 (float64) and 1e-6 (float32) of the
JAX functions' scale; the feature summary within rtol 1e-9 of the JAX
summary (its own test's tolerance); a solve on a hybrid within 1e-6 of the
same solve on the ELL, with the JAX hybrid solve's iterations.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.ops.sparse as J
from photon_ml_tpu.core.types import LabeledBatch as JBatch
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.validators import sanity_check_data
from photon_ml_tpu_torch.interop import (
    hybrid_from_numpy,
    hybrid_to_numpy,
    labeled_batch_from_numpy,
    sparse_from_numpy,
)
from photon_ml_tpu_torch.kernels import dispatch
from photon_ml_tpu_torch.ops import sparse as P

N, D, NNZ = 128, 80, 6
RTOL = {torch.float64: 1e-12, torch.float32: 1e-6}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def zipf_coo(rng, n=N, d=D, nnz=NNZ):
    rows = np.repeat(np.arange(n), nnz)
    cols = (rng.zipf(1.3, size=n * nnz) - 1) % d
    return rows, cols, rng.normal(size=n * nnz)


def pair(rng, dtype=torch.float64, n=N, d=D, nnz=NNZ):
    """(JAX ELL, the port's ELL) of one seeded design."""
    jsf = J.from_coo(*zipf_coo(rng, n, d, nnz), n, d, dtype=JDT[dtype])
    return jsf, sparse_from_numpy(np.asarray(jsf.indices), np.asarray(jsf.values), d)


def close(got, want, rtol, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert np.abs(got - want).max(initial=0.0) <= rtol * scale, what


def assert_same_split(jh, ph):
    assert np.array_equal(np.asarray(jh.hot_ids), ph.hot_ids.numpy())
    assert np.array_equal(np.asarray(jh.row_perm), ph.row_perm.numpy())
    assert jh.segment_bounds() == ph.segment_bounds()
    assert ph.hot_ids.dtype == ph.row_perm.dtype == torch.int32
    for js, ps in zip(jh.cold_segments, ph.cold_segments, strict=True):
        assert ps.d == js.d
        assert np.array_equal(np.asarray(js.indices), ps.indices.numpy())
        assert np.array_equal(np.asarray(js.values), ps.values.numpy())
    assert np.array_equal(np.asarray(jh.dense), ph.dense.numpy())
    assert ph.dense.dtype == ph.cold_segments[0].values.dtype


class TestToHybrid:
    @pytest.mark.parametrize("buckets", [1, 3, 8])
    @pytest.mark.parametrize("hot_columns", [-1, 1, 3, D], ids=["auto", "1", "3", "all"])
    def test_split_equals_jax(self, rng, hot_columns, buckets):
        jsf, psf = pair(rng)
        jh = J.to_hybrid(jsf, hot_columns=hot_columns, num_row_buckets=buckets)
        ph = P.to_hybrid(psf, hot_columns=hot_columns, num_row_buckets=buckets)
        assert_same_split(jh, ph)
        assert P.stored_cold_entries(ph) == J.stored_cold_entries(jh)
        assert P.cold_padded_slots(ph) == J.cold_padded_slots(jh)
        assert ph.shape == (N, D) and ph.ndim == 2 and ph.d == D

    def test_auto_split_with_threshold_and_cap(self, rng):
        jsf, psf = pair(rng)
        for kw in (dict(min_count=8), dict(min_count=8, max_slab_bytes=N * 8 * 3),
                   dict(min_count=10_000)):  # no column qualifies: H = 1
            assert_same_split(J.to_hybrid(jsf, **kw), P.to_hybrid(psf, **kw))
        assert P.to_hybrid(psf, min_count=10_000).dense.shape == (N, 1)
        assert P.to_hybrid(psf, min_count=8, max_slab_bytes=N * 8 * 3).dense.shape == (N, 3)

    def test_float32_and_target_dtype(self, rng):
        jsf, psf = pair(rng, torch.float32)
        assert_same_split(J.to_hybrid(jsf), P.to_hybrid(psf))
        jsf, psf = pair(rng)
        ph = P.to_hybrid(psf, dtype=torch.float32)
        assert_same_split(J.to_hybrid(jsf, dtype=jnp.float32), ph)
        assert ph.dtype == torch.float32

    def test_duplicate_slots_refused(self):
        ind = [[0, 0, 2], [1, 2, 3]]
        val = [[1.0, 2.0, 3.0], [1.0, 1.0, 1.0]]
        with pytest.raises(ValueError, match="dedup-summed") as got:
            P.to_hybrid(sparse_from_numpy(np.asarray(ind), np.asarray(val), 4))
        with pytest.raises(ValueError, match="dedup-summed") as want:
            J.to_hybrid(J.SparseFeatures(jnp.asarray(ind, jnp.int32),
                                         jnp.asarray(val, jnp.float64), 4))
        assert str(got.value) == str(want.value)

    def test_all_hot_leaves_one_padding_segment(self, rng):
        jsf, psf = pair(rng)
        ph = P.to_hybrid(psf, hot_columns=D)
        assert_same_split(J.to_hybrid(jsf, hot_columns=D), ph)
        assert P.stored_cold_entries(ph) == 0
        assert [s.nnz_per_row for s in ph.cold_segments] == [1]
        np.testing.assert_array_equal(P.to_dense(ph), P.to_dense(psf))

    def test_placed_beside_its_input_and_cast(self, rng):
        _, psf = pair(rng)
        ph = P.to_hybrid(psf)
        assert {ph.dense.device, ph.hot_ids.device, ph.row_perm.device} == {psf.indices.device}
        cast = P.cast_values(ph, torch.float32, "cpu")
        assert cast.dense.dtype == torch.float32
        assert all(s.values.dtype == torch.float32 and s.indices.dtype == torch.int32
                   for s in cast.cold_segments)
        assert torch.equal(cast.row_perm, ph.row_perm) and torch.equal(cast.hot_ids, ph.hot_ids)


class TestHybridOps:
    @pytest.mark.parametrize("buckets", [1, 3, 8])
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
    def test_contractions_match_jax(self, rng, dtype, buckets):
        jsf, psf = pair(rng, dtype)
        jh = J.to_hybrid(jsf, num_row_buckets=buckets)
        ph = P.to_hybrid(psf, num_row_buckets=buckets)
        w = rng.normal(size=D).astype(np.float64 if dtype == torch.float64 else np.float32)
        a = rng.normal(size=N).astype(w.dtype)
        tw, ta = torch.from_numpy(w), torch.from_numpy(a)
        rtol = RTOL[dtype]
        before = dispatch.launch_counts()
        close(P.matvec(ph, tw), J.matvec(jh, jnp.asarray(w)), rtol, "matvec")
        close(ph @ tw, J.matvec(jh, jnp.asarray(w)), rtol, "@")
        close(P.rmatvec(ph, ta), J.rmatvec(jh, jnp.asarray(a)), rtol, "rmatvec")
        for square in (False, True):
            close(P.colsum(ph, ta, square=square), J.colsum(jh, jnp.asarray(a), square=square),
                  rtol, f"colsum square={square}")
        assert dispatch.launch_counts() == before  # CPU: the plain versions
        # and against the ELL through the permutation
        perm = ph.row_perm.long()
        close(P.matvec(ph, tw), P.matvec(psf, tw)[perm], rtol)
        close(P.rmatvec(ph, ta[perm]), P.rmatvec(psf, ta), rtol)

    def test_pad_rows_density_dense_and_single_ell(self, rng):
        jsf, psf = pair(rng)
        jh, ph = J.to_hybrid(jsf, num_row_buckets=3), P.to_hybrid(psf, num_row_buckets=3)
        jp, pp = J.pad_rows(jh, 32), P.pad_rows(ph, 32)
        assert_same_split(jp, pp)
        np.testing.assert_array_equal(P.to_dense(pp), J.to_dense(jp))
        np.testing.assert_array_equal(P.row_density(ph).numpy(), np.asarray(J.row_density(jh)))
        np.testing.assert_array_equal(P.row_density(psf).numpy(), np.asarray(J.row_density(jsf)))
        np.testing.assert_array_equal(P.to_dense(ph), J.to_dense(jh))
        np.testing.assert_array_equal(P.to_dense(ph), P.to_dense(psf))
        js, ps = J.cold_as_single_ell(jh), P.cold_as_single_ell(ph)
        assert np.array_equal(np.asarray(js.indices), ps.indices.numpy())
        assert np.array_equal(np.asarray(js.values), ps.values.numpy())
        # the ELL's pad_rows too
        jpe, ppe = J.pad_rows(jsf, 5), P.pad_rows(psf, 5)
        assert np.array_equal(np.asarray(jpe.indices), ppe.indices.numpy())
        assert np.array_equal(np.asarray(jpe.values), ppe.values.numpy())

    def test_interop_round_trip(self, rng):
        jsf, psf = pair(rng)
        jh = J.to_hybrid(jsf, num_row_buckets=3)
        carried = hybrid_from_numpy(jh.dense, jh.hot_ids, jh.cold_segments, jh.row_perm)
        assert_same_split(jh, carried)
        back = hybrid_to_numpy(P.to_hybrid(psf, num_row_buckets=3))
        jback = J.HybridFeatures(
            dense=jnp.asarray(back["dense"]), hot_ids=jnp.asarray(back["hot_ids"]),
            cold_segments=tuple(J.SparseFeatures(jnp.asarray(i), jnp.asarray(v), d)
                                for i, v, d in back["cold_segments"]),
            row_perm=jnp.asarray(back["row_perm"]))
        np.testing.assert_array_equal(J.to_dense(jback), J.to_dense(jh))

    def test_empty_cold_segment(self, rng):
        """Rows whose every entry is hot make a first segment of width 1
        that is all padding: its contractions are exact zeros, and the
        hybrid still equals the ELL."""
        n = 64
        rows, cols, vals = zipf_coo(rng, n=n)
        cols[rows < 16] = rows[rows < 16] % 3  # 16 rows with only columns 0-2
        jsf = J.from_coo(rows, cols, vals, n, D, dtype=jnp.float64)
        psf = sparse_from_numpy(np.asarray(jsf.indices), np.asarray(jsf.values), D)
        jh, ph = J.to_hybrid(jsf, hot_columns=3), P.to_hybrid(psf, hot_columns=3)
        assert_same_split(jh, ph)
        first = ph.cold_segments[0]
        assert first.nnz_per_row == 1 and bool((first.indices == D).all())
        a = torch.from_numpy(rng.normal(size=n))
        lo, hi = ph.segment_bounds()[0]
        assert not P.rmatvec(first, a[lo:hi]).any() and not P.colsum(first, a[lo:hi]).any()
        assert not P.matvec(first, torch.ones(D, dtype=torch.float64)).any()
        close(P.rmatvec(ph, a), J.rmatvec(jh, jnp.asarray(a.numpy())), 1e-12)
        close(P.colsum(ph, a, square=True),
              J.colsum(jh, jnp.asarray(a.numpy()), square=True), 1e-12)
        np.testing.assert_array_equal(P.to_dense(ph), P.to_dense(psf))


def _batches(rng, jsf, psf, buckets=8):
    """(JAX hybrid batch, the port's hybrid batch, the port's ELL batch):
    labels, offsets and weights permuted with the rows."""
    n = psf.shape[0]
    y = (rng.uniform(size=n) > 0.5).astype(np.float64)
    off = rng.normal(0.0, 0.2, size=n)
    wt = rng.uniform(0.5, 2.0, size=n)
    jh, ph = J.to_hybrid(jsf, num_row_buckets=buckets), P.to_hybrid(psf, num_row_buckets=buckets)
    perm = ph.row_perm.numpy()
    jb = JBatch.create(jh, y[perm], offsets=off[perm], weights=wt[perm], dtype=jnp.float64)
    pb = labeled_batch_from_numpy(ph, y[perm], off[perm], wt[perm], np.ones(n))
    eb = labeled_batch_from_numpy(psf, y, off, wt, np.ones(n))
    return jb, pb, eb


class TestHybridBatch:
    def test_summary_matches_jax(self, rng):
        from photon_ml_tpu.ops.stats import summarize_features as jsum
        from photon_ml_tpu_torch.ops.stats import summarize_features

        jsf, psf = pair(rng)
        jb, pb, eb = _batches(rng, jsf, psf)
        got, want, ell = summarize_features(pb), jsum(jb), summarize_features(eb)
        for f in ("mean", "variance", "min", "max", "norm_l1", "norm_l2", "mean_abs",
                  "num_nonzeros"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-9, atol=1e-12, err_msg=f)
            np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ell, f).numpy(),
                                       rtol=1e-9, atol=1e-12, err_msg=f)
        assert float(got.count) == float(want.count) == N

    def test_validators_see_nonfinite_slab_and_cold(self, rng):
        jsf, psf = pair(rng)
        _, pb, _ = _batches(rng, jsf, psf)
        sanity_check_data(pb, TaskType.LOGISTIC_REGRESSION)  # clean
        hf = pb.features
        bad_dense = hf.dense.clone()
        bad_dense[3, 0] = float("nan")
        bad = dataclasses.replace(pb, features=dataclasses.replace(hf, dense=bad_dense))
        with pytest.raises(ValueError, match="finite_features"):
            sanity_check_data(bad, TaskType.LOGISTIC_REGRESSION)
        seg = hf.cold_segments[-1]
        vals = seg.values.clone()
        vals[0, 0] = float("inf")
        bad = dataclasses.replace(pb, features=dataclasses.replace(
            hf, cold_segments=hf.cold_segments[:-1] + (dataclasses.replace(seg, values=vals),)))
        with pytest.raises(ValueError, match="finite_features"):
            sanity_check_data(bad, TaskType.LOGISTIC_REGRESSION)

    def test_hessian_full_refuses_a_hybrid(self, rng):
        from photon_ml_tpu_torch.ops.losses import LOGISTIC_LOSS
        from photon_ml_tpu_torch.ops.objective import GLMObjective

        jsf, psf = pair(rng)
        _, pb, _ = _batches(rng, jsf, psf)
        with pytest.raises(ValueError, match="requires dense features"):
            GLMObjective(loss=LOGISTIC_LOSS).hessian_full(torch.zeros(D, dtype=torch.float64), pb)


class TestHybridTraining:
    @pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
    def test_solve_matches_ell_and_jax(self, rng, optimizer):
        from photon_ml_tpu.models import GLMTrainingConfig as JCfg
        from photon_ml_tpu.models import OptimizerType as JOpt
        from photon_ml_tpu.models import TaskType as JTask
        from photon_ml_tpu.models import train_glm as jtrain
        from photon_ml_tpu.ops import RegularizationContext as JReg
        from photon_ml_tpu_torch.models.training import (
            GLMTrainingConfig,
            OptimizerType,
            train_glm,
        )
        from photon_ml_tpu_torch.ops.objective import RegularizationContext

        n, d = 400, 60
        jsf, psf = pair(rng, n=n, d=d, nnz=8)
        jb, pb, eb = _batches(rng, jsf, psf)
        common = dict(reg_weights=(1.0,), tolerance=1e-9, max_iters=100)
        cfg = GLMTrainingConfig(task=TaskType.LOGISTIC_REGRESSION,
                                optimizer=OptimizerType[optimizer],
                                regularization=RegularizationContext("L2"), **common)
        (hyb,), (ell,) = train_glm(pb, cfg), train_glm(eb, cfg)
        (ref,) = jtrain(jb, JCfg(task=JTask.LOGISTIC_REGRESSION, optimizer=JOpt[optimizer],
                                 regularization=JReg("L2"), **common))
        w_h, w_e = hyb.model.coefficients.means.numpy(), ell.model.coefficients.means.numpy()
        np.testing.assert_allclose(w_h, w_e, rtol=1e-6, atol=1e-8)
        assert hyb.result.iterations == int(ref.result.iterations)
        close(w_h, ref.model.coefficients.means, 1e-8)

    def test_fixed_effect_coordinate_keeps_the_global_row_order(self, rng):
        """The coordinate's hybrid is private: partial scores in and
        rescores out in the batch's own row order, equal to the ELL
        coordinate's."""
        from photon_ml_tpu_torch.game.coordinates import CoordinateConfig, FixedEffectCoordinate

        jsf, psf = pair(rng)
        _, _, eb = _batches(rng, jsf, psf)
        cfg = CoordinateConfig(shard="g", reg_weight=1.0, tolerance=1e-9, max_iters=50)
        ell = FixedEffectCoordinate(eb, cfg)
        hyb = FixedEffectCoordinate(eb, cfg, hot_columns=-1)
        assert P.is_hybrid(hyb.batch.features) and not P.is_hybrid(ell.batch.features)
        partial = torch.from_numpy(rng.normal(0.0, 0.5, size=N))
        w0 = ell.initial_params()
        we, _, se = ell.update_and_score(w0, partial)
        wh, _, sh = hyb.update_and_score(w0, partial)
        close(wh, we.numpy(), 1e-8)
        close(sh, se.numpy(), 1e-8)
        close(hyb.score(wh), ell.score(wh).numpy(), 1e-12)
        packed = FixedEffectCoordinate.hybridize_batch(eb, -1)
        again = FixedEffectCoordinate(packed[0], cfg, hybrid_pack=packed)
        assert again.batch is packed[0]
        with pytest.raises(ValueError, match="padded-ELL"):
            FixedEffectCoordinate.hybridize_batch(
                dataclasses.replace(eb, features=torch.from_numpy(P.to_dense(psf))), -1)


class TestRefusals:
    """The JAX package's refusals of ``hot_columns``, with its messages."""

    def _glm(self, **kw):
        from photon_ml_tpu.cli.config import GLMDriverParams as JParams
        from photon_ml_tpu_torch.cli.config import GLMDriverParams

        return [cls(train_input=["x"], output_dir="y", **kw) for cls in (GLMDriverParams, JParams)]

    def _same_refusal(self, params, match):
        messages = []
        for p in params:
            with pytest.raises(ValueError, match=match) as e:
                p.validate()
            messages.append(str(e.value))
        assert messages[0] == messages[1]

    def test_glm_needs_sparse(self):
        self._same_refusal(self._glm(hot_columns=4), "hot_columns requires sparse")

    def test_glm_refuses_newton(self):
        self._same_refusal(self._glm(sparse=True, hot_columns=-1, optimizer="NEWTON"), "NEWTON")

    def test_glm_refuses_a_mesh(self):
        self._same_refusal(self._glm(sparse=True, hot_columns=-1, mesh_shape={"data": 2}),
                           "single-device")

    def _game(self, coord, sparse_shards=("g",)):
        from photon_ml_tpu.cli.config import GameDriverParams as JParams
        from photon_ml_tpu_torch.cli.config import GameDriverParams, load_params

        raw = {"train_input": ["x"], "output_dir": "y", "updating_sequence": ["c"],
               "sparse_shards": list(sparse_shards),
               "coordinates": {"c": {"shard": "g", **coord}}}
        from photon_ml_tpu.cli.config import load_params as jload

        return [load_params(dict(raw), GameDriverParams), jload(dict(raw), JParams)]

    @pytest.mark.parametrize("coord,sparse", [
        ({"hot_columns": -1}, ()),
        ({"hot_columns": -1, "random_effect": "userId"}, ()),
    ], ids=["dense shard", "random effect"])
    def test_game_applies_to_sparse_fixed_effects(self, coord, sparse):
        self._same_refusal(self._game(coord, sparse), "hot_columns applies")

    def test_game_refuses_newton(self):
        self._same_refusal(self._game({"hot_columns": -1, "optimizer": "NEWTON"}), "NEWTON")

    def test_game_refuses_a_multiprocess_run(self, monkeypatch, tmp_path):
        from photon_ml_tpu_torch.cli import game_train as tgame

        monkeypatch.setenv("PHOTON_PROCESS_COUNT", "2")
        monkeypatch.setenv("PHOTON_PROCESS_INDEX", "0")
        params = {"train_input": ["x"], "output_dir": str(tmp_path / "out"),
                  "updating_sequence": ["c"], "sparse_shards": ["g"],
                  "coordinates": {"c": {"shard": "g", "hot_columns": -1}}}
        with pytest.raises(ValueError, match="multi-process GAME training does not support: "
                           "coordinate 'c': hot_columns"):
            tgame.run_game_training(params, device="cpu")
        assert not (tmp_path / "out").exists()


class TestGameRefusesHybridShards:
    """GAME joins shards, entities and scores by row, so a hybrid shard
    (rows in an order of its own) is refused where the JAX package refuses
    it: the dataset, the scorer and the serving pad."""

    def test_game_data_scoring_and_padding_refuse(self, rng):
        from photon_ml_tpu.game.data import GameData as JGameData
        from photon_ml_tpu_torch.game.data import GameData
        from photon_ml_tpu_torch.game.scoring import score_game_data
        from photon_ml_tpu_torch.serving.engine import pad_game_data

        jsf, psf = pair(rng)
        ph = P.to_hybrid(psf)
        with pytest.raises(ValueError, match="HybridFeatures container") as got:
            GameData.create({"g": ph}, np.zeros(N))
        with pytest.raises(ValueError, match="HybridFeatures container") as want:
            JGameData.create({"g": J.to_hybrid(jsf)}, np.zeros(N))
        assert str(got.value) == str(want.value)
        data = GameData.create({"g": psf}, np.zeros(N))
        data = dataclasses.replace(data, features={"g": ph})
        with pytest.raises(ValueError, match="HybridFeatures container"):
            score_game_data({"fixed": torch.zeros(D, dtype=torch.float64)}, {"fixed": "g"},
                            {"fixed": None}, data, device="cpu")
        with pytest.raises(ValueError, match="only dense and plain-ELL shards pad"):
            pad_game_data(data, N + 8)
