"""The port's mesh-sharded GLM training (``photon_ml_tpu_torch.parallel``)
against the JAX package, on the CPU.

The port's ranks run in gloo worlds spawned by ``torch_worlds.run_world``
(each world under its own time limit); the JAX references run here, on
the 8 virtual CPU devices. The JAX package's own sparse feature-sharded
solve fails on this JAX version, so the port's sparse feature-sharded
solves are held to the single-device ``train_glm``, the reference the JAX
tests use themselves.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core.normalization import NormalizationType as JNorm
from photon_ml_tpu.core.types import LabeledBatch as JBatch
from photon_ml_tpu.models import GLMTrainingConfig as JConfig
from photon_ml_tpu.models import train_glm as jtrain
from photon_ml_tpu.models.training import OptimizerType as JOpt
from photon_ml_tpu.ops import RegularizationContext as JReg
from photon_ml_tpu.ops import sparse as jsparse
from photon_ml_tpu.ops.losses import LOGISTIC_LOSS
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.parallel import distributed_train_glm as jdist
from photon_ml_tpu.parallel import feature_sharded_train_glm as jfeat
from photon_ml_tpu.parallel import make_feature_mesh as jfmesh
from photon_ml_tpu.parallel import make_mesh as jmesh
from photon_ml_tpu.parallel import multihost as jmulti
from photon_ml_tpu_torch import parallel
from photon_ml_tpu_torch.core.types import LabeledBatch
from photon_ml_tpu_torch.ops import sparse as tsparse
from photon_ml_tpu_torch.parallel import overlap
from torch_worlds import run_world


def _jcfg(spec):
    spec = dict(spec)
    spec.pop("initial", None)
    kw = {}
    if "normalization" in spec:
        kw["normalization"] = JNorm[spec.pop("normalization")]
    return JConfig(optimizer=JOpt[spec.pop("optimizer")],
                   regularization=JReg(spec.pop("reg_type", "L2"), alpha=spec.pop("alpha", 0.0)),
                   track_states=False, **kw, **spec)


def _coo(rng, n, d, nnz, intercept=False):
    rows = np.repeat(np.arange(n), nnz)
    cols = rng.integers(0, d - (2 if intercept else 1), size=n * nnz)
    vals = rng.normal(size=n * nnz)
    if intercept:
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.full(n, d - 1)])
        vals = np.concatenate([vals, np.ones(n)])
    return rows, cols, vals, n, d


def _labels(rng, x, w, scale=1.0):
    return (rng.uniform(size=x.shape[0]) < 1 / (1 + np.exp(-(x @ w) * scale))).astype(float)


def _jsf(coo):
    r, c, v, n, d = coo
    return jsparse.from_coo(r, c, v, n, d, dtype=jnp.float64)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _same_on_every_rank(results, case):
    for r in results[1:]:
        for a, b in zip(r["cases"][case]["w"], results[0]["cases"][case]["w"]):
            assert np.array_equal(a.view(np.int64), b.view(np.int64)), case


# -- (a) the blocked container, outside a mesh ---------------------------------


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
def test_shard_columns_equals_jax(rng, blocks, balance):
    """``shard_columns`` (flat and balanced), ``blocked_column_map``,
    ``balanced_virtual_width`` and the blocked contractions equal the JAX
    functions; the contractions also equal the unblocked ELL's within
    1e-12 (``tests/test_parallel.py:388``, ``tests/test_partition.py:127``)."""
    coo = _coo(rng, 257, 93, 7)
    jsf = _jsf(coo)
    tsf = tsparse.from_coo(*coo, dtype=torch.float64)
    jf = jsparse.shard_columns(jsf, blocks, balance_rows=balance)
    tf = tsparse.shard_columns(tsf, blocks, balance_rows=balance)
    assert np.array_equal(np.asarray(jf.indices), tf.indices.numpy())
    assert np.array_equal(np.asarray(jf.values), tf.values.numpy())
    assert (tf.d_shard, tf.d_orig, tf.is_balanced) == (jf.d_shard, jf.d_orig, jf.is_balanced)
    if jf.is_balanced:
        assert np.array_equal(np.asarray(jf.row_map), tf.row_map.numpy())
        assert (tf.num_rows, tf.aligned_rows) == (jf.num_rows, jf.aligned_rows)
    cmap = tsparse.blocked_column_map(93, blocks)
    assert np.array_equal(cmap, jsparse.blocked_column_map(93, blocks))
    counts = rng.integers(0, 9, size=(blocks, 50))
    assert tsparse.balanced_virtual_width(counts) == jsparse.balanced_virtual_width(counts)

    w = rng.normal(size=93)
    wb = np.zeros(blocks * tf.d_shard)
    wb[cmap] = w
    a = rng.normal(size=257)
    cases = [
        (tsparse.matvec(tf, torch.tensor(wb)), jsparse.matvec(jf, jnp.asarray(wb)),
         jsparse.matvec(jsf, jnp.asarray(w)), None),
        (tsparse.rmatvec(tf, torch.tensor(a)), jsparse.rmatvec(jf, jnp.asarray(a)),
         jsparse.rmatvec(jsf, jnp.asarray(a)), cmap),
        (tsparse.colsum(tf, torch.tensor(a), square=True),
         jsparse.colsum(jf, jnp.asarray(a), square=True),
         jsparse.colsum(jsf, jnp.asarray(a), square=True), cmap),
    ]
    for got, jax_blocked, ell, idx in cases:
        got = got.numpy()
        _close(got, jax_blocked, 1e-12)
        _close(got if idx is None else got[idx], ell, 1e-12)
    # the dots riding the margins, padding rows, and the flat ELL view
    v = rng.normal(size=len(wb))
    z, (dd,) = tsparse.matvec_and_feature_dots(tf, torch.tensor(wb),
                                               ((torch.tensor(wb), torch.tensor(v)),))
    jz, (jd,) = jsparse.matvec_and_feature_dots(jf, jnp.asarray(wb),
                                                ((jnp.asarray(wb), jnp.asarray(v)),))
    _close(z.numpy(), jz, 1e-12)
    assert abs(float(dd) - float(jd)) <= 1e-12 * max(1.0, abs(float(jd)))
    _close(tsparse.matvec(tsparse.pad_rows(tf, 5), torch.tensor(wb)).numpy(),
           jsparse.matvec(jsparse.pad_rows(jf, 5), jnp.asarray(wb)), 1e-12)
    _close(tsparse.to_dense(tf), jsparse.to_dense(jf), 0.0)


@pytest.mark.parametrize("balance", [False, True])
def test_interop_carries_the_blocked_layout(rng, balance):
    """The JAX container's arrays (its ``row_map`` and ``aligned_rows``
    too) through ``interop`` equal the port's ``shard_columns`` and
    contract alike; blocked coefficient vectors round-trip."""
    from photon_ml_tpu_torch import interop

    coo = _coo(rng, 120, 41, 5)
    jf = jsparse.shard_columns(_jsf(coo), 4, balance_rows=balance)
    got = interop.feature_sharded_from_numpy(
        np.asarray(jf.indices), np.asarray(jf.values), jf.d_shard, jf.d_orig,
        None if jf.row_map is None else np.asarray(jf.row_map), jf.num_rows, jf.aligned_rows)
    want = tsparse.shard_columns(tsparse.from_coo(*coo, dtype=torch.float64), 4,
                                 balance_rows=balance)
    assert torch.equal(got.indices, want.indices) and torch.equal(got.values, want.values)
    w = rng.normal(size=41)
    wb = interop.blocked_from_numpy(w, 4)
    assert np.array_equal(interop.unblocked_to_numpy(wb, 41, 4), w)
    _close(tsparse.matvec(got, wb).numpy(), jsparse.matvec(jf, jnp.asarray(wb.numpy())), 1e-12)
    a = rng.normal(size=120)
    _close(tsparse.rmatvec(got, torch.tensor(a)).numpy(),
           jsparse.rmatvec(jf, jnp.asarray(a)), 1e-12)


def test_block_sum_and_collective_mode(rng, monkeypatch):
    """With no mesh the block sum is the plain sum; the mode and chunk
    knobs read as the JAX package's do."""
    payload = rng.normal(size=(4, 37))
    np.testing.assert_allclose(parallel.feature_block_sum(torch.tensor(payload)).numpy(),
                               payload.sum(0), rtol=1e-15)
    monkeypatch.delenv(overlap.COLLECTIVE_MODE_ENV, raising=False)
    assert overlap.collective_mode() == "overlap"
    monkeypatch.setenv(overlap.COLLECTIVE_MODE_ENV, "async")
    with pytest.raises(ValueError, match="fused"):
        overlap.collective_mode()
    monkeypatch.setenv(overlap.OVERLAP_CHUNKS_ENV, "junk")
    assert overlap.overlap_chunks() == 4


def test_meshes_of_one_world():
    """A world of one: meshes of its size build with no group (their
    reductions are the identity); a larger or smaller one raises."""
    mesh = parallel.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.group("data") is None
    assert parallel.make_feature_mesh(1, 1).shape == {"data": 1, "feature": 1}
    with pytest.raises(ValueError, match="mesh of 2 'data' devices requested, have 1"):
        parallel.make_mesh(2)
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        parallel.make_feature_mesh(2, 2)


def test_feature_sharding_refusals(rng):
    """Hybrid and already-blocked designs are refused in the JAX words."""
    coo = _coo(rng, 64, 20, 4)
    sf = tsparse.from_coo(*coo, dtype=torch.float64)
    mesh = parallel.make_feature_mesh(1, 1)
    from photon_ml_tpu_torch.models.training import GLMTrainingConfig

    cfg = GLMTrainingConfig()
    for feats, words in ((tsparse.to_hybrid(sf, hot_columns=2), "hybrid containers"),
                         (tsparse.shard_columns(sf, 2), "already column-blocked")):
        with pytest.raises(ValueError, match=words):
            parallel.feature_sharded_train_glm(
                LabeledBatch(feats, *(torch.zeros(64, dtype=torch.float64),) * 3,
                             torch.ones(64, dtype=torch.float64)), cfg, mesh)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "ell"])
def test_world_of_one_is_the_plain_run_bit_for_bit(rng, sparse):
    """A mesh of one (no process group) takes the plain path: the same
    iterations, CG steps and w bits as ``train_glm`` without a mesh."""
    from photon_ml_tpu_torch.models.training import GLMTrainingConfig, OptimizerType, train_glm
    from photon_ml_tpu_torch.ops.objective import RegularizationContext

    coo = _coo(rng, 301, 37, 6)
    x = tsparse.from_coo(*coo, dtype=torch.float64)
    y = _labels(rng, tsparse.to_dense(x), rng.normal(size=37), 0.5)
    batch = LabeledBatch.create(x if sparse else tsparse.to_dense(x), y, dtype=torch.float64)
    cfg = GLMTrainingConfig(optimizer=OptimizerType.TRON, regularization=RegularizationContext("L2"),
                            reg_weights=(10.0, 1.0), max_iters=40, tolerance=1e-10)
    plain = train_glm(batch, cfg)
    for mesh in (parallel.make_mesh(), parallel.make_feature_mesh(1, 1)):
        sharded = (parallel.distributed_train_glm(batch, cfg, mesh) if "feature" not in mesh.shape
                   else parallel.feature_sharded_train_glm(batch, cfg, mesh))
        for a, b in zip(sharded, plain):
            assert (a.result.iterations, a.result.cg_iterations) == (
                b.result.iterations, b.result.cg_iterations)
            assert torch.equal(a.model.coefficients.means, b.model.coefficients.means)


def test_split_rows_equal_jax():
    """(g) ``split_rows`` and ``process_local_rows`` equal the JAX functions."""
    for total in (0, 1, 7, 100, 101):
        for n in (1, 2, 3, 8):
            for i in range(n):
                assert parallel.split_rows(total, n, i) == jmulti.split_rows(total, n, i)
    assert parallel.process_local_rows(11) == jmulti.process_local_rows(11)
    assert parallel.process_local_paths(["b", "a"]) == jmulti.process_local_paths(["b", "a"])


# -- (b), (d), (f), (g): two ranks over 'data' ------------------------------------


def _jbatch(design, y):
    return JBatch.create(_jsf(design) if isinstance(design, tuple) else design, y,
                         dtype=jnp.float64)


@pytest.fixture(scope="module")
def data_world(tmp_path_factory):
    from photon_ml_tpu.io.avro import write_avro_file
    from photon_ml_tpu.io.ingest import IngestSource as JSource
    from photon_ml_tpu.io.ingest import make_training_example
    from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
    from photon_ml_tpu.io.vocab import FeatureVocabulary as JVocab

    rng = np.random.default_rng(20261018)
    tmp = tmp_path_factory.mktemp("data_world")
    x = rng.normal(size=(401, 10))
    y = _labels(rng, x, rng.normal(size=10))
    coo = _coo(rng, 301, 37, 6)
    y_sp = _labels(rng, tsparse.to_dense(tsparse.from_coo(*coo, dtype=torch.float64)),
                   rng.normal(size=37) * (rng.uniform(size=37) < 0.5), 0.5)
    tight = dict(reg_weights=(1.0,), max_iters=60, tolerance=1e-12)
    cases = {}
    for o in ("TRON", "LBFGS"):
        cases[f"dense-{o}"] = (x, y, dict(optimizer=o, **tight))
        cases[f"ell-{o}"] = (coo, y_sp, dict(optimizer=o, **tight))
    cases["ell-TRON-path-variances"] = (coo, y_sp, dict(
        optimizer="TRON", reg_weights=(10.0, 1.0), max_iters=60, tolerance=1e-12,
        compute_variances=True))

    # (f): two part files, one per rank
    d = 12
    w_true = rng.normal(size=d)
    paths = []
    for part in range(2):
        recs = []
        for _ in range(200):
            xi = rng.normal(size=d)
            yi = float(rng.uniform() < 1 / (1 + np.exp(-xi @ w_true)))
            recs.append(make_training_example(
                label=yi, features={(f"f{j}", ""): float(xi[j]) for j in range(d)}))
        p = str(tmp / f"part-{part}.avro")
        write_avro_file(p, TRAINING_EXAMPLE_SCHEMA, recs)
        paths.append(p)
    vocab_path = str(tmp / "vocab.txt")
    JVocab([f"f{j}\x01" for j in range(d)], add_intercept=False).save(vocab_path)
    split_spec = dict(optimizer="TRON", reg_weights=(1.0,), max_iters=40, tolerance=1e-12)
    probe = (x, y, rng.normal(size=10))

    results = run_world(tmp, 2, "data_world", cases=cases, probe=probe, paths=paths,
                        vocab=vocab_path, split_spec=split_spec)
    refs = {name: jdist(_jbatch(design, yy), _jcfg(spec), jmesh(2))
            for name, (design, yy, spec) in cases.items()}
    full, _, _ = JSource(paths).labeled_batch(JVocab.load(vocab_path), dtype="float64")
    (split_ref,) = jtrain(full, _jcfg(split_spec))
    return dict(results=results, refs=refs, probe=probe, paths=paths, split_ref=split_ref)


def _assert_cases(results, refs, atol=1e-8):
    for name, ref in refs.items():
        got = results[0]["cases"][name]
        assert len(got["w"]) == len(ref)
        for w, r in zip(got["w"], ref):
            _close(w, r.model.coefficients.means, atol)
        if "variances" in got:
            for v, r in zip(got["variances"], ref):
                np.testing.assert_allclose(v, np.asarray(r.model.coefficients.variances),
                                           rtol=1e-8)
        _same_on_every_rank(results, name)


def test_data_sharded_equals_jax(data_world):
    """(b), (d): ``distributed_train_glm`` with TRON and L-BFGS on a dense
    and an ELL design (and a two-lambda ELL path with variances) equals JAX
    ``distributed_train_glm`` on ``make_mesh(2)`` within 1e-8, and every
    rank's w equals rank 0's bit for bit."""
    _assert_cases(data_world["results"], data_world["refs"])


def test_explicit_value_and_grad_equals_jax(data_world):
    """``shard_map_value_and_grad`` over two ranks' rows equals the JAX
    objective on the whole batch within 1e-12, on every rank."""
    x, y, w = data_world["probe"]
    val, grad = JObjective(loss=LOGISTIC_LOSS, l2_weight=0.5).value_and_grad(
        jnp.asarray(w), JBatch.create(x, y, dtype=jnp.float64))
    for r in data_world["results"]:
        v, g = r["shard_map"]
        assert abs(v - float(val)) <= 1e-12 * abs(float(val))
        _close(g, grad, 1e-12)


def test_file_split_equals_single_process_jax(data_world):
    """(f): each rank reads its part file (``process_local_paths``), its
    batch is its shard (``make_global_batch``), and ``train_glm`` under the
    mesh equals the single-process JAX ``train_glm`` of both files, dense
    and ELL, on both ranks (``tests/test_parallel.py:701``)."""
    ref = data_world["split_ref"].model.coefficients.means
    for rank, r in enumerate(data_world["results"]):
        assert r["split"]["paths"] == [sorted(data_world["paths"])[rank]]
        assert r["split"]["rows"] == 200
        _close(r["split"]["w"], ref, 1e-8)
        _close(r["split"]["w_sparse"], ref, 1e-8)


def test_host_exchanges_and_store_heartbeats(data_world):
    """(g) ``allgather_host`` / ``allgather_strings`` / ``process_local_rows``
    across two ranks, and the store heartbeats: each rank reads its
    peer's beat, and no peer is lost."""
    for rank, r in enumerate(data_world["results"]):
        assert r["allgather"].tolist() == [[0, 10], [1, 11]]
        assert r["strings"] == ["r0-0", "r1-0", "r1-1"]
        assert r["rows"] == list(parallel.split_rows(11, 2, rank))
        hb = r["heartbeat"]
        assert hb["transport"] == "DistributedKVHeartbeats"
        assert list(hb["ages"]) == [1 - rank] and hb["lost"] == []
        assert hb["ages"][1 - rank] < 60.0


# -- (c), (d), (e): four ranks over ('data', 'feature') ---------------------------


def _dense_problem(rng, n=512, d=60):
    x = rng.normal(size=(n, d))
    w = rng.normal(size=d) * (rng.uniform(size=d) < 0.4)
    return x, _labels(rng, x, w)


def _sparse_problem(rng, n, d, nnz, intercept=False):
    coo = _coo(rng, n, d, nnz, intercept)
    dense = tsparse.to_dense(tsparse.from_coo(*coo, dtype=torch.float64))
    return coo, _labels(rng, dense, rng.normal(size=d) * (rng.uniform(size=d) < 0.5), 0.5)


TIGHT = dict(reg_weights=(1.0,), max_iters=60, tolerance=1e-12)


@pytest.fixture(scope="module")
def feature_2x2(tmp_path_factory):
    """A 2 x 2 world: the dense cases against JAX ``feature_sharded_train_glm``
    on ``make_feature_mesh(2, 2)``, the ELL cases in ``fused`` mode against
    JAX single-device ``train_glm``."""
    rng = np.random.default_rng(20261019)
    x, y = _dense_problem(rng)
    x13, y13 = _dense_problem(rng, 300, 13)
    d = 21
    xs = rng.normal(size=(400, d)) * rng.uniform(1, 9, size=d)
    xs[:, -1] = 1.0
    ys = _labels(rng, xs, rng.normal(size=d), 0.1)
    coo, y_sp = _sparse_problem(rng, 401, 53, 6)
    dense_cases = {
        "dense-TRON": (x, y, dict(optimizer="TRON", **TIGHT)),
        "dense-LBFGS": (x, y, dict(optimizer="LBFGS", **TIGHT)),
        "uneven-TRON": (x13, y13, dict(optimizer="TRON", reg_weights=(1.0,), max_iters=40,
                                       tolerance=1e-10)),
        "constraints-LBFGS": (x13, y13, dict(
            optimizer="LBFGS", reg_weights=(0.5,), lower_bounds=tuple([-0.2] * 13),
            upper_bounds=tuple([0.2] * 13), max_iters=60, tolerance=1e-12)),
        "standardization-TRON": (xs, ys, dict(
            optimizer="TRON", normalization="STANDARDIZATION", intercept_index=d - 1,
            compute_variances=True, **TIGHT)),
        "warm-LBFGS": (x, y, dict(optimizer="LBFGS", initial=rng.normal(size=60) * 0.1,
                                  **TIGHT)),
        "tracked-uneven-TRON": (x13, y13, dict(optimizer="TRON", reg_weights=(1.0,),
                                               max_iters=40, tolerance=1e-10,
                                               track_models=True)),
    }
    ell_cases = {f"ell-{o}": (coo, y_sp, dict(optimizer=o, **TIGHT)) for o in ("TRON", "LBFGS")}
    probe = (x, y, rng.normal(size=60))
    d_sp = coo[4]
    reductions = (rng.uniform(0.5, 2.0, size=d_sp), 0.1 * rng.normal(size=d_sp),
                  0.1 * rng.normal(size=d_sp), rng.normal(size=d_sp))
    results = run_world(
        tmp_path_factory.mktemp("feature_2x2"), 4, "feature_world", shape=(2, 2),
        cases={k: v + ("fused",) for k, v in {**dense_cases, **ell_cases}.items()},
        count_case=(coo, y_sp), probe=probe, reductions=reductions)
    from photon_ml_tpu.core.types import Coefficients as JCoef

    refs = {}
    for name, (xp, yp, spec) in dense_cases.items():
        kw = {}
        if "initial" in spec:
            kw["initial_coefficients"] = JCoef(means=jnp.asarray(spec["initial"]))
        refs[name] = jfeat(_jbatch(xp, yp), _jcfg(spec), jfmesh(2, 2), **kw)
    for name, (design, yp, spec) in ell_cases.items():
        refs[name] = jtrain(_jbatch(design, yp), _jcfg(spec))
    return dict(results=results, refs=refs, probe=probe, count_case=(coo, y_sp),
                reductions=reductions)


def test_feature_sharded_2x2_equals_jax(feature_2x2):
    """(c), (d): dense designs (uneven d, box constraints, standardization
    with variances, a warm start) equal JAX ``feature_sharded_train_glm``
    on a 2 x 2 mesh within 1e-8; the ELL design in ``fused`` mode equals
    JAX single-device ``train_glm`` within 1e-8; every rank's w equals
    rank 0's bit for bit."""
    results = feature_2x2["results"]
    assert sorted(tuple(r["coordinate"].values()) for r in results) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    _assert_cases(results, feature_2x2["refs"])
    w = results[0]["cases"]["constraints-LBFGS"]["w"][0]
    assert np.all(w >= -0.2 - 1e-12) and np.all(w <= 0.2 + 1e-12)
    # the tracked coefficients, gathered over 'feature', in the blocked
    # space (13 columns padded to 14): the last one is the solution, and
    # the pad column stays 0
    tracked = results[0]["cases"]["tracked-uneven-TRON"]
    hist = tracked["w_history"][0]
    assert hist.shape == (tracked["iterations"][0] + 1, 14)
    np.testing.assert_array_equal(hist[-1, :13], tracked["w"][0])
    assert np.all(hist[:, 13] == 0.0) and np.all(hist[0] == 0.0)


def test_fused_pass_is_one_feature_collective(feature_2x2):
    """(e): counted by wrapping ``torch.distributed.all_reduce``, one
    objective pass in ``fused`` mode is one all-reduce over the 'feature'
    group (the margins with the L2 dot) plus the 'data' group's value and
    gradient; a Hessian-vector product likewise."""
    for r in feature_2x2["results"]:
        assert r["pass_all_reduces"] == {"feature": 1, "data": 1}
        assert r["hvp_all_reduces"] == {"feature": 1, "data": 1}


def test_feature_reductions_fused_or_not_equal_jax(feature_2x2):
    """``fuse_feature_reductions`` on and off, with whitening shifts and
    L2: each rank's value and blocks of the gradient and of H v equal the
    JAX objective's on the whole batch within 1e-12. Fused, a pass is one
    'feature' all-reduce (the margins with the shift and L2 dots) and a
    Hessian-vector product one; unfused, each dot is its own all-reduce
    (3 a pass, 2 a product). 'data' reduces once either way."""
    from photon_ml_tpu.core.normalization import NormalizationContext as JNormCtx

    factors, shifts, w, v = feature_2x2["reductions"]
    coo, y = feature_2x2["count_case"]
    jobj = JObjective(loss=LOGISTIC_LOSS, l2_weight=0.5,
                      normalization=JNormCtx(factors=jnp.asarray(factors),
                                             shifts=jnp.asarray(shifts)))
    jb = _jbatch(coo, y)
    val, grad = jobj.value_and_grad(jnp.asarray(w), jb)
    hv = jobj.hessian_vector(jnp.asarray(w), jnp.asarray(v), jb)
    col_map = tsparse.blocked_column_map(coo[4], 2)
    ds = -(-coo[4] // 2)

    def block(vec, lo):
        full = np.zeros(2 * ds)
        full[col_map] = np.asarray(vec)
        return full[lo:lo + ds]

    want_counts = {True: ({"feature": 1, "data": 1}, {"feature": 1, "data": 1}),
                   False: ({"feature": 3, "data": 1}, {"feature": 2, "data": 1})}
    for r in feature_2x2["results"]:
        red = r["reductions"]
        for fuse in (True, False):
            got = red[fuse]
            assert abs(got["value"] - float(val)) <= 1e-12 * abs(float(val))
            _close(got["grad"], block(grad, red["lo"]), 1e-12)
            _close(got["hvp"], block(hv, red["lo"]), 1e-12)
            assert (got["pass_all_reduces"], got["hvp_all_reduces"]) == want_counts[fuse]


def test_hierarchical_reduction_equals_jax(feature_2x2):
    """``hierarchical_value_and_grad`` over ('host', 'device') = 2 x 2 equals
    the JAX objective on the whole batch within 1e-12, and
    ``hierarchical_psum`` is the flat sum on every rank."""
    x, y, w = feature_2x2["probe"]
    val, grad = JObjective(loss=LOGISTIC_LOSS, l2_weight=0.5).value_and_grad(
        jnp.asarray(w), JBatch.create(x, y, dtype=jnp.float64))
    want = np.arange(7.0) * (1 + 2 + 3 + 4)
    for r in feature_2x2["results"]:
        v, g = r["hierarchical"]
        assert abs(v - float(val)) <= 1e-12 * abs(float(val))
        _close(g, grad, 1e-12)
        _close(r["hierarchical_psum"], want, 0.0)


@pytest.fixture(scope="module")
def feature_1x4(tmp_path_factory):
    """A 1 x 4 world on ELL designs: the balanced layout in ``overlap``
    mode (TRON, L-BFGS, OWL-QN, standardization) and the flat one in
    ``fused`` mode, each against JAX single-device ``train_glm``."""
    rng = np.random.default_rng(20261020)
    coo, y = _sparse_problem(rng, 500, 83, 6)
    coo_l1, y_l1 = _sparse_problem(rng, 400, 45, 5)
    coo_s, y_s = _sparse_problem(rng, 400, 31, 5, intercept=True)
    cases = {
        "overlap-TRON": (coo, y, dict(optimizer="TRON", **TIGHT), "overlap"),
        "overlap-LBFGS": (coo, y, dict(optimizer="LBFGS", **TIGHT), "overlap"),
        "fused-TRON": (coo, y, dict(optimizer="TRON", **TIGHT), "fused"),
        "overlap-OWLQN": (coo_l1, y_l1, dict(
            optimizer="LBFGS", reg_type="ELASTIC_NET", alpha=0.5, reg_weights=(0.3,),
            max_iters=80, tolerance=1e-12), "overlap"),
        "overlap-standardization": (coo_s, y_s, dict(
            optimizer="TRON", normalization="STANDARDIZATION", intercept_index=30, **TIGHT),
            "overlap"),
    }
    results = run_world(tmp_path_factory.mktemp("feature_1x4"), 4, "feature_world",
                        shape=(1, 4), cases=cases, count_case=(coo, y))
    refs = {name: jtrain(_jbatch(design, yy), _jcfg(spec))
            for name, (design, yy, spec, _) in cases.items()}
    return dict(results=results, refs=refs)


def test_feature_sharded_1x4_equals_single_device_jax(feature_1x4):
    """(c), (d): at 1 x 4 the balanced layout in ``overlap`` mode and the
    flat layout in ``fused`` mode equal JAX single-device ``train_glm``
    within 1e-8 (OWL-QN within 1e-7, the JAX tests' tolerance for it);
    every rank's w equals rank 0's bit for bit; an overlap solve issues
    its margins in chunks (4 all-reduces a pass, not 1)."""
    refs = dict(feature_1x4["refs"])
    owlqn = {"overlap-OWLQN": refs.pop("overlap-OWLQN")}
    _assert_cases(feature_1x4["results"], refs)
    _assert_cases(feature_1x4["results"], owlqn, atol=1e-7)
    cases = feature_1x4["results"][0]["cases"]
    for name in ("overlap-TRON", "fused-TRON"):
        c = cases[name]["collectives"]
        assert c["margins"]["count"] > 0
    # the two solves take the same passes; 'data' (size 1) issues no
    # collective beside 'feature', so the passes are counted by the
    # margins' reductions: one a pass fused, one a chunk overlapped
    assert (cases["overlap-TRON"]["iterations"], cases["overlap-TRON"]["cg"]) == (
        cases["fused-TRON"]["iterations"], cases["fused-TRON"]["cg"])
    over, fused = cases["overlap-TRON"]["collectives"], cases["fused-TRON"]["collectives"]
    assert "value_grad" not in over and "hvp" not in fused
    assert over["margins"]["count"] == 4 * fused["margins"]["count"]
