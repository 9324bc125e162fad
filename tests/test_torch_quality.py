"""The port's quality layer (``photon_ml_tpu_torch.obs.quality``) and its
ingest hooks (``io/ingest._feed_fingerprint``, ``_resilient_read``)
against the JAX package's, on the CPU, on the same seeded numpy inputs:
the baseline fingerprint after the same ``observe_*`` calls, merged and
saved; the drift monitor's reports after the same batches; the exact AUC,
the calibration error, the online-quality window and the offline
fingerprint comparison; the fingerprint the real ingest paths feed, on
both codecs; and the retried read under an armed ``ingest.read`` fault.

Tolerances: counts, rows, keys, names and flags exactly; every float
within 1e-12 relative (``assert_same_doc``). The port's exact AUC is also
held to its ``ops.metrics.area_under_roc_curve`` within 1e-12.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.io import ingest as jax_ingest
from photon_ml_tpu.io import native as jax_native
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.io.vocab import FeatureVocabulary as JaxVocab
from photon_ml_tpu.obs import quality as jq
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.io import ingest as port_ingest
from photon_ml_tpu_torch.io import native as port_native
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.obs import quality as tq
from photon_ml_tpu_torch.ops import metrics as port_metrics
from photon_ml_tpu_torch.resilience import faults

RTOL = 1e-12


def assert_same_doc(got, want, rtol=RTOL, path="$"):
    """Two JSON-shaped documents equal: the same keys, lengths, strings,
    flags and integers; floats within ``rtol`` relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same_doc(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_doc(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (float, int)) and not isinstance(got, bool), path
        assert got == want or math.isclose(got, want, rel_tol=rtol), (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(autouse=True)
def _no_leaked_collector():
    """A leaked global collector would blur every later ingest."""
    for mod in (jq, tq):
        mod.uninstall_fingerprint_collector()
    yield
    for mod in (jq, tq):
        mod.uninstall_fingerprint_collector()


def _observed(mod, seed, max_features=5):
    """A fingerprint after one fixed sequence of calls: two dense shards
    (one wider than the cap, with names), weighted labels in two chunks, a
    non-2D container, margins and two categorical kinds."""
    rng = np.random.default_rng(seed)
    fp = mod.BaselineFingerprint(max_features=max_features)
    w = rng.uniform(0.0, 2.0, size=300)
    w[::17] = 0.0
    fp.observe_rows("wide", rng.standard_t(3, size=(300, 9)), w,
                    names=[f"c{j}é" for j in range(9)])
    fp.observe_rows("narrow", rng.exponential(size=(300, 2)) * 40.0)
    fp.observe_labels((rng.uniform(size=200) < 0.3).astype(float), w[:200])
    fp.observe_batch(features=object(), labels=np.ones(100), weights=w[200:])
    fp.observe_batch(rng.normal(size=(50, 3)), None, shard="narrow")
    fp.observe_margins(rng.normal(0.0, 4.0, size=300) - 1.5, w)
    fp.observe_categorical("userId", [f"u{int(k)}" for k in rng.zipf(1.3, 300) % 40])
    fp.observe_categorical("adId", ["a", "b", "a"], [1.0, 0.5, 2.0])
    return fp


@pytest.mark.parametrize("max_features", [1, 5, 64])
def test_fingerprint_to_dict_equals_jax(max_features):
    got = _observed(tq, 7, max_features).to_dict()
    want = _observed(jq, 7, max_features).to_dict()
    assert_same_doc(got, want)
    assert got["rows"] == 300 and len(got["shards"]["wide"]) == min(9, max_features)


def test_fingerprint_merge_and_files_cross_packages(tmp_path):
    """Chunked observations merged equal JAX's merged ones; a fingerprint
    saved by either package loads in the other to the same document."""
    docs = []
    for mod in (tq, jq):
        merged = mod.BaselineFingerprint(max_features=4)
        for seed in (1, 2, 3):
            merged.merge(_observed(mod, seed, max_features=4))
        docs.append(merged.to_dict())
    assert_same_doc(*docs)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    path = _observed(tq, 4).save(str(port_dir))
    assert os.path.basename(path) == tq.QUALITY_FINGERPRINT == jq.QUALITY_FINGERPRINT
    _observed(jq, 4).save(str(jax_dir))
    assert_same_doc(jq.BaselineFingerprint.load(str(port_dir)).to_dict(),
                    tq.BaselineFingerprint.load(str(jax_dir)).to_dict())
    assert json.load(open(path)) == tq.BaselineFingerprint.load(path).to_dict()


def _monitor_run(mod, sample_every):
    """A monitor over a two-shard baseline fed the same batches: quiet
    ones, one wider and one narrower than the baseline (the fast and the
    per-column paths), a shard the baseline lacks, then shifted ones.
    Returns every report, the final snapshot and the registry's gauges."""
    rng = np.random.default_rng(11)
    base = mod.BaselineFingerprint(max_features=6)
    base.observe_rows("g", rng.normal(size=(3000, 6)))
    base.observe_rows("u", rng.normal(size=(3000, 3)) * 2.0)
    base.observe_margins(rng.normal(size=3000))
    from photon_ml_tpu.obs.metrics import MetricsRegistry as JaxRegistry

    registry = obs.MetricsRegistry() if mod is tq else JaxRegistry()
    monitor = mod.DriftMonitor(base, registry=registry, check_every_rows=128, min_rows=64,
                               sample_every=sample_every, max_rows_per_batch=50)
    reports = []
    for i in range(40):
        shift = 3.0 if i >= 27 else 0.0
        n = int(rng.integers(20, 70))
        feats = {"g": rng.normal(size=(n, 6 if i % 5 else 8)) + shift,
                 "u": rng.normal(size=(n, 3 if i % 7 else 2)) * 2.0,
                 "other": rng.normal(size=(n, 4))}
        scores = rng.normal(size=n) + shift
        reports.append(monitor.observe(feats, scores if i % 4 else None))
    reports.append(monitor.check())
    return reports, monitor.snapshot(), registry.snapshot()["gauges"]


@pytest.mark.parametrize("sample_every", [1, 3])
def test_drift_monitor_reports_equal_jax(sample_every):
    got, want = _monitor_run(tq, sample_every), _monitor_run(jq, sample_every)
    reports = [r for r in want[0] if r is not None]
    assert reports and any(r["alarm"] for r in reports) and not reports[0]["alarm"]
    assert [r is None for r in got[0]] == [r is None for r in want[0]]
    assert_same_doc(got, want)


def _auc_cases():
    rng = np.random.default_rng(5)
    n = 400
    y = (rng.uniform(size=n) < 0.35).astype(float)
    s = np.round(rng.normal(size=n) + y, 1)  # ties
    w = rng.uniform(0.0, 3.0, size=n)
    w[::9] = 0.0
    return [(y, s, None), (y, s, w), (np.ones(5), s[:5], None), (y[:0], s[:0], None),
            (np.array([1.0, 0.0, 1.0, 0.0]), np.zeros(4), np.array([1.0, 2.0, 0.5, 1.0]))]


@pytest.mark.parametrize("case", range(5))
def test_exact_auc_and_calibration_equal_jax(case):
    y, s, w = _auc_cases()[case]
    auc = tq.exact_auc(y, s, w)
    assert auc == jq.exact_auc(y, s, w)
    assert tq.calibration_error(y, s, w) == jq.calibration_error(y, s, w)
    if y.size and 0.0 < y.sum() < y.size:
        ref = float(port_metrics.area_under_roc_curve(
            torch.from_numpy(y), torch.from_numpy(s),
            torch.from_numpy(np.ones_like(s) if w is None else w)))
        assert abs(auc - ref) <= 1e-12


def test_online_quality_snapshot_equals_jax():
    """The same feedback stream through a bounded window: every snapshot
    and the exported gauges equal, non-finite feedback refused by both."""
    from photon_ml_tpu.obs.metrics import MetricsRegistry as JaxRegistry

    rng = np.random.default_rng(9)
    stream = [(float(rng.uniform() < 0.4), float(rng.normal()), float(rng.uniform(0.1, 2.0)))
              for _ in range(300)]
    out = []
    for mod, registry in ((tq, obs.MetricsRegistry()), (jq, JaxRegistry())):
        q = mod.OnlineQuality(registry=registry, max_samples=128, refresh_every=16)
        snaps = []
        for i, (label, score, weight) in enumerate(stream):
            q.record(label, score, weight)
            if i % 50 == 0:
                snaps.append(q.snapshot())
        with pytest.raises(ValueError, match="finite"):
            q.record(1.0, float("nan"))
        snaps.append(q.snapshot())
        labels, scores, weights = q.window_arrays()
        out.append((snaps, q.window_n, q.total, registry.snapshot()["gauges"],
                    registry.snapshot()["counters"], labels.tolist(), scores.tolist()))
    assert_same_doc(*out)
    assert out[0][1] == 128 and out[0][2] == 300


def test_compare_fingerprints_equals_jax():
    docs = []
    for mod in (tq, jq):
        r = np.random.default_rng(3)
        base = mod.BaselineFingerprint(max_features=4)
        base.observe_batch(r.normal(size=(2000, 4)), (r.uniform(size=2000) < 0.5) * 1.0,
                           shard="s", names=list("abcd"))
        base.observe_margins(r.normal(size=2000))
        cur = mod.BaselineFingerprint(max_features=4)
        x = r.normal(size=(2000, 4))
        x[:, 2] += 4.0
        cur.observe_batch(x, (r.uniform(size=2000) < 0.5) * 1.0, shard="s")
        cur.observe_margins(r.normal(size=2000) + 0.1)
        docs.append([mod.compare_fingerprints(base, cur),
                     mod.compare_fingerprints(base, base, psi_alarm=0.01)])
    assert_same_doc(*docs)
    assert docs[0][0]["flagged"] == ["s.2"] and not docs[0][1]["alarm"]


def test_try_load_fingerprint_degrades_like_jax(tmp_path):
    """Missing, torn and fault-corrupted fingerprints load as None and are
    counted; a good one loads; the ``quality.baseline`` site raises."""
    from photon_ml_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    from photon_ml_tpu.resilience import faults as jax_faults

    good = tmp_path / "good"
    good.mkdir()
    _observed(tq, 2).save(str(good))
    torn = tmp_path / "torn"
    torn.mkdir()
    (torn / "quality-fingerprint.json").write_text("{torn")
    counts = []
    for mod, registry, fmod in ((tq, obs.MetricsRegistry(), faults),
                                (jq, JaxRegistry(), jax_faults)):
        assert mod.try_load_fingerprint(str(tmp_path / "missing"), registry=registry) is None
        assert mod.try_load_fingerprint(str(torn), registry=registry) is None
        assert mod.try_load_fingerprint(str(good), registry=registry).rows == 300
        with fmod.inject(fmod.FaultSpec("quality.baseline", "corrupt", nth=1)):
            assert mod.try_load_fingerprint(str(good), registry=registry) is None
        with fmod.inject(fmod.FaultSpec("quality.baseline", "raise", nth=1)):
            assert mod.try_load_fingerprint(str(good), registry=registry) is None
        counts.append(registry.snapshot()["counters"])
    assert counts[0] == counts[1]
    assert counts[0]["quality.baseline_missing"] == 2
    assert counts[0]["quality.baseline_errors"] == 2


def test_collector_install_and_uninstall():
    assert tq.fingerprint_collector() is None
    port_ingest._feed_fingerprint({"s": np.ones((3, 2))}, np.ones(3), None)  # a no-op
    fp = tq.install_fingerprint_collector(max_features=2)
    assert tq.fingerprint_collector() is fp and fp.max_features == 2
    mine = tq.BaselineFingerprint()
    assert tq.install_fingerprint_collector(mine) is mine
    tq.uninstall_fingerprint_collector()
    assert tq.fingerprint_collector() is None


# -- the ingest paths feed the collector -------------------------------------


def _records(rng, n):
    recs = []
    for i in range(n):
        cols = rng.choice(8, size=int(rng.integers(2, 6)), replace=False)
        recs.append({
            "uid": f"r{i}",
            "label": float(rng.uniform() < 0.4),
            "features": [{"name": f"f{int(c)}", "term": "té" if c % 3 else "",
                          "value": float(rng.normal() * (1 + c))} for c in cols]
                        + [{"name": "g", "term": str(int(rng.integers(0, 30))),
                            "value": 1.0}],
            "metadataMap": {"userId": f"u{int(rng.integers(0, 6))}"} if i % 5 else None,
            "weight": float(rng.uniform(0.5, 2.0)) if i % 3 == 1 else None,
            "offset": float(rng.normal()) if i % 2 else None,
        })
    return recs


@pytest.fixture(scope="module")
def avro(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_quality")
    rng = np.random.default_rng(20261018)
    paths = []
    for part in range(2):
        path = str(tmp / f"part-{part}.avro")
        write_avro_file(path, TRAINING_EXAMPLE_SCHEMA, _records(rng, 90))
        paths.append(path)
    return paths


def _collected(mod, fn):
    fp = mod.install_fingerprint_collector()
    try:
        fn()
    finally:
        mod.uninstall_fingerprint_collector()
    return fp.to_dict()


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    """Both packages on one codec (the Python one when the native reader
    is made unavailable)."""
    if request.param == "python":
        monkeypatch.setattr(jax_native, "native_available", lambda: False)
        monkeypatch.setattr(port_native, "native_available", lambda: False)
    return request.param


def test_labeled_batch_feeds_the_collector_like_jax(avro, codec):
    def run(ingest, vocab_cls, **kw):
        source = ingest.IngestSource(avro)
        vocab = source.build_vocab(add_intercept=True)
        assert isinstance(vocab, vocab_cls)
        return source.labeled_batch(vocab, **kw)

    got = _collected(tq, lambda: run(port_ingest, FeatureVocabulary, device="cpu"))
    want = _collected(jq, lambda: run(jax_ingest, JaxVocab))
    assert_same_doc(got, want)
    assert got["rows"] == 180 and len(got["shards"]["features"]) > 10
    # a sparse design contributes its labels only, in both packages
    got = _collected(tq, lambda: run(port_ingest, FeatureVocabulary, sparse=True,
                                     device="cpu"))
    want = _collected(jq, lambda: run(jax_ingest, JaxVocab, sparse=True))
    assert_same_doc(got, want)
    assert got["shards"] == {} and got["rows"] == 180


def test_game_data_feeds_the_collector_like_jax(avro, codec):
    keys = sorted({f"f{c}\x01{'t' + chr(233) if c % 3 else ''}" for c in range(8)})

    def run(ingest, vocab_cls):
        shards = {"dense": vocab_cls(keys, add_intercept=True),
                  "ell": vocab_cls(keys[:4], add_intercept=True)}
        ingest.IngestSource(avro).game_data(shards, ["userId"], sparse_shards={"ell"})

    got = _collected(tq, lambda: run(port_ingest, FeatureVocabulary))
    want = _collected(jq, lambda: run(jax_ingest, JaxVocab))
    assert_same_doc(got, want)
    assert sorted(got["shards"]) == ["dense"]
    assert bool(got["categoricals"]) == (codec == "native")


def test_resilient_read_retries_an_armed_fault(avro):
    """An ``ingest.read`` fault armed on the first probe costs a retry:
    the batch equals the unarmed read, and the reads are counted."""
    vocab = port_ingest.IngestSource(avro).build_vocab()
    clean, _, _ = port_ingest.IngestSource(avro).labeled_batch(vocab, device="cpu")
    reg = obs.registry()
    before = {k: reg.counter(k).value for k in ("io.ingest.files", "io.ingest.bytes_read",
                                                "resilience.faults_injected.ingest.read")}
    with faults.inject(faults.FaultSpec("ingest.read", "raise", nth=1)):
        source = port_ingest.IngestSource(avro)
        batch, _, _ = source.labeled_batch(vocab, device="cpu")
    assert source.codec == "native"
    assert torch.equal(batch.features, clean.features)
    assert torch.equal(batch.labels, clean.labels)
    after = {k: reg.counter(k).value for k in before}
    assert after["resilience.faults_injected.ingest.read"] == before[
        "resilience.faults_injected.ingest.read"] + 1
    assert after["io.ingest.files"] == before["io.ingest.files"] + len(avro)
    assert after["io.ingest.bytes_read"] == before["io.ingest.bytes_read"] + sum(
        os.path.getsize(p) for p in avro)
    # the Python codec's per-file reads take the same path
    got = port_ingest._resilient_read(lambda x: x + 1, 1, label="t", paths=avro[:1])
    assert got == 2
    with faults.inject(faults.FaultSpec("ingest.read", "raise", nth=1, count=-1)):
        with pytest.raises(Exception, match="always: gave up after 4 attempts"):
            port_ingest._resilient_read(lambda: None, label="always")
