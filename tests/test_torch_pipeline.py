"""The port's streaming ingest pipeline and out-of-core epochs
(``photon_ml_tpu_torch/io/pipeline.py``) against the JAX package's
(``photon_ml_tpu/io/pipeline.py``), class by class as
``tests/test_pipeline.py`` holds the JAX one, on the CPU.

The same part files (or the same seeded numpy batch) go to both packages.
Tolerances: the streamed batches and GameData equal the one-shot reads and
the JAX pipeline's bit for bit, at every prefetch depth; the streaming
objective's value, gradient, Hessian-vector product and diagonal equal the
JAX one's within 1e-12 in float64; out-of-core models equal the in-core
models within 1e-10, with the same iterations (and CG steps for TRON),
and the JAX package's out-of-core models within 1e-8 x max(1, |w|inf).
"""

import gc
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.io.pipeline as jpipe
from photon_ml_tpu.core.types import LabeledBatch as JBatch
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.ingest import IngestSource as JSource
from photon_ml_tpu.io.ingest import make_training_example
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.io.vocab import FeatureVocabulary as JVocab
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import Coefficients, LabeledBatch
from photon_ml_tpu_torch.io import native
from photon_ml_tpu_torch.io.ingest import IngestSource
from photon_ml_tpu_torch.io.pipeline import (
    COLUMNS,
    IngestPipeline,
    PipelineConfig,
    PipelineStats,
    StageStall,
    StreamedDesign,
    StreamingObjective,
    count_records,
    plan_file_groups,
    rows_per_chunk_for,
)
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.models.training import (
    GLMTrainingConfig,
    OptimizerType,
    train_glm,
    train_glm_streamed,
)
from photon_ml_tpu_torch.obs.metrics import MetricsRegistry
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.objective import GLMObjective, RegularizationContext
from photon_ml_tpu_torch.resilience.faults import FaultSpec, inject
from photon_ml_tpu_torch.resilience.retry import RetryBudgetExceeded

D = 60
SIZES = [151, 89, 203, 57]


def _records(n, seed=0, with_meta=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        feats = {(f"f{j}", "t"): float(rng.standard_normal())
                 for j in rng.choice(D, 6, replace=False)}
        rec = make_training_example(
            label=float(rng.integers(0, 2)), features=feats,
            uid=f"u{i}" if i % 3 else None,
            offset=float(rng.standard_normal()) if i % 2 else None,
            weight=float(rng.uniform(0.5, 2.0)) if i % 5 else None,
        )
        if with_meta:
            rec["metadataMap"] = {"userId": f"user{i % 7}"} if i % 4 else None
        out.append(rec)
    return out


def _keys():
    return [f"f{i}\x01t" for i in range(D)]


def _vocab():
    return FeatureVocabulary(_keys(), add_intercept=True)


def _jvocab():
    return JVocab(_keys(), add_intercept=True)


@pytest.fixture()
def part_files(tmp_path):
    """Four part files with awkward, distinct row counts."""
    paths = []
    for i, n in enumerate(SIZES):
        p = str(tmp_path / f"part-{i}.avro")
        write_avro_file(p, TRAINING_EXAMPLE_SCHEMA, _records(n, seed=10 + i, with_meta=True),
                        codec="deflate")
        paths.append(p)
    return paths


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_batches_equal(a, b):
    for f in COLUMNS:
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)), err_msg=f)


def _with_registry(fn):
    reg = MetricsRegistry()
    prev = obs.set_registry(reg)
    try:
        return fn(), reg.snapshot()
    finally:
        obs.set_registry(prev)


class TestPlanning:
    @pytest.mark.parametrize("chunk_mb", [0.01, 0.02, 1024])
    def test_groups_match_jax_and_keep_order(self, part_files, chunk_mb):
        groups = plan_file_groups(part_files, chunk_mb=chunk_mb)
        assert groups == jpipe.plan_file_groups(part_files, chunk_mb=chunk_mb)
        assert [g for group in groups for g in group] == part_files
        if chunk_mb == 0.01:
            assert all(len(g) == 1 for g in groups)
        if chunk_mb == 1024:
            assert groups == [part_files]

    @pytest.mark.parametrize("bad", [dict(chunk_mb=0), dict(prefetch_depth=0),
                                     dict(decode_threads=-1), dict(stage_timeout_s=0.0),
                                     dict(epoch_policy="retry")])
    def test_config_validation(self, bad):
        for cls in (PipelineConfig, jpipe.PipelineConfig):
            with pytest.raises(ValueError):
                cls(**bad).validate()

    def test_overlap_frac_sweep_line(self):
        for cls in (PipelineStats, jpipe.PipelineStats):
            s = cls()
            s.note("decode", 1.0, t0=0.0)
            s.note("stage", 1.0, t0=0.5)
            # [0, 1.5] covered, [0.5, 1.0] doubly covered
            assert s.overlap_frac() == pytest.approx(1.0 / 3.0)
            serial = cls()
            serial.note("decode", 1.0, t0=0.0)
            serial.note("stage", 1.0, t0=1.0)
            assert serial.overlap_frac() == 0.0
            serial.note_stall(0.5)
            serial.finish(2.0)
            assert serial.stall_frac() == 0.25

    @pytest.mark.parametrize("d,itemsize", [(61, 8), (61, 4), (257, 8), (1 << 20, 8)])
    def test_rows_per_chunk_matches_jax(self, d, itemsize):
        for mb in (0.02, 8.0, 64.0):
            assert rows_per_chunk_for(mb, d, itemsize) == jpipe.rows_per_chunk_for(
                mb, d, itemsize)

    def test_count_records_reads_the_block_headers(self, part_files, tmp_path):
        assert [count_records(p) for p in part_files] == SIZES
        # many small blocks, and a file with none
        p = str(tmp_path / "blocks.avro")
        write_avro_file(p, TRAINING_EXAMPLE_SCHEMA, _records(300, seed=3), block_size=7)
        assert count_records(p) == 300
        empty = str(tmp_path / "empty.avro")
        write_avro_file(empty, TRAINING_EXAMPLE_SCHEMA, [])
        assert count_records(empty) == 0


class TestPipelineAssembly:
    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_bit_for_bit_across_prefetch_depths(self, part_files, depth):
        """The streamed batch is the one-shot ``labeled_batch`` and the JAX
        pipeline's batch exactly, at every prefetch depth."""
        whole, uids_w, pres_w = IngestSource(part_files).labeled_batch(
            _vocab(), dtype=torch.float64)
        cfg = dict(chunk_mb=0.02, decode_threads=2, prefetch_depth=depth)
        with IngestPipeline(part_files, [_vocab()], config=PipelineConfig(**cfg)) as pipe:
            batch, uids, pres = pipe.labeled_batch(dtype=torch.float64)
            assert len(pipe.groups) > 1 and pipe.stats.chunks > 1
        _assert_batches_equal(batch, whole)
        assert list(uids) == list(uids_w)
        np.testing.assert_array_equal(pres, pres_w)
        with jpipe.IngestPipeline(part_files, [_jvocab()],
                                  config=jpipe.PipelineConfig(**cfg)) as jp:
            jbatch, juids, _ = jp.labeled_batch(dtype=jnp.float64)
        _assert_batches_equal(batch, jbatch)
        assert list(uids) == list(juids)

    def test_float32_batch_is_the_one_shot_read(self, part_files):
        whole, _, _ = IngestSource(part_files).labeled_batch(_vocab())
        with IngestPipeline(part_files, [_vocab()],
                            config=PipelineConfig(chunk_mb=0.01)) as pipe:
            batch, _, _ = pipe.labeled_batch()
        assert batch.features.dtype == torch.float32
        _assert_batches_equal(batch, whole)

    def test_streamed_ingest_source_delegates(self, part_files):
        vocab = _vocab()
        whole, uids_w, _ = IngestSource(part_files).labeled_batch(vocab, dtype=torch.float64)
        src = IngestSource(part_files)
        streamed, uids, _ = src.labeled_batch_streamed(
            vocab, dtype=torch.float64, chunk_mb=0.02, prefetch_depth=2)
        _assert_batches_equal(streamed, whole)
        assert list(uids) == list(uids_w)
        assert src.codec == "native"
        jbatch, _, _ = JSource(part_files).labeled_batch_streamed(
            _jvocab(), dtype=jnp.float64, chunk_mb=0.02, prefetch_depth=2)
        _assert_batches_equal(streamed, jbatch)

    def test_device_chunks_and_the_destructive_deposit(self, part_files):
        """``device_chunks`` yields the chunks in order, each in memory of
        its own while the ring's slots are reused under them, and their
        rows in order are the one-shot batch; ``labeled_batch`` deposits
        them into the preallocated rows."""
        whole, _, _ = IngestSource(part_files).labeled_batch(_vocab(), dtype=torch.float64)
        with IngestPipeline(part_files, [_vocab()],
                            config=PipelineConfig(chunk_mb=0.02, prefetch_depth=1)) as pipe:
            chunks = list(pipe.device_chunks(dtype=torch.float64))
        assert [c["index"] for c in chunks] == list(range(len(chunks)))
        starts = np.cumsum([0] + [c["rows"] for c in chunks])
        assert [c["start_row"] for c in chunks] == starts[:-1].tolist()
        assert int(starts[-1]) == sum(SIZES) and "event" not in chunks[0]
        assert len({c["features"].data_ptr() for c in chunks}) == len(chunks)
        for f in COLUMNS:
            np.testing.assert_array_equal(
                np.concatenate([c[f].numpy() for c in chunks]), _np(getattr(whole, f)),
                err_msg=f)

    @pytest.mark.parametrize("sparse", [False, True])
    def test_game_data_streamed_matches(self, part_files, sparse):
        sparse_shards = {"global"} if sparse else None
        a, vocabs_a, uids_a, pres_a = IngestSource(part_files).game_data(
            {"global": _vocab()}, ["userId"], sparse_shards=sparse_shards)
        src = IngestSource(part_files)
        b, vocabs_b, uids_b, pres_b = src.game_data_streamed(
            {"global": _vocab()}, ["userId"], sparse_shards=sparse_shards, chunk_mb=0.02)
        j, vocabs_j, uids_j, _ = JSource(part_files).game_data_streamed(
            {"global": _jvocab()}, ["userId"], sparse_shards=sparse_shards, chunk_mb=0.02)
        fa, fb, fj = (x.features["global"] for x in (a, b, j))
        if sparse:
            for field in ("indices", "values"):
                np.testing.assert_array_equal(_np(getattr(fb, field)),
                                              _np(getattr(fa, field)))
                np.testing.assert_array_equal(_np(getattr(fb, field)),
                                              _np(getattr(fj, field)))
        else:
            np.testing.assert_array_equal(_np(fb), _np(fa))
            np.testing.assert_array_equal(_np(fb), _np(fj))
        for f in ("labels", "offsets", "weights"):
            np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)))
            np.testing.assert_array_equal(_np(getattr(j, f)), _np(getattr(b, f)))
        np.testing.assert_array_equal(_np(a.entity_ids["userId"]), _np(b.entity_ids["userId"]))
        np.testing.assert_array_equal(_np(j.entity_ids["userId"]), _np(b.entity_ids["userId"]))
        assert vocabs_a == vocabs_b == vocabs_j
        assert list(uids_a) == list(uids_b) == list(uids_j)
        np.testing.assert_array_equal(pres_a, pres_b)
        assert src.codec == "native"

    def test_pipeline_metrics_and_stats(self, part_files):
        def run():
            with IngestPipeline(part_files, [_vocab()],
                                config=PipelineConfig(chunk_mb=0.02)) as pipe:
                pipe.labeled_batch(dtype=torch.float64)
                return pipe.stats.snapshot()

        stats, snap = _with_registry(run)
        assert stats["records"] == sum(SIZES)
        assert stats["chunks"] >= 2
        assert stats["bytes_to_device"] == sum(SIZES) * (D + 1 + 4) * 8
        assert stats["wall_s"] > 0 and 0.0 <= stats["overlap_frac"] <= 1.0
        assert snap["counters"]["ingest.pipeline.records"] == sum(SIZES)
        assert snap["counters"]["ingest.pipeline.chunks"] == stats["chunks"]
        assert snap["counters"]["ingest.pipeline.bytes_to_device"] == stats["bytes_to_device"]
        assert "ingest.pipeline.decode_ms" in snap["histograms"]
        assert "ingest.pipeline.transfer_ms" in snap["histograms"]

    def test_empty_input_raises(self, tmp_path):
        p = str(tmp_path / "empty.avro")
        write_avro_file(p, TRAINING_EXAMPLE_SCHEMA, [], codec="deflate")
        with IngestPipeline([p], [_vocab()]) as pipe:
            with pytest.raises(ValueError, match="no records"):
                pipe.labeled_batch(dtype=torch.float64)

    def test_null_label_policy(self, tmp_path):
        schema = dict(TRAINING_EXAMPLE_SCHEMA)
        schema["fields"] = [
            {"name": "label", "type": ["null", "double"], "default": None}
            if f["name"] == "label" else f
            for f in TRAINING_EXAMPLE_SCHEMA["fields"]
        ]
        recs = _records(20, seed=1)
        recs[7]["label"] = None
        p = str(tmp_path / "nulls.avro")
        write_avro_file(p, schema, recs, codec="deflate")
        with IngestPipeline([p], [_vocab()]) as pipe:
            with pytest.raises(ValueError, match="null/missing label"):
                pipe.labeled_batch(dtype=torch.float64)
        with IngestPipeline([p], [_vocab()], allow_null_labels=True) as pipe:
            batch, _, present = pipe.labeled_batch(dtype=torch.float64)
        assert batch.labels.shape == (20,) and not present[7] and present.sum() == 19
        with jpipe.IngestPipeline([p], [_jvocab()], allow_null_labels=True) as jp:
            jbatch, _, jpresent = jp.labeled_batch(dtype=jnp.float64)
        _assert_batches_equal(batch, jbatch)
        np.testing.assert_array_equal(present, jpresent)


class TestFaultInjection:
    def test_mid_stream_retry_no_dup_no_drop(self, part_files):
        """A transient decode failure mid-stream retries through the
        ``ingest.read`` seam: the batch is the same, no chunk duplicated and
        none dropped."""
        whole, uids_w, _ = IngestSource(part_files).labeled_batch(_vocab(), dtype=torch.float64)

        groups = len(plan_file_groups(part_files, 0.02))
        assert groups > 2

        def run():
            # the probes of ingest.read: each group's record count, then
            # each group's decode; the second decode is in mid-stream
            with inject(FaultSpec("ingest.read", "raise", nth=groups + 2)):
                with IngestPipeline(part_files, [_vocab()], config=PipelineConfig(
                        chunk_mb=0.02, decode_threads=2)) as pipe:
                    return pipe.labeled_batch(dtype=torch.float64)

        (batch, uids, _), snap = _with_registry(run)
        _assert_batches_equal(batch, whole)
        assert list(uids) == list(uids_w)
        assert snap["counters"]["resilience.faults_injected"] == 1

    @pytest.mark.parametrize("site", ["pipeline.decode", "pipeline.transfer"])
    def test_pipeline_sites_retry_without_dup_or_drop(self, part_files, site):
        whole, _, _ = IngestSource(part_files).labeled_batch(_vocab(), dtype=torch.float64)

        def run():
            with inject(FaultSpec(site, "raise", nth=2)):
                with IngestPipeline(part_files, [_vocab()], config=PipelineConfig(
                        chunk_mb=0.02, prefetch_depth=1)) as pipe:
                    out = pipe.labeled_batch(dtype=torch.float64)
                    return out, pipe.stats.snapshot()

        ((batch, _, _), stats), snap = _with_registry(run)
        _assert_batches_equal(batch, whole)
        assert snap["counters"]["resilience.faults_injected"] == 1
        assert stats["retries"] == (1 if site == "pipeline.transfer" else 0)

    def test_stalled_decode_is_abandoned_and_redone(self, part_files):
        """A decode attempt delayed past ``stage_timeout_s`` raises
        ``StageStall`` into the retry seam, and the batch is the same."""
        whole, _, _ = IngestSource(part_files).labeled_batch(_vocab(), dtype=torch.float64)

        def run():
            with inject(FaultSpec("pipeline.decode", "delay", nth=1, delay=1.0)):
                with IngestPipeline(part_files, [_vocab()], config=PipelineConfig(
                        chunk_mb=0.02, decode_threads=1, stage_timeout_s=0.3)) as pipe:
                    return pipe.labeled_batch(dtype=torch.float64)

        (batch, _, _), snap = _with_registry(run)
        _assert_batches_equal(batch, whole)
        assert snap["counters"]["ingest.pipeline.watchdog_stalls.decode"] == 1
        assert issubclass(StageStall, OSError)

    def test_exhausted_retries_propagate_and_release_handles(self, part_files):
        # past the record counts: the decodes open native readers and fail
        groups = len(plan_file_groups(part_files, 0.02))
        with inject(FaultSpec("ingest.read", "raise", nth=groups + 1, count=-1)):
            with IngestPipeline(part_files, [_vocab()], config=PipelineConfig(
                    chunk_mb=0.02, decode_threads=2)) as pipe:
                with pytest.raises(RetryBudgetExceeded):
                    pipe.labeled_batch(dtype=torch.float64)
        assert native.live_native_handles() == 0

    def test_skip_policy_drops_the_lost_group_only(self, part_files):
        """``epoch_policy="skip"``: the group whose retries exhaust is left
        out and counted; the rest is the one-shot read of the other files."""
        rest, _, _ = IngestSource(part_files[:1] + part_files[2:]).labeled_batch(
            _vocab(), dtype=torch.float64)

        def run():
            with inject(FaultSpec("pipeline.decode", "raise", nth=1, count=-1, key="1")):
                with IngestPipeline(part_files, [_vocab()], config=PipelineConfig(
                        chunk_mb=0.01, epoch_policy="skip")) as pipe:
                    out = pipe.labeled_batch(dtype=torch.float64)
                    return out, pipe.stats.snapshot()

        ((batch, uids, _), stats), snap = _with_registry(run)
        _assert_batches_equal(batch, rest)
        assert len(uids) == sum(SIZES) - SIZES[1]
        assert stats["groups_skipped"] == 1
        assert snap["counters"]["ingest.pipeline.groups_skipped"] == 1


    def test_stalled_transfer_is_abandoned_and_harmless(self, part_files):
        """A copy attempt delayed past ``stage_timeout_s`` raises
        ``StageStall`` into the transfer's retry; the abandoned attempt
        wakes after the batch is built and copies into tensors of its own,
        so the batch, checked again after it, is still the one-shot read."""
        whole, _, _ = IngestSource(part_files).labeled_batch(_vocab(), dtype=torch.float64)

        def run():
            with inject(FaultSpec("pipeline.transfer", "delay", nth=1, delay=1.0)):
                with IngestPipeline(part_files, [_vocab()], config=PipelineConfig(
                        chunk_mb=0.02, prefetch_depth=1, stage_timeout_s=0.3)) as pipe:
                    out = pipe.labeled_batch(dtype=torch.float64)
                    _assert_batches_equal(out[0], whole)
                    return out, pipe.stats.snapshot()

        ((batch, _, _), stats), snap = _with_registry(run)
        time.sleep(1.0)  # the stray has woken and copied by now
        _assert_batches_equal(batch, whole)
        assert snap["counters"]["ingest.pipeline.watchdog_stalls.transfer"] == 1
        assert stats["retries"] == 1

    def test_record_count_retries_through_the_read_seam(self, part_files):
        """The block headers are read through ``ingest.read``: a transient
        failure of the first count costs a retry, not the run."""
        whole, _, _ = IngestSource(part_files).labeled_batch(_vocab(), dtype=torch.float64)

        def run():
            with inject(FaultSpec("ingest.read", "raise", nth=1)):
                with IngestPipeline(part_files, [_vocab()],
                                    config=PipelineConfig(chunk_mb=0.01)) as pipe:
                    return pipe.labeled_batch(dtype=torch.float64)

        (batch, _, _), snap = _with_registry(run)
        _assert_batches_equal(batch, whole)
        assert snap["counters"]["resilience.faults_injected"] == 1

    @pytest.mark.parametrize("policy", ["skip", "fail"])
    def test_exhausted_record_count_follows_the_epoch_policy(self, part_files, policy):
        """The first file's count fails all four attempts: ``skip`` leaves
        its group out (the batch is the other files' one-shot read) and
        ``fail`` raises, with every native handle released."""
        rest, _, _ = IngestSource(part_files[1:]).labeled_batch(_vocab(), dtype=torch.float64)

        def run():
            with inject(FaultSpec("ingest.read", "raise", nth=1, count=4)):
                with IngestPipeline(part_files, [_vocab()], config=PipelineConfig(
                        chunk_mb=0.01, epoch_policy=policy)) as pipe:
                    assert pipe.groups[0] == part_files[:1]
                    if policy == "fail":
                        with pytest.raises(RetryBudgetExceeded):
                            pipe.labeled_batch(dtype=torch.float64)
                        return None, pipe.stats.snapshot()
                    return pipe.labeled_batch(dtype=torch.float64), pipe.stats.snapshot()

        (out, stats), snap = _with_registry(run)
        assert snap["counters"]["resilience.faults_injected"] == 4
        assert native.live_native_handles() == 0
        if policy == "fail":
            assert out is None and stats["groups_skipped"] == 0
            return
        batch, uids, _ = out
        _assert_batches_equal(batch, rest)
        assert len(uids) == sum(SIZES[1:])
        assert stats["groups_skipped"] == 1
        assert snap["counters"]["ingest.pipeline.groups_skipped"] == 1


class TestHandleCensus:
    def test_no_leaked_handles_across_entry_points(self, part_files):
        vocab = _vocab()
        assert native.live_native_handles() == 0
        src = IngestSource(part_files)
        src.build_vocab()
        src.labeled_batch(vocab)
        src.labeled_batch_streamed(vocab, chunk_mb=0.02)
        src.game_data_streamed({"global": vocab}, ["userId"])
        with IngestPipeline(part_files, [vocab], config=PipelineConfig(chunk_mb=0.02)) as pipe:
            for _ in pipe.parts():
                pass
            StreamedDesign.from_pipeline(pipe, rows_per_chunk=64)
        gc.collect()
        assert native.live_native_handles() == 0

    def test_context_managers(self, part_files):
        schema = native._read_header_schema(part_files[0])
        fp, fd = native.compile_schema(schema, label_field="label")
        with native.NativeVocabSet([], []) as vs:
            with native.NativeAvroReader(fp, fd, vs, ()) as reader:
                reader.feed_file(part_files[0])
                assert reader.num_records == SIZES[0]
                assert native.live_native_handles() == 2
            assert native.live_native_handles() == 1
        assert native.live_native_handles() == 0


def _dense_arrays(n=260, d=14, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    logits = 0.7 * x[:, 0] - 0.4 * x[:, 1]
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(float)
    w = rng.uniform(0.5, 2.0, size=n)
    off = rng.standard_normal(n) * 0.1
    return x, y, off, w


def _dense_batch(n=260, d=14, seed=0):
    x, y, off, w = _dense_arrays(n, d, seed)
    return LabeledBatch.create(x, y, offsets=off, weights=w, dtype=torch.float64)


def _jdense_batch(n=260, d=14, seed=0):
    x, y, off, w = _dense_arrays(n, d, seed)
    return JBatch.create(x, y, offsets=off, weights=w, dtype=jnp.float64)


def _config(optimizer="TRON", reg="L2", lambdas=(1.0, 0.1), **kw):
    return GLMTrainingConfig(
        task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType[optimizer],
        regularization=RegularizationContext(reg), reg_weights=lambdas, **kw)


def _jconfig(optimizer="TRON", reg="L2", lambdas=(1.0, 0.1), **kw):
    from photon_ml_tpu.models.glm import TaskType as JTask
    from photon_ml_tpu.models.training import GLMTrainingConfig as JConfig
    from photon_ml_tpu.models.training import OptimizerType as JOpt
    from photon_ml_tpu.ops.objective import RegularizationContext as JReg

    return JConfig(task=JTask.LOGISTIC_REGRESSION, optimizer=JOpt[optimizer],
                   regularization=JReg(reg), reg_weights=lambdas, **kw)


class TestOutOfCore:
    """Out-of-core epochs equal the in-core solve within 1e-10, with the
    same iterations, and the JAX package's."""

    @pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
    @pytest.mark.parametrize("rows_per_chunk", [64, 97])
    def test_matches_in_core(self, optimizer, rows_per_chunk):
        batch = _dense_batch()
        cfg = _config(optimizer, max_iters=80, tolerance=1e-12, compute_variances=True)
        incore = train_glm(batch, cfg)
        stats = PipelineStats()
        design = StreamedDesign.from_batch(batch, rows_per_chunk=rows_per_chunk)
        assert design.num_chunks == -(-260 // rows_per_chunk)
        streamed = train_glm_streamed(design, cfg, stats=stats)
        assert [m.reg_weight for m in streamed] == [1.0, 0.1]
        for a, b in zip(incore, streamed):
            assert b.result.iterations == a.result.iterations
            assert b.result.cg_iterations == a.result.cg_iterations
            for f in ("means", "variances"):
                np.testing.assert_allclose(
                    getattr(b.model.coefficients, f).numpy(),
                    getattr(a.model.coefficients, f).numpy(), atol=1e-10, rtol=0)
        assert stats.consume_s > 0 and stats.wall_s > 0

    @pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
    def test_matches_jax_out_of_core(self, optimizer):
        from photon_ml_tpu.models.training import train_glm_streamed as jtrain

        cfg = dict(max_iters=80, tolerance=1e-12, compute_variances=True)
        got = train_glm_streamed(StreamedDesign.from_batch(_dense_batch(), 97),
                                 _config(optimizer, **cfg))
        ref = jtrain(jpipe.StreamedDesign.from_batch(_jdense_batch(), 97),
                     _jconfig(optimizer, **cfg))
        for a, b in zip(ref, got):
            assert b.reg_weight == a.reg_weight
            assert b.result.iterations == int(a.result.iterations)
            for f in ("means", "variances"):
                want = np.asarray(getattr(a.model.coefficients, f))
                np.testing.assert_allclose(getattr(b.model.coefficients, f).numpy(), want,
                                           atol=1e-8 * max(1.0, np.abs(want).max()), rtol=0)

    def test_owlqn_l1_matches(self):
        batch = _dense_batch(seed=3)
        cfg = _config("LBFGS", "L1", (0.3,), max_iters=100, tolerance=1e-12)
        (a,) = train_glm(batch, cfg)
        (b,) = train_glm_streamed(StreamedDesign.from_batch(batch, rows_per_chunk=80), cfg)
        assert b.result.iterations == a.result.iterations
        np.testing.assert_allclose(b.model.coefficients.means.numpy(),
                                   a.model.coefficients.means.numpy(), atol=1e-10, rtol=0)
        assert (b.model.coefficients.means == 0).sum() == (a.model.coefficients.means == 0).sum()

    def test_streaming_objective_matches_jax(self):
        """Value, gradient, Hessian-vector product and diagonal against the
        JAX streaming objective and the in-core objective, 1e-12 in f64."""
        from photon_ml_tpu.models.glm import TaskType as JTask
        from photon_ml_tpu.ops.losses import loss_for_task as jloss_for_task

        batch = _dense_batch(seed=5)
        loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
        stats = PipelineStats()
        sobj = StreamingObjective(StreamedDesign.from_batch(batch, rows_per_chunk=50),
                                  loss, l2_weight=0.7, stats=stats)
        jobj = jpipe.StreamingObjective(
            jpipe.StreamedDesign.from_batch(_jdense_batch(seed=5), rows_per_chunk=50),
            jloss_for_task(JTask.LOGISTIC_REGRESSION), l2_weight=0.7)
        obj = GLMObjective(loss=loss, l2_weight=0.7)
        rng = np.random.default_rng(0)
        w_np, v_np = rng.standard_normal(14), rng.standard_normal(14)
        w, v = torch.from_numpy(w_np), torch.from_numpy(v_np)
        val_s, grad_s = sobj.value_and_grad(w)
        val_j, grad_j = jobj.value_and_grad(jnp.asarray(w_np))
        val_i, grad_i = obj.value_and_grad(w, batch)
        for val in (val_j, val_i):
            np.testing.assert_allclose(float(val_s), float(val), rtol=1e-12)
        for grad in (grad_j, grad_i):
            np.testing.assert_allclose(grad_s.numpy(), _np(grad), atol=1e-12, rtol=0)
        hv_s = sobj.hessian_vector(w, v)
        for hv in (jobj.hessian_vector(jnp.asarray(w_np), jnp.asarray(v_np)),
                   obj.hessian_vector(w, v, batch)):
            np.testing.assert_allclose(hv_s.numpy(), _np(hv), atol=1e-12, rtol=0)
        diag_s = sobj.hessian_diagonal(w)
        for diag in (jobj.hessian_diagonal(w_np), obj.hessian_diagonal(w, batch)):
            np.testing.assert_allclose(diag_s.numpy(), _np(diag), atol=1e-12, rtol=0)
        # three sweeps, one per evaluation, each over all six chunks
        assert len(stats._intervals) == 3 * 6 and stats.wall_s > 0

    def test_sweep_metrics(self):
        batch = _dense_batch(n=100)
        sobj = StreamingObjective(StreamedDesign.from_batch(batch, 40),
                                  loss_for_task(TaskType.LOGISTIC_REGRESSION), l2_weight=1.0)
        w = torch.zeros(14, dtype=torch.float64)
        _, snap = _with_registry(lambda: (sobj.value_and_grad(w), sobj.hessian_vector(w, w)))
        assert snap["counters"]["ingest.oocore.sweeps"] == 2
        assert snap["counters"]["ingest.oocore.sweeps.value_and_grad"] == 1
        assert snap["counters"]["ingest.oocore.sweeps.hessian_vector"] == 1
        assert "ingest.oocore.sweep_ms" in snap["histograms"]

    def test_warm_start_and_order(self):
        design = StreamedDesign.from_batch(_dense_batch(seed=7), rows_per_chunk=90)
        cfg = _config("LBFGS", lambdas=(0.1, 10.0), max_iters=60, tolerance=1e-10)
        models = train_glm_streamed(design, cfg)
        assert [m.reg_weight for m in models] == [0.1, 10.0]
        warm = train_glm_streamed(design, cfg, initial_coefficients=Coefficients(
            means=models[0].model.coefficients.means))
        assert len(warm) == 2
        # started at its own optimum, the smallest lambda's solve ends at once
        assert warm[1].result.iterations < models[1].result.iterations

    def test_rejects_unsupported_configs(self):
        from photon_ml_tpu_torch.core.normalization import NormalizationType

        design = StreamedDesign.from_batch(_dense_batch(n=60), rows_per_chunk=30)
        with pytest.raises(ValueError, match="normalization"):
            train_glm_streamed(design, GLMTrainingConfig(
                task=TaskType.LOGISTIC_REGRESSION,
                normalization=NormalizationType.SCALE_WITH_STANDARD_DEVIATION))
        with pytest.raises(ValueError, match="NEWTON"):
            train_glm_streamed(design, _config("NEWTON"))
        with pytest.raises(ValueError, match="dense"):
            from photon_ml_tpu_torch.ops.sparse import from_coo

            x = from_coo(np.arange(4), np.arange(4), np.ones(4), 4, 4, dtype=torch.float64)
            StreamedDesign.from_batch(LabeledBatch.create(x, np.zeros(4)), 2)

    @pytest.mark.parametrize("rows_per_chunk", [128, None])
    def test_from_pipeline_matches_from_batch_and_jax(self, part_files, rows_per_chunk):
        whole, _, _ = IngestSource(part_files).labeled_batch(_vocab(), dtype=torch.float64)
        cfg = dict(chunk_mb=0.02)
        with IngestPipeline(part_files, [_vocab()], config=PipelineConfig(**cfg)) as pipe:
            design = StreamedDesign.from_pipeline(pipe, dtype=torch.float64,
                                                  rows_per_chunk=rows_per_chunk)
        rpc = rows_per_chunk or rows_per_chunk_for(0.02, D + 1)
        assert design.rows_per_chunk == rpc and design.pin_s == 0.0
        oracle = StreamedDesign.from_batch(whole, rows_per_chunk=rpc)
        with jpipe.IngestPipeline(part_files, [_jvocab()],
                                  config=jpipe.PipelineConfig(**cfg)) as jp:
            jdesign = jpipe.StreamedDesign.from_pipeline(jp, dtype=np.float64,
                                                         rows_per_chunk=rows_per_chunk)
        assert design.n == oracle.n == jdesign.n == sum(SIZES)
        assert design.num_chunks == oracle.num_chunks == jdesign.num_chunks
        assert design.bytes_per_epoch == jdesign.bytes_per_epoch
        for a, b, j in zip(design.chunks, oracle.chunks, jdesign.chunks):
            for k in COLUMNS:
                np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
                np.testing.assert_array_equal(a[k].numpy(), j[k])


class TestGlmDriverOutOfCore:
    def test_driver_out_of_core_matches_in_core(self, tmp_path):
        """The out-of-core driver trains the in-core driver's model and
        reports the pipeline's and the sweeps' numbers."""
        from photon_ml_tpu_torch.cli.train import run_glm_training

        data = str(tmp_path / "train.avro")
        write_avro_file(data, TRAINING_EXAMPLE_SCHEMA, _records(240, seed=21), codec="deflate")
        base = dict(train_input=[data], task="LOGISTIC_REGRESSION", optimizer="LBFGS",
                    reg_type="L2", reg_weights=[1.0], max_iters=60, tolerance=1e-10,
                    log_level="WARN")
        run_a = run_glm_training(dict(base, output_dir=str(tmp_path / "incore")),
                                 device="cpu")
        run_b = run_glm_training(dict(base, output_dir=str(tmp_path / "oocore"),
                                      out_of_core=True, ingest_chunk_mb=0.02), device="cpu")
        assert run_b.num_training_rows == run_a.num_training_rows == 240
        assert run_b.models[0].result.iterations == run_a.models[0].result.iterations
        np.testing.assert_allclose(run_b.models[0].model.coefficients.means.numpy(),
                                   run_a.models[0].model.coefficients.means.numpy(),
                                   atol=1e-10, rtol=0)
        assert run_b.summary is None and run_b.codecs == {"ingest": "native"}
        assert not (tmp_path / "oocore" / "feature-summary.tsv").exists()
        chunks = -(-240 // rows_per_chunk_for(0.02, D + 1))
        assert run_b.timings["pipeline_chunks"] == chunks
        assert run_b.timings["bytes_per_epoch"] == chunks * rows_per_chunk_for(
            0.02, D + 1) * (D + 1 + 4) * 8
        assert run_b.timings["oocore_bytes"] == 0.0  # on the CPU nothing is copied
        for key in ("pipeline_decode", "pipeline_transfer", "pipeline_stall",
                    "pipeline_overlap_frac", "oocore_consume", "pin"):
            assert key in run_b.timings

    @pytest.mark.parametrize("field,value,match", [
        ("sparse", True, "out_of_core streams dense"),
        ("streamed_ingest", True, "subsumes streamed_ingest"),
        ("normalization", "STANDARDIZATION", "normalization NONE"),
        ("optimizer", "NEWTON", "NEWTON materializes"),
        ("mesh_shape", {"data": 2}, "single-device"),
        ("diagnostics", True, "in-core"),
        ("validate_per_iteration", True, "in-core"),
    ])
    def test_out_of_core_refusals_carry_the_jax_messages(self, tmp_path, field, value, match):
        from photon_ml_tpu.cli.config import GLMDriverParams as JParams
        from photon_ml_tpu_torch.cli.config import GLMDriverParams

        kw = dict(train_input=["x"], output_dir=str(tmp_path / "o"), out_of_core=True,
                  validate_input=["v"], **{field: value})
        for cls in (GLMDriverParams, JParams):
            with pytest.raises(ValueError, match=match):
                cls(**kw).validate()

    def test_streamed_sparse_is_refused_as_in_jax(self, tmp_path):
        from photon_ml_tpu_torch.cli.train import run_glm_training

        data = str(tmp_path / "train.avro")
        write_avro_file(data, TRAINING_EXAMPLE_SCHEMA, _records(30, seed=2))
        with pytest.raises(ValueError, match="streamed_ingest is dense-only"):
            run_glm_training(dict(train_input=[data], output_dir=str(tmp_path / "o"),
                                  streamed_ingest=True, sparse=True), device="cpu")

    def test_cli_flags(self, tmp_path):
        from photon_ml_tpu_torch.cli.train import build_arg_parser

        args = build_arg_parser().parse_args([
            "--out-of-core", "--streamed-ingest", "--ingest-chunk-mb", "8",
            "--decode-threads", "3", "--prefetch-depth", "4", "--stage-timeout-s", "2.5",
            "--epoch-policy", "skip"])
        assert (args.out_of_core, args.streamed_ingest, args.ingest_chunk_mb,
                args.decode_threads, args.prefetch_depth, args.stage_timeout_s,
                args.epoch_policy) == (True, True, 8.0, 3, 4, 2.5, "skip")


def test_game_cli_flags_reach_the_params(tmp_path, monkeypatch):
    """``cli.game_train``'s ingest flags land in the params as the JAX
    driver's do."""
    import json

    from photon_ml_tpu_torch.cli import game_train as tgame

    cfg = tmp_path / "g.json"
    cfg.write_text(json.dumps({"train_input": ["x"], "output_dir": "y"}))
    seen = {}
    monkeypatch.setattr(tgame, "run_game_training",
                        lambda params, device=None: seen.update(params, device=device))
    tgame.main(["--config", str(cfg), "--device", "cpu", "--streamed-ingest",
                "--ingest-chunk-mb", "8", "--decode-threads", "3", "--prefetch-depth", "4",
                "--stage-timeout-s", "2.5", "--epoch-policy", "skip"])
    assert {k: seen[k] for k in ("streamed_ingest", "ingest_chunk_mb", "decode_threads",
                                 "prefetch_depth", "stage_timeout_s", "epoch_policy",
                                 "device")} == {
        "streamed_ingest": True, "ingest_chunk_mb": 8.0, "decode_threads": 3,
        "prefetch_depth": 4, "stage_timeout_s": 2.5, "epoch_policy": "skip", "device": "cpu"}
