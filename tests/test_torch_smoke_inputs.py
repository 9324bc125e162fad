"""``chip_smoke.py``'s input writers: the records that its worker processes
encode and write decode to the records that ``encode_examples`` writes when
called directly in this process, record for record, for each writer: GLM
scoring and training, GAME scoring, and GAME training with and without the
wide shard and the ads."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from photon_ml_tpu_torch.io.avro import read_avro_file  # noqa: E402

D_HASHED = 1 << 16


def _write_all(root):
    """Each writer at a small depth under ``root``; returns the data files."""
    _, data, _, _, _ = cs.write_scoring_inputs(os.path.join(root, "score"), 60, D_HASHED)
    _, game, _, _ = cs.write_game_inputs(os.path.join(root, "game"), 60, D_HASHED, 8, 300, 4)
    _, plain, _ = cs.write_game_training_inputs(os.path.join(root, "gt"), 60, 20, D_HASHED, 8)
    _, wide, _ = cs.write_game_training_inputs(os.path.join(root, "gp"), 60, 20, D_HASHED, 8,
                                               user_cols=300, n_ads=4)
    _, _, sets = cs.write_training_inputs(os.path.join(root, "train"), 60, 20, D_HASHED)
    return [data, game, *plain, *wide, sets["train"][0], sets["heldout"][0]]


@pytest.fixture
def writers():
    cs.start_writers(2)
    try:
        yield
    finally:
        cs.stop_writers()


def test_worker_written_records_equal_main_process_records(tmp_path, writers, monkeypatch):
    ahead = _write_all(str(tmp_path / "workers"))
    assert sorted(cs._written) == sorted(ahead)
    assert cs.wait_written(*ahead) >= 0.0 and not cs._written
    # the same draws, encoded here
    monkeypatch.setattr(cs, "write_examples_file", cs.encode_examples)
    here = _write_all(str(tmp_path / "main"))
    assert not cs._written
    for a, b in zip(ahead, here, strict=True):
        assert os.path.relpath(a, tmp_path / "workers") == os.path.relpath(b, tmp_path / "main")
        got, want = read_avro_file(a)[1], read_avro_file(b)[1]
        assert len(got) == len(want) > 0 and got == want, a


def test_a_worker_error_raises_where_the_phase_waits(tmp_path, writers):
    path = str(tmp_path / "bad.avro")
    # a block whose ids and values disagree in length fails in the worker
    cs.write_examples_file(path, "x", np.zeros(2), np.zeros(2),
                           [("h", np.zeros((2, 3), np.int64), np.zeros((1, 3)))])
    with pytest.raises(IndexError):
        cs.wait_written(path)


def test_the_pool_starts_at_the_first_write_at_the_lowest_priority(tmp_path):
    cs.stop_writers()
    try:
        labels = np.zeros(2)
        path = str(tmp_path / "one.avro")
        cs.write_examples_file(path, "x", labels, labels,
                               [("h", np.zeros((2, 1), np.int64), np.ones((2, 1)))])
        assert cs._writers is not None and path in cs._written
        cs.wait_written(path)
        assert len(read_avro_file(path)[1]) == 2
        assert cs._writers.submit(os.nice, 0).result() == 19
    finally:
        cs.stop_writers()
    assert cs._writers is None and not cs._written
