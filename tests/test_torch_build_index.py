"""The port's feature-indexing job against the JAX package's, on the CPU:
``io.native.scan_feature_keys`` (the native distinct-key scan over 1 and 3
files, in parallel), ``IngestSource.build_vocab`` (the native scan, its
``selected_keys`` filter, the empty-input refusal, and the Python codec
only where the native reader refuses the schema) and ``cli.build_index``
(its files byte for byte, in the GLM layout, the GAME shard layout and
with ``--name-prefix``; its CLI). Inputs are Avro files written from a
numpy seed with non-ASCII names and terms, duplicate keys within a record
and keys holding the escaped characters of the vocabulary format."""

import os
import subprocess
import sys

import numpy as np
import pytest

from photon_ml_tpu.cli.build_index import build_index as jax_build_index
from photon_ml_tpu.io import native as jax_native
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.ingest import IngestSource as JaxSource
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.cli import build_index as port_cli
from photon_ml_tpu_torch.io import native as port_native
from photon_ml_tpu_torch.io.ingest import IngestSource
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["age", "ctr", "naïve", "géo\\x", "multi\nline", "a"]


def _records(rng, n):
    recs = []
    for i in range(n):
        feats = []
        for _ in range(int(rng.integers(0, 6))):
            name = NAMES[int(rng.integers(0, len(NAMES)))]
            term = ["", "t", "ü", str(int(rng.integers(0, 50)))][int(rng.integers(0, 4))]
            feats.append({"name": name, "term": term, "value": float(rng.normal())})
        if feats and i % 4 == 0:
            feats.append(dict(feats[0]))  # a duplicate key in one record
        recs.append({"uid": f"r{i}", "label": float(i % 2), "features": feats,
                     "metadataMap": None, "weight": None, "offset": None})
    return recs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_build_index")
    rng = np.random.default_rng(20261018)
    paths = []
    for part in range(3):
        path = str(tmp / "data" / f"part-{part}.avro")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_avro_file(path, TRAINING_EXAMPLE_SCHEMA, _records(rng, 150 + 40 * part))
        paths.append(path)
    empty = str(tmp / "empty.avro")
    write_avro_file(empty, TRAINING_EXAMPLE_SCHEMA, [])
    return {"paths": paths, "empty": empty, "tmp": tmp}


@pytest.mark.parametrize("count", [1, 3])
def test_scan_feature_keys_equals_jax(files, count):
    paths = files["paths"][:count]
    keys, n = port_native.scan_feature_keys(paths)
    want_keys, want_n = jax_native.scan_feature_keys(paths)
    assert sorted(keys) == sorted(want_keys) and len(keys) == len(set(keys))
    assert n == want_n == sum(150 + 40 * p for p in range(count))
    assert sorted(keys) == IngestSource(paths).build_vocab(add_intercept=False).index_to_key
    records = [r for p in paths for r in JaxSource([p]).records()]
    assert sorted(keys) == FeatureVocabulary.from_records(records, add_intercept=False
                                                          ).index_to_key


def test_empty_inputs_raise_as_in_jax(files):
    for scan in (port_native.scan_feature_keys, jax_native.scan_feature_keys):
        with pytest.raises(FileNotFoundError, match="no input files"):
            scan([])
    assert port_native.scan_feature_keys([files["empty"]]) == ([], 0)
    assert jax_native.scan_feature_keys([files["empty"]]) == ([], 0)
    for source in (IngestSource, JaxSource):
        with pytest.raises(ValueError, match="no records found"):
            source([files["empty"]]).build_vocab()


@pytest.mark.parametrize("add_intercept", [True, False])
def test_build_vocab_equals_jax(files, add_intercept):
    source = IngestSource(files["paths"])
    vocab = source.build_vocab(add_intercept=add_intercept)
    assert source.codec == "native"
    want = JaxSource(files["paths"]).build_vocab(add_intercept=add_intercept)
    assert vocab.index_to_key == want.index_to_key
    assert vocab.intercept_index == want.intercept_index
    selected = set(want.index_to_key[::3])
    assert (IngestSource(files["paths"]).build_vocab(selected_keys=selected).index_to_key
            == JaxSource(files["paths"]).build_vocab(selected_keys=selected).index_to_key)


def test_build_vocab_falls_back_only_on_unsupported_schema(files, monkeypatch):
    """The Python codec's records where the native reader refuses the
    schema (as in JAX); any other failure of the native scan propagates."""
    want = JaxSource(files["paths"]).build_vocab().index_to_key

    def refuse(*a, **k):
        raise port_native.UnsupportedSchema("refused")

    monkeypatch.setattr(port_native, "scan_feature_keys", refuse)
    source = IngestSource(files["paths"])
    assert source.build_vocab().index_to_key == want
    assert source.codec == "python"

    def broken(*a, **k):
        raise RuntimeError("native build failed")

    monkeypatch.setattr(port_native, "scan_feature_keys", broken)
    with pytest.raises(RuntimeError, match="native build failed"):
        IngestSource(files["paths"]).build_vocab()


LAYOUTS = {
    "glm": {},
    "glm-intercept": {"add_intercept": True},
    "shard": {"shard": "global", "add_intercept": True},
    "name-prefix": {"shard": "n", "name_prefix": "n"},
    "name-prefix-none": {"shard": "z", "name_prefix": "zzz", "add_intercept": True},
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_build_index_files_equal_jax(files, tmp_path, layout):
    kw = LAYOUTS[layout]
    got = port_cli.build_index(files["paths"], str(tmp_path / "port"), **kw)
    want = jax_build_index(files["paths"], str(tmp_path / "jax"), **kw)
    assert os.path.basename(got) == os.path.basename(want)
    assert os.path.basename(got) == (f"feature-index-{kw['shard']}.txt" if "shard" in kw
                                     else "feature-index.txt")
    with open(got, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()
    assert FeatureVocabulary.load(got).index_to_key == FeatureVocabulary.load(
        want).index_to_key


def test_build_index_cli(files, tmp_path, capsys):
    """``main`` takes the JAX flags and prints the path; ``python -m``
    writes the same file from a directory input."""
    port_cli.main(["--input", *files["paths"], "--output-dir", str(tmp_path / "a"),
                   "--shard", "n", "--name-prefix", "n", "--add-intercept"])
    path = capsys.readouterr().out.strip()
    assert path == str(tmp_path / "a" / "feature-index-n.txt")
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.build_index", "--input",
         os.path.dirname(files["paths"][0]), "--output-dir", str(tmp_path / "b")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip()
    want = jax_build_index(files["paths"], str(tmp_path / "c"))
    with open(out, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()
