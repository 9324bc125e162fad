"""Standalone feature-indexing job: Avro inputs -> feature vocabulary files
(counterpart of ``photon_ml_tpu/cli/build_index.py``).

Rebuild of the reference's ``FeatureIndexingJob.scala:48-160`` (a separate
Spark job that scans training data for distinct (name, term) keys and
writes the off-heap PalDB index the drivers then load) and the
``NameAndTermFeatureSetContainer`` main. It writes plain text vocabularies
(one key per line, ``io/vocab.py`` format) that the GLM driver consumes via
``feature_file`` and the GAME driver via ``feature_shards``. The scan is the
native parallel distinct-key pass of :mod:`photon_ml_tpu_torch.io.native`
(``IngestSource.build_vocab``); it runs on the host only.

    python -m photon_ml_tpu_torch.cli.build_index \\
        --input data/train --output-dir out \\
        --shard global --add-intercept

Run once per shard definition (a shard = a feature bag; rerun with a
different ``--name-prefix`` filter to build partitioned bags).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from photon_ml_tpu_torch.io.ingest import IngestSource
from photon_ml_tpu_torch.io.schemas import NAME_TERM_DELIMITER
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary


def build_index(
    inputs: List[str],
    output_dir: str,
    shard: Optional[str] = None,
    add_intercept: bool = False,
    name_prefix: Optional[str] = None,
    field_names: str = "TRAINING_EXAMPLE",
) -> str:
    """Scan inputs for distinct feature keys and write the vocabulary.

    ``name_prefix`` keeps only features whose NAME starts with the prefix
    — the lightweight analog of the reference's per-section feature bags
    (``NameAndTermFeatureSetContainer``): partition a shared namespace
    into shards without a section-key schema.

    Returns the written file path: ``feature-index.txt`` (GLM layout) or
    ``feature-index-<shard>.txt`` (GAME shard layout)."""
    source = IngestSource(inputs, field_names)
    vocab = source.build_vocab(add_intercept=add_intercept)
    if name_prefix is not None:
        # ONE scan; the prefix filter is a host-side key filter
        kept = [
            k
            for k in vocab.index_to_key
            if k.split(NAME_TERM_DELIMITER)[0].startswith(name_prefix)
        ]
        vocab = FeatureVocabulary(kept, add_intercept=add_intercept)
    os.makedirs(output_dir, exist_ok=True)
    fname = f"feature-index-{shard}.txt" if shard else "feature-index.txt"
    path = os.path.join(output_dir, fname)
    vocab.save(path)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.build_index",
        description="Build feature vocabulary files from Avro training "
        "data (the FeatureIndexingJob analog).",
    )
    p.add_argument("--input", nargs="+", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument(
        "--shard",
        help="write feature-index-<shard>.txt (GAME layout); omit for "
        "the GLM feature-index.txt",
    )
    p.add_argument("--add-intercept", action="store_true")
    p.add_argument(
        "--name-prefix",
        help="keep only features whose name starts with this prefix "
        "(partitioned feature bags)",
    )
    p.add_argument("--field-names", default="TRAINING_EXAMPLE")
    args = p.parse_args(argv)
    path = build_index(
        args.input,
        args.output_dir,
        shard=args.shard,
        add_intercept=args.add_intercept,
        name_prefix=args.name_prefix,
        field_names=args.field_names,
    )
    print(path)


if __name__ == "__main__":
    main()
