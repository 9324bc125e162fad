"""Feature vocabularies: (name, term) -> dense column index.

Rebuild of the reference's index-map stack: ``util/IndexMap.scala:25-47``,
``util/DefaultIndexMap.scala``, the off-heap ``util/PalDBIndexMap.scala:43-212``
and its builder job ``FeatureIndexingJob.scala:48-160``, plus the GAME-side
``avro/data/NameAndTermFeatureSetContainer.scala:38-253``.

The PalDB off-heap store exists because JVM executors could not hold >200k
string keys per task; here the vocabulary is built once on the host, used to
index during ingest, and persisted as plain text — on device only dense
column indices exist, so there is no runtime analog to replace (documented
drop per SURVEY §2.4).

A copy of ``photon_ml_tpu/io/vocab.py``: the ``feature-index.txt`` format is shared.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

from photon_ml_tpu_torch.io.schemas import (
    INTERCEPT_NAME,
    NAME_TERM_DELIMITER,
)

INTERCEPT_KEY = f"{INTERCEPT_NAME}{NAME_TERM_DELIMITER}"


def feature_key(name: str, term: str) -> str:
    """``Utils.getFeatureKey``: name + \\x01 + term."""
    return f"{name}{NAME_TERM_DELIMITER}{term}"


class FeatureVocabulary:
    """Bidirectional (name,term)-key <-> index map with optional intercept."""

    def __init__(self, keys: List[str], add_intercept: bool = False):
        if add_intercept and INTERCEPT_KEY not in keys:
            keys = list(keys) + [INTERCEPT_KEY]
        self.key_to_index: Dict[str, int] = {
            k: i for i, k in enumerate(keys)
        }
        if len(self.key_to_index) != len(keys):
            raise ValueError("duplicate feature keys in vocabulary")
        self.index_to_key: List[str] = list(keys)

    def __len__(self) -> int:
        return len(self.index_to_key)

    def get(self, name: str, term: str = "") -> Optional[int]:
        return self.key_to_index.get(feature_key(name, term))

    @property
    def intercept_index(self) -> Optional[int]:
        return self.key_to_index.get(INTERCEPT_KEY)

    @staticmethod
    def from_records(
        records: Iterable[dict],
        add_intercept: bool = True,
        selected_keys: Optional[set] = None,
    ) -> "FeatureVocabulary":
        """Scan TrainingExampleAvro-shaped records for distinct (name, term)
        pairs (the ``FeatureIndexingJob`` / ``DefaultIndexMap`` path), with
        the optional selected-features filter of ``GLMSuite.scala:96-150``."""
        seen: Dict[str, None] = {}
        for rec in records:
            for f in rec["features"]:
                k = feature_key(f["name"], f["term"])
                if selected_keys is None or k in selected_keys:
                    seen.setdefault(k, None)
        return FeatureVocabulary(sorted(seen), add_intercept=add_intercept)

    # -- persistence (text, one key per line; \x01 survives utf-8, embedded
    # newlines/backslashes are escaped so indices never shift on reload) ----

    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for k in self.index_to_key:
                f.write(
                    k.replace("\\", "\\\\").replace("\n", "\\n") + "\n"
                )

    @staticmethod
    def load(path: str) -> "FeatureVocabulary":
        def unescape(s: str) -> str:
            out, i = [], 0
            while i < len(s):
                if s[i] == "\\" and i + 1 < len(s):
                    out.append("\n" if s[i + 1] == "n" else s[i + 1])
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            return "".join(out)

        with open(path, encoding="utf-8") as f:
            keys = [
                unescape(line.rstrip("\n")) for line in f if line.rstrip("\n")
            ]
        return FeatureVocabulary(keys)

    def name_term(self, index: int) -> Tuple[str, str]:
        name, _, term = self.index_to_key[index].partition(
            NAME_TERM_DELIMITER
        )
        return name, term
