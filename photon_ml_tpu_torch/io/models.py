"""Model persistence, wire-compatible with the reference and with
``photon_ml_tpu/io/models.py``.

GLM models: one BayesianLinearModelAvro record holding means and optional
variances as (name, term, value) triples (``avro/AvroUtils.scala:53-225``).

GAME models: the reference's directory layout
(``ModelProcessingUtils.scala:39-86``)::

    <root>/fixed-effect/<coordinate>/{id-info, coefficients/part-00000.avro}
    <root>/random-effect/<coordinate>/{id-info, coefficients/part-00000.avro}
    <root>/factored-random-effect/<coordinate>/{id-info,
        latent-factors.avro, projection.avro}

fixed-effect coefficients hold ONE record; random-effect files hold one
record per entity with modelId = the raw entity key. id-info records the
feature-shard id (and random-effect type for RE coordinates). A model
saved by either package loads in the other. Not ported yet: the collapse
of coordinates and the matrix-factorization model files (GAME training).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.tasks import TaskType
from photon_ml_tpu_torch.core.types import Coefficients
from photon_ml_tpu_torch.game.factored import FactoredParams, is_factored_params
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.schemas import (
    BAYESIAN_LINEAR_MODEL_SCHEMA,
    LATENT_FACTOR_SCHEMA,
)
from photon_ml_tpu_torch.io.vocab import FeatureVocabulary
from photon_ml_tpu_torch.utils.device import to_numpy

# reference loss-function class names (BayesianLinearModelAvro.lossFunction)
_LOSS_CLASS = {
    TaskType.LOGISTIC_REGRESSION: "com.linkedin.photon.ml.function.LogisticLossFunction",
    TaskType.LINEAR_REGRESSION: "com.linkedin.photon.ml.function.SquaredLossFunction",
    TaskType.POISSON_REGRESSION: "com.linkedin.photon.ml.function.PoissonLossFunction",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: "com.linkedin.photon.ml.function.SmoothedHingeLossFunction",
}
_CLASS_LOSS = {v: k for k, v in _LOSS_CLASS.items()}


def _coefficients_to_record(
    model_id: str,
    means: np.ndarray,
    variances: Optional[np.ndarray],
    vocab: FeatureVocabulary,
    task: Optional[TaskType],
    sparsify: bool = True,
) -> dict:
    def triples(vec):
        # the JAX package's loop over every entry, skipping zeros but the
        # intercept, done by one nonzero pass (wide random-effect tables
        # hold few nonzeros in each row)
        vec = np.asarray(vec)
        keep = vec != 0.0 if sparsify else np.ones(vec.shape, bool)
        icpt = vocab.intercept_index
        if icpt is not None and icpt < vec.shape[0]:
            keep[icpt] = True
        out = []
        for i in np.flatnonzero(keep).tolist():
            name, term = vocab.name_term(i)
            out.append({"name": name, "term": term, "value": float(vec[i])})
        return out

    return {
        "modelId": model_id,
        "means": triples(means),
        "variances": None if variances is None else triples(variances),
        "lossFunction": _LOSS_CLASS.get(task) if task else None,
    }


def _record_to_coefficients(
    rec: dict, vocab: FeatureVocabulary
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    d = len(vocab)
    means = np.zeros(d)
    for t in rec["means"]:
        idx = vocab.get(t["name"], t["term"])
        if idx is not None:
            means[idx] = t["value"]
    variances = None
    if rec.get("variances"):
        variances = np.zeros(d)
        for t in rec["variances"]:
            idx = vocab.get(t["name"], t["term"])
            if idx is not None:
                variances[idx] = t["value"]
    return means, variances


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def save_glm_model(
    path: str,
    coefficients: Coefficients,
    vocab: FeatureVocabulary,
    task: Optional[TaskType] = None,
    model_id: str = "",
):
    variances = (
        None if coefficients.variances is None else _host_numpy(coefficients.variances)
    )
    write_avro_file(
        path,
        BAYESIAN_LINEAR_MODEL_SCHEMA,
        [
            _coefficients_to_record(
                model_id, _host_numpy(coefficients.means), variances, vocab, task
            )
        ],
    )


def load_glm_model(
    path: str, vocab: FeatureVocabulary, device="cpu"
) -> Tuple[Coefficients, Optional[TaskType]]:
    """-> (float64 Coefficients on ``device``, task named by the file)."""
    _, records = read_avro_file(path)
    if len(records) != 1:
        raise ValueError(f"{path}: expected 1 model record, got {len(records)}")
    means, variances = _record_to_coefficients(records[0], vocab)
    task = _CLASS_LOSS.get(records[0].get("lossFunction"))
    device = torch.device(device)
    return (
        Coefficients(
            means=torch.from_numpy(means).to(device),
            variances=None if variances is None else torch.from_numpy(variances).to(device),
        ),
        task,
    )


# ---------------------------------------------------------------------------
# Model-export integrity manifests (the serving hot-reload gate)
# ---------------------------------------------------------------------------

MODEL_MANIFEST = "model-manifest.json"


class ModelIntegrityError(Exception):
    """A model export failed sha256 manifest verification: partially
    written, tampered with, or missing its manifest entirely."""


_MODEL_KINDS = ("fixed-effect", "random-effect", "factored-random-effect")


def sha256_file(path: str) -> str:
    """Streaming sha256 of a file."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_files(root: str) -> List[str]:
    """Model-BEARING files under an export root: coordinate directories
    (at any nesting: ``best/``, ``all/<i>/``), feature-index vocabularies,
    and model-spec.json. Volatile run artifacts riding along in a training
    output dir (logs, checkpoints, metrics) are outside the integrity
    boundary: they keep changing after the export is sealed."""
    out = []
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name == MODEL_MANIFEST:
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            parts = rel.split(os.sep)
            if (
                any(p in _MODEL_KINDS for p in parts[:-1])
                or (name.startswith("feature-index-") and name.endswith(".txt"))
                or name == "model-spec.json"
            ):
                out.append(rel)
    return sorted(out)


def write_model_manifest(root: str) -> str:
    """Record a sha256 digest per model-bearing file of an export in
    ``<root>/model-manifest.json``, written atomically. A serving registry
    refuses an export whose digests do not verify."""
    digests = {
        rel: sha256_file(os.path.join(root, rel)) for rel in _manifest_files(root)
    }
    if not digests:
        raise ValueError(
            f"{root}: no model files to manifest (an empty manifest would "
            "verify vacuously and defeat the serving integrity gate)"
        )
    path = os.path.join(root, MODEL_MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"created": time.time(), "digests": digests}, f, indent=2)
    os.replace(tmp, path)  # atomic: a reader never sees a torn manifest
    return path


def verify_model_manifest(root: str, require: bool = True) -> Dict[str, str]:
    """Verify every digest in ``<root>/model-manifest.json`` against the
    files on disk. Raises :class:`ModelIntegrityError` on a missing file or
    digest mismatch, and on a missing manifest when ``require`` (files the
    manifest does not list are ignored). Returns the verified
    ``{relpath: digest}`` map."""
    path = os.path.join(root, MODEL_MANIFEST)
    if not os.path.exists(path):
        if require:
            raise ModelIntegrityError(f"{root}: no {MODEL_MANIFEST}")
        return {}
    try:
        with open(path) as f:
            manifest = json.load(f)
        digests = manifest["digests"]
    except (OSError, json.JSONDecodeError, KeyError) as e:
        raise ModelIntegrityError(f"{path}: unreadable manifest ({e})") from e
    for rel, want in digests.items():
        fpath = os.path.join(root, rel)
        if not os.path.exists(fpath):
            raise ModelIntegrityError(f"{root}: missing {rel}")
        got = sha256_file(fpath)
        if got != want:
            raise ModelIntegrityError(
                f"{root}: {rel} digest mismatch "
                f"(manifest {want[:12]}…, file {got[:12]}…)"
            )
    return digests


# ---------------------------------------------------------------------------
# GAME model directories
# ---------------------------------------------------------------------------


def _read_id_info(cdir: str) -> Dict[str, str]:
    info = {}
    with open(os.path.join(cdir, "id-info")) as f:
        for line in f:
            if "=" in line:
                k, v = line.strip().split("=", 1)
                info[k] = v
    return info


def _write_id_info(cdir: str, shard: str, re_type: Optional[str], extra: str = "") -> None:
    with open(os.path.join(cdir, "id-info"), "w") as f:
        f.write(f"featureShardId={shard}\n")
        if re_type is not None:
            f.write(f"randomEffectType={re_type}\n")
        f.write(extra)


def save_game_model(
    root: str,
    params: Dict[str, object],
    shards: Dict[str, str],
    vocabs: Dict[str, FeatureVocabulary],
    entity_vocabs: Dict[str, dict],
    random_effects: Dict[str, Optional[str]],
    task: Optional[TaskType] = None,
):
    """params: coordinate -> (d,) fixed or (E, d) random-effect table
    (numpy or tensors), or ``FactoredParams``. shards: coordinate ->
    feature shard id; vocabs: coordinate -> vocab; entity_vocabs:
    coordinate -> {raw_id: index} for RE coordinates; random_effects:
    coordinate -> RE type name or None (fixed)."""
    for name, table in params.items():
        if is_factored_params(table):
            _save_factored_coordinate(
                root, name, table, shards[name],
                random_effects.get(name), entity_vocabs.get(name, {}),
                vocabs[name],
            )
            continue
        table = to_numpy(table)
        re_type = random_effects.get(name)
        kind = "fixed-effect" if re_type is None else "random-effect"
        cdir = os.path.join(root, kind, name)
        os.makedirs(os.path.join(cdir, "coefficients"), exist_ok=True)
        _write_id_info(cdir, shards[name], re_type)
        vocab = vocabs[name]
        if re_type is None:
            records = [_coefficients_to_record(name, table, None, vocab, task)]
        else:
            index_to_id = {v: k for k, v in entity_vocabs[name].items()}
            records = [
                _coefficients_to_record(
                    str(index_to_id.get(e, e)), table[e], None, vocab, task
                )
                for e in range(table.shape[0])
            ]
        write_avro_file(
            os.path.join(cdir, "coefficients", "part-00000.avro"),
            BAYESIAN_LINEAR_MODEL_SCHEMA,
            records,
        )


def load_game_model(
    root: str,
    vocabs: Dict[str, FeatureVocabulary],
    entity_vocabs: Optional[Dict[str, dict]] = None,
):
    """Returns (params, shards, random_effects, entity_vocabs) mirroring
    save_game_model: fixed effects as (d,) and random effects as dense
    (E, len(vocab)) float64 numpy tables, factored effects as
    ``FactoredParams`` of float64 CPU tensors. Coordinates without a
    vocabulary in ``vocabs`` are skipped. The returned entity_vocabs maps
    each random-effect coordinate to its {raw_id: row} table mapping; when
    the caller didn't supply one it is built from record order and MUST be
    used to index the table."""
    params: Dict[str, object] = {}
    shards: Dict[str, str] = {}
    random_effects: Dict[str, Optional[str]] = {}
    entity_vocabs_out: Dict[str, dict] = {}
    for kind in ("fixed-effect", "random-effect"):
        kdir = os.path.join(root, kind)
        if not os.path.isdir(kdir):
            continue
        for name in sorted(os.listdir(kdir)):
            if name not in vocabs:
                # a coordinate the caller has no vocabulary for cannot be
                # decoded: skip it instead of failing the whole load
                continue
            cdir = os.path.join(kdir, name)
            info = _read_id_info(cdir)
            shards[name] = info.get("featureShardId", name)
            random_effects[name] = info.get("randomEffectType")
            vocab = vocabs[name]
            _, records = read_avro_file(
                os.path.join(cdir, "coefficients", "part-00000.avro")
            )
            if kind == "fixed-effect":
                params[name], _ = _record_to_coefficients(records[0], vocab)
                continue
            if entity_vocabs is not None and name in entity_vocabs:
                evocab = entity_vocabs[name]
            else:
                evocab = {rec["modelId"]: i for i, rec in enumerate(records)}
            table = np.zeros((len(evocab), len(vocab)))
            for rec in records:
                raw = rec["modelId"]
                e = evocab.get(raw, evocab.get(_maybe_int(raw)))
                if e is not None:
                    table[e], _ = _record_to_coefficients(rec, vocab)
            params[name] = table
            entity_vocabs_out[name] = dict(evocab)
    fdir = os.path.join(root, "factored-random-effect")
    if os.path.isdir(fdir):
        for name in sorted(os.listdir(fdir)):
            if name not in vocabs:
                continue
            evocab = entity_vocabs.get(name) if entity_vocabs is not None else None
            fparams, info, evocab = load_factored_coordinate(
                os.path.join(fdir, name), vocabs[name], evocab
            )
            params[name] = fparams
            shards[name] = info.get("featureShardId", name)
            random_effects[name] = info.get("randomEffectType")
            entity_vocabs_out[name] = evocab
    return params, shards, random_effects, entity_vocabs_out


def _maybe_int(s):
    try:
        return int(s)
    except (TypeError, ValueError):
        return s


def union_entity_vocab(vocabs) -> dict:
    """Union of raw entity ids over an iterable of {raw: row} vocabs,
    assigned rows in first-seen order."""
    out: dict = {}
    for vocab in vocabs:
        for raw in vocab:
            out.setdefault(raw, len(out))
    return out


def remap_entity_rows(table: np.ndarray, own: dict, shared: dict) -> np.ndarray:
    """Re-index a per-entity row table from its own {raw: row} vocab into a
    shared one (missing entities keep zero rows: the cogroup
    missing-entity-scores-0 semantic). Identity vocab: returns the input
    unchanged (no copy)."""
    table = np.asarray(table)
    if shared == own:
        return table
    src = np.fromiter(own.values(), np.int64, count=len(own))
    dst = np.asarray([shared[raw] for raw in own], np.int64)
    out = np.zeros((len(shared), table.shape[1]), table.dtype)
    out[dst] = table[src]
    return out


def collapse_game_model(
    params: Dict[str, object],
    shards: Dict[str, str],
    random_effects: Dict[str, Optional[str]],
    entity_vocabs: Dict[str, dict],
):
    """Merge coordinates sharing (effect type, feature shard) by
    coefficient ADDITION (``ModelProcessingUtils.collapseGameModel``
    :224-264): fixed-effect vectors sum directly; random-effect tables
    cogroup on the raw entity id (an entity absent from one coordinate
    contributes zeros). Returns (params, shards, random_effects,
    entity_vocabs) as numpy, merged coordinates named "<effect>-<shard>".
    Factored coordinates are refused, like the reference."""
    groups: Dict[Tuple[str, str], List[str]] = {}
    for name in params:
        if is_factored_params(params[name]):
            raise ValueError(
                f"collapse of factored coordinate {name!r} is not supported "
                "(reference ModelProcessingUtils.scala:235-236)"
            )
        effect = random_effects.get(name) or "fixed-effect"
        groups.setdefault((effect, shards[name]), []).append(name)

    out_params: Dict[str, np.ndarray] = {}
    out_shards: Dict[str, str] = {}
    out_res: Dict[str, Optional[str]] = {}
    out_evocabs: Dict[str, dict] = {}
    for (effect, shard), names in groups.items():
        merged_name = f"{effect}-{shard}"
        out_shards[merged_name] = shard
        re_type = random_effects.get(names[0])
        out_res[merged_name] = re_type
        if re_type is None:
            out_params[merged_name] = np.sum([to_numpy(params[n]) for n in names], axis=0)
            continue
        merged_vocab = union_entity_vocab(entity_vocabs[n] for n in names)
        d = to_numpy(params[names[0]]).shape[1]
        table = np.zeros((len(merged_vocab), d))
        for n in names:
            table += remap_entity_rows(to_numpy(params[n]), entity_vocabs[n], merged_vocab)
        out_params[merged_name] = table
        out_evocabs[merged_name] = merged_vocab
    return out_params, out_shards, out_res, out_evocabs


def resolve_game_dirs(root: str) -> Tuple[str, str]:
    """(model_root, vocab_root): model_root holds fixed-effect/random-effect
    subdirs (the training-output root itself, its 'best' child, or the
    first 'all/<i>' child); vocab_root holds the feature-index-*.txt files
    (the training-output root, walking up from model_root)."""

    def has_model(d):
        return os.path.isdir(os.path.join(d, "fixed-effect")) or os.path.isdir(
            os.path.join(d, "random-effect")
        )

    candidates = [root, os.path.join(root, "best")]
    all_dir = os.path.join(root, "all")
    if os.path.isdir(all_dir):
        candidates += [os.path.join(all_dir, s) for s in sorted(os.listdir(all_dir))]
    model_root = next((c for c in candidates if has_model(c)), None)
    if model_root is None:
        raise FileNotFoundError(
            f"no GAME model (fixed-effect/random-effect dirs) under {root}"
        )

    def has_vocabs(d):
        return any(
            f.startswith("feature-index-") and f.endswith(".txt")
            for f in os.listdir(d)
        )

    vocab_root = model_root
    while not has_vocabs(vocab_root):
        parent = os.path.dirname(vocab_root.rstrip(os.sep))
        if not parent or parent == vocab_root:
            raise FileNotFoundError(
                f"no feature-index-*.txt vocab files found at or above "
                f"{model_root}"
            )
        vocab_root = parent
    return model_root, vocab_root


def load_game_model_auto(root: str):
    """One-call GAME model load for scoring: resolve the model/vocab dirs
    under a training-output root, load every coordinate, and merge entity
    vocabularies per random-effect TYPE (the union over the coordinates
    sharing it: data is indexed once per type, and each coordinate's table
    rows must live in that shared space; a first-coordinate-wins merge
    would silently misattribute per-entity rows). Coordinates lacking an
    entity contribute zero rows.

    Returns ``(params, shards, random_effects, shard_vocabs, re_vocabs)``
    where ``shard_vocabs`` maps feature-shard id -> FeatureVocabulary and
    ``re_vocabs`` maps random-effect type -> shared {raw_id: row} vocab."""
    model_root, vocab_root = resolve_game_dirs(root)
    shard_vocabs = {
        f[len("feature-index-"):-len(".txt")]: FeatureVocabulary.load(
            os.path.join(vocab_root, f)
        )
        for f in os.listdir(vocab_root)
        if f.startswith("feature-index-") and f.endswith(".txt")
    }
    # coordinate -> shard comes from id-info; vocabs keyed per coordinate
    # for load_game_model
    coord_vocabs: Dict[str, FeatureVocabulary] = {}
    for kind in _MODEL_KINDS:
        kdir = os.path.join(model_root, kind)
        if not os.path.isdir(kdir):
            continue
        for name in os.listdir(kdir):
            shard = _read_id_info(os.path.join(kdir, name)).get("featureShardId")
            if shard is not None:
                coord_vocabs[name] = shard_vocabs[shard]
    params, shards, random_effects, entity_vocabs = load_game_model(
        model_root, coord_vocabs
    )
    re_vocabs: Dict[str, dict] = {}
    for re_key in sorted({re for re in random_effects.values() if re is not None}):
        re_vocabs[re_key] = union_entity_vocab(
            entity_vocabs[name]
            for name, rk in random_effects.items()
            if rk == re_key
        )
    for name, re_key in random_effects.items():
        if re_key is None:
            continue
        shared = re_vocabs[re_key]
        own = entity_vocabs[name]
        p = params[name]
        if is_factored_params(p):
            params[name] = FactoredParams(
                gamma=torch.from_numpy(remap_entity_rows(p.gamma.numpy(), own, shared)),
                projection=p.projection,
            )
        else:
            params[name] = remap_entity_rows(p, own, shared)
    return params, shards, random_effects, shard_vocabs, re_vocabs


# ---------------------------------------------------------------------------
# Factored random effects (latent-factor wire format,
# ``ModelProcessingUtils.saveMatrixFactorizationModelToHDFS`` :274-332)
# ---------------------------------------------------------------------------


def _write_latent_factor_table(path: str, table: np.ndarray, vocab: Optional[dict]) -> None:
    """(rows, k) -> LatentFactorAvro records keyed by the vocab's raw ids
    (positional string ids when no vocab)."""
    index_to_id = {v: k for k, v in vocab.items()} if vocab else {}
    write_avro_file(
        path,
        LATENT_FACTOR_SCHEMA,
        [
            {
                "effectId": str(index_to_id.get(i, i)),
                "latentFactor": [float(v) for v in table[i]],
            }
            for i in range(table.shape[0])
        ],
    )


def _fill_table_from_latent_records(records, vocab: Optional[dict], what: str):
    """LatentFactorAvro records -> ((rows, k) table, vocab). Builds the
    vocab from record order when absent; raises on records whose id the
    vocab cannot place (silent drops would corrupt scoring)."""
    if vocab is None:
        vocab = {rec["effectId"]: i for i, rec in enumerate(records)}
    k = len(records[0]["latentFactor"]) if records else 1
    table = np.zeros((len(vocab), k))
    for rec in records:
        raw = rec["effectId"]
        i = vocab.get(raw, vocab.get(_maybe_int(raw)))
        if i is None:
            raise ValueError(
                f"{what}: record id {raw!r} is not in the provided "
                "vocabulary — refusing a silently truncated table"
            )
        table[i] = rec["latentFactor"]
    return table, dict(vocab)


def _save_factored_coordinate(
    root: str,
    name: str,
    params: FactoredParams,
    shard: str,
    re_type: Optional[str],
    entity_vocab: dict,
    vocab: FeatureVocabulary,
):
    """w_e = B gamma_e saved as two LatentFactorAvro tables: gamma rows
    keyed by raw entity id, projection rows keyed by the feature key (the
    factorization survives the round trip)."""
    gamma = to_numpy(params.gamma)
    projection = to_numpy(params.projection)
    cdir = os.path.join(root, "factored-random-effect", name)
    os.makedirs(cdir, exist_ok=True)
    _write_id_info(cdir, shard, re_type, f"latentDim={gamma.shape[1]}\n")
    _write_latent_factor_table(
        os.path.join(cdir, "latent-factors.avro"), gamma, entity_vocab
    )
    write_avro_file(
        os.path.join(cdir, "projection.avro"),
        LATENT_FACTOR_SCHEMA,
        [
            {
                "effectId": "{}\x01{}".format(*vocab.name_term(j)),
                "latentFactor": [float(v) for v in projection[j]],
            }
            for j in range(projection.shape[0])
        ],
    )


def load_factored_coordinate(
    cdir: str,
    vocab: FeatureVocabulary,
    entity_vocab: Optional[dict] = None,
):
    """Returns (FactoredParams of float64 CPU tensors, info dict,
    entity_vocab)."""
    info = _read_id_info(cdir)
    k = int(info["latentDim"])
    _, grecords = read_avro_file(os.path.join(cdir, "latent-factors.avro"))
    gamma, entity_vocab = _fill_table_from_latent_records(
        grecords, entity_vocab, f"factored coordinate {cdir}"
    )
    _, precords = read_avro_file(os.path.join(cdir, "projection.avro"))
    projection = np.zeros((len(vocab), k))
    for rec in precords:
        name, _, term = rec["effectId"].partition("\x01")
        idx = vocab.get(name, term)
        if idx is not None:
            projection[idx] = rec["latentFactor"]
    return (
        FactoredParams(gamma=torch.from_numpy(gamma), projection=torch.from_numpy(projection)),
        info,
        entity_vocab,
    )
