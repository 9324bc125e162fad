"""Training-state checkpoints for mid-run durability (counterpart of the
single-writer store of ``photon_ml_tpu/io/checkpoint.py``).

Each coordinate-descent pass can write the FULL training state: the
parameter tables, the random state, the iteration counter, the objective
history and the frozen set, and a resumed run continues where the original
left off (bit for bit on the CPU).

Layout, the JAX package's, so a step written by either package loads in
the other: ``<dir>/step-<k>/`` holding ``arrays.npz`` (plain tables keyed
``param/<coordinate>``; a factored coordinate's two leaves
``param/<coordinate>#gamma`` and ``param/<coordinate>#projection``, its
kind in the manifest) and ``manifest.json`` (step, ``rng_key``, history,
frozen list, a sha256 digest per data file).

The port's random state is its ``torch.Generator`` state, stored in
``arrays.npz`` as ``rng/torch_generator_state``, a name the JAX package's
``rng_key`` cannot be mistaken for; ``rng_key`` holds the JAX layout of
``PRNGKey(seed)`` so that the JAX package can resume from the step (its
draws then restart from the seed: ROADMAP.md lists the divergence). The
port's two additions to a history record (``cg_iterations``,
``entity_iterations``) go to ``history_port``, so that ``history`` holds
the JAX package's fields only.

Failure model: the write is ATOMIC (temp dir + rename; any existing
same-step dir is renamed aside first and deleted only after the new one is
in place), transient ``OSError`` is retried with backoff
(:mod:`photon_ml_tpu_torch.resilience.retry`), and loads verify the
digests: :func:`latest_checkpoint` falls back to the newest step that
loads clean. The write probes the ``checkpoint.save`` fault site between
the temp dir's write and the swap, and each step's load probes
``checkpoint.load``.

SHARDED layout (the JAX package's, ``photon_ml_tpu/io/checkpoint.py:
391-1007``): ``<dir>/step-<k>/`` holding ``shard-<p>-of-<P>.npz`` and
``shard-<p>-of-<P>.json`` per shard plus ONE quorum ``manifest.json``
(``format: "sharded"``, a sha256 digest per shard). An entity-keyed table
is split round-robin over the shards (rows ``p::P``, :func:`shard_rows`)
with its entity keys; everything else, and the port's generator state, is
stored in shard 0. In a world of P ranks every rank writes its own shard,
the digests are exchanged with ``allgather_strings`` and rank 0 publishes
(:func:`save_checkpoint_sharded`); the survivors of a lost peer publish a
complete set with no collective (:func:`save_checkpoint_sharded_final`).
A restore at another width or entity order re-keys rows by entity
(:func:`reindex_entity_params`). :func:`latest_checkpoint` takes both
formats and a sharded step only when its whole digest-verified shard set
is present (quorum).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import zipfile
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.game.factored import FactoredParams, is_factored_params
from photon_ml_tpu_torch.resilience import faults, retry

_STEP_PREFIX = "step-"
_DATA_FILES = ("arrays.npz",)
_GENERATOR_KEY = "rng/torch_generator_state"
# the fields a history record carries in the port only
_PORT_RECORD_FIELDS = ("cg_iterations", "entity_iterations")


@dataclasses.dataclass
class TrainingCheckpoint:
    step: int  # completed outer iterations
    # coordinate -> plain table OR FactoredParams (numpy leaves)
    params: Dict[str, object]
    rng_key: np.ndarray  # the JAX package's key (uint32)
    history: List[dict]
    # coordinates frozen by the divergence guard or the caller
    frozen: List[str] = dataclasses.field(default_factory=list)
    # the port's torch.Generator state (uint8); None in a step the JAX
    # package wrote
    generator_state: Optional[np.ndarray] = None
    # sharded steps only: coordinate -> ordered entity keys (str), the row
    # labels that reindex_entity_params re-keys by
    entity_keys: Optional[Dict[str, List[str]]] = None
    # how many shard files held this step (1 = the whole-model format)
    shards: int = 1


class CheckpointCorrupted(Exception):
    """A step directory failed integrity verification."""


def sha256_file(path: str) -> str:
    """Streaming sha256 of a file."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def jax_prng_key(seed: int) -> np.ndarray:
    """The JAX package's ``jax.random.PRNGKey(seed)`` (threefry) as uint32."""
    seed = int(seed)
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _prune_leftovers(directory: str, keep=()) -> None:
    """Remove the debris of earlier crashes: a ``.tmp`` or ``.shards`` is an
    unfinished write, a ``.old`` a superseded step whose replacement already
    swapped in, a ``.publisher`` the election claim of a final save whose
    publisher died. ``keep`` protects the current save's staging directory
    (peers may be writing their shards into it)."""
    if isinstance(keep, str):
        keep = (keep,)
    for name in os.listdir(directory):
        if name in keep or not name.startswith(_STEP_PREFIX):
            continue
        path = os.path.join(directory, name)
        if name.endswith(".publisher"):
            try:
                os.remove(path)
            except OSError:
                pass
        elif name.endswith((".tmp", ".old", ".shards")):
            shutil.rmtree(path, ignore_errors=True)


def _split_history(history: List[dict]):
    """(the JAX package's records, the port's additions per record)."""
    jax_records, port = [], []
    for h in history:
        h = dict(h)
        extra = {k: h.pop(k, None) for k in _PORT_RECORD_FIELDS}
        if extra["entity_iterations"] is not None:
            extra["entity_iterations"] = np.asarray(extra["entity_iterations"]).tolist()
        jax_records.append(h)
        port.append(extra)
    return jax_records, port


def save_checkpoint(
    directory: str,
    step: int,
    params: Dict[str, object],  # host tables and/or FactoredParams
    rng_key,
    history: Optional[List[dict]] = None,
    keep: int = 2,
    frozen: Optional[List[str]] = None,
    generator_state=None,
    retries: int = 4,
    logger=None,
) -> str:
    """Atomically write ``<directory>/step-<step>`` and keep the newest
    ``keep`` steps. A transient ``OSError`` during the write is retried
    with backoff; each attempt restarts from a clean temp dir. In a world of
    several ranks it refuses, as the JAX package does: every rank would
    race the same step directory (:func:`save_checkpoint_sharded`)."""
    from photon_ml_tpu_torch.parallel.mesh import world

    n_world = world()[0]
    if n_world > 1:
        raise RuntimeError(
            f"save_checkpoint(step={step}) called in a {n_world}-process run: every "
            "process would race the same step directory and trample the atomic-swap "
            "protocol. Use save_checkpoint_sharded — each process writes only its "
            "shard-<p>-of-<P> files and process 0 publishes the quorum manifest."
        )
    for name in params:
        if "#" in name:
            # '#' separates a factored coordinate's leaves in npz keys
            raise ValueError(
                f"coordinate name {name!r} contains '#' (reserved for the "
                "checkpoint leaf encoding)"
            )
    os.makedirs(directory, exist_ok=True)
    _prune_leftovers(directory)
    final = os.path.join(directory, f"{_STEP_PREFIX}{step}")
    tmp = final + ".tmp"
    old = final + ".old"

    arrays: Dict[str, np.ndarray] = {}
    param_kinds: Dict[str, str] = {}
    for name, p in params.items():
        if is_factored_params(p):
            param_kinds[name] = "factored"
            arrays[f"param/{name}#gamma"] = np.asarray(p.gamma)
            arrays[f"param/{name}#projection"] = np.asarray(p.projection)
        else:
            param_kinds[name] = "array"
            arrays[f"param/{name}"] = np.asarray(p)
    if generator_state is not None:
        arrays[_GENERATOR_KEY] = np.asarray(generator_state, np.uint8)
    jax_history, port_history = _split_history(history or [])

    def _write() -> None:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "rng_key": np.asarray(rng_key).tolist(),
            "param_names": sorted(params),
            "param_kinds": param_kinds,
            "history": jax_history,
            "history_port": port_history,
            "frozen": sorted(frozen or []),
            "digests": {f: sha256_file(os.path.join(tmp, f)) for f in _DATA_FILES},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # fault site: the torn-checkpoint window — the temp dir is fully
        # written but the swap has not happened. raise-mode kills the write
        # here; corrupt-mode tears arrays.npz AFTER its digest was
        # recorded, so the load-side verification must catch it.
        if faults.fire("checkpoint.save").corrupt:
            faults.corrupt_file(os.path.join(tmp, "arrays.npz"))
        # swap: old step aside -> new step in -> delete old; every instant
        # keeps at least one complete copy of the step on disk
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(final):
            os.rename(final, old)
        os.rename(tmp, final)
        if os.path.exists(old):
            shutil.rmtree(old)

    retry.retry_call(_write, retries=retries, logger=logger, label=f"checkpoint step {step}")
    _prune_old_steps(directory, keep)
    return final


def _list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if (name.startswith(_STEP_PREFIX) and not name.endswith(".tmp")
                and not name.endswith(".old") and not name.endswith(".shards")):
            try:
                out.append(int(name[len(_STEP_PREFIX):]))
            except ValueError:
                continue
    return out


def _load_step(directory: str, step: int) -> TrainingCheckpoint:
    """Load one step directory, verifying integrity. Raises
    :class:`CheckpointCorrupted` on any defect (an unreadable manifest, a
    missing data file, a digest mismatch, a missing npz key)."""
    d = os.path.join(directory, f"{_STEP_PREFIX}{step}")
    faults.fire("checkpoint.load")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorrupted(f"{d}: unreadable manifest ({e})") from e
    if manifest.get("format") == "sharded":
        return _load_sharded_step(d, manifest)
    digests = manifest.get("digests")
    if digests is not None:
        for fname, want in digests.items():
            path = os.path.join(d, fname)
            if not os.path.exists(path):
                raise CheckpointCorrupted(f"{d}: missing {fname}")
            got = sha256_file(path)
            if got != want:
                raise CheckpointCorrupted(
                    f"{d}: {fname} digest mismatch (manifest {want[:12]}…, file {got[:12]}…)"
                )
    try:
        arrays = np.load(os.path.join(d, "arrays.npz"))
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise CheckpointCorrupted(f"{d}: unreadable arrays.npz ({e})") from e
    kinds = manifest.get("param_kinds", {})
    try:
        params = {}
        for name in manifest["param_names"]:
            if kinds.get(name, "array") == "factored":
                params[name] = FactoredParams(gamma=arrays[f"param/{name}#gamma"],
                                              projection=arrays[f"param/{name}#projection"])
            else:
                params[name] = arrays[f"param/{name}"]
        return TrainingCheckpoint(
            step=manifest["step"],
            params=params,
            rng_key=np.asarray(manifest["rng_key"], np.uint32),
            history=_joined_history(manifest),
            frozen=list(manifest.get("frozen", [])),
            generator_state=(arrays[_GENERATOR_KEY] if _GENERATOR_KEY in arrays.files
                             else None),
        )
    except (KeyError, zipfile.BadZipFile) as e:
        raise CheckpointCorrupted(f"{d}: manifest/arrays mismatch ({e})") from e


def _joined_history(manifest: dict) -> List[dict]:
    """The manifest's records with the port's additions put back."""
    history = [dict(h) for h in manifest["history"]]
    for h, extra in zip(history, manifest.get("history_port", [])):
        h.update(extra)
    return history


def verify_checkpoint(directory: str, step: int) -> TrainingCheckpoint:
    """Integrity-check one step; raises :class:`CheckpointCorrupted`."""
    return _load_step(directory, step)


def latest_checkpoint(directory: str, logger=None) -> Optional[TrainingCheckpoint]:
    """The newest VALID checkpoint, or None. Steps that do not load clean
    (a truncated manifest, a missing or torn ``arrays.npz``, a digest
    mismatch) are skipped, newest first: a run that died mid-write
    restarts from the last good pass."""
    for step in sorted(_list_steps(directory), reverse=True):
        try:
            return _load_step(directory, step)
        except (CheckpointCorrupted, OSError) as e:
            if logger is not None:
                logger.warn(f"checkpoint step {step} invalid, falling back: {e}")
    return None


# -- the sharded store ------------------------------------------------------------
#
#   step-<k>.shards/          staging (a recognized debris suffix)
#     shard-<p>-of-<P>.npz    shard p's rows: entity tables round-robin
#                             (rows p::P), replicated params in shard 0
#     shard-<p>-of-<P>.json   per-shard manifest: digest + its entity keys
#     manifest.json           the QUORUM manifest: a sha256 per shard, the
#                             counters, the key, the global key order
#   step-<k>/                 the staging dir, swapped in atomically
#
# A step is restorable when the quorum manifest lists P shards and every
# one is present with its digest.


def _prune_old_steps(directory: str, keep: int) -> None:
    """Keep only the newest ``keep`` published steps."""
    for old_step in sorted(_list_steps(directory))[:-keep]:
        shutil.rmtree(os.path.join(directory, f"{_STEP_PREFIX}{old_step}"))


def _dir_of_shards(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_STEP_PREFIX}{step}")


def shard_rows(n: int, p: int, num_shards: int) -> range:
    """Rows of a length-n entity axis that shard p owns: round-robin
    ``p::P`` (``photon_ml_tpu/io/checkpoint.py:397``). Entity-sharded GAME
    (``game.data.entity_shard_assignment``) derives its device layout from
    this rule, so the device and checkpoint layouts cannot drift."""
    return range(p, n, num_shards)


def _write_one_shard(staging: str, p: int, num_shards: int, step: int,
                     params: Dict[str, object], entity_keys: Dict[str, List[str]],
                     extra: Optional[Dict[str, np.ndarray]] = None) -> str:
    """Write shard p's npz and json into ``staging``; returns the npz's
    sha256. ``extra`` arrays (the port's generator state) go to shard 0.
    Probes ``checkpoint.shard_write`` (key = shard index) after the digest
    is recorded, so that corrupt mode tears a shard the quorum check must
    catch."""
    arrays: Dict[str, np.ndarray] = {}
    local_keys: Dict[str, List[str]] = {}

    def leaf(key: str, table, keys) -> None:
        table = np.asarray(table)
        if keys is not None:
            rows = list(shard_rows(table.shape[0], p, num_shards))
            arrays[key] = table[rows]
            local_keys[name] = [keys[i] for i in rows]
        elif p == 0:
            arrays[key] = table

    for name, value in params.items():
        keys = entity_keys.get(name)
        if is_factored_params(value):
            leaf(f"param/{name}#gamma", value.gamma, keys)
            if p == 0:
                arrays[f"param/{name}#projection"] = np.asarray(value.projection)
        else:
            leaf(f"param/{name}", value, keys)
    if p == 0:
        arrays.update(extra or {})
    stem = f"shard-{p}-of-{num_shards}"
    npz_path = os.path.join(staging, stem + ".npz")
    np.savez(npz_path, **arrays)
    digest = sha256_file(npz_path)
    with open(os.path.join(staging, stem + ".json"), "w") as f:
        json.dump({"shard": p, "of": num_shards, "step": step, "digest": digest,
                   "entity_keys": local_keys}, f)
    if faults.fire("checkpoint.shard_write", key=str(p)).corrupt:
        faults.corrupt_file(npz_path)
    return digest


def _swap_in_step(staging: str, final: str) -> None:
    """Atomic swap-aside: old step aside, staging in, old deleted."""
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(staging, final)
    if os.path.exists(old):
        shutil.rmtree(old)


def _validated_entity_keys(params: Dict[str, object], entity_keys) -> Dict[str, List[str]]:
    """Check the coordinate names and that each key list labels every row
    of its table, before any file is touched; returns the keys as str."""
    for name in params:
        if "#" in name:
            raise ValueError(
                f"coordinate name {name!r} contains '#' (reserved for the "
                "checkpoint leaf encoding)"
            )
    ekeys: Dict[str, List[str]] = {}
    for name, keys in (entity_keys or {}).items():
        if name not in params:
            continue
        table = params[name]
        n_rows = np.asarray(table.gamma if is_factored_params(table) else table).shape[0]
        if len(keys) != n_rows:
            raise ValueError(
                f"coordinate {name!r}: {len(keys)} entity keys for {n_rows} table rows — "
                "the keys must label every row"
            )
        ekeys[name] = [str(k) for k in keys]
    return ekeys


def _quorum_manifest_dict(*, step: int, num_shards: int, rng_key, params: Dict[str, object],
                          ekeys: Dict[str, List[str]], history, frozen,
                          digests: Dict[str, str]) -> dict:
    jax_history, port_history = _split_history(history or [])
    return {
        "format": "sharded",
        "step": step,
        "shards": num_shards,
        "rng_key": np.asarray(rng_key).tolist(),
        "param_names": sorted(params),
        "param_kinds": {n: "factored" if is_factored_params(p) else "array"
                        for n, p in params.items()},
        "param_sharding": {n: "entity" if n in ekeys else "replicated" for n in params},
        "entity_keys": ekeys,
        "history": jax_history,
        "history_port": port_history,
        "frozen": sorted(frozen or []),
        "digests": digests,
    }


def _write_full_shard_set(staging: str, final: str, num_shards: int, step: int,
                          params: Dict[str, object], ekeys: Dict[str, List[str]],
                          extra, manifest_fn, retries: int, logger, label: str) -> None:
    """One writer stages all ``num_shards`` shards and the quorum manifest,
    then swaps the step in: one retryable unit from a clean staging dir
    (the single-process writer and the survivors' final save)."""

    def _write() -> None:
        if os.path.exists(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        digests = {f"shard-{p}-of-{num_shards}.npz": _write_one_shard(
            staging, p, num_shards, step, params, ekeys, extra) for p in range(num_shards)}
        with open(os.path.join(staging, "manifest.json"), "w") as f:
            json.dump(manifest_fn(digests), f)
        _swap_in_step(staging, final)

    retry.retry_call(_write, retries=retries, logger=logger, label=label)


def _prune_foreign_shard_files(staging: str, num_shards: int) -> None:
    """Drop staging files outside the current shard set (a crashed earlier
    attempt's, perhaps at another width) before rank 0 publishes."""
    expected = {"manifest.json"}
    for p in range(num_shards):
        expected.update({f"shard-{p}-of-{num_shards}.npz", f"shard-{p}-of-{num_shards}.json"})
    for name in os.listdir(staging):
        if name in expected:
            continue
        path = os.path.join(staging, name)
        try:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)
        except OSError:
            pass


def _extra_arrays(generator_state) -> Dict[str, np.ndarray]:
    if generator_state is None:
        return {}
    return {_GENERATOR_KEY: np.asarray(generator_state, np.uint8)}


def save_checkpoint_sharded(
    directory: str,
    step: int,
    params: Dict[str, object],
    rng_key,
    *,
    history: Optional[List[dict]] = None,
    frozen: Optional[List[str]] = None,
    keep: int = 2,
    entity_keys: Optional[Dict[str, List]] = None,
    num_shards: Optional[int] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    generator_state=None,
    retries: int = 4,
    logger=None,
) -> str:
    """Write this rank's shard(s) of ``<directory>/step-<step>``
    (``photon_ml_tpu/io/checkpoint.py:606``).

    - In a world of several ranks every rank calls this at the same pass
      boundary with the whole tables; each writes ONLY
      ``shard-<rank>-of-<P>``, the digests are exchanged with
      ``allgather_strings`` (under the collective watchdog), rank 0 writes
      the quorum manifest and swaps the step in, and a completion barrier
      follows.
    - In one process: all ``num_shards`` shards (default 1) locally.

    ``entity_keys``: coordinate -> the ordered entity keys of its table's
    rows (the same on every rank); those tables shard round-robin by row,
    everything else is stored in shard 0."""
    from photon_ml_tpu_torch.parallel import multihost
    from photon_ml_tpu_torch.parallel.mesh import world

    n_world, rank = world()
    if process_count is None:
        process_count = n_world
    if process_index is None:
        process_index = rank if process_count > 1 else 0
    if process_count > 1:
        if num_shards is not None and num_shards != process_count:
            raise ValueError(
                f"num_shards={num_shards} conflicts with process_count={process_count}: "
                "in a world every process writes exactly its own shard"
            )
        num_shards = process_count
    else:
        num_shards = int(num_shards or 1)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    ekeys = _validated_entity_keys(params, entity_keys)
    extra = _extra_arrays(generator_state)
    os.makedirs(directory, exist_ok=True)
    final = _dir_of_shards(directory, step)
    staging = final + ".shards"

    def manifest(digests):
        return _quorum_manifest_dict(step=step, num_shards=num_shards, rng_key=rng_key,
                                     params=params, ekeys=ekeys, history=history,
                                     frozen=frozen, digests=digests)

    if process_count == 1:
        _prune_leftovers(directory)
        _write_full_shard_set(staging, final, num_shards, step, params, ekeys, extra,
                              manifest, retries, logger, f"sharded checkpoint step {step}")
    else:
        if process_index == 0:
            _prune_leftovers(directory, keep=os.path.basename(staging))
        os.makedirs(staging, exist_ok=True)
        digest = retry.retry_call(
            lambda: _write_one_shard(staging, process_index, num_shards, step, params,
                                     ekeys, extra),
            retries=retries, logger=logger,
            label=f"checkpoint shard {process_index} step {step}")
        entries = multihost.allgather_strings(
            [json.dumps({"shard": process_index, "digest": digest})])
        if process_index == 0:
            digests = {}
            for entry in entries:
                e = json.loads(entry)
                digests[f"shard-{e['shard']}-of-{num_shards}.npz"] = e["digest"]
            _prune_foreign_shard_files(staging, num_shards)
            with open(os.path.join(staging, "manifest.json"), "w") as f:
                json.dump(manifest(digests), f)
            _swap_in_step(staging, final)
        # the swap lands before any rank starts the next step
        multihost.allgather_host(np.zeros(1, np.int8))
    if process_count == 1 or process_index == 0:
        _prune_old_steps(directory, keep)
    return final


def save_checkpoint_sharded_final(
    directory: str,
    step: int,
    params: Dict[str, object],
    rng_key,
    *,
    history: Optional[List[dict]] = None,
    frozen: Optional[List[str]] = None,
    keep: int = 2,
    entity_keys: Optional[Dict[str, List]] = None,
    num_shards: Optional[int] = None,
    process_index: Optional[int] = None,
    generator_state=None,
    retries: int = 4,
    logger=None,
) -> Optional[str]:
    """The survivors' final save on a lost peer: a COMPLETE quorum step
    with NO collective (``photon_ml_tpu/io/checkpoint.py:737``). Survivors
    race an ``O_EXCL`` claim file (``step-<k>.publisher``); the winner
    writes every shard from the whole tables into a private staging dir,
    publishes the quorum manifest and swaps the step in; the others return
    None. A step already published and valid is returned as it is."""
    from photon_ml_tpu_torch.parallel.mesh import world

    n_world, rank = world()
    num_shards = int(max(n_world, 1) if num_shards is None else num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if process_index is None:
        process_index = rank
    ekeys = _validated_entity_keys(params, entity_keys)
    os.makedirs(directory, exist_ok=True)
    final = _dir_of_shards(directory, step)
    if os.path.isdir(final):
        try:
            verify_checkpoint(directory, step)
            return final
        except (CheckpointCorrupted, OSError):
            pass  # a torn step: publish over it
    claim = final + ".publisher"
    try:
        fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return None
    try:
        with os.fdopen(fd, "w") as f:
            f.write(str(int(process_index)))
        staging = f"{final}.h{int(process_index)}.shards"
        _write_full_shard_set(
            staging, final, num_shards, step, params, ekeys, _extra_arrays(generator_state),
            lambda digests: _quorum_manifest_dict(
                step=step, num_shards=num_shards, rng_key=rng_key, params=params,
                ekeys=ekeys, history=history, frozen=frozen, digests=digests),
            retries, logger, f"final sharded checkpoint step {step}")
        _prune_old_steps(directory, keep)
        return final
    finally:
        try:
            os.remove(claim)
        except OSError:
            pass


def _load_sharded_step(d: str, manifest: dict) -> TrainingCheckpoint:
    """Reassemble one sharded step under QUORUM
    (``photon_ml_tpu/io/checkpoint.py:844``): every listed shard present
    with its digest, every entity table back to its manifest's row count;
    anything less raises :class:`CheckpointCorrupted`."""
    num_shards = int(manifest.get("shards", 0))
    digests = manifest.get("digests", {})
    if num_shards < 1 or len(digests) != num_shards:
        raise CheckpointCorrupted(
            f"{d}: quorum manifest lists {len(digests)} digests for {num_shards} shards")
    shard_arrays: List[dict] = []
    for p in range(num_shards):
        fname = f"shard-{p}-of-{num_shards}.npz"
        want = digests.get(fname)
        path = os.path.join(d, fname)
        if want is None or not os.path.exists(path):
            raise CheckpointCorrupted(f"{d}: missing {fname} (no quorum)")
        got = sha256_file(path)
        if got != want:
            raise CheckpointCorrupted(
                f"{d}: {fname} digest mismatch (manifest {want[:12]}…, file {got[:12]}…)")
        try:
            shard_arrays.append(dict(np.load(path)))
        except (OSError, ValueError, zipfile.BadZipFile) as e:
            raise CheckpointCorrupted(f"{d}: unreadable {fname} ({e})") from e
    kinds = manifest.get("param_kinds", {})
    sharding = manifest.get("param_sharding", {})
    ekeys = manifest.get("entity_keys", {})

    def assemble(leaf_key: str, name: str) -> np.ndarray:
        if sharding.get(name) != "entity":
            if leaf_key not in shard_arrays[0]:
                raise CheckpointCorrupted(f"{d}: shard 0 lacks replicated leaf {leaf_key!r}")
            return shard_arrays[0][leaf_key]
        n = len(ekeys.get(name, ()))
        parts = []
        for p in range(num_shards):
            if leaf_key not in shard_arrays[p]:
                raise CheckpointCorrupted(f"{d}: shard {p} lacks entity leaf {leaf_key!r}")
            part = shard_arrays[p][leaf_key]
            want_rows = len(shard_rows(n, p, num_shards))
            if part.shape[0] != want_rows:
                raise CheckpointCorrupted(
                    f"{d}: shard {p} of {leaf_key!r} holds {part.shape[0]} rows, quorum "
                    f"expects {want_rows}")
            parts.append(part)
        out = np.empty((n,) + parts[0].shape[1:], parts[0].dtype)
        for p, part in enumerate(parts):
            out[p::num_shards] = part
        return out

    try:
        params: Dict[str, object] = {}
        for name in manifest["param_names"]:
            if kinds.get(name, "array") == "factored":
                params[name] = FactoredParams(gamma=assemble(f"param/{name}#gamma", name),
                                              projection=assemble(f"param/{name}#projection", ""))
            else:
                params[name] = assemble(f"param/{name}", name)
        return TrainingCheckpoint(
            step=manifest["step"],
            params=params,
            rng_key=np.asarray(manifest["rng_key"], np.uint32),
            history=_joined_history(manifest),
            frozen=list(manifest.get("frozen", [])),
            generator_state=shard_arrays[0].get(_GENERATOR_KEY),
            entity_keys={k: list(v) for k, v in ekeys.items()} or None,
            shards=num_shards,
        )
    except KeyError as e:
        raise CheckpointCorrupted(f"{d}: manifest/shard mismatch ({e})") from e


def reindex_entity_params(ckpt: TrainingCheckpoint,
                          entity_keys: Dict[str, List]) -> Dict[str, object]:
    """A checkpoint's entity tables re-keyed onto a NEW entity-key order
    (``photon_ml_tpu/io/checkpoint.py:940``): rows matched BY KEY, never by
    position; target keys the checkpoint lacks start at zero, checkpoint
    rows whose key left are dropped. Tables without keys pass through, and
    an identical order returns the original arrays."""
    if not ckpt.entity_keys:
        return dict(ckpt.params)
    out: Dict[str, object] = {}
    for name, value in ckpt.params.items():
        old_keys = ckpt.entity_keys.get(name)
        target = entity_keys.get(name)
        if old_keys is None or target is None:
            out[name] = value
            continue
        target = [str(k) for k in target]
        if target == old_keys:
            out[name] = value
            continue
        index = {k: i for i, k in enumerate(old_keys)}
        src = np.asarray([index.get(k, -1) for k in target], np.int64)
        hit = src >= 0

        def reorder(table: np.ndarray) -> np.ndarray:
            table = np.asarray(table)
            fresh = np.zeros((len(target),) + table.shape[1:], table.dtype)
            fresh[hit] = table[src[hit]]
            return fresh

        out[name] = (dataclasses.replace(value, gamma=reorder(value.gamma))
                     if is_factored_params(value) else reorder(value))
    return out
