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
``checkpoint.load``. Not ported: the sharded writer and
``reindex_entity_params`` (ROADMAP.md queue A item 9).
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


def _prune_leftovers(directory: str) -> None:
    """Remove ``*.tmp`` / ``*.old`` debris of earlier crashes: a ``.tmp``
    is an unfinished write, a ``.old`` a superseded step whose replacement
    already swapped in."""
    for name in os.listdir(directory):
        if name.startswith(_STEP_PREFIX) and (name.endswith(".tmp") or name.endswith(".old")):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


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
    with backoff; each attempt restarts from a clean temp dir."""
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
    for old_step in sorted(_list_steps(directory))[:-keep]:
        shutil.rmtree(os.path.join(directory, f"{_STEP_PREFIX}{old_step}"))
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
        raise CheckpointCorrupted(
            f"{d}: a sharded checkpoint (the sharded store is not ported: ROADMAP.md "
            "queue A item 9)"
        )
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
        history = [dict(h) for h in manifest["history"]]
        for h, extra in zip(history, manifest.get("history_port", [])):
            h.update(extra)
        return TrainingCheckpoint(
            step=manifest["step"],
            params=params,
            rng_key=np.asarray(manifest["rng_key"], np.uint32),
            history=history,
            frozen=list(manifest.get("frozen", [])),
            generator_state=(arrays[_GENERATOR_KEY] if _GENERATOR_KEY in arrays.files
                             else None),
        )
    except (KeyError, zipfile.BadZipFile) as e:
        raise CheckpointCorrupted(f"{d}: manifest/arrays mismatch ({e})") from e


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
