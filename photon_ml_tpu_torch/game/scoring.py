"""Model-level GAME scoring, detached from training coordinates
(counterpart of ``photon_ml_tpu/game/scoring.py``).

Rebuild of the scoring side of the GAME model hierarchy
(``model/FixedEffectModel.scala:31-88`` broadcast-dot,
``model/RandomEffectModel.scala:117-146`` cogroup-with-default-0) for data
that was NOT part of training: validation sets and the scoring driver
(``cli/game/scoring/Driver.scala:139-141``: total score = sum of sub-model
scores). Parameters are host numpy arrays or tensors; each coordinate's
inputs are placed on the scoring device per call. A fixed effect on a
padded-ELL shard goes through ``ops.sparse.matvec``, so on a CUDA device it
launches the ``ell_matvec`` kernel once per call; the random-effect joins
and the factored projection are plain tensor operations.
"""

from __future__ import annotations

import weakref
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.factored import is_factored_params
from photon_ml_tpu_torch.ops.sparse import cast_values, is_hybrid, is_structured, matvec
from photon_ml_tpu_torch.utils.device import resolve_device, to_numpy


class CompactReTable(NamedTuple):
    """Pre-compacted wide random-effect coefficient table: per-entity
    ASCENDING column ids padded with d, matching values padded with 0,
    exactly what ``_compact_table`` produces (numpy arrays or tensors).
    Pass one of these as a coordinate's params to skip the host-side
    (E, d) densify+nonzero entirely."""

    columns: object  # (E, k) int32
    values: object  # (E, k)


def _placed(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor of ``dtype`` on ``device``
    (read-only arrays, which torch cannot wrap, are copied)."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
        if not x.flags.writeable:
            x = x.copy()
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=dtype)


def _fixed_scores(w: torch.Tensor, feats) -> torch.Tensor:
    return matvec(feats, w)


def _random_scores(table, feats, ents):
    safe = ents.clamp(min=0)
    per_row = torch.einsum("nd,nd->n", feats, table[safe])
    return torch.where(ents >= 0, per_row, 0.0)


def _compact_table(table: np.ndarray):
    """Host-side (E, d) -> padded (E, k) (columns, values) with k = max
    nonzeros per entity; column pad = d (sorts after every real id),
    value pad = 0. Per-entity columns come out ASCENDING (np.nonzero row
    order), which the searchsorted join below requires."""
    t = np.asarray(table)
    e, d = t.shape
    ent, col = np.nonzero(t)
    counts = np.bincount(ent, minlength=e)
    k = max(int(counts.max()) if counts.size else 1, 1)
    cols = np.full((e, k), d, np.int32)
    vals = np.zeros((e, k), t.dtype)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = np.arange(ent.size) - starts[ent]
    cols[ent, slot] = col
    vals[ent, slot] = t[ent, col]
    return cols, vals


# compaction results keyed by id(table) with WEAK references: entries die
# with their table, and the weakref identity check guards against id
# recycling. A tensor's entry also holds its ``_version`` counter, which
# every in-place edit bumps, so an edited tensor is compacted again.
_COMPACT_CACHE: Dict[int, tuple] = {}


def _cacheable_numpy(p) -> bool:
    """numpy is cacheable only when neither the array NOR any base it
    views is writeable (a read-only view over a writeable base still
    changes under the caller's feet)."""
    return (
        isinstance(p, np.ndarray)
        and not p.flags.writeable
        and (
            p.base is None
            or not getattr(p.base, "flags", np.ones(1).flags).writeable
        )
    )


def _compact_table_cached(p) -> CompactReTable:
    """Per-coordinate cache around ``_compact_table``: without it every
    ``score_game_data`` call re-densifies the full (E, d) table on the
    host and re-runs np.nonzero.

    Tensors are cached by identity and version; numpy only when it is
    read-only all the way down. A writeable numpy table is compacted on
    every call, since it may be mutated in place between calls. Callers
    who score the same wide table repeatedly can pre-compact once into a
    :class:`CompactReTable`."""
    is_tensor = torch.is_tensor(p)
    if not (is_tensor or _cacheable_numpy(p)):
        return CompactReTable(*_compact_table(np.asarray(p)))
    version = p._version if is_tensor else None
    key = id(p)
    hit = _COMPACT_CACHE.get(key)
    if hit is not None and hit[0]() is p and hit[1] == version:
        return hit[2]
    compact = CompactReTable(*_compact_table(to_numpy(p) if is_tensor else p))
    try:
        ref = weakref.ref(p, lambda _, k=key: _COMPACT_CACHE.pop(k, None))
    except TypeError:  # referent type without weakref support
        return compact
    _COMPACT_CACHE[key] = (ref, version, compact)
    return compact


def _random_scores_sparse(cols_tab, vals_tab, feats, ents):
    """Wide random effect over a padded-ELL shard: x_i . w_{e_i} through
    the COMPACT per-entity coefficient tables ((E, k) columns + values;
    back-projected tables are zero outside each entity's active union, so
    k is small even when d is huge). Gathers O(n * k) and joins by a
    per-row searchsorted against the entity's sorted columns."""
    safe_e = ents.clamp(min=0)
    ec = cols_tab[safe_e]  # (n, kt) the row's entity's active columns
    ev = vals_tab[safe_e]
    idx = feats.indices  # (n, ke); padding slots hold d
    loc = torch.searchsorted(ec, idx)
    loc = loc.clamp(0, ec.shape[1] - 1)
    hit = torch.gather(ec, 1, loc) == idx
    # entry padding (idx == d) can only hit a column pad (value 0): 0
    # contribution either way
    coef = torch.where(hit, torch.gather(ev, 1, loc), 0.0)
    per_row = torch.sum(feats.values * coef, dim=-1)
    return torch.where(ents >= 0, per_row, 0.0)


def _random_scores_compact_dense(cols_tab, vals_tab, feats, ents):
    """x_i . w_{e_i} through a :class:`CompactReTable` against DENSE
    per-row features: gather the entity's k active (column, value) pairs
    and pick those columns out of the dense row. Column pad d is out of
    range for the (n, d) row: clamp the gather; its value pad 0 zeroes
    the term."""
    safe_e = ents.clamp(min=0)
    ec = cols_tab[safe_e]  # (n, k) active columns of the row's entity
    ev = vals_tab[safe_e]  # (n, k) matching coefficients
    picked = torch.gather(feats, 1, ec.clamp(max=feats.shape[1] - 1).long())
    per_row = torch.sum(picked * ev, dim=-1)
    return torch.where(ents >= 0, per_row, 0.0)


def _factored_scores(gamma, projection, feats, ents):
    """score = (x B) . gamma_e without materializing B gamma^T
    (``FactoredRandomEffectCoordinate`` scoring contraction)."""
    latent = feats @ projection  # (n, k)
    safe = ents.clamp(min=0)
    per_row = torch.einsum("nk,nk->n", latent, gamma[safe])
    return torch.where(ents >= 0, per_row, 0.0)


def score_game_data(
    params: Dict[str, object],
    shards: Dict[str, str],
    random_effects: Dict[str, Optional[str]],
    data: GameData,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> torch.Tensor:
    """Sum of all coordinates' scores for every row, as an (n,) tensor on
    ``device`` (margins WITHOUT the data offsets; add ``data.offsets`` for
    the full margin). Rows whose entity is unknown to a random effect
    contribute 0 for that coordinate (``RandomEffectModel.scala:117-146``).

    ``device=None`` means CUDA, and raises when no card is present."""
    device = resolve_device(device)
    total = torch.zeros((data.num_rows,), dtype=dtype, device=device)
    for name, p in params.items():
        shard = shards[name]
        raw = data.features[shard]
        if is_hybrid(raw):
            # HybridFeatures rows live in a permuted order private to the
            # GLM training batch; GAME scoring sums coordinates by ROW
            raise ValueError(
                f"shard {shard!r} is a HybridFeatures container; GAME "
                "shards must be dense or plain ELL (row-aligned)"
            )
        re_key = random_effects.get(name)
        factored = is_factored_params(p)
        if re_key is not None and is_structured(raw) and factored:
            raise ValueError(
                f"coordinate {name!r}: factored effects need the dense "
                f"per-row latent projection; shard {shard!r} is sparse"
            )
        feats = cast_values(raw, dtype, device)
        if re_key is None:
            total = total + _fixed_scores(_placed(p, dtype, device), feats)
            continue
        ents = _placed(data.entity_ids[re_key], torch.int64, device)
        if factored:
            total = total + _factored_scores(
                _placed(p.gamma, dtype, device),
                _placed(p.projection, dtype, device),
                feats,
                ents,
            )
        elif isinstance(p, CompactReTable) or is_structured(raw):
            compact = p if isinstance(p, CompactReTable) else _compact_table_cached(p)
            scorer = (
                _random_scores_sparse
                if is_structured(raw)
                else _random_scores_compact_dense
            )
            total = total + scorer(
                _placed(compact.columns, torch.int32, device),
                _placed(compact.values, dtype, device),
                feats,
                ents,
            )
        else:
            total = total + _random_scores(_placed(p, dtype, device), feats, ents)
    return total


def compact_table_rows(rows: np.ndarray, k: int):
    """Compact a BLOCK of dense table rows at a FORCED width ``k``
    (columns ascending, pad column = d, pad value = 0): exactly
    ``_compact_table``'s per-row output, but with ``k`` imposed by the
    caller so every shard of a partitioned table compacts to one shape.
    Raises when a row holds more than ``k`` nonzeros."""
    t = np.asarray(rows)
    e, d = t.shape
    cols = np.full((e, k), d, np.int32)
    vals = np.zeros((e, k), t.dtype)
    if e == 0:
        return cols, vals
    ent, col = np.nonzero(t)
    counts = np.bincount(ent, minlength=e)
    if counts.size and int(counts.max()) > k:
        raise ValueError(
            f"row with {int(counts.max())} nonzeros cannot compact at "
            f"width k={k}"
        )
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = np.arange(ent.size) - starts[ent]
    cols[ent, slot] = col
    vals[ent, slot] = t[ent, col]
    return cols, vals


def shard_compact_table(compact: CompactReTable, assignment) -> CompactReTable:
    """Reorder a GLOBAL :class:`CompactReTable` into the stored
    (shard-major, padded) layout of an ``EntityShardAssignment``
    (``photon_ml_tpu/game/scoring.py:265``): shard p's entities contiguous
    in block ``[p*R, (p+1)*R)``, pad rows all-zero (they score 0 wherever
    gathered). Host numpy in, host numpy out."""
    cols = to_numpy(compact.columns, np.int32)
    vals = to_numpy(compact.values)
    out_c = np.zeros((assignment.padded_rows,) + cols.shape[1:], cols.dtype)
    out_v = np.zeros((assignment.padded_rows,) + vals.shape[1:], vals.dtype)
    real = assignment.stored_to_global < assignment.num_entities
    out_c[real] = cols[assignment.stored_to_global[real]]
    out_v[real] = vals[assignment.stored_to_global[real]]
    return CompactReTable(columns=out_c, values=out_v)


def precompact_model(params: Dict[str, object]) -> Dict[str, object]:
    """Replace every (E, d) random-effect coefficient table with its
    :class:`CompactReTable`: pre-compact ONCE instead of leaning on the
    identity-keyed cache per call. Fixed-effect vectors (1-D), factored
    params and already-compact tables pass through unchanged."""
    out: Dict[str, object] = {}
    for name, p in params.items():
        if (
            isinstance(p, CompactReTable)
            or is_factored_params(p)
            or (p.dim() if torch.is_tensor(p) else np.ndim(p)) != 2
        ):
            out[name] = p
        else:
            out[name] = _compact_table_cached(p)
    return out
