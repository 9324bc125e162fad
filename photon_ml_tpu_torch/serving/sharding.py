"""Entity-sharded serving: random-effect tables split by entity over P
shards, with shard-routed batches (counterpart of
``photon_ml_tpu/serving/sharding.py``).

The unsharded :class:`~photon_ml_tpu_torch.serving.engine.ScoringEngine`
keeps every compact random-effect table whole on one device, so serving
capacity is bounded by one card's memory. This engine splits each table's
rows over P shards:

- **Ownership is the checkpoint rule.** Entity -> shard is the round-robin
  rule of sharded checkpoints and entity-sharded training
  (``io.checkpoint.shard_rows`` through ``game.data.entity_shard_assignment``):
  device layout, checkpoint layout and request routing come from one rule.
- **Shard-routed batches.** :func:`route_batch` groups a batch's rows by
  owning shard; each shard's sub-batch pads to one shared power-of-two
  bucket, so routed traffic rides the engine's bucket ladder and builds
  nothing after warmup. A request whose entities span shards is placed on
  every owner shard; the partial scores merge on the host in ascending
  shard order, the fixed effect counted once, on the lowest owner shard.
- **No collective.** Shard p's block is on ``devices[p]`` (a list that may
  repeat a device). The blocks that share a device are one contiguous
  table there, their sub-batches one (m * bucket)-row batch, scored by one
  gather and dot per coordinate (the plain tensor operations of
  :mod:`photon_ml_tpu_torch.game.scoring`, as the JAX package scores
  outside any Pallas kernel); only the per-request merge of the (P, bucket)
  partials crosses shards, on the host.
- **Sharded loading.** :func:`load_sharded_re_table` assembles a serving
  shard set straight from a sharded checkpoint step
  (``step-<N>/shard-<p>-of-<P>.npz`` with its quorum manifest), one
  checkpoint shard file at a time: the dense (E, d) table is never held,
  and the serving shard count may differ from the checkpoint's.

Fault site ``serving.shard_route`` (key = shard index) is probed once per
shard per routed batch: a raise- or corrupt-mode fault marks that shard
down for the batch, its entities score fixed-effect-only (the cold-start
answer) and every request still completes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.game.data import EntityShardAssignment, entity_shard_assignment
from photon_ml_tpu_torch.game.factored import is_factored_params
from photon_ml_tpu_torch.game.scoring import (
    CompactReTable,
    _factored_scores,
    _fixed_scores,
    _placed,
    _random_scores_compact_dense,
    compact_table_rows,
    precompact_model,
    shard_compact_table,
)
from photon_ml_tpu_torch.resilience import faults as _faults
from photon_ml_tpu_torch.serving.engine import ScoringEngine, _host_tensor, bucket_size
from photon_ml_tpu_torch.serving.stats import record_build
from photon_ml_tpu_torch.utils.device import to_numpy

__all__ = [
    "ShardedCompactTable",
    "RoutedBatch",
    "route_batch",
    "ShardedScoringEngine",
    "load_sharded_re_table",
    "iter_checkpoint_re_blocks",
]

CACHE_REFUSAL = (
    "the tiered HBM/host cache composes with the unsharded "
    "engine; on a sharded mesh each shard's slice IS the "
    "resident set (drop hbm_cache_entities or num_shards)"
)


@dataclasses.dataclass(frozen=True)
class ShardedCompactTable:
    """A compact RE table already in the stored (shard-major, padded)
    layout of ``assignment``: what the sharded-checkpoint loader produces
    and what :class:`ShardedScoringEngine` pins as it is
    (``photon_ml_tpu/serving/sharding.py:83``)."""

    columns: np.ndarray  # (padded_rows, k) int32, shard-major
    values: np.ndarray  # (padded_rows, k)
    assignment: EntityShardAssignment


# ---------------------------------------------------------------------------
# shard routing (the serving analog of game.data.entity_partition_rows)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoutedBatch:
    """One batch's rows grouped by owning shard
    (``photon_ml_tpu/serving/sharding.py:100``).

    Placements: each (row, shard) pair where the row has work on that
    shard: its primary placement (fixed effect and every RE coordinate
    owned there) plus one placement per additional owner shard of its
    entities. Sorted by (row, shard), so the merge adds partial scores in
    ascending shard order per request."""

    num_rows: int
    num_shards: int
    bucket: int
    p_row: np.ndarray  # (M,) original batch row of each placement
    p_shard: np.ndarray  # (M,) owner shard of each placement
    p_slot: np.ndarray  # (M,) slot within the shard's padded sub-batch
    fixed_mask: np.ndarray  # (M,) 1.0 on the primary placement
    ents: Dict[str, np.ndarray]  # re_key -> (M,) shard-local ids (-1 off)
    counts: np.ndarray  # (P,) placements per shard
    down_shards: Tuple[int, ...]  # shards degraded by a routing fault
    degraded_rows: int  # placements whose RE gathers were dropped

    def scatter_feats(self, features: Dict[str, np.ndarray], dtype) -> Dict[str, np.ndarray]:
        """(B, d) per shard name -> routed (P, bucket, d); pad slots stay
        zero (they score 0 and carry fixed_mask 0)."""
        out = {}
        for name, x in features.items():
            x = np.asarray(x, dtype)
            routed = np.zeros((self.num_shards, self.bucket) + x.shape[1:], dtype)
            routed[self.p_shard, self.p_slot] = x[self.p_row]
            out[name] = routed
        return out

    def routed_entities(self) -> Dict[str, np.ndarray]:
        """Shard-local entity ids as routed (P, bucket) int32 (-1 on pad
        slots and on placements that do not own the key)."""
        out = {}
        for rk, e in self.ents.items():
            routed = np.full((self.num_shards, self.bucket), -1, np.int32)
            routed[self.p_shard, self.p_slot] = e
            out[rk] = routed
        return out

    def routed_fixed_mask(self, dtype) -> np.ndarray:
        routed = np.zeros((self.num_shards, self.bucket), dtype)
        routed[self.p_shard, self.p_slot] = self.fixed_mask
        return routed

    def merge(self, partials: np.ndarray) -> np.ndarray:
        """(P, bucket) per-shard partial scores -> (B,) per-request scores:
        the one step that crosses shards, summed on the host in placement
        order (ascending shard within each request)."""
        t0 = time.perf_counter()
        with obs.span("serving.route.merge", cat="serving", rows=self.num_rows,
                      shards=self.num_shards):
            out = np.zeros(self.num_rows, partials.dtype)
            np.add.at(out, self.p_row, partials[self.p_shard, self.p_slot])
        obs.registry().observe("serving.route.merge_ms", (time.perf_counter() - t0) * 1e3)
        return out


def route_batch(
    entity_ids: Dict[str, Optional[np.ndarray]],
    assignments: Dict[str, EntityShardAssignment],
    num_rows: int,
    num_shards: int,
    min_bucket: int = 8,
) -> RoutedBatch:
    """Group ``num_rows`` batch rows by owning shard
    (``photon_ml_tpu/serving/sharding.py:175``).

    A row's primary shard is the lowest shard owning any of its known
    entities (all-cold rows go round-robin by row index: they score
    fixed-effect-only, so any shard balances); additional owner shards get
    secondary placements carrying only the RE keys they own. Probes
    ``serving.shard_route`` once per involved shard; a raise or corrupt
    fault marks the shard down (its RE gathers degrade to -1). The host
    cost is split into the ``serving.route.{group,pad}`` spans and ``_ms``
    histograms (``serving.route.merge`` is :meth:`RoutedBatch.merge`)."""
    t_group = time.perf_counter()
    owner: Dict[str, np.ndarray] = {}
    local: Dict[str, np.ndarray] = {}
    for rk, a in assignments.items():
        o = np.full(num_rows, -1, np.int64)
        l = np.full(num_rows, -1, np.int64)  # noqa: E741
        e = entity_ids.get(rk)
        if e is not None:
            e = np.asarray(e, np.int64)
            known = (e >= 0) & (e < a.num_entities)
            o[known] = a.owner_of_global(e[known])
            l[known] = a.local_of_global(e[known])
        owner[rk] = o
        local[rk] = l

    rows = np.arange(num_rows, dtype=np.int64)
    if owner:
        own_mat = np.stack([owner[rk] for rk in sorted(owner)])
        primary = np.where(own_mat >= 0, own_mat, num_shards).min(axis=0)
    else:
        primary = np.full(num_rows, num_shards, np.int64)
    cold = primary >= num_shards
    primary[cold] = rows[cold] % num_shards

    flat = [rows * num_shards + primary]
    for rk in sorted(owner):
        known = owner[rk] >= 0
        flat.append(rows[known] * num_shards + owner[rk][known])
    flat = np.unique(np.concatenate(flat))  # sorted => (row, shard) order
    p_row = flat // num_shards
    p_shard = (flat % num_shards).astype(np.int64)
    fixed_mask = (p_shard == primary[p_row]).astype(np.float64)

    # fault seam: per-shard routing. raise/corrupt = shard down for this
    # batch (entities degrade to fixed-effect-only, no request lost);
    # delay = a slow route leg
    down: List[int] = []
    for s in np.unique(p_shard).tolist():
        try:
            action = _faults.fire("serving.shard_route", key=str(s))
        except OSError:
            down.append(int(s))
        else:
            if action.corrupt:
                down.append(int(s))
    down_mask = np.isin(p_shard, down) if down else np.zeros(p_shard.shape, bool)

    ents: Dict[str, np.ndarray] = {}
    for rk in sorted(owner):
        e = np.full(p_row.shape, -1, np.int32)
        sel = (owner[rk][p_row] == p_shard) & ~down_mask
        e[sel] = local[rk][p_row[sel]].astype(np.int32)
        ents[rk] = e
    t_pad = time.perf_counter()

    counts = np.bincount(p_shard, minlength=num_shards)
    bucket = bucket_size(max(int(counts.max()), 1), min_bucket)
    order = np.argsort(p_shard, kind="stable")  # keeps (row, shard) order
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot = np.empty(p_row.shape, np.int64)
    slot[order] = np.arange(p_row.size) - starts[p_shard[order]]

    t_end = time.perf_counter()
    reg = obs.registry()
    reg.observe("serving.route.group_ms", (t_pad - t_group) * 1e3)
    reg.observe("serving.route.pad_ms", (t_end - t_pad) * 1e3)
    tracer = obs.get_tracer()
    if tracer is not None:
        # retro-emitted stage spans: group = ownership lookup, placements,
        # fault probes and RE ids; pad = bucket sizing and slots. The batch
        # identity (the trace join key) rides explicitly, since a retro
        # span does not merge the ambient context
        ctx = obs.current_span_context() or {}
        ctx_args = {"batch_id": ctx["batch_id"]} if "batch_id" in ctx else {}
        end_us = tracer.now_us()
        pad_us = (t_end - t_pad) * 1e6
        group_us = (t_pad - t_group) * 1e6
        tracer.add_span("serving.route.group", end_us - pad_us - group_us, group_us,
                        cat="serving", args={"rows": int(num_rows),
                                             "placements": int(p_row.size), **ctx_args})
        tracer.add_span("serving.route.pad", end_us - pad_us, pad_us, cat="serving",
                        args={"bucket": int(bucket), **ctx_args})

    return RoutedBatch(
        num_rows=num_rows,
        num_shards=num_shards,
        bucket=bucket,
        p_row=p_row,
        p_shard=p_shard,
        p_slot=slot,
        fixed_mask=fixed_mask,
        ents=ents,
        counts=counts,
        down_shards=tuple(down),
        degraded_rows=int(np.count_nonzero(down_mask)),
    )


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def shard_devices(num_shards: int, devices=None, device=None) -> List[torch.device]:
    """The device of each serving shard. ``devices``: an explicit list of
    ``num_shards`` devices (repeats allowed). Otherwise ``device`` pins
    every shard to it when it names one device (``"cpu"``, ``"cuda:0"``);
    with ``device`` None or ``"cuda"`` shard p goes to ``cuda:p``, and too
    few cards raise in the JAX package's words."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if len(out) != num_shards:
            raise ValueError(f"{num_shards} serving shards need {num_shards} devices, "
                             f"got a list of {len(out)}")
        return out
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return [dev] * num_shards
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if num_shards > have:
        raise ValueError(f"{num_shards} serving shards need {num_shards} devices, have {have}")
    return [torch.device("cuda", p) for p in range(num_shards)]


class _ShardedBucketScorer:
    """One padded bucket's prepared scorer for every device group: per
    group of m shards, its (m * bucket, d) feature buffers, (m * bucket,)
    entity buffers (group-local table rows) and fixed-effect mask; shard
    p's sub-batch is rows ``[j * bucket, (j + 1) * bucket)`` of its group,
    j its place there. A call copies each shard's placements into its rows
    (the rows past them zeroed, their entities -1), scores each group with
    one gather and dot per coordinate, and returns the (P, bucket) partials
    on the host. The rows are copied from the (B, d) batch, never through
    a routed (P, bucket, d) array."""

    def __init__(self, engine: "ShardedScoringEngine", bucket: int, dims: Dict[str, int]):
        self.bucket = bucket
        self.groups = []
        for device, members in engine._groups:
            rows = len(members) * bucket
            self.groups.append((
                {s: torch.zeros((rows, dims[s]), dtype=engine.dtype, device=device)
                 for s in engine._used_shards},
                {rk: torch.full((rows,), -1, dtype=torch.int64, device=device)
                 for rk in engine._re_keys},
                torch.zeros((rows,), dtype=engine.dtype, device=device),
            ))
        self._lock = threading.Lock()

    def __call__(self, engine: "ShardedScoringEngine", plan: Optional[RoutedBatch],
                 feats: Dict[str, np.ndarray]) -> np.ndarray:
        """``plan`` None: the build's trial run (every row a pad row)."""
        b = self.bucket
        partials = np.zeros((engine.num_shards, b), engine.np_dtype)
        if plan is not None:
            order = np.argsort(plan.p_shard, kind="stable")
            starts = np.concatenate([[0], np.cumsum(plan.counts)])
        with self._lock:
            outs = []
            for (device, members), (f_buf, e_buf, m_buf), params in zip(
                    engine._groups, self.groups, engine._group_params):
                for j, p in enumerate(members.tolist()):
                    # shard p's placements, in slot order
                    sel = (order[starts[p]:starts[p + 1]] if plan is not None
                           else np.zeros(0, np.int64))
                    n = sel.size
                    for s, buf in f_buf.items():
                        if n:
                            buf[j * b:j * b + n].copy_(_host_tensor(feats[s][plan.p_row[sel]]))
                        buf[j * b + n:(j + 1) * b].zero_()
                    for rk, buf in e_buf.items():
                        if n:
                            e = plan.ents[rk][sel].astype(np.int64)
                            r = engine.assignments[rk].rows_per_shard
                            # block j of the group starts at row j * R of its table
                            buf[j * b:j * b + n].copy_(
                                _host_tensor(np.where(e >= 0, e + j * r, -1)))
                        buf[j * b + n:(j + 1) * b].fill_(-1)
                    if n:
                        m_buf[j * b:j * b + n].copy_(
                            _host_tensor(plan.fixed_mask[sel].astype(engine.np_dtype)))
                    m_buf[j * b + n:(j + 1) * b].zero_()
                outs.append(engine._score_group(params, f_buf, e_buf, m_buf))
            for (_, members), out in zip(engine._groups, outs):
                partials[members] = to_numpy(out).reshape(len(members), b)
        return partials


class ShardedScoringEngine(ScoringEngine):
    """The entity-sharded serving engine
    (``photon_ml_tpu/serving/sharding.py:309``): RE table rows split
    round-robin over ``num_shards`` shards, shard p's block on
    ``devices[p]``; batches route per shard and score with no cross-shard
    collective. The resident RE bytes per shard drop about P times (the
    ``serving.shard.resident_re_bytes_per_process`` gauge holds one
    shard's block).

    The construction surface of :class:`ScoringEngine` plus ``num_shards``
    and ``devices`` (see :func:`shard_devices`; the fixed effects and
    factored projections are copied to each device);
    :meth:`from_sharded_checkpoint` stands one up from a sharded
    checkpoint step without holding the dense table. The tiered cache is
    refused: each shard's block is its resident set."""

    def __init__(
        self,
        params,
        shards,
        random_effects,
        shard_vocabs=None,
        re_vocabs=None,
        *,
        num_shards: int,
        devices=None,
        **kw,
    ):
        if kw.get("hbm_cache_entities"):
            raise ValueError(CACHE_REFUSAL)
        num_shards = int(num_shards)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self.devices = shard_devices(num_shards, devices, kw.get("device"))
        groups: Dict[torch.device, List[int]] = {}
        for p, dev in enumerate(self.devices):
            groups.setdefault(dev, []).append(p)
        # (device, its shards ascending), in the order of their first shard
        self._groups = [(dev, np.asarray(ps, np.int64)) for dev, ps in groups.items()]
        self.assignments: Dict[str, EntityShardAssignment] = {}
        kw["device"] = self.devices[0]
        super().__init__(params, shards, random_effects, shard_vocabs, re_vocabs, **kw)

    # -- construction hooks ------------------------------------------------

    def _placement_fingerprint(self) -> str:
        # a scorer's buffers are pinned to these devices and this split
        return "shards:" + ",".join(str(d) for d in self.devices) + f"/{self.num_shards}"

    def _precompact(self, params):
        pre = {n: p for n, p in params.items() if isinstance(p, ShardedCompactTable)}
        out = precompact_model({n: p for n, p in params.items() if n not in pre})
        out.update(pre)
        return out

    def _pin_params(self, compact):
        # one assignment per RE key (every coordinate sharing a key indexes
        # the same entity axis; a pre-sharded table brings its own, and
        # they must agree)
        for name in self._coord_order:
            re_key = self.random_effects.get(name)
            if re_key is None:
                continue
            p = compact[name]
            if isinstance(p, ShardedCompactTable):
                a = p.assignment
                if a.num_shards != self.num_shards:
                    raise ValueError(f"coordinate {name!r}: table pre-sharded at "
                                     f"{a.num_shards} shards, engine has {self.num_shards}")
            else:
                rows = int(np.shape(p.gamma if is_factored_params(p) else p.columns)[0])
                a = self.assignments.get(re_key) or entity_shard_assignment(
                    rows, self.num_shards)
            prev = self.assignments.setdefault(re_key, a)
            if prev.num_entities != a.num_entities:
                raise ValueError(f"coordinate {name!r}: {a.num_entities} entities, other "
                                 f"coordinates keyed {re_key!r} have {prev.num_entities}")

        # every table in its stored (shard-major) layout on the host
        stored: Dict[str, object] = {}
        re_bytes = 0
        for name in self._coord_order:
            p = compact[name]
            re_key = self.random_effects.get(name)
            if re_key is None:
                stored[name] = to_numpy(p, self.np_dtype)
                continue
            a = self.assignments[re_key]
            if is_factored_params(p):
                stored[name] = type(p)(
                    gamma=a.table_from_global(to_numpy(p.gamma, self.np_dtype)),
                    projection=to_numpy(p.projection, self.np_dtype))
                re_bytes += stored[name].gamma.nbytes // self.num_shards
                continue
            if not isinstance(p, ShardedCompactTable):
                p = shard_compact_table(p, a)
            stored[name] = CompactReTable(columns=to_numpy(p.columns, np.int32),
                                          values=to_numpy(p.values, self.np_dtype))
            re_bytes += (stored[name].columns.nbytes
                         + stored[name].values.nbytes) // self.num_shards

        def block_rows(x, re_key, members):
            r = self.assignments[re_key].rows_per_shard
            return np.concatenate([x[p * r:(p + 1) * r] for p in members])

        # each device group's blocks, contiguous on its device
        self._group_params = []
        for device, members in self._groups:
            out: Dict[str, object] = {}
            for name in self._coord_order:
                p = stored[name]
                re_key = self.random_effects.get(name)
                if re_key is None:
                    out[name] = _placed(p, self.dtype, device)
                elif is_factored_params(p):
                    out[name] = type(p)(
                        gamma=_placed(block_rows(p.gamma, re_key, members), self.dtype, device),
                        projection=_placed(p.projection, self.dtype, device))
                else:
                    out[name] = CompactReTable(
                        columns=_placed(block_rows(p.columns, re_key, members), torch.int32,
                                        device),
                        values=_placed(block_rows(p.values, re_key, members), self.dtype,
                                       device))
            self._group_params.append(out)
        # ONE shard's block: what each shard keeps resident
        self.stats.registry.set_gauge("serving.shard.resident_re_bytes_per_process", re_bytes)
        for device, _ in self._groups:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        # the first group's params: the fixed-effect-only scorer's
        return self._group_params[0]

    # -- scoring body ------------------------------------------------------

    def _score_group(self, params, feats, ents, mask):
        """One device group's routed rows: the fixed effects on the primary
        placements (``mask``), plus every RE coordinate through its block
        (rows whose key another shard owns carry -1 and score 0)."""
        fixed = torch.zeros(mask.shape, dtype=self.dtype, device=mask.device)
        total = torch.zeros_like(fixed)
        for name in self._coord_order:
            p = params[name]
            f = feats[self.shards[name]]
            re_key = self.random_effects.get(name)
            if re_key is None:
                fixed = fixed + _fixed_scores(p, f)
            elif is_factored_params(p):
                total = total + _factored_scores(p.gamma, p.projection, f, ents[re_key])
            else:
                total = total + _random_scores_compact_dense(p.columns, p.values, f,
                                                             ents[re_key])
        return mask * fixed + total

    def _build_scorer(self, bucket, dims, fixed_only):
        if fixed_only:
            # the degraded mode bypasses routing: plain padded batches
            # against the fixed params on the first device
            return super()._build_scorer(bucket, dims, fixed_only)
        t0 = time.perf_counter()
        dims = dims or {s: self._shard_dim(s) for s in self._used_shards}
        scorer = _ShardedBucketScorer(self, bucket, dims)
        scorer(self, None, {})
        record_build(bucket, False, time.perf_counter() - t0)
        return scorer

    # -- scoring -----------------------------------------------------------

    def score_arrays(
        self,
        features: Dict[str, np.ndarray],
        entity_ids: Optional[Dict[str, np.ndarray]] = None,
        offsets: Optional[np.ndarray] = None,
        fixed_only: bool = False,
    ) -> np.ndarray:
        if fixed_only:
            return super().score_arrays(features, entity_ids, offsets, fixed_only=True)
        entity_ids = entity_ids or {}
        missing = [s for s in self._used_shards if s not in features]
        if missing:
            raise KeyError(f"missing feature shard(s): {missing}")
        n = int(np.shape(features[self._used_shards[0]])[0])
        plan = route_batch({rk: entity_ids.get(rk) for rk in self._re_keys}, self.assignments,
                           n, self.num_shards, self.min_bucket)
        if plan.down_shards:
            self.stats.record_shard_degraded(plan.down_shards, plan.degraded_rows)
        # fault seam shared with the unsharded engine: raise-mode surfaces
        # through the batcher, corrupt-mode poisons the scores
        action = _faults.fire("serving.score", key=str(plan.bucket))
        feats_np = {s: np.asarray(features[s], self.np_dtype) for s in self._used_shards}
        scorer = self._ensure_compiled(plan.bucket,
                                       {s: feats_np[s].shape[1] for s in self._used_shards})
        with obs.span("serving.score", cat="serving", bucket=plan.bucket, rows=n,
                      shards=self.num_shards, fixed_only=False):
            t0 = time.perf_counter()
            out = plan.merge(scorer(self, plan, feats_np))
            if action.corrupt:
                out = np.full_like(out, np.nan)
            elapsed = time.perf_counter() - t0
            self.stats.record_bucket_latency(plan.bucket, elapsed)
            self.stats.record_shard_batch(plan.counts, elapsed)
        if offsets is not None:
            out = out + np.asarray(offsets, out.dtype)
        if self.drift is not None:
            self.drift.observe({s: np.asarray(features[s]) for s in self._used_shards}, out)
        return out

    def shard_presort_key(self, requests: Sequence[object]) -> np.ndarray:
        """Primary owner shard per request: the MicroBatcher's
        ``presort_fn``, so that routed sub-batches come out contiguous."""
        from photon_ml_tpu_torch.io.models import _maybe_int

        keys = np.full(len(requests), self.num_shards, np.int64)
        for i, r in enumerate(requests):
            best = self.num_shards
            for rk, a in self.assignments.items():
                raw = getattr(r, "entities", {}).get(rk)
                if raw is None:
                    continue
                vocab = self.re_vocabs.get(rk, {})
                e = vocab.get(raw)
                if e is None:
                    e = vocab.get(_maybe_int(raw))
                if e is not None and 0 <= e < a.num_entities:
                    best = min(best, int(a.owner_of_global(np.asarray([e]))[0]))
            keys[i] = best if best < self.num_shards else i % self.num_shards
        return keys

    # -- sharded-checkpoint construction -----------------------------------

    @classmethod
    def from_sharded_checkpoint(
        cls,
        step_dir: str,
        shards: Dict[str, str],
        random_effects: Dict[str, Optional[str]],
        shard_vocabs=None,
        *,
        num_shards: int,
        **kw,
    ) -> "ShardedScoringEngine":
        """An engine from one sharded checkpoint step (``step-<N>/`` with
        its quorum manifest; ``photon_ml_tpu/serving/sharding.py:678``).
        Entity-sharded tables stream in one checkpoint shard file at a time
        (:func:`load_sharded_re_table`); the serving shard count may differ
        from the checkpoint's. Entity vocabularies come from the manifest's
        entity-key order, so restored rows attach to the right entities at
        any width."""
        manifest = _read_step_manifest(step_dir)
        kinds = manifest.get("param_kinds", {})
        sharding = manifest.get("param_sharding", {})
        params: Dict[str, object] = {}
        re_vocabs: Dict[str, dict] = {}
        shard0 = None
        for name, re_key in random_effects.items():
            if name not in manifest.get("param_names", []):
                raise ValueError(f"coordinate {name!r} not in checkpoint {step_dir!r} "
                                 f"(has {manifest.get('param_names')})")
            if kinds.get(name) == "factored":
                raise ValueError(f"coordinate {name!r}: factored params load through the "
                                 "export path, not the sharded checkpoint loader")
            if re_key is None or sharding.get(name) != "entity":
                if shard0 is None:
                    shard0 = _load_shard_npz(step_dir, 0)
                params[name] = np.asarray(shard0[f"param/{name}"])
                continue
            table, ekeys = load_sharded_re_table(step_dir, name, num_shards)
            params[name] = table
            vocab = {k: i for i, k in enumerate(ekeys)}
            prev = re_vocabs.setdefault(re_key, vocab)
            if prev != vocab:
                raise ValueError(f"coordinates keyed {re_key!r} disagree on the "
                                 "checkpoint's entity order")
        return cls(params, shards, random_effects, shard_vocabs, re_vocabs,
                   num_shards=num_shards, **kw)


# ---------------------------------------------------------------------------
# sharded-checkpoint streaming loader
# ---------------------------------------------------------------------------


def _read_step_manifest(step_dir: str) -> dict:
    with open(os.path.join(step_dir, "manifest.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    if manifest.get("format") != "sharded":
        raise ValueError(f"{step_dir!r} is not a sharded checkpoint step")
    return manifest


def _load_shard_npz(step_dir: str, p: int):
    num = int(_read_step_manifest(step_dir)["shards"])
    return np.load(os.path.join(step_dir, f"shard-{p}-of-{num}.npz"))


def iter_checkpoint_re_blocks(step_dir: str, name: str):
    """Yield ``(global_rows, block)`` per checkpoint shard file for one
    entity-sharded table, one file resident at a time
    (``photon_ml_tpu/serving/sharding.py:759``). Row ownership comes from
    the shared round-robin rule, so it holds at any width."""
    from photon_ml_tpu_torch.io.checkpoint import shard_rows

    manifest = _read_step_manifest(step_dir)
    num = int(manifest["shards"])
    ekeys = manifest.get("entity_keys", {}).get(name)
    if not ekeys:
        raise ValueError(f"coordinate {name!r} is not entity-sharded in {step_dir!r}")
    e = len(ekeys)
    for p in range(num):
        npz = np.load(os.path.join(step_dir, f"shard-{p}-of-{num}.npz"))
        key = f"param/{name}"
        if key not in npz:
            continue
        rows = np.asarray(list(shard_rows(e, p, num)), np.int64)
        yield rows, np.asarray(npz[key])


def load_sharded_re_table(
    step_dir: str,
    name: str,
    num_shards: int,
    k: Optional[int] = None,
    only_shard: Optional[int] = None,
) -> Tuple[ShardedCompactTable, List[str]]:
    """One coordinate's serving shard set straight from a sharded
    checkpoint (``photon_ml_tpu/serving/sharding.py:783``), without the
    dense (E, d) table: each checkpoint block compacts on its own at a
    shared width ``k`` (two streaming passes: the widest row, then the
    fill). Returns ``(ShardedCompactTable, entity_keys)`` in the
    manifest's entity order; with ``only_shard`` the compact arrays cover
    that serving shard's block alone (peak memory O(E/P))."""
    manifest = _read_step_manifest(step_dir)
    ekeys = manifest.get("entity_keys", {}).get(name)
    if not ekeys:
        raise ValueError(f"coordinate {name!r} is not entity-sharded in {step_dir!r}")
    e = len(ekeys)
    assignment = entity_shard_assignment(e, num_shards)
    if k is None:
        k = 1
        for _, block in iter_checkpoint_re_blocks(step_dir, name):
            if block.size:
                nnz = (block != 0).sum(axis=1)
                k = max(k, int(nnz.max()) if nnz.size else 1)
    lo, hi = 0, assignment.padded_rows
    if only_shard is not None:
        lo = only_shard * assignment.rows_per_shard
        hi = lo + assignment.rows_per_shard
    cols = None
    vals = None
    for rows, block in iter_checkpoint_re_blocks(step_dir, name):
        if vals is None:
            cols = np.zeros((hi - lo, k), np.int32)
            vals = np.zeros((hi - lo, k), block.dtype)
        stored = assignment.global_to_stored[rows]
        keep = (stored >= lo) & (stored < hi)
        if not np.any(keep):
            continue
        bc, bv = compact_table_rows(block[keep], k)
        cols[stored[keep] - lo] = bc
        vals[stored[keep] - lo] = bv
    if vals is None:
        raise ValueError(f"no shard file of {step_dir!r} carries coordinate {name!r}")
    return (ShardedCompactTable(columns=cols, values=vals, assignment=assignment),
            [str(key) for key in ekeys])
