"""Deterministic fault injection for the training runtime (a copy of
``photon_ml_tpu/resilience/faults.py``, with the same site names; an
injection is recorded in the port's ``obs``).

The reference's fault-tolerance story is Spark lineage recompute — and
``data/RandomEffectDataSet.scala:282-286`` documents a bug in exactly that
strategy (SURVEY §5.3-5.4). A TPU rebuild has no lineage, so every
durability path (checkpoint write/load, ingest reads, coordinate updates)
must be *testable under failure*. This module is that test harness: a
process-global registry of named fault SITES that production code probes
with :func:`fire`, and that tests (or an operator drill via the
``PHOTON_FAULTS`` env var) arm with :class:`FaultSpec` entries.

Sites in-tree today::

    checkpoint.save         between the temp-dir write and the atomic swap
    checkpoint.load         per step-directory load attempt
    checkpoint.async_write  the background serialize/swap of the overlapped
                            GAME checkpoint writer (key = none)
    ingest.read             per input-file decode
    descent.update          per coordinate update (key = coordinate name)
    serving.score           per device scoring call (key = padded bucket)
    serving.reload          per registry load/warmup attempt (key = version)
    pipeline.decode         per decode-pool group attempt (key = chunk index)
    pipeline.transfer       per staged-chunk device transfer (key = chunk)
    collective.allreduce    per multihost host-collective exchange
    collective.stall        inside each watchdogged collective attempt
                            (key = exchange label; delay = straggler host,
                            raise = peer died mid-exchange)
    heartbeat.miss          per peer per heartbeat poll (key = peer index;
                            raise = peer went silent, delay = straggler)
    checkpoint.shard_write  per per-process checkpoint shard write
                            (key = shard index; corrupt = torn shard)
    quality.baseline        per quality-fingerprint load attempt
                            (key = export dir name; raise = unreadable,
                            corrupt = torn/garbage fingerprint — serving
                            must continue WITHOUT drift monitoring)
    serving.shard_route     per shard per routed batch of the entity-
                            sharded engine (key = shard index; raise/
                            corrupt = shard down — its entities degrade
                            to fixed-effect-only, zero lost requests;
                            delay = a slow route leg)
    serving.cache_tier      per tiered-cache promotion batch (key = RE
                            key; raise = failed host->HBM copy — the
                            entities stay cold and serve fixed-effect-
                            only; delay = a slow tier)
    cache.admission_log     per admission-log flush (key = log path;
                            raise = failed atomic-swap write — entries
                            stay in memory and the next flush retries;
                            scoring is never touched)
    retrain.warm_start      per lifecycle warm-start load (key = export
                            dir; raise/corrupt = unreadable or torn
                            prior export — the cycle fails, the old
                            model keeps serving, the alarm stays
                            latched)
    retrain.export          per lifecycle re-export (key = output dir;
                            raise = export died mid-write — no manifest
                            lands, so the registry never loads the
                            partial dir; corrupt = torn payload the
                            manifest gate / reload breaker must catch)
    frontend.accept         per accepted front-end connection (key =
                            peer address; raise = drop the connection
                            at accept — the listener and every other
                            connection keep serving; delay = slow
                            accept path)
    tenant.quota            per tenant admission quota check (key =
                            tenant name; raise = quota check fails
                            CLOSED — the request is rejected, never
                            silently admitted past quota; corrupt =
                            force the over-quota mark)
    replica.route           per routed batch attempt (key = replica
                            name; raise = replica died mid-batch — the
                            router must fail over with zero lost
                            requests; delay = a slow replica skewing
                            the load view)

Arming a site OUTSIDE this list raises at arm time: a typo'd drill that
silently probes nothing would "pass" by testing nothing. Libraries that
grow new seams register them via :func:`register_site`.

Modes:

- ``raise``   — raise :class:`InjectedFault` (an ``OSError``, so the
  retry layer treats it as transient I/O).
- ``corrupt`` — signal the call site to corrupt its payload: flip bytes
  in a written file (torn write) or poison an update with non-finites.
- ``delay``   — sleep ``delay`` seconds (stall, for deadline tests).

Triggers are deterministic: ``nth`` fires on the Nth probe of the site
(1-based, ``count`` consecutive probes, ``count=-1`` forever), ``p``
fires with seeded probability per probe. Sites with no armed spec cost
one dict lookup — the registry is empty unless armed, so production
runs pay nothing.

Env spec grammar (``;``-separated)::

    PHOTON_FAULTS="checkpoint.save:raise@n=2;ingest.read:delay@p=0.1,seed=7,delay=0.2"
    PHOTON_FAULTS="descent.update:corrupt@n=3,count=-1,key=per-user"

Tests prefer the :func:`inject` context manager, which arms specs and
restores the previous registry state on exit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import time
from typing import Dict, List, Optional

ENV_VAR = "PHOTON_FAULTS"

KNOWN_SITES = (
    "checkpoint.save",
    "checkpoint.load",
    "checkpoint.async_write",
    "ingest.read",
    "descent.update",
    "serving.score",
    "serving.reload",
    "pipeline.decode",
    "pipeline.transfer",
    "collective.allreduce",
    "collective.stall",
    "heartbeat.miss",
    "checkpoint.shard_write",
    "quality.baseline",
    "partition.shard_skew",
    "serving.shard_route",
    "serving.cache_tier",
    "cache.admission_log",
    "retrain.warm_start",
    "retrain.export",
    "frontend.accept",
    "tenant.quota",
    "replica.route",
)

MODES = ("raise", "corrupt", "delay")

# extension point: seams registered at runtime (plugins, tests for
# not-yet-promoted sites) — validated exactly like KNOWN_SITES
_EXTRA_SITES: set = set()


def register_site(site: str) -> None:
    """Declare an additional drillable site (idempotent). Arm-time
    validation accepts KNOWN_SITES plus everything registered here."""
    if not site or not isinstance(site, str):
        raise ValueError(f"fault site must be a non-empty string: {site!r}")
    _EXTRA_SITES.add(site)


def known_sites() -> tuple:
    """Every site an arm() will accept, sorted."""
    return tuple(sorted(set(KNOWN_SITES) | _EXTRA_SITES))


def registered_sites() -> tuple:
    """The machine-readable site registry: the single source of truth
    shared by arm-time validation, the ``photon-chaos sites`` listing,
    the docs/ROBUSTNESS.md site table, and the ``photon-lint`` PL003
    rule (a ``fire("...")``/``FaultSpec("...")`` literal outside this
    set is a build-time error, not an arm-time one). Alias of
    :func:`known_sites`, exported under the name the consumers bind."""
    return known_sites()


class UnknownFaultSite(ValueError):
    """Armed a site no production code probes — the drill would test
    nothing. Carries the valid-site list so the typo is obvious."""

    def __init__(self, site: str):
        super().__init__(
            f"unknown fault site {site!r}; known sites: "
            f"{', '.join(known_sites())} (register_site() adds new seams)"
        )
        self.site = site


def _note_injection(
    site: str, mode: str, call: int, key: Optional[str]
) -> None:
    """Record a triggered injection in the obs layer. Import is deferred:
    the registry/tracer are only touched when a drill actually fires, so
    unarmed production probes stay one dict lookup."""
    from photon_ml_tpu_torch import obs

    obs.registry().inc("resilience.faults_injected")
    obs.registry().inc(f"resilience.faults_injected.{site}")
    obs.emit_event(
        "resilience.fault_injected",
        cat="resilience",
        site=site,
        mode=mode,
        call=call,
        key=key,
    )


class InjectedFault(OSError):
    """Raised by an armed ``raise``-mode fault. Subclasses OSError so the
    retry layer classifies it as transient I/O — injected crashes exercise
    the same recovery path as real ones."""

    def __init__(self, site: str, call: int):
        super().__init__(f"injected fault at site {site!r} (call #{call})")
        self.site = site
        self.call = call


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: where, how, and when it triggers."""

    site: str
    mode: str  # raise | corrupt | delay
    nth: Optional[int] = None  # 1-based call index to trigger on
    count: int = 1  # consecutive triggers from nth (-1 = forever)
    p: Optional[float] = None  # per-call probability (needs seed)
    seed: int = 0
    delay: float = 0.05  # seconds, delay mode
    key: Optional[str] = None  # context filter (e.g. coordinate name)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"fault mode must be one of {MODES}: {self.mode!r}")
        if (self.nth is None) == (self.p is None):
            raise ValueError(
                f"exactly one of nth= / p= must be set: {self}"
            )
        self._rng = random.Random(self.seed)

    def triggers(self, call: int, key: Optional[str]) -> bool:
        if self.key is not None and key != self.key:
            return False
        if self.nth is not None:
            if call < self.nth:
                return False
            return self.count < 0 or call < self.nth + self.count
        return self._rng.random() < self.p


@dataclasses.dataclass
class FaultAction:
    """What :func:`fire` tells the call site to do. ``raise``/``delay``
    are handled inside fire(); ``corrupt`` is the site's job (only it
    knows its payload)."""

    corrupt: bool = False

    def __bool__(self) -> bool:
        return self.corrupt


class FaultInjector:
    """Registry + per-site probe counters. One process-global instance
    (:data:`registry`); tests swap state via :func:`inject`."""

    def __init__(self):
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._calls: Dict[str, int] = {}

    def arm(self, spec: FaultSpec) -> None:
        # validate at arm time: a typo'd site would otherwise sit inert
        # in the registry and the drill would "pass" by testing nothing
        if spec.site not in KNOWN_SITES and spec.site not in _EXTRA_SITES:
            raise UnknownFaultSite(spec.site)
        self._specs.setdefault(spec.site, []).append(spec)

    def clear(self) -> None:
        self._specs.clear()
        self._calls.clear()

    def active(self) -> bool:
        return bool(self._specs)

    def calls(self, site: str) -> int:
        return self._calls.get(site, 0)

    def fire(self, site: str, key: Optional[str] = None) -> FaultAction:
        """Probe ``site``: increments its counter, raises / sleeps for
        armed raise/delay specs, and returns whether the site should
        corrupt its payload. No armed specs -> one dict lookup. Every
        TRIGGERED spec lands in the obs layer (counter + instant event):
        a drill whose injections aren't visible in the trace can't be
        told apart from a drill that never fired."""
        specs = self._specs.get(site)
        if not specs:
            return FaultAction()
        call = self._calls.get(site, 0) + 1
        self._calls[site] = call
        action = FaultAction()
        for spec in specs:
            if not spec.triggers(call, key):
                continue
            _note_injection(site, spec.mode, call, key)
            if spec.mode == "raise":
                raise InjectedFault(site, call)
            if spec.mode == "delay":
                time.sleep(spec.delay)
            elif spec.mode == "corrupt":
                action.corrupt = True
        return action


registry = FaultInjector()


def fire(site: str, key: Optional[str] = None) -> FaultAction:
    """Module-level probe used by production call sites."""
    return registry.fire(site, key)


def corrupt_file(path: str, offset: int = -16, nbytes: int = 8) -> None:
    """Flip ``nbytes`` bytes of ``path`` in place (default: near the end,
    the torn-write shape). The canonical payload corruption for
    ``corrupt``-mode faults on file-writing sites."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return
        pos = offset if offset >= 0 else max(0, size + offset)
        f.seek(pos)
        chunk = f.read(nbytes)
        f.seek(pos)
        f.write(bytes(b ^ 0xFF for b in chunk))


def parse_spec(text: str) -> List[FaultSpec]:
    """Parse the ``PHOTON_FAULTS`` grammar into specs (see module doc)."""
    specs: List[FaultSpec] = []
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        try:
            site_mode, _, argstr = part.partition("@")
            site, _, mode = site_mode.partition(":")
            kwargs: Dict[str, object] = {}
            for kv in filter(None, argstr.split(",")):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k in ("nth", "n"):
                    kwargs["nth"] = int(v)
                elif k == "count":
                    kwargs["count"] = int(v)
                elif k == "p":
                    kwargs["p"] = float(v)
                elif k == "seed":
                    kwargs["seed"] = int(v)
                elif k == "delay":
                    kwargs["delay"] = float(v)
                elif k == "key":
                    kwargs["key"] = v
                else:
                    raise ValueError(f"unknown fault arg {k!r}")
            specs.append(FaultSpec(site=site.strip(), mode=mode.strip(), **kwargs))
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"bad {ENV_VAR} entry {part!r}: {e}"
            ) from e
    return specs


def arm_from_env(injector: Optional[FaultInjector] = None) -> int:
    """Arm specs from ``PHOTON_FAULTS`` (operator drills on a real
    deployment). Returns the number of specs armed."""
    injector = injector or registry
    text = os.environ.get(ENV_VAR, "")
    specs = parse_spec(text) if text else []
    for s in specs:
        injector.arm(s)
    return len(specs)


@contextlib.contextmanager
def inject(*specs: FaultSpec):
    """Arm ``specs`` on the global registry for the block, restoring the
    previous specs AND counters on exit — tests never leak faults."""
    prev_specs = {k: list(v) for k, v in registry._specs.items()}
    prev_calls = dict(registry._calls)
    registry.clear()
    for s in specs:
        registry.arm(s)
    try:
        yield registry
    finally:
        registry.clear()
        registry._specs.update(prev_specs)
        registry._calls.update(prev_calls)
