"""Online scoring server: resident GAME engine behind a JSON-lines protocol
(counterpart of ``photon_ml_tpu/cli/serve.py``).

The batch drivers (``cli/score.py``) load, score once, and exit; this
entry point keeps the model resident on the card and answers requests as
they arrive, micro-batched. Run over stdin/stdout

    python -m photon_ml_tpu_torch.cli.serve --model-dir out/game

or as a TCP socket server (one JSON object per line per connection):

    python -m photon_ml_tpu_torch.cli.serve --model-dir out/game --socket 7474

``--device`` names the torch device (default ``cuda``, which raises
without a card; ``--device cpu`` runs on the CPU).

Protocol (one JSON object per line):

    {"features": {"age": 0.7, "ctr\\u0001day7": 1.2},
     "entities": {"userId": "u123"}, "offset": 0.0,
     "deadline_ms": 50, "priority": 1}
        -> {"score": 1.234}
    {"cmd": "stats"}    -> latency/QPS/bucket snapshot (serving/stats.py)
    {"cmd": "metrics"}  -> {"prometheus": "<text exposition>"} — the
                           serving registry and the process default one
    {"cmd": "slo"}      -> rolling-window p99 + error-budget snapshot
                           (serving.stats.SloTracker; --slo-p99-ms)
    {"cmd": "health"}   -> queue/shed/degraded state + the reload circuit
                           breaker snapshot
    {"cmd": "version"}  -> {"version": "<current model version>"}
    {"cmd": "reload", "path": "<export dir>"} -> {"reloaded": "<version>"}
                           (an explicit reload bypasses the breaker's
                           quarantine — the operator asked)
    {"cmd": "exemplars"} -> tail-sampled exemplar rings: latency-bucket
                           -> recent trace ids (optional "ge_ms"/"class"
                           filters; obs/exemplars.py, --exemplar-fraction)

``deadline_ms`` (per request, or ``--default-deadline-ms``) drops a
request that can't start scoring in time — the Future answers
``{"error": ...}`` and no device work is burned; ``priority`` lets an
important request shed the oldest lower-priority queued one when the
bounded queue is full. Under sustained queue pressure the batcher
degrades to fixed-effect-only scoring (``--no-degrade`` disables).
``--hbm-cache-entities N`` serves through the tiered device/host entity
cache (the hot head on the card, misses score fixed-effect-only while
async promotion runs).

Unknown feature keys are ignored per shard vocabulary (ingest semantics);
unknown entity ids score fixed-effect-only (cold start). SIGTERM/SIGINT
drain the micro-batcher — accepted requests finish, new ones are refused —
via the ``GracefulShutdown.register_drain`` hook; a FAILED drain logs the
undrained depth and exits nonzero so orchestrators see the dropped work.
With ``--watch-root``, new verified model exports under the directory
hot-reload automatically; exports that keep failing to load are
quarantined by the reload circuit breaker (backoff probes re-admit them)
while the last good version keeps serving.

Not ported, and refused with their item in ROADMAP.md queue A
(:data:`UNPORTED_FLAGS`, :data:`UNPORTED_COMMANDS`): the async front end
with its tenants and replicas (``--frontend-port``, ``--tenant``,
``--replicas``; item 10), entity-sharded serving (``--serving-shards`` >
1; item 9), and the online-quality and drift commands (``feedback``,
``quality``, ``drift``; item 5).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import Optional

from photon_ml_tpu_torch.serving.batcher import Backpressure, MicroBatcher
from photon_ml_tpu_torch.serving.engine import ScoreRequest
from photon_ml_tpu_torch.serving.registry import ModelRegistry
from photon_ml_tpu_torch.serving.stats import ServingStats, SloTracker

# flags and commands the port does not run yet: -> their item in
# ROADMAP.md queue A
_FRONTEND = "item 10, Host layers with no device math (frontend/)"
UNPORTED_FLAGS = {
    "--frontend-port": _FRONTEND,
    "--tenant": _FRONTEND,
    "--replicas": _FRONTEND,
    "--serving-shards": "item 9, Parallel (serving/sharding.py)",
}
UNPORTED_COMMANDS = {
    "feedback": "item 5, Ingest hooks (obs/quality.py)",
    "quality": "item 5, Ingest hooks (obs/quality.py)",
    "drift": "item 5, Ingest hooks (obs/quality.py)",
    "tenants": _FRONTEND,
    "replicas": _FRONTEND,
}


def _unported(what: str, item: str) -> str:
    return f"{what} is not ported (ROADMAP.md queue A {item})"


def build_request(obj: dict) -> ScoreRequest:
    if not isinstance(obj, dict):
        raise ValueError(f"request must be a JSON object, got {type(obj)}")
    features = obj.get("features", {})
    if not isinstance(features, dict):
        raise ValueError("'features' must be an object of key -> value")
    return ScoreRequest(
        features=features,
        entities=obj.get("entities", {}),
        offset=float(obj.get("offset", 0.0)),
    )


def make_admin_handler(
    batcher,
    registry: Optional[ModelRegistry] = None,
    stats: Optional[ServingStats] = None,
):
    """One ``{"cmd": ...} -> dict`` dispatcher shared by every channel
    (stdin and ``--socket``)."""

    def handle(obj: dict) -> dict:
        cmd = obj.get("cmd")
        if cmd in UNPORTED_COMMANDS:
            return {"error": _unported(f"the {cmd!r} command",
                                       UNPORTED_COMMANDS[cmd])}
        try:
            if cmd == "stats":
                return (stats or batcher.stats).snapshot()
            if cmd == "metrics":
                # Prometheus text exposition of the serving registry
                # PLUS the process-default registry (solver/io/
                # resilience counters), so one scrape sees the whole
                # process (docs/OBSERVABILITY.md)
                from photon_ml_tpu_torch import obs

                st = stats or batcher.stats
                text = st.registry.to_prometheus()
                if st.registry is not obs.registry():
                    text += obs.registry().to_prometheus()
                return {"prometheus": text}
            if cmd == "slo":
                slo = getattr(batcher, "slo", None)
                if slo is None:
                    return {"error": "no SLO tracker configured"}
                return slo.snapshot()
            if cmd == "health":
                # breaker/shed/queue state in one reply — the
                # orchestration probe (readiness, alerting)
                health = dict(batcher.health())
                if registry is not None:
                    health.update(registry.health())
                return health
            if cmd == "exemplars":
                # tail-sampled exemplar rings (obs/exemplars.py): a
                # latency-histogram bucket resolves to live trace ids
                # for `photon-obs request`; optional "ge_ms" / "class"
                # narrow the lookup
                from photon_ml_tpu_torch.obs import exemplars as _exemplars

                st = _exemplars.store()
                if st is None:
                    return {"error": "no exemplar store installed"}
                if obj.get("ge_ms") is not None or obj.get("class"):
                    return {
                        "exemplars": st.lookup(
                            ge_ms=obj.get("ge_ms"),
                            cls=obj.get("class"),
                        )
                    }
                return st.snapshot()
            if cmd == "version":
                return {"version": registry.version()}
            if cmd == "reload":
                # operator-explicit: bypass breaker quarantine
                v = registry.load(obj["path"], force=True)
                return {"reloaded": v.version_id}
            return {"error": f"unknown cmd {cmd!r}"}
        except Exception as e:  # noqa: BLE001 — keep serving
            return {"error": str(e)}

    return handle


def serve_lines(
    lines,
    out,
    batcher: MicroBatcher,
    registry: Optional[ModelRegistry] = None,
    stats: Optional[ServingStats] = None,
    shutdown=None,
    window: int = 128,
    default_deadline_ms: Optional[float] = None,
) -> int:
    """Pump a JSON-lines stream through the batcher, writing one response
    line per request IN ORDER. A dedicated writer thread emits each
    response as soon as its (in-order) future resolves, so an interactive
    client gets its score promptly while a pipelining client can keep up
    to ``window`` requests outstanding (which is what fills micro-batches
    from a single stream). Commands execute at read time; their replies
    take their place in the output order. Returns the number of scored
    requests."""
    import queue as queue_mod

    outbox: "queue_mod.Queue" = queue_mod.Queue(maxsize=window)
    scored = [0]

    def writer() -> None:
        broken = False
        while True:
            item = outbox.get()
            if item is None:
                return
            kind, payload = item
            if kind == "score":
                try:
                    reply = json.dumps({"score": payload.result()})
                    scored[0] += 1
                except Exception as e:  # noqa: BLE001 — per-request reply
                    reply = json.dumps({"error": str(e)})
            else:
                reply = payload
            if broken:
                continue  # output gone: keep draining so readers don't block
            try:
                out.write(reply + "\n")
                out.flush()
            except Exception:  # noqa: BLE001 — e.g. client hung up
                broken = True

    wt = threading.Thread(target=writer, name="serve-writer", daemon=True)
    wt.start()

    def reply_now(obj: dict) -> None:
        outbox.put(("line", json.dumps(obj)))

    handle_cmd = make_admin_handler(batcher, registry, stats)

    try:
        for line in lines:
            if shutdown is not None and shutdown.requested:
                break
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                reply_now({"error": f"bad JSON: {e}"})
                continue
            cmd = obj.get("cmd") if isinstance(obj, dict) else None
            if cmd is not None:
                reply_now(handle_cmd(obj))
                continue
            try:
                deadline_ms = obj.get("deadline_ms", default_deadline_ms)
                outbox.put(
                    (
                        "score",
                        batcher.submit(
                            build_request(obj),
                            deadline_ms=(
                                float(deadline_ms)
                                if deadline_ms is not None
                                else None
                            ),
                            priority=int(obj.get("priority", 0)),
                        ),
                    )
                )
            except (Backpressure, ValueError, TypeError) as e:
                reply_now({"error": str(e)})
    finally:
        outbox.put(None)
        wt.join()
    return scored[0]


def _watch_loop(registry, watch_root, poll_s, shutdown, logger):
    while not shutdown.requested:
        try:
            loaded = registry.poll(watch_root)
            if loaded is not None and logger is not None:
                logger.info(f"hot-reloaded version {loaded!r}")
        except Exception as e:  # noqa: BLE001 — watcher must survive
            if logger is not None:
                logger.warn(f"watch poll failed: {e}")
        shutdown._event.wait(poll_s)


def _serve_socket(
    port, batcher, registry, stats, shutdown, logger,
    default_deadline_ms=None,
):
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            lines = (raw.decode("utf-8") for raw in self.rfile)

            class _W:  # text adapter over the binary wfile
                def write(inner, s):
                    self.wfile.write(s.encode("utf-8"))

                def flush(inner):
                    pass

            serve_lines(
                lines, _W(), batcher, registry, stats, shutdown=shutdown,
                default_deadline_ms=default_deadline_ms,
            )

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server(("127.0.0.1", port), Handler) as server:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        if logger is not None:
            logger.info(f"serving on 127.0.0.1:{port}")
        shutdown._event.wait()  # SIGTERM/SIGINT or programmatic request
        server.shutdown()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.serve",
        description="Serve a GAME model online (stdin or TCP JSON lines).",
    )
    p.add_argument("--model-dir", required=True)
    p.add_argument("--watch-root", help="poll for new model versions here")
    p.add_argument("--poll-s", type=float, default=5.0)
    p.add_argument("--socket", type=int, help="TCP port (default: stdin)")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--queue-depth", type=int, default=1024)
    p.add_argument("--min-bucket", type=int, default=8)
    p.add_argument(
        "--dtype", choices=["float32", "float64"], default="float32"
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default: cuda, which raises without a card)",
    )
    p.add_argument(
        "--slo-p99-ms", type=float, default=10.0,
        help="p99 latency target for the SLO tracker ({'cmd': 'slo'})",
    )
    p.add_argument(
        "--slo-objective", type=float, default=0.99,
        help="fraction of requests that must meet the target "
        "(error budget = 1 - objective)",
    )
    p.add_argument(
        "--slo-window-s", type=float, default=60.0,
        help="rolling SLO window in seconds",
    )
    p.add_argument(
        "--no-verify-manifest",
        action="store_true",
        help="serve exports without a sha256 manifest (NOT recommended)",
    )
    p.add_argument(
        "--default-deadline-ms", type=float, default=None,
        help="deadline applied to requests that don't carry their own "
        "deadline_ms; expired requests drop before batch assembly",
    )
    p.add_argument(
        "--no-degrade", action="store_true",
        help="disable degrade-to-fixed-effect-only scoring under "
        "sustained queue pressure",
    )
    p.add_argument(
        "--breaker-threshold", type=int, default=3,
        help="consecutive reload failures that quarantine an export dir",
    )
    p.add_argument(
        "--breaker-backoff-s", type=float, default=30.0,
        help="initial backoff before a quarantined export is re-probed "
        "(doubles per failed probe)",
    )
    p.add_argument(
        "--serving-shards", type=int, default=1,
        help="entity-sharded serving: not ported, only 1 is accepted",
    )
    p.add_argument(
        "--hbm-cache-entities", type=int, default=None,
        help="tiered entity cache: keep this many hot entities per RE "
        "key in device memory, the cold tail in host RAM with async "
        "promotion; a "
        "miss scores fixed-effect-only (cold-start semantics) while "
        "the promotion is in flight",
    )
    p.add_argument(
        "--admission-log", default=None,
        help="persist a bounded repeat-miss admission log here (entity "
        "key, miss count, last seen; atomic-swap writes) — the retrain "
        "orchestrator (photon-retrain) promotes repeat-missed entities "
        "into the next training set (docs/LIFECYCLE.md)",
    )
    p.add_argument(
        "--frontend-port", type=int, default=None,
        help="the async front end: not ported, refused",
    )
    p.add_argument(
        "--replicas", type=int, default=1,
        help="engine replicas behind the front end: not ported, only 1 "
        "is accepted",
    )
    p.add_argument(
        "--tenant", action="append", default=None, metavar="JSON",
        help="a tenant of the front end: not ported, refused",
    )
    p.add_argument(
        "--exemplar-fraction", type=float, default=0.01,
        help="fast-path sampling fraction for the tail-based exemplar "
        "store (errors/sheds/expiries/degraded/failovers and the "
        "rolling slow tail are always kept; negative disables the "
        "store entirely) — the {'cmd': 'exemplars'} surface",
    )
    p.add_argument("--stats-json", help="dump a stats snapshot here on exit")
    args = p.parse_args(argv)
    for flag, given in (
        ("--frontend-port", args.frontend_port is not None),
        ("--tenant", bool(args.tenant)),
        ("--replicas", args.replicas != 1),
        ("--serving-shards", args.serving_shards != 1),
    ):
        if given:
            p.error(_unported(flag, UNPORTED_FLAGS[flag]))
    # after parse_args: --help / bad flags must not initialize torch
    import torch

    from photon_ml_tpu_torch.resilience import GracefulShutdown
    from photon_ml_tpu_torch.utils.logging import PhotonLogger

    logger = PhotonLogger(None)
    stats = ServingStats()
    registry = ModelRegistry(
        verify=not args.no_verify_manifest,
        warmup_max_batch=args.max_batch,
        warmup_degraded=not args.no_degrade,
        breaker_threshold=args.breaker_threshold,
        breaker_backoff_s=args.breaker_backoff_s,
        stats=stats,
        logger=logger,
        dtype={"float32": torch.float32, "float64": torch.float64}[args.dtype],
        min_bucket=args.min_bucket,
        device=args.device,
        **(
            {"hbm_cache_entities": args.hbm_cache_entities}
            if args.hbm_cache_entities
            else {}
        ),
        **(
            {"admission_log_path": args.admission_log}
            if args.admission_log
            else {}
        ),
    )
    registry.load(args.model_dir)
    slo = SloTracker(
        target_p99_ms=args.slo_p99_ms,
        objective=args.slo_objective,
        window_s=args.slo_window_s,
        registry=stats.registry,
    )
    # tail-based exemplar sampling: the batcher feeds every finished
    # request; the rings answer {"cmd": "exemplars"} with live trace ids
    if args.exemplar_fraction >= 0:
        from photon_ml_tpu_torch.obs import exemplars as _exemplars

        _exemplars.install_store(fast_fraction=args.exemplar_fraction)
    batcher = MicroBatcher(
        registry.score,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth,
        stats=stats,
        slo=slo,
        degraded_score_fn=(
            None if args.no_degrade else registry.score_fixed_only
        ),
    )
    shutdown = GracefulShutdown(logger).install()
    shutdown.register_drain(batcher.begin_drain)
    if args.watch_root:
        threading.Thread(
            target=_watch_loop,
            args=(registry, args.watch_root, args.poll_s, shutdown, logger),
            daemon=True,
        ).start()
    try:
        if args.socket:
            _serve_socket(
                args.socket, batcher, registry, stats, shutdown, logger,
                default_deadline_ms=args.default_deadline_ms,
            )
        else:
            serve_lines(
                sys.stdin,
                sys.stdout,
                batcher,
                registry,
                stats,
                shutdown=shutdown,
                window=args.max_batch * 2,
                default_deadline_ms=args.default_deadline_ms,
            )
    finally:
        drained = batcher.drain()
        if args.stats_json:
            stats.dump(args.stats_json)
        shutdown.uninstall()
        if not drained:
            # accepted requests are still queued — silently exiting 0
            # here is how dropped work hides from orchestrators
            depth = batcher.queue_depth()
            logger.warn(
                f"drain FAILED: {depth} accepted request(s) undrained "
                "at exit"
            )
            sys.exit(3)


if __name__ == "__main__":
    main()
