"""photon-obs for the port: operator tools for pod-level observability
artifacts (counterpart of ``photon_ml_tpu/cli/obs_tools.py``, on the
port's ``obs.dist``, ``obs.quality``, ``obs.reqtrace`` and
``frontend.server.FrontendClient``). The on-disk layouts are the JAX
package's, so either package's CLI reads either package's artifacts; the
tools are host-only and touch no device.

A multi-process run leaves one observability shard per host process —
``<dir>/trace.json`` + ``events.jsonl`` + ``metrics.json`` — each on its
own monotonic clock. This CLI folds them into pod-level artifacts:

    # merge per-process shards into one Perfetto-loadable pod trace
    python -m photon_ml_tpu_torch.cli.obs_tools merge \
        --out out/pod-trace out/trace-host0 out/trace-host1 ...

    # render a run's convergence health from its events.jsonl
    python -m photon_ml_tpu_torch.cli.obs_tools convergence out/trace

    # compare two quality fingerprints; exit 1 on drift alarm (cron)
    python -m photon_ml_tpu_torch.cli.obs_tools drift out/run1 out/run2

    # rebuild one request's causal timeline from event logs
    python -m photon_ml_tpu_torch.cli.obs_tools request <trace-id> out/trace ...

    # live fleet console over every replica's admin channel
    python -m photon_ml_tpu_torch.cli.obs_tools top --endpoint host:port ...

``convergence`` reads the ``convergence.solve`` / ``convergence.fleet``
events the obs.convergence layer emits (train CLIs under ``--trace-dir``
and/or ``--convergence-report``) and renders per-solve value/grad-norm
curves plus per-coordinate fleet summaries (iterations histogram,
non-converged entities, worst-k by final gradient norm) as terminal
text. Exit 0 with a BENCH-style JSON summary line, 2 when the log holds
no convergence records.

``merge`` accepts trace directories or ``trace.json`` paths, aligns the
per-shard clocks at the barrier-stamped ``clock.sync`` event each shard
carries (``obs.dist.emit_clock_sync``; fallback: wall-clock epochs),
rewrites each shard onto its own Perfetto pid track (``host.<i>``), and
writes:

- ``<out>/trace.json``   — the merged Chrome trace (load in Perfetto),
- ``<out>/events.jsonl`` — every shard's structured events, host-tagged
  and time-ordered (when shards carry event logs),
- ``<out>/metrics.json`` — per-host instruments under ``host.<i>.``
  prefixes plus ``pod.*`` counter sums (when shards carry snapshots),
- ``<out>/quality-fingerprint.json`` — per-host quality fingerprints
  folded EXACTLY (sketch merge; pod-merged == single-pass) when shard
  dirs carry them (``obs.quality``: sketch merge).

``request`` is the request-causality surface (``obs.reqtrace``): given
a trace id (echoed in every frontend reply, or pulled from the
``{"cmd": "exemplars"}`` rings) and one or more trace
directories / ``events.jsonl`` paths, it merges the per-process event
shards and renders the request's reconstructed timeline — wire read,
queue wait, batch assembly, replica hop(s) incl. breaker failovers,
per-shard device time, cache misses, reply write — with failover/
degraded/truncation flags (``obs.reqtrace.reconstruct_timeline``). Exit
2 when the id appears in no readable shard.

``top`` polls every ``--endpoint``'s admin channel (the front end's
``{"cmd": ...}`` passthrough) and folds per-replica health/stats/
tenants/replicas/SLO/drift answers into ONE schema-stable fleet
snapshot: per-tenant qps/p99/SLO/shed, per-replica breaker + outstanding
state, per-shard cache hit-frac + resident bytes, drift gauges, and the
lifecycle alarm latch. ``--once --json`` prints the snapshot and exits
(the machine surface tests gate); ``--out`` also writes a
``fleet-snapshot.json`` artifact; without ``--once`` it refreshes every
``--interval`` seconds as a terminal console. Exit 2 when no endpoint
answered.

Missing / truncated / torn shards are skipped with a warning — merges
run during post-mortems and must work with whatever survived. Exit 0 on
success (possibly with warnings), 2 when nothing could be merged.

One BENCH-style JSON summary line goes to stdout; warnings to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Tuple

from photon_ml_tpu_torch.obs import dist as obs_dist


def _resolve_shards(args_paths: List[str]) -> List[str]:
    """Expand CLI operands: a directory stands for its ``trace.json``.
    Order is preserved (it is the positional process-index fallback)."""
    out = []
    for p in args_paths:
        if os.path.isdir(p):
            out.append(os.path.join(p, "trace.json"))
        else:
            out.append(p)
    return out


def merge_command(args) -> int:
    paths = _resolve_shards(args.shards)
    docs: List[Tuple[dict, str]] = []
    warnings: List[str] = []
    for path in paths:
        doc, warn = obs_dist.load_trace_shard(path)
        if doc is None:
            warnings.append(warn)
        else:
            docs.append((doc, path))
    if not docs:
        for w in warnings:
            print(f"photon-obs: {w}", file=sys.stderr)
        print("photon-obs: no readable trace shards", file=sys.stderr)
        return 2
    merged, info = obs_dist.merge_trace_shards(docs)
    warnings.extend(info["warnings"])

    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, "trace.json")
    with open(trace_path, "w", encoding="utf-8") as f:
        json.dump(merged, f)

    # events.jsonl: merge whatever shard directories carry one
    events_written = 0
    events_paths = []
    for pos, (doc, label) in enumerate(docs):
        shard_dir = os.path.dirname(os.path.abspath(label))
        ev_path = os.path.join(shard_dir, "events.jsonl")
        if os.path.exists(ev_path):
            idx = (doc.get("metadata") or {}).get("process_index", pos)
            events_paths.append((ev_path, int(idx)))
    if events_paths:
        records, ev_warns = obs_dist.merge_events_shards(events_paths)
        warnings.extend(ev_warns)
        with open(
            os.path.join(args.out, "events.jsonl"), "w", encoding="utf-8"
        ) as f:
            for rec in records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        events_written = len(records)

    # quality-fingerprint.json: exact sketch folding — the pod-merged
    # fingerprint equals one single-pass fingerprint over all hosts'
    # rows (obs.sketches merge contract)
    merged_fp = None
    fp_shards = 0
    for _, label in docs:
        shard_dir = os.path.dirname(os.path.abspath(label))
        fp_path = os.path.join(shard_dir, "quality-fingerprint.json")
        if not os.path.exists(fp_path):
            continue
        from photon_ml_tpu_torch.obs.quality import BaselineFingerprint

        try:
            fp = BaselineFingerprint.load(fp_path)
        except (OSError, ValueError, KeyError, TypeError) as e:
            warnings.append(f"{fp_path}: skipped ({e})")
            continue
        if merged_fp is None:
            merged_fp = fp
        else:
            merged_fp.merge(fp)
        fp_shards += 1
    if merged_fp is not None:
        merged_fp.save(os.path.join(args.out, "quality-fingerprint.json"))

    # metrics.json: host.<i>.-prefixed union + pod.* counter sums
    metric_snaps = []
    for pos, (doc, label) in enumerate(docs):
        shard_dir = os.path.dirname(os.path.abspath(label))
        m_path = os.path.join(shard_dir, "metrics.json")
        if not os.path.exists(m_path):
            continue
        try:
            with open(m_path, encoding="utf-8") as f:
                snap = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            warnings.append(f"{m_path}: skipped ({e})")
            continue
        idx = (doc.get("metadata") or {}).get("process_index", pos)
        metric_snaps.append((snap, int(idx)))
    if metric_snaps:
        merged_metrics = obs_dist.merge_metrics_shards(metric_snaps)
        with open(
            os.path.join(args.out, "metrics.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(merged_metrics, f, indent=2)

    for w in warnings:
        print(f"photon-obs: warning: {w}", file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "obs_merge",
                "value": info["shards"],
                "unit": "shards",
                "extra": {
                    "out": trace_path,
                    "events": info["events"],
                    "events_jsonl": events_written,
                    "metrics_shards": len(metric_snaps),
                    "fingerprint_shards": fp_shards,
                    "duplicates_dropped": info["duplicates_dropped"],
                    "aligned_by": info["aligned_by"],
                    "skipped": len(paths) - info["shards"],
                    "warnings": len(warnings),
                },
            }
        )
    )
    return 0


# -- photon-obs convergence --------------------------------------------------

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(series, width: int = 48) -> str:
    """Terminal sparkline of a numeric series (log-spread where the
    dynamic range warrants it — grad norms span decades per solve)."""
    import math as _math

    vals = [
        float(v)
        for v in series
        if isinstance(v, (int, float)) and _math.isfinite(v)
    ]
    if not vals:
        return ""
    if len(vals) > width:
        # decimate evenly; keep the endpoints
        idx = [round(i * (len(vals) - 1) / (width - 1)) for i in range(width)]
        vals = [vals[i] for i in idx]
    lo, hi = min(vals), max(vals)
    if hi > 0 and lo > 0 and hi / max(lo, 1e-300) > 1e3:
        vals = [_math.log10(v) for v in vals]
        lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_BLOCKS[0] * len(vals)
    return "".join(
        _SPARK_BLOCKS[
            min(int((v - lo) / span * (len(_SPARK_BLOCKS) - 1) + 0.5),
                len(_SPARK_BLOCKS) - 1)
        ]
        for v in vals
    )


def _load_convergence_events(path: str):
    """(solve_events, fleet_events, warnings) from one events.jsonl —
    torn lines skipped, like the merge path (post-mortem logs)."""
    solves, fleets, warnings = [], [], []
    try:
        f = open(path, encoding="utf-8")
    except OSError as e:
        return [], [], [f"{path}: unreadable ({e})"]
    with f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                warnings.append(f"{path}:{lineno}: torn line skipped")
                continue
            # kind matters: the convergence counter-track samples share
            # the "convergence.solve" NAME with the structured events
            if rec.get("kind") != "event":
                continue
            name = rec.get("name", "")
            if name == "convergence.solve":
                solves.append(rec)
            elif name == "convergence.fleet":
                fleets.append(rec)
    return solves, fleets, warnings


def convergence_command(args) -> int:
    path = args.events
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    solves, fleets, warnings = _load_convergence_events(path)
    for w in warnings:
        print(f"photon-obs: warning: {w}", file=sys.stderr)
    if not solves and not fleets:
        print(
            f"photon-obs: no convergence records in {path} (run training "
            "with --trace-dir and/or --convergence-report)",
            file=sys.stderr,
        )
        return 2

    out = sys.stderr  # human rendering; the JSON summary owns stdout
    if solves:
        print(f"— per-solve convergence ({len(solves)} solves) —", file=out)
        for rec in solves[-args.last:]:
            label = rec.get("label") or rec.get("optimizer", "solve")
            print(
                f"{label}: {rec.get('optimizer', '?')} "
                f"iters={rec.get('iterations')} "
                f"reason={rec.get('reason')} order={rec.get('order')}"
                + (
                    f" rate={rec['rate']:.3g}"
                    if isinstance(rec.get("rate"), (int, float))
                    else ""
                ),
                file=out,
            )
            values = rec.get("values") or []
            gnorms = rec.get("grad_norms") or []
            if len(values) > 1:
                print(f"  value     {_sparkline(values)}", file=out)
            if len(gnorms) > 1:
                print(f"  |grad|    {_sparkline(gnorms)}", file=out)
            for tape_name, tape in sorted(
                (rec.get("tapes") or {}).items()
            ):
                if len(tape) > 1:
                    print(
                        f"  {tape_name:<9} {_sparkline(tape)}", file=out
                    )
    by_coord = {}
    for rec in fleets:
        by_coord.setdefault(rec.get("coordinate", "?"), []).append(rec)
    if by_coord:
        print(
            f"— fleet convergence ({len(fleets)} coordinate updates) —",
            file=out,
        )
        for coord, recs in sorted(by_coord.items()):
            entities = recs[-1].get("entities", 0)
            nonconv = sum(r.get("nonconverged", 0) for r in recs)
            total = sum(r.get("entities", 0) for r in recs)
            medians = [
                r["median_iters"]
                for r in recs
                if isinstance(r.get("median_iters"), (int, float))
            ]
            med = sorted(medians)[len(medians) // 2] if medians else 0.0
            print(
                f"{coord}: {len(recs)} updates x {entities} entities; "
                f"median_iters={med:g} "
                f"nonconverged={nonconv}/{total} "
                f"({(nonconv / total if total else 0.0):.2%})",
                file=out,
            )
            print(
                "  median iters/pass "
                + _sparkline([r.get("median_iters", 0) for r in recs]),
                file=out,
            )
            last = recs[-1]
            hist = last.get("iters_histogram") or {}
            if hist:
                pairs = sorted((int(k), v) for k, v in hist.items())
                print(
                    "  last-pass iters histogram: "
                    + " ".join(f"{k}:{v}" for k, v in pairs),
                    file=out,
                )
            worst = last.get("worst") or []
            if worst:
                print(
                    "  worst entities (final |grad|): "
                    + ", ".join(
                        f"#{int(e)}={g:.3g}" for e, g in worst
                    ),
                    file=out,
                )
    print(
        json.dumps(
            {
                "metric": "obs_convergence",
                "value": len(solves) + len(fleets),
                "unit": "records",
                "extra": {
                    "events": path,
                    "solves": len(solves),
                    "fleet_updates": len(fleets),
                    "coordinates": sorted(by_coord),
                    "warnings": len(warnings),
                },
            }
        )
    )
    return 0


# -- photon-obs drift --------------------------------------------------------


def drift_command(args) -> int:
    """Compare two quality fingerprints (train-time baseline vs a newer
    fingerprint — a later train run, a pod-merged serving sample, or a
    suspect export). Prints a per-feature PSI/JS table to stderr, one
    BENCH-style JSON line to stdout, and exits NONZERO when any feature
    (or the margin distribution) crosses the alarm threshold — the cron
    contract: `photon-obs drift base/ current/ || trigger-retrain`."""
    from photon_ml_tpu_torch.obs.quality import (
        BaselineFingerprint,
        compare_fingerprints,
    )

    sides = {}
    for role, path in (("baseline", args.baseline), ("current", args.current)):
        try:
            sides[role] = BaselineFingerprint.load(path)
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(
                f"photon-obs: {role} fingerprint {path!r} unreadable "
                f"({e})",
                file=sys.stderr,
            )
            return 2
    report = compare_fingerprints(
        sides["baseline"], sides["current"], psi_alarm=args.threshold
    )

    out = sys.stderr  # human rendering; the JSON summary owns stdout
    ranked = sorted(
        report["features"].items(),
        key=lambda kv: -kv[1]["psi"],
    )
    print(
        f"— drift report: {report['baseline_rows']} baseline rows vs "
        f"{report['current_rows']} current rows "
        f"(alarm threshold PSI >= {args.threshold:g}) —",
        file=out,
    )
    for key, f in ranked[: args.top]:
        flag = " ALARM" if f["psi"] >= args.threshold else ""
        label = f" ({f['name']})" if f.get("name") else ""
        print(
            f"{key}{label}: psi={f['psi']:.4f} js={f['js']:.4f} "
            f"mean {f['baseline_mean']:g} -> {f['current_mean']:g}"
            f"{flag}",
            file=out,
        )
    if report["margin_psi"] is not None:
        print(f"margin/score psi={report['margin_psi']:.4f}", file=out)
    if report["label_psi"] is not None:
        print(f"label psi={report['label_psi']:.4f}", file=out)
    if report["alarm"]:
        print(
            f"DRIFT ALARM: {len(report['flagged'])} feature(s) over "
            f"threshold: {report['flagged']}",
            file=out,
        )
    print(
        json.dumps(
            {
                "metric": "drift_psi_max",
                "value": report["psi_max"],
                "unit": "psi",
                "extra": {
                    "alarm": report["alarm"],
                    "flagged": report["flagged"],
                    "js_max": report["js_max"],
                    "margin_psi": report["margin_psi"],
                    "label_psi": report["label_psi"],
                    "threshold": args.threshold,
                    "features_compared": len(report["features"]),
                    "baseline_rows": report["baseline_rows"],
                    "current_rows": report["current_rows"],
                },
            }
        )
    )
    return 1 if report["alarm"] else 0


# -- photon-obs request ------------------------------------------------------


def _load_event_shards(paths):
    """CLI operands (trace dirs or events.jsonl paths) -> merged,
    host-tagged, time-ordered records. Positional order is the
    process-index fallback, like ``merge``."""
    return obs_dist.merge_events_shards(
        [(p, pos) for pos, p in enumerate(paths)]
    )


def request_command(args) -> int:
    from photon_ml_tpu_torch.obs import reqtrace

    records, warnings = _load_event_shards(args.shards)
    for w in warnings:
        print(f"photon-obs: warning: {w}", file=sys.stderr)
    if not records:
        print("photon-obs: no readable event shards", file=sys.stderr)
        return 2
    timeline = reqtrace.reconstruct_timeline(records, args.trace_id)
    if timeline is None:
        known = reqtrace.trace_ids(records)
        print(
            f"photon-obs: trace {args.trace_id!r} not found "
            f"({len(records)} records, {len(known)} trace ids)",
            file=sys.stderr,
        )
        for tid in known[-args.last:]:
            print(f"  recent trace: {tid}", file=sys.stderr)
        return 2

    out = sys.stderr  # human rendering; the JSON summary owns stdout
    flags = [
        f for f in ("truncated", "failover", "degraded")
        if timeline[f]
    ]
    print(
        f"— request {timeline['trace']} "
        f"[{' '.join(flags) if flags else 'complete'}] —",
        file=out,
    )
    if timeline["request_id"] is not None:
        print(
            f"request_id={timeline['request_id']} "
            f"batch_ids={timeline['batch_ids']} "
            f"hosts={timeline['hosts']}",
            file=out,
        )
    seg = timeline["segments"]
    if seg:
        order = ("wire_read_ms", "queue_wait_ms", "assembly_ms",
                 "device_ms", "reply_write_ms")
        print(
            "segments: " + " -> ".join(
                f"{k[:-3]} {seg[k]:.3f}ms" for k in order if k in seg
            ),
            file=out,
        )
    for hop in timeline["hops"]:
        status = "FAILED" if hop["error"] else "ok"
        print(
            f"hop: replica={hop['replica']} attempt={hop['attempt']} "
            f"{status}",
            file=out,
        )
    if timeline["cache_misses"]:
        print(f"cache misses: {timeline['cache_misses']}", file=out)
    t0_unix = timeline["events"][0].get("time_unix", 0.0)
    for rec in timeline["events"]:
        dt = (rec.get("time_unix", 0.0) - t0_unix) * 1e3
        dur = rec.get("duration_ms")
        dur_s = f" {dur:.3f}ms" if isinstance(dur, (int, float)) else ""
        host = rec.get("host")
        host_s = f" host={host}" if host is not None else ""
        print(
            f"  +{dt:9.3f}ms {rec.get('kind', '?'):<5} "
            f"{rec.get('name', '?')}{dur_s}{host_s}",
            file=out,
        )
    print(
        json.dumps(
            {
                "metric": "obs_request",
                "value": len(timeline["events"]),
                "unit": "events",
                "extra": {
                    "trace": timeline["trace"],
                    "complete": timeline["complete"],
                    "truncated": timeline["truncated"],
                    "failover": timeline["failover"],
                    "degraded": timeline["degraded"],
                    "hops": len(timeline["hops"]),
                    "cache_misses": timeline["cache_misses"],
                    "hosts": timeline["hosts"],
                    "segments": timeline["segments"],
                    "warnings": len(warnings),
                },
            }
        )
    )
    return 0


# -- photon-obs top ----------------------------------------------------------

# the admin commands one fleet poll issues per endpoint; an endpoint
# missing a surface (single-tenant, unreplicated, no drift monitor)
# answers {"error": ...} and folds in as None — schema-stable either way
_TOP_CMDS = ("health", "stats", "tenants", "replicas", "slo", "drift")


def _parse_endpoint(ep: str):
    host, _, port = ep.rpartition(":")
    return host or "127.0.0.1", int(port)


def _prom_gauge(text: str, name: str):
    """One gauge value out of a Prometheus text exposition, or None."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            try:
                return float(line.split()[1])
            except (IndexError, ValueError):
                return None
    return None


def poll_endpoint(ep: str, *, binary: bool = False,
                  timeout: float = 5.0) -> dict:
    """One replica's raw admin answers (``_TOP_CMDS`` + the lifecycle
    alarm latch dug out of the metrics exposition). Unreachable
    endpoints come back ``{"reachable": False, "error": ...}`` — the
    console renders whatever survived, like the merge path."""
    from photon_ml_tpu_torch.frontend.server import FrontendClient

    entry: dict = {"reachable": False, "error": None}
    try:
        host, port = _parse_endpoint(ep)
        with FrontendClient(
            host, port, binary=binary, timeout=timeout
        ) as cli:
            for cmd in _TOP_CMDS:
                reply = cli.call({"cmd": cmd})
                reply.pop("id", None)
                entry[cmd] = None if "error" in reply else reply
            prom = cli.call({"cmd": "metrics"}).get("prometheus", "")
            latched = _prom_gauge(prom, "photon_lifecycle_alarm_latched")
            entry["lifecycle_alarm_latched"] = bool(latched)
            entry["reachable"] = True
    except (OSError, ConnectionError, ValueError, KeyError) as e:
        entry["error"] = f"{type(e).__name__}: {e}"
    return entry


def collect_fleet_snapshot(
    endpoints, *, binary: bool = False, timeout: float = 5.0
) -> dict:
    """Poll every endpoint once and aggregate to THE fleet snapshot —
    the ``photon-obs top`` payload (schema-stable: every key below is
    present regardless of which surfaces each replica serves)."""
    raw = {ep: poll_endpoint(ep, binary=binary, timeout=timeout)
           for ep in endpoints}

    replicas = {}
    tenants: dict = {}
    fleet = {
        "qps": 0.0,
        "requests": 0,
        "shed": 0,
        "expired": 0,
        "errors": 0,
        "worst_p99_ms": 0.0,
        "slo_met": True,
        "drift_alarm": False,
        "lifecycle_alarm": False,
    }
    for ep, entry in raw.items():
        rep = {
            "reachable": entry["reachable"],
            "error": entry.get("error"),
            "qps": None,
            "p99_ms": None,
            "queue_depth": None,
            "degraded": None,
            "draining": None,
            "outstanding": None,
            "breakers": {},
            "failovers": 0,
            "cache_hit_frac": None,
            "resident_re_bytes": None,
            "shards": {},
            "drift": None,
            "lifecycle_alarm_latched": bool(
                entry.get("lifecycle_alarm_latched")
            ),
        }
        stats = entry.get("stats")
        if stats:
            rep["qps"] = stats.get("qps")
            rep["p99_ms"] = (stats.get("request_latency") or {}).get(
                "p99_ms"
            )
            cache = stats.get("cache") or {}
            rep["cache_hit_frac"] = cache.get("hit_frac")
            rep["resident_re_bytes"] = stats.get(
                "resident_re_bytes_per_process"
            )
            rep["shards"] = {
                name: {"occupancy": shard.get("occupancy")}
                for name, shard in (stats.get("shards") or {}).items()
            }
            fleet["qps"] += float(stats.get("qps") or 0.0)
            fleet["requests"] += int(stats.get("requests") or 0)
            fleet["errors"] += int(stats.get("errors") or 0)
        health = entry.get("health")
        if health:
            rep["queue_depth"] = health.get("queue_depth")
            rep["degraded"] = health.get("degraded")
            rep["draining"] = health.get("draining")
            fleet["shed"] += int(health.get("shed") or 0)
            fleet["expired"] += int(health.get("expired") or 0)
        routers = entry.get("replicas")
        if routers:
            for tname, router in routers.items():
                for rname, snap in (
                    router.get("replicas") or {}
                ).items():
                    rep["breakers"][f"{tname}/{rname}"] = {
                        "state": snap.get("state"),
                        "outstanding": snap.get("outstanding"),
                        "failures": snap.get("failures"),
                    }
                rep["failovers"] += int(router.get("failovers") or 0)
        drift = entry.get("drift")
        if drift:
            rep["drift"] = {
                "checks": drift.get("checks"),
                "alarms": drift.get("alarms"),
                "psi_alarm": drift.get("psi_alarm"),
            }
            if drift.get("alarms"):
                fleet["drift_alarm"] = True
        if rep["lifecycle_alarm_latched"]:
            fleet["lifecycle_alarm"] = True
        tsnap = entry.get("tenants")
        if tsnap:
            for name, ten in (tsnap.get("tenants") or {}).items():
                agg = tenants.setdefault(
                    name,
                    {
                        "endpoints": 0,
                        "outstanding": 0,
                        "submitted": 0,
                        "completed": 0,
                        "failed": 0,
                        "rejected": 0,
                        "over_quota_submits": 0,
                        "p99_ms": 0.0,
                        "violation_rate": 0.0,
                        "slo_met": True,
                    },
                )
                agg["endpoints"] += 1
                for k in ("outstanding", "submitted", "completed",
                          "failed", "rejected", "over_quota_submits"):
                    agg[k] += int(ten.get(k) or 0)
                slo = ten.get("slo") or {}
                agg["p99_ms"] = max(
                    agg["p99_ms"], float(slo.get("p99_ms") or 0.0)
                )
                agg["violation_rate"] = max(
                    agg["violation_rate"],
                    float(slo.get("violation_rate") or 0.0),
                )
                if slo.get("slo_met") is False:
                    agg["slo_met"] = False
                    fleet["slo_met"] = False
        if rep["p99_ms"]:
            fleet["worst_p99_ms"] = max(
                fleet["worst_p99_ms"], float(rep["p99_ms"])
            )
        replicas[ep] = rep
    fleet["qps"] = round(fleet["qps"], 2)
    return {
        "schema": 1,
        "endpoints": len(replicas),
        "reachable": sum(
            1 for r in replicas.values() if r["reachable"]
        ),
        "fleet": fleet,
        "tenants": tenants,
        "replicas": replicas,
    }


def _render_fleet(snap: dict, out) -> None:
    fleet = snap["fleet"]
    alarm_bits = []
    if not fleet["slo_met"]:
        alarm_bits.append("SLO-VIOLATED")
    if fleet["drift_alarm"]:
        alarm_bits.append("DRIFT-ALARM")
    if fleet["lifecycle_alarm"]:
        alarm_bits.append("LIFECYCLE-ALARM")
    print(
        f"— fleet: {snap['reachable']}/{snap['endpoints']} replicas up, "
        f"{fleet['qps']:g} qps, worst p99 {fleet['worst_p99_ms']:g}ms, "
        f"shed {fleet['shed']} expired {fleet['expired']} errors "
        f"{fleet['errors']}"
        + (f"  [{' '.join(alarm_bits)}]" if alarm_bits else " [healthy]"),
        file=out,
    )
    for name, ten in sorted(snap["tenants"].items()):
        met = "met" if ten["slo_met"] else "VIOLATED"
        print(
            f"tenant {name}: {ten['completed']}/{ten['submitted']} done "
            f"({ten['endpoints']} eps) outstanding={ten['outstanding']} "
            f"rejected={ten['rejected']} p99={ten['p99_ms']:g}ms "
            f"slo={met}",
            file=out,
        )
    for ep, rep in sorted(snap["replicas"].items()):
        if not rep["reachable"]:
            print(f"replica {ep}: UNREACHABLE ({rep['error']})", file=out)
            continue
        cache = (
            f" cache={rep['cache_hit_frac']:.0%}"
            if isinstance(rep["cache_hit_frac"], float)
            and rep["cache_hit_frac"] > 0
            else ""
        )
        resident = (
            f" resident={rep['resident_re_bytes']}B"
            if rep["resident_re_bytes"] else ""
        )
        lifecycle = (
            " LIFECYCLE-ALARM" if rep["lifecycle_alarm_latched"] else ""
        )
        print(
            f"replica {ep}: qps={rep['qps']} p99={rep['p99_ms']}ms "
            f"queue={rep['queue_depth']} degraded={rep['degraded']}"
            f"{cache}{resident} failovers={rep['failovers']}{lifecycle}",
            file=out,
        )
        for bname, br in sorted(rep["breakers"].items()):
            print(
                f"  breaker {bname}: {br['state']} "
                f"outstanding={br['outstanding']} "
                f"failures={br['failures']}",
                file=out,
            )


def top_command(args) -> int:
    import time as _time

    while True:
        snap = collect_fleet_snapshot(
            args.endpoint, binary=args.binary, timeout=args.timeout
        )
        if args.out:
            os.makedirs(
                os.path.dirname(os.path.abspath(args.out)), exist_ok=True
            )
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump(snap, f, indent=2, sort_keys=True)
        if args.json:
            print(json.dumps(snap, sort_keys=True))
        else:
            _render_fleet(snap, sys.stderr)
        if args.once:
            if not args.json:
                # the BENCH-style line owns stdout on the human path
                print(
                    json.dumps(
                        {
                            "metric": "obs_top",
                            "value": snap["reachable"],
                            "unit": "replicas",
                            "extra": {
                                "endpoints": snap["endpoints"],
                                "tenants": sorted(snap["tenants"]),
                                "qps": snap["fleet"]["qps"],
                                "slo_met": snap["fleet"]["slo_met"],
                            },
                        }
                    )
                )
            return 0 if snap["reachable"] else 2
        _time.sleep(args.interval)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="photon-obs",
        description="pod-level observability artifact tools",
    )
    sub = p.add_subparsers(dest="command", required=True)
    mp = sub.add_parser(
        "merge",
        help="merge per-process trace shards into one pod trace",
    )
    mp.add_argument(
        "shards",
        nargs="+",
        help="per-process trace directories (or trace.json paths)",
    )
    mp.add_argument(
        "--out",
        required=True,
        help="output directory for the merged pod artifacts",
    )
    mp.set_defaults(func=merge_command)
    cp = sub.add_parser(
        "convergence",
        help="render per-solve curves + fleet summaries from a run's "
        "events.jsonl",
    )
    cp.add_argument(
        "events",
        help="trace directory (or events.jsonl path) of a traced run",
    )
    cp.add_argument(
        "--last",
        type=int,
        default=8,
        help="how many of the most recent solves to render (default 8)",
    )
    cp.set_defaults(func=convergence_command)
    dp = sub.add_parser(
        "drift",
        help="compare two quality fingerprints; exit 1 on drift alarm "
        "(cron contract)",
    )
    dp.add_argument(
        "baseline",
        help="train-time quality-fingerprint.json (or its export dir)",
    )
    dp.add_argument(
        "current",
        help="newer fingerprint to compare (file or directory)",
    )
    dp.add_argument(
        "--threshold",
        type=float,
        default=0.25,
        help="PSI alarm threshold (default 0.25 — the conventional "
        "'action-worthy shift' reading)",
    )
    dp.add_argument(
        "--top",
        type=int,
        default=10,
        help="how many worst features to render (default 10)",
    )
    dp.set_defaults(func=drift_command)
    rp = sub.add_parser(
        "request",
        help="rebuild one request's causal timeline from event logs",
    )
    rp.add_argument("trace_id", help="the trace id (echoed in replies)")
    rp.add_argument(
        "shards",
        nargs="+",
        help="trace directories (or events.jsonl paths) to search",
    )
    rp.add_argument(
        "--last",
        type=int,
        default=5,
        help="recent trace ids to suggest when the id is absent "
        "(default 5)",
    )
    rp.set_defaults(func=request_command)
    tp = sub.add_parser(
        "top",
        help="aggregated live fleet console over replica admin channels",
    )
    tp.add_argument(
        "--endpoint",
        action="append",
        required=True,
        help="replica front-end host:port (repeatable)",
    )
    tp.add_argument(
        "--binary",
        action="store_true",
        help="speak the length-prefixed framing to the endpoints",
    )
    tp.add_argument(
        "--timeout",
        type=float,
        default=5.0,
        help="per-endpoint connect/answer timeout seconds (default 5)",
    )
    tp.add_argument(
        "--interval",
        type=float,
        default=2.0,
        help="refresh period in console mode (default 2s)",
    )
    tp.add_argument(
        "--once",
        action="store_true",
        help="poll once and exit (2 when no endpoint answered)",
    )
    tp.add_argument(
        "--json",
        action="store_true",
        help="print the full snapshot as one JSON line on stdout",
    )
    tp.add_argument(
        "--out",
        help="also write the snapshot to this fleet-snapshot.json path",
    )
    tp.set_defaults(func=top_command)
    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
