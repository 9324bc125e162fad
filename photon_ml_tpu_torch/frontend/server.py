"""Asyncio front end: multiplexed connections, dual framing, streaming
batches, backpressure as an explicit wire answer (a copy of
``photon_ml_tpu/frontend/server.py``).

The event loop runs on its own daemon thread and never waits on the
card: a frame's requests go to the submit function (the tenant layer's
shared batcher), whose worker thread scores them, and the loop awaits
only the futures.

`cli/serve.py`'s original protocol is one blocking JSON-line per
request per connection — fine for an admin channel, fatal for a fleet
front end (every in-flight request holds a thread and a connection).
This server multiplexes: requests carry client-chosen ``id``s, replies
come back in COMPLETION order, and one connection can keep hundreds of
requests in flight while the micro-batcher coalesces them.

Framing — auto-detected per connection from the first byte:

- **JSON-lines** (first byte ``{``): one JSON object per ``\\n`` line.
  Debuggable with ``nc``; the serving_lab client speaks it.
- **Length-prefixed binary** (anything else): 4-byte big-endian length,
  then that many bytes of UTF-8 JSON. No line-scanning on the hot path
  and embedded newlines are legal; frames above ``max_frame_bytes``
  close the connection (a malformed length prefix must not make the
  server allocate unbounded memory).

Request envelope (both framings)::

    {"id": 7, "tenant": "t0", "features": {...}, "entities": {...}}
    {"id": 8, "tenant": "t1", "batch": [{...}, {...}], "stream": true}
    {"id": 9, "cmd": "tenants"}            # admin passthrough

Replies are tagged with the request's ``id``. A batch reply is one
``{"id", "scores": [...]}`` message, or — with ``"stream": true`` — one
``{"id", "seq", "score"}`` message per row AS EACH ROW'S FUTURE
RESOLVES plus a final ``{"id", "done": n}``; a streaming client renders
early rows while late ones still sit in the admission queue.

Backpressure is an ANSWER, not a drop: when the admission queue is full
past the shed policy the reply is ``{"id", "error", "code":
"RESOURCE_EXHAUSTED"}`` — the client knows immediately and can back
off; a deadline that expires in-queue comes back ``DEADLINE_EXCEEDED``.
The server never silently discards an accepted frame.

Fault site ``frontend.accept`` (key = peer address) probes every
accepted connection: raise-mode drops the connection at accept (the
listener stays up), delay-mode is a slow accept path.
"""

from __future__ import annotations

import asyncio
import json
import socket
import struct
import threading
import time
from typing import Callable, Optional

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.obs import reqtrace as _reqtrace
from photon_ml_tpu_torch.resilience import faults as _faults
from photon_ml_tpu_torch.serving.batcher import Backpressure, DeadlineExceeded
from photon_ml_tpu_torch.serving.engine import ScoreRequest

__all__ = ["FrontendServer", "FrontendClient"]

_LEN = struct.Struct(">I")


def _error_code(exc: BaseException) -> str:
    if isinstance(exc, Backpressure):
        return "RESOURCE_EXHAUSTED"
    if isinstance(exc, DeadlineExceeded):
        return "DEADLINE_EXCEEDED"
    if isinstance(exc, (KeyError, ValueError, TypeError)):
        return "INVALID_ARGUMENT"
    return "INTERNAL"


def _parse_request(obj: dict) -> ScoreRequest:
    return ScoreRequest(
        features=obj.get("features") or {},
        entities=obj.get("entities") or {},
        offset=float(obj.get("offset", 0.0)),
    )


class _Conn:
    """Per-connection state: framing mode + a write lock so concurrent
    reply tasks never interleave bytes on the socket."""

    def __init__(self, reader, writer, binary: bool):
        self.reader = reader
        self.writer = writer
        self.binary = binary
        self.wlock = asyncio.Lock()

    async def send(self, obj: dict) -> int:
        data = json.dumps(obj).encode()
        async with self.wlock:
            if self.binary:
                self.writer.write(_LEN.pack(len(data)) + data)
            else:
                self.writer.write(data + b"\n")
            # socket backpressure: a slow reader stalls ITS replies here,
            # never the scoring path (reply tasks are per-request)
            await self.writer.drain()
        return len(data)


class FrontendServer:
    """The async multiplexing front end over a :class:`TenantManager`.

    ``submit_fn(tenant, request) -> concurrent.futures.Future`` is the
    scoring entry (``TenantManager.submit``, or a plain batcher adapted
    with ``lambda _t, r: batcher.submit(r)``). ``admin_fn(obj) -> dict``
    (optional) answers ``{"cmd": ...}`` frames — cli/serve.py passes its
    existing command handler so the old protocol rides along as the
    compat admin channel.

    Runs its own event loop in a daemon thread: ``start()`` binds and
    returns (``.port`` is then live), ``stop()`` closes the listener,
    cancels per-connection tasks, and joins the thread. In-flight
    requests already admitted to the batcher still resolve — their
    reply tasks are awaited during shutdown grace.
    """

    def __init__(
        self,
        submit_fn: Callable,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        admin_fn: Optional[Callable[[dict], dict]] = None,
        default_tenant: Optional[str] = None,
        max_frame_bytes: int = 1 << 20,
    ):
        self.submit_fn = submit_fn
        self.admin_fn = admin_fn
        self.host = host
        self.port = port
        self.default_tenant = default_tenant
        self.max_frame_bytes = max_frame_bytes
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._conn_tasks: set = set()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FrontendServer":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._thread = threading.Thread(
            target=self._run, name="frontend-server", daemon=True
        )
        self._thread.start()
        if not self._started.wait(10.0):
            raise RuntimeError("frontend server failed to start")
        return self

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._server = self._loop.run_until_complete(
                asyncio.start_server(
                    self._on_connection, self.host, self.port,
                    limit=self.max_frame_bytes + 1024,
                )
            )
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()
            self._loop.run_forever()
            # shutdown grace: let reply tasks for already-admitted
            # requests finish writing
            pending = [t for t in self._conn_tasks if not t.done()]
            for t in pending:
                t.cancel()
            if pending:
                self._loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            self._server.close()
            self._loop.run_until_complete(self._server.wait_closed())
        finally:
            self._started.set()  # unblock start() on bind failure
            self._loop.close()

    def stop(self) -> None:
        if self._loop is None:
            return
        if self._loop.is_running():
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(10.0)

    def __enter__(self) -> "FrontendServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- connection handling ----------------------------------------------

    async def _on_connection(self, reader, writer) -> None:
        peer = writer.get_extra_info("peername")
        reg = obs.registry()
        try:
            # chaos seam: one bad accept drops ONE connection; the
            # listener and every other connection keep serving
            _faults.fire(
                "frontend.accept",
                key=str(peer[0] if peer else "?"),
            )
        except OSError:
            reg.inc("frontend.accept_rejected")
            writer.close()
            return
        reg.inc("frontend.connections")
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        conn: Optional[_Conn] = None
        try:
            first = await reader.readexactly(1)
            conn = _Conn(reader, writer, binary=first != b"{")
            if conn.binary:
                await self._serve_binary(conn, first)
            else:
                await self._serve_lines(conn, first)
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            asyncio.CancelledError,
            ValueError,  # line overran the stream limit — drop the conn
        ):
            pass
        finally:
            self._conn_tasks.discard(task)
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — already torn down
                pass

    async def _serve_lines(self, conn: _Conn, first: bytes) -> None:
        # wire-read timing starts at each frame's FIRST byte (the
        # untimed 1-byte read absorbs client think-time between frames),
        # so wire_read_ms is transfer time, not connection idle
        reg = obs.registry()
        while True:
            t0 = time.perf_counter()
            rest = await conn.reader.readline()
            wire_ms = (time.perf_counter() - t0) * 1e3
            line = first + rest
            first = b""
            if not line:
                return
            if len(line) > self.max_frame_bytes:
                await conn.send({
                    "error": "frame too large",
                    "code": "INVALID_ARGUMENT",
                })
                return
            if line.strip():
                reg.inc("frontend.frames")
                reg.inc("frontend.bytes_in", len(line))
                await self._dispatch(conn, line, wire_ms)
            try:
                first = await conn.reader.readexactly(1)
            except asyncio.IncompleteReadError:
                return

    async def _serve_binary(self, conn: _Conn, first: bytes) -> None:
        reg = obs.registry()
        while True:
            t0 = time.perf_counter()
            head = first + await conn.reader.readexactly(4 - len(first))
            (n,) = _LEN.unpack(head)
            if n > self.max_frame_bytes:
                await conn.send({
                    "error": f"frame of {n} bytes exceeds "
                             f"{self.max_frame_bytes}",
                    "code": "INVALID_ARGUMENT",
                })
                return
            payload = await conn.reader.readexactly(n)
            wire_ms = (time.perf_counter() - t0) * 1e3
            reg.inc("frontend.frames")
            reg.inc("frontend.bytes_in", n + 4)
            await self._dispatch(conn, payload, wire_ms)
            first = await conn.reader.readexactly(1)

    async def _dispatch(
        self, conn: _Conn, raw: bytes, wire_ms: float = 0.0
    ) -> None:
        """Parse one frame and start its reply task — the reader loop
        moves straight on to the next frame (the multiplexing)."""
        reg = obs.registry()
        try:
            obj = json.loads(raw)
            if not isinstance(obj, dict):
                raise ValueError("frame must be a JSON object")
        except ValueError as e:
            reg.inc("frontend.bad_frames")
            await conn.send({
                "error": f"bad frame: {e}", "code": "INVALID_ARGUMENT",
            })
            return
        rid = obj.get("id")
        if "cmd" in obj:
            await self._reply_admin(conn, rid, obj)
            return
        # request causality (docs/OBSERVABILITY.md): accept the client's
        # `trace` field or issue one here — the id rides the tenant
        # envelope into the batcher and comes back in every reply, so
        # `photon-obs request <id>` can rebuild the timeline
        trace, issued = _reqtrace.ensure_trace_id(obj.get("trace"))
        if issued:
            reg.inc("frontend.traces_issued")
        tracer = obs.get_tracer()
        if tracer is not None:
            # retro wire-read span: the frame's transfer time, stamped
            # now that its trace id is known
            end_us = tracer.now_us()
            dur_us = max(wire_ms, 0.0) * 1e3
            tracer.add_span(
                "frontend.wire_read", end_us - dur_us, dur_us,
                cat="frontend",
                args={"trace": trace, "bytes": len(raw)},
            )
        tenant = obj.get("tenant", self.default_tenant)
        # envelope-level deadline/priority override the tenant defaults
        # for every request in the frame (compat with the old per-line
        # protocol's fields)
        kw = {"trace": trace, "wire_read_ms": wire_ms}
        if obj.get("deadline_ms") is not None:
            kw["deadline_ms"] = float(obj["deadline_ms"])
        if obj.get("priority") is not None:
            kw["priority"] = int(obj["priority"])
        try:
            if "batch" in obj:
                futs = [
                    self.submit_fn(tenant, _parse_request(r), **kw)
                    for r in obj["batch"]
                ]
            else:
                futs = [self.submit_fn(tenant, _parse_request(obj), **kw)]
        except BaseException as e:  # noqa: BLE001 — answered on the wire
            reg.inc("frontend.rejected")
            await conn.send({
                "id": rid, "trace": trace,
                "error": str(e), "code": _error_code(e),
            })
            return
        wrapped = [
            asyncio.wrap_future(f, loop=self._loop) for f in futs
        ]
        task = self._loop.create_task(
            self._reply(conn, rid, obj, wrapped, trace)
        )
        # keep a reference so shutdown grace can await it
        self._conn_tasks.add(task)
        task.add_done_callback(self._conn_tasks.discard)

    async def _reply_admin(self, conn: _Conn, rid, obj: dict) -> None:
        if self.admin_fn is None:
            await conn.send({
                "id": rid, "error": "no admin channel",
                "code": "INVALID_ARGUMENT",
            })
            return
        try:
            out = await self._loop.run_in_executor(
                None, self.admin_fn, obj
            )
        except BaseException as e:  # noqa: BLE001 — answered on the wire
            out = {"error": str(e), "code": _error_code(e)}
        out = dict(out or {})
        if rid is not None:
            out["id"] = rid
        await conn.send(out)

    @staticmethod
    def _note_reply_write(trace: str, write_s: float, nbytes: int) -> None:
        """Retro-emit the reply-write segment — the trailing edge of the
        request timeline (``photon-obs request`` closes the gap between
        the device call and the bytes leaving the host with it)."""
        tracer = obs.get_tracer()
        if tracer is None:
            return
        end_us = tracer.now_us()
        dur_us = max(write_s, 0.0) * 1e6
        tracer.add_span(
            "frontend.reply_write", end_us - dur_us, dur_us,
            cat="frontend", args={"trace": trace, "bytes": nbytes},
        )

    async def _reply(self, conn: _Conn, rid, obj: dict, futs,
                     trace: str) -> None:
        reg = obs.registry()
        stream = bool(obj.get("stream")) and "batch" in obj
        single = "batch" not in obj
        write_s = 0.0
        wrote = 0
        try:
            if stream:
                done = 0
                for seq, f in enumerate(futs):
                    msg = {"id": rid, "seq": seq, "trace": trace}
                    try:
                        msg["score"] = await f
                        done += 1
                    except BaseException as e:  # noqa: BLE001
                        msg["error"] = str(e)
                        msg["code"] = _error_code(e)
                        reg.inc("frontend.rejected")
                    t0 = time.perf_counter()
                    sent = await conn.send(msg)
                    write_s += time.perf_counter() - t0
                    wrote += sent
                    reg.inc("frontend.bytes_out", sent)
                t0 = time.perf_counter()
                sent = await conn.send({
                    "id": rid, "done": done, "trace": trace,
                })
                write_s += time.perf_counter() - t0
                wrote += sent
                reg.inc("frontend.bytes_out", sent)
                reg.inc("frontend.replies")
                self._note_reply_write(trace, write_s, wrote)
                return
            scores, errors = [], []
            for f in futs:
                try:
                    scores.append(await f)
                except BaseException as e:  # noqa: BLE001
                    scores.append(None)
                    errors.append({
                        "index": len(scores) - 1,
                        "error": str(e),
                        "code": _error_code(e),
                    })
            if single:
                if errors:
                    reg.inc("frontend.rejected")
                    msg = {"id": rid, **{
                        k: errors[0][k] for k in ("error", "code")
                    }}
                else:
                    msg = {"id": rid, "score": scores[0]}
            else:
                msg = {"id": rid, "scores": scores}
                if errors:
                    reg.inc("frontend.rejected", len(errors))
                    msg["errors"] = errors
            msg["trace"] = trace
            t0 = time.perf_counter()
            sent = await conn.send(msg)
            write_s += time.perf_counter() - t0
            reg.inc("frontend.bytes_out", sent)
            reg.inc("frontend.replies")
            self._note_reply_write(trace, write_s, sent)
        except (ConnectionError, asyncio.CancelledError):
            pass  # client went away; scoring already happened


class FrontendClient:
    """Small synchronous client for tests, drills, and serving_lab.

    Speaks either framing (``binary=True`` for length-prefixed) and
    multiplexes: ``submit`` sends without waiting, ``recv`` returns the
    next COMPLETION-ordered reply, ``call`` does a blocking round trip
    matched by id. One lock per direction, so a sender and a receiver
    thread can pump the same connection concurrently (the closed-loop
    shape serving_lab uses)."""

    def __init__(self, host: str, port: int, *, binary: bool = False,
                 timeout: Optional[float] = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.binary = binary
        self._rfile = self.sock.makefile("rb")
        self._next_id = 0
        self._slock = threading.Lock()
        self._rlock = threading.Lock()
        self._pending: dict = {}

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self.sock.close()

    def __enter__(self) -> "FrontendClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def submit(self, obj: dict) -> int:
        """Send one frame (assigning ``id`` when absent); returns the id."""
        with self._slock:
            if "id" not in obj:
                self._next_id += 1
                obj = dict(obj, id=self._next_id)
            data = json.dumps(obj).encode()
            if self.binary:
                self.sock.sendall(_LEN.pack(len(data)) + data)
            else:
                self.sock.sendall(data + b"\n")
            return obj["id"]

    def recv(self) -> dict:
        """Next reply in completion order."""
        with self._rlock:
            if self.binary:
                head = self._rfile.read(4)
                if len(head) < 4:
                    raise ConnectionError("server closed")
                (n,) = _LEN.unpack(head)
                return json.loads(self._rfile.read(n))
            line = self._rfile.readline()
            if not line:
                raise ConnectionError("server closed")
            return json.loads(line)

    def call(self, obj: dict) -> dict:
        """Blocking round trip matched by id (other ids seen along the
        way are parked for their own callers)."""
        rid = self.submit(obj)
        while True:
            with self._rlock:
                if rid in self._pending:
                    return self._pending.pop(rid)
            msg = self.recv()
            if msg.get("id") == rid:
                return msg
            with self._rlock:
                self._pending[msg.get("id")] = msg
