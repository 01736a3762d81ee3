"""Thin HTTP front for the simulation service (stdlib only; the JAX
package's ``serve/http_front.py``, the same endpoints, status codes,
payloads and ``Retry-After`` headers).

A :class:`~http.server.ThreadingHTTPServer` on a daemon thread, speaking a
seven-endpoint JSON protocol over the :class:`~.scheduler.SimServer`'s
thread-safe surface::

    POST /requests        {"ra":1e4,"horizon":0.1,...}  -> 202 {"id", "steps",
                          "trace_id"} — the trace id names the request's
                          whole lifecycle across restarts
                          an "idempotency_key" field makes retries safe:
                          a repeat submit with a seen key replays the
                          original ack as 200 {...,"deduped":true}
                          instead of enqueueing duplicate work
                          429 {"error","reason","queue_depth",
                          "retry_after_s"} + a Retry-After header on
                          admission rejection (queue_full / draining /
                          quota), so clients back off intelligently;
                          503 + Retry-After when the queue volume is out
                          of space (reason="storage_full")
                          400 on a malformed request body / bad
                          Content-Length / truncated body, 413 oversized
    GET  /requests/<id>   lifecycle record               (404 unknown)
    GET  /requests/<id>/trace  the request's assembled Perfetto timeline
                          (admission -> queued -> scheduled -> chunks ->
                          re-bucket -> done, across incarnations) — load it
                          straight into ui.perfetto.dev  (404 unknown)
    GET  /stats           queue counts + throughput counters
    GET  /healthz         {"ok", "draining", "queue", "slots"} — liveness
                          plus queue depth and slot utilization, so an
                          orchestrator can see back-pressure, not just "up"
    GET  /metrics         Prometheus text exposition of the live registry
                          (telemetry/exporters.py) — point a scraper here
    POST /profile?seconds=N   on-demand torch.profiler capture into
                          <run_dir>/profiles (ServeConfig.profile_max_s cap,
                          single-flight: 409 while one runs, 400 bad args)
    POST /drain           ask the service to drain       -> 202

Durability lives BELOW this layer: a submit is acknowledged only after the
queue fsynced the request file, so an accepted 202 survives any crash.
The handlers read host state only (the queue's files, the scheduler's
host counters): none of them touches a device tensor, so a request never
waits on, or reads into, a chunk graph being replayed.
The front is deliberately minimal — no auth, no TLS, bind it to loopback
(the default) and put a real proxy in front for anything public.
"""

from __future__ import annotations

import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..telemetry import metrics as _tm
from ..telemetry.exporters import PROMETHEUS_CONTENT_TYPE, prometheus_text
from .request import AdmissionError, RequestError

#: request bodies past this are rejected with 413 before any parse — a
#: SimRequest is a handful of scalars; megabyte bodies are abuse or bugs
MAX_BODY_BYTES = 1 << 20


def reply_json(handler, code: int, payload: dict, headers: dict | None = None) -> None:
    """One JSON reply, shared by every front (the root server's handler
    and the fleet proxy's): Content-Length framed, optional extra headers
    (the 429 path's ``Retry-After``)."""
    body = json.dumps(payload).encode("utf-8")
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for name, value in (headers or {}).items():
        handler.send_header(name, str(value))
    handler.end_headers()
    handler.wfile.write(body)


def reply_text(handler, code: int, text: str, content_type: str) -> None:
    body = text.encode("utf-8")
    handler.send_response(code)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def read_body(handler):
    """Validated request body, or (code, error) on a broken frame:
    non-integer/negative Content-Length -> 400, oversized -> 413,
    truncated (client hung up early) -> 400.  Never trusts the header for
    the read — the socket read is capped and the byte count re-checked."""
    raw = handler.headers.get("Content-Length", "0")
    try:
        length = int(raw)
    except (TypeError, ValueError):
        return None, (400, f"bad Content-Length: {raw!r}")
    if length < 0:
        return None, (400, f"bad Content-Length: {raw!r}")
    if length > MAX_BODY_BYTES:
        return None, (
            413,
            f"request body of {length} bytes exceeds the "
            f"{MAX_BODY_BYTES}-byte limit",
        )
    body = handler.rfile.read(length)
    if len(body) != length:
        return None, (
            400,
            f"truncated body: Content-Length {length}, got {len(body)} bytes",
        )
    return body, None


#: jitter stream for 429 Retry-After values — module-level so tests can
#: pin it (seed_retry_jitter) and every front in the process shares one
#: sequence; NOT the random module's global state, which user code owns
_retry_jitter = random.Random()


def seed_retry_jitter(seed) -> None:
    """Re-seed the Retry-After jitter stream.  Tests pin this for
    deterministic backoff assertions; production leaves it entropy-seeded
    so a rejected client herd doesn't re-arrive in lockstep."""
    _retry_jitter.seed(seed)


def rejection_payload(exc: AdmissionError, queue_depth: int):
    """The 429 body + headers for one admission rejection: machine-
    readable reason, the live queue depth, and a ``Retry-After`` both in
    the JSON and as the standard header — so clients can back off
    intelligently instead of hammering a full queue.

    The advice is queue-depth-derived and JITTERED: the base grows with
    the live backlog (a deep queue needs longer than the exception's
    floor to drain) and a ±50% multiplicative jitter de-synchronizes the
    herd — N clients rejected in the same burst must not all come back
    on the same second.  Invariants the clients rely on: the value is an
    integer ≥ 1 and the header always equals the JSON field."""
    base_s = float(exc.retry_after_s) + 0.25 * max(0, int(queue_depth))
    retry_after = max(1, int(round(base_s * _retry_jitter.uniform(0.5, 1.5))))
    payload = {
        "error": str(exc),
        "reason": exc.reason,
        "queue_depth": int(queue_depth),
        "retry_after_s": retry_after,
    }
    return payload, {"Retry-After": retry_after}


class HttpFront:
    """Lifecycle wrapper: ``start()`` binds (port 0 = ephemeral, see
    ``address``), ``stop()`` shuts the listener down.  Handlers call the
    server's thread-safe methods only.  ``registry`` defaults to the
    process-wide telemetry registry rendered by ``GET /metrics``."""

    def __init__(self, sim_server, host: str = "127.0.0.1", port: int = 0,
                 registry=None):
        self.sim = sim_server
        self.registry = registry if registry is not None else _tm.default_registry()
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _make_handler(self):
        sim = self.sim
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            # socket timeout (socketserver applies it in setup()): a client
            # that promises a body and then goes SILENT — without hanging
            # up — must not wedge a handler thread forever; the 400/413
            # checks below only cover malformed/oversized/EOF frames
            timeout = 30.0

            def log_message(self, fmt, *args):  # quiet: the journal is the log
                pass

            def _reply(self, code: int, payload: dict, headers: dict | None = None) -> None:
                reply_json(self, code, payload, headers)

            def _reply_text(self, code: int, text: str, content_type: str) -> None:
                reply_text(self, code, text, content_type)

            def do_GET(self):
                registry.counter(
                    "http_requests_total", "HTTP requests served", method="GET"
                ).inc()
                if self.path == "/healthz":
                    # enriched liveness: queue depth + slot utilization ride
                    # along, so "up but drowning" is visible to the prober
                    return self._reply(
                        200,
                        {
                            "ok": True,
                            "draining": sim.draining,
                            "queue": sim.queue.counts(),
                            "slots": sim.slot_info(),
                        },
                    )
                if self.path == "/metrics":
                    return self._reply_text(
                        200, prometheus_text(registry), PROMETHEUS_CONTENT_TYPE
                    )
                if self.path == "/stats":
                    return self._reply(200, sim.stats())
                if self.path.startswith("/requests/"):
                    parts = self.path.strip("/").split("/")
                    if len(parts) == 3 and parts[2] == "trace":
                        trace = sim.request_trace(parts[1])
                        if trace is None:
                            return self._reply(
                                404, {"error": "unknown request id (or no "
                                              "trace recorded for it)"}
                            )
                        return self._reply(200, trace)
                    status = sim.status(parts[-1])
                    if status is None:
                        return self._reply(404, {"error": "unknown request id"})
                    return self._reply(200, status)
                return self._reply(404, {"error": "unknown endpoint"})

            def _read_body(self):
                return read_body(self)

            def do_POST(self):
                registry.counter(
                    "http_requests_total", "HTTP requests served", method="POST"
                ).inc()
                if self.path == "/drain":
                    sim.request_drain()
                    return self._reply(202, {"draining": True})
                if self.path.split("?", 1)[0] == "/profile":
                    from urllib.parse import parse_qs, urlsplit

                    query = parse_qs(urlsplit(self.path).query)
                    seconds = (query.get("seconds") or ["5"])[0]
                    try:
                        seconds = float(seconds)
                    except ValueError:
                        return self._reply(
                            400, {"error": f"bad seconds {seconds!r}"}
                        )
                    status = sim.profile_capture(seconds)
                    if status.get("started"):
                        return self._reply(202, status)
                    code = 409 if "already running" in status.get("error", "") else 400
                    return self._reply(code, status)
                if self.path != "/requests":
                    return self._reply(404, {"error": "unknown endpoint"})
                body, err = self._read_body()
                if err is not None:
                    code, message = err
                    return self._reply(code, {"error": message})
                try:
                    data = json.loads(body or b"{}")
                    req = sim.submit(data)
                except AdmissionError as exc:
                    # 429 with a Retry-After header + the live queue depth
                    # in the body: clients see WHY and for HOW LONG, not a
                    # bare reason string.  A storage_full reject is a 503:
                    # the SERVICE is impaired (the queue volume hit
                    # ENOSPC), not the client over a bound — load
                    # balancers fail over on 5xx, which is the right call
                    payload, headers = rejection_payload(
                        exc, sim.queue.counts()["queued"]
                    )
                    code = 503 if exc.reason == "storage_full" else 429
                    return self._reply(code, payload, headers)
                except (RequestError, ValueError, TypeError) as exc:
                    # typed malformed-request rejects (e.g. the sub-mesh
                    # admission's "no_submesh") carry a machine-readable
                    # reason alongside the human-readable message
                    payload = {"error": str(exc)}
                    reason = getattr(exc, "reason", None)
                    if reason:
                        payload["reason"] = reason
                    return self._reply(400, payload)
                payload = {
                    "id": req.id,
                    "steps": req.steps,
                    "trace_id": req.trace_id,
                }
                if getattr(req, "deduped", False):
                    # idempotent retry: replay the ORIGINAL ack (200, not
                    # 202 — nothing new was accepted) with the marker
                    payload["deduped"] = True
                    return self._reply(200, payload)
                return self._reply(202, payload)

        return Handler
