"""Stateless HTTP proxy tier: the fleet's replicated front door.

A server's own HTTP front is root-only — one process, one crash, no door.
A :class:`FleetProxy` is a front-door process that holds NO request
state: every endpoint reads or writes the shared durable queue (the
fsynced atomic-rename lifecycle IS the coordination substrate) plus the
replica heartbeat files, so any number of proxies can run behind a dumb
TCP load-balancer and any single process death loses nothing::

    POST /requests        validate + QoS quota check + fsynced enqueue
                          -> 202 {"id","steps","trace_id"}; 429 + a
                          jittered queue-depth-derived Retry-After header
                          on rejection (queue_full / quota), 400
                          malformed, 413 big; when a bearer-token
                          allowlist is configured (``auth_tokens=``),
                          401 ``auth_missing`` /
                          403 ``auth_invalid`` with constant-time compares
    GET  /requests/<id>   lifecycle record from durable state (404)
    GET  /requests/<id>/trace
                          cross-replica Perfetto timeline: proxy
                          admission + every replica's lifecycle rows +
                          campaign chunk spans stitched from the
                          ``replicas/<rid>/`` journals (one process lane
                          per journal source)
    GET  /stats           queue counts + per-tenant census + bucket
                          leases + replica heartbeat aggregation
    GET  /healthz         {"ok", "proxy", "queue", "replicas"} — a
                          proxy is healthy whenever the queue dir is;
                          replica liveness rides along for orchestrators
    GET  /metrics         Prometheus exposition of this proxy's registry

A submit is acknowledged only after the queue fsynced the request file —
the same durability contract the root front makes — and the ack is valid
even if every replica is momentarily dead: a replica that comes back (or
a survivor that breaks the dead one's leases) finds the request in the
shared queue.

**Replica heartbeats** (how stateless fronts answer "who is serving"):
each fleet-mode replica atomically rewrites
``<run_dir>/replicas/<id>.json`` every heartbeat with its stats
snapshot; :func:`read_replica_status` aggregates them with a staleness
verdict, and the proxy serves the aggregate on /stats and /healthz.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import json
import os
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ...telemetry import metrics as _tm
from ...telemetry.exporters import PROMETHEUS_CONTENT_TYPE, prometheus_text
from ...telemetry.reqtrace import assemble_fleet_request_trace
from ...utils.fsutil import atomic_write_text
from ...utils.journal import JournalWriter
from ..http_front import read_body, rejection_payload, reply_json, reply_text
from ..queue import DurableQueue
from ..request import AdmissionError, RequestError, SimRequest
from . import qos as _qos
from .lease import LeaseManager


def replicas_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "replicas")


def write_replica_heartbeat(run_dir: str, replica_id: str, payload: dict) -> None:
    """Atomically publish one replica's liveness + stats snapshot (tmp +
    rename + dirsync, like every durable write): proxies aggregate these
    files, so the write must never be observable half-done."""
    root = replicas_dir(run_dir)
    os.makedirs(root, exist_ok=True)
    record = {
        "replica": replica_id,
        "hb_unix": time.time(),
        "hb_mono": time.monotonic(),
        "pid": os.getpid(),
        **payload,
    }
    atomic_write_text(
        os.path.join(root, f"{replica_id}.json"),
        json.dumps(record, sort_keys=True),
    )


def read_replica_status(
    run_dir: str, ttl_s: float, journal=None
) -> list[dict]:
    """Every replica's last heartbeat, staleness-marked: ``stale`` is true
    when the heartbeat file has not been rewritten for ``ttl_s`` (file
    mtime vs this process's clock — display-grade; the authoritative
    failure detector is the lease sweep's observer-monotonic window).

    A heartbeat file that exists but won't parse (torn/truncated JSON —
    a crashed writer, a reader racing a non-atomic copy tool) is NOT a
    missing replica: it surfaces as a ``stale`` + ``torn`` entry with a
    warning, so autoscalers and dashboards see a sick replica instead of
    silently forgetting one.  Files that vanish mid-scan (replica
    retirement unlinking its heartbeat) are still skipped.

    **Clock-step hardening** (fleet/clock.py): a wall clock that stepped
    FORWARD past the staleness window since the last scan would mark
    every replica stale at once — an NTP correction read as a fleet-wide
    death.  The shared :data:`~rustpde_mpi_tpu_torch.serve.fleet.clock.MONITOR`
    detects the step against monotonic time, journals a one-shot
    ``clock_skew`` row (``journal`` optional), and this scan compensates
    ages by the step instead of mass-expiring; a BACKWARD step (mtimes
    ahead of our clock) clamps ages to zero rather than going negative."""
    from .clock import MONITOR

    root = replicas_dir(run_dir)
    out = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    now = time.time()
    skew = MONITOR.check(
        float(ttl_s), journal=journal, where="replica_heartbeats"
    )
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(root, name)
        try:
            age = now - os.stat(path).st_mtime
        except OSError:
            continue  # unlinked between listdir and stat
        if skew > 0.0:
            age -= skew  # forward step inflated every age by the step
        age = max(0.0, age)  # backward step / writer clock ahead of ours
        try:
            with open(path, encoding="utf-8") as fh:
                rec = json.load(fh)
        except OSError:
            continue
        except ValueError:
            warnings.warn(
                f"torn replica heartbeat {path}: treating as stale",
                RuntimeWarning,
                stacklevel=2,
            )
            out.append(
                {
                    "replica": name[: -len(".json")],
                    "torn": True,
                    "hb_age_s": round(age, 3),
                    "stale": True,
                }
            )
            continue
        rec["hb_age_s"] = round(age, 3)
        rec["stale"] = age > float(ttl_s)
        out.append(rec)
    return out


class FleetProxy:
    """One stateless front-door process over a shared fleet ``run_dir``.

    ``fleet`` (a :class:`~rustpde_mpi_tpu_torch.config.FleetConfig`) supplies
    the QoS quotas and the staleness TTL for replica reporting; ``None``
    serves without quotas (pure pass-through admission).  ``start()``
    binds (port 0 = ephemeral, see ``address``), ``stop()`` shuts down.
    Thread-safe by construction: handlers touch only the (locked) queue
    object and read-only durable state.

    ``auth_tokens`` is the bearer-token allowlist for MUTATING endpoints
    (POST /requests): any presented token must match one entry under a
    constant-time compare.  ``None`` or an empty list serves open (the
    pre-auth behavior, and the right call behind a trusted LB).  Reads
    (/stats, /healthz, /metrics, GET /requests/*) stay open: they expose
    no tenant payloads and orchestrator probes must not need secrets."""

    def __init__(
        self,
        run_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
        max_queue: int = 256,
        fleet=None,
        registry=None,
        auth_tokens: list[str] | None = None,
        submesh=None,
        vote_rate: float = 0.0,
    ):
        self.run_dir = run_dir
        self.fleet = fleet
        self.submesh = submesh
        # cross-replica voting (the integrity tentpole's fleet check):
        # the fraction of admitted requests double-assigned as an
        # independent ".vote" twin whose done-record state digest is
        # compared against the original's (check_votes)
        self.vote_rate = min(1.0, max(0.0, float(vote_rate)))
        self._votes_seen: set[str] = set()
        if auth_tokens is None:
            auth_tokens = []
        self.auth_tokens = tuple(auth_tokens)
        self.queue = DurableQueue(
            os.path.join(run_dir, "queue"), max_queue=int(max_queue)
        )
        pid = (
            fleet.resolved_replica_id()
            if fleet is not None
            else f"{os.getpid()}"
        )
        self.proxy_id = f"proxy-{pid}"
        self.ttl_s = fleet.resolved_ttl() if fleet is not None else 15.0
        self.registry = registry if registry is not None else _tm.default_registry()
        self._journal_writer = JournalWriter(
            os.path.join(replicas_dir(run_dir), self.proxy_id, "journal.jsonl")
        )
        self._leases = LeaseManager(
            os.path.join(run_dir, "queue", "leases"), self.proxy_id, self.ttl_s
        )
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-proxy", daemon=True
        )
        self._thread.start()
        self._journal(
            {"event": "proxy_listen", "address": list(self.address)}
        )

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._journal_writer.close()

    def _journal(self, event: dict) -> None:
        self._journal_writer.append({"proxy": self.proxy_id, **event})

    # -- the admission path (shared by every proxy endpoint handler) ----------

    def auth_check(self, headers) -> tuple[int, dict, dict] | None:
        """Bearer-token gate for mutating endpoints: ``None`` admits,
        else ``(status, payload, extra_headers)`` — 401 ``auth_missing``
        (no/malformed Authorization header, with a ``WWW-Authenticate``
        challenge) or 403 ``auth_invalid`` (well-formed but unknown
        token).  Every configured token is compared via
        :func:`hmac.compare_digest`, and ALL of them are always checked,
        so response timing leaks neither prefix matches nor which slot
        matched.  No tokens configured = open admission."""
        if not self.auth_tokens:
            return None
        presented = ""
        header = headers.get("Authorization") or ""
        if header.startswith("Bearer "):
            presented = header[len("Bearer ") :].strip()
        if not presented:
            code, reason = 401, "auth_missing"
            extra = {"WWW-Authenticate": "Bearer"}
        else:
            ok = False
            for token in self.auth_tokens:
                ok |= hmac.compare_digest(presented, token)
            if ok:
                return None
            code, reason, extra = 403, "auth_invalid", {}
        self.registry.counter(
            "fleet_auth_rejected_total",
            "mutating requests rejected by the proxy bearer-token gate",
            reason=reason,
        ).inc()
        self._journal({"event": "auth_rejected", "reason": reason})
        return code, {"error": "unauthorized", "reason": reason}, extra

    def submit(self, data: dict) -> SimRequest:
        """Validate + QoS-admit + durably enqueue one request.  The proxy
        NEVER talks to a replica: the fsynced queue file is the handoff.
        Raises RequestError (malformed) / AdmissionError (backpressure or
        quota)."""
        if not isinstance(data, dict):
            raise RequestError(
                f"request must be a JSON object, got {type(data).__name__}"
            )
        req = SimRequest.from_dict(data)
        req.validate()
        if (
            self.queue.dedupe_lookup(getattr(req, "idempotency_key", None))
            is not None
        ):
            # idempotent retry: skip quota/sub-mesh re-judgement, replay
            # the original submit's identity (queue._dedupe_into via
            # queue.submit — nothing is enqueued)
            req = self.queue.submit(req)
            return self._ack_deduped(req)
        if self.submesh is not None:
            # stamp sharded grids with their sub-mesh shape at the DOOR, so
            # every proxy and the root front bucket the same grid the same
            # way; permanent shape mismatches die here as typed 400s
            # instead of poisoning the durable queue
            self.queue.invalidate()
            pending = sum(
                1
                for _, queued in self.queue.snapshot_queued()
                if int(getattr(queued, "submesh", 0)) > 0
            )
            try:
                req = _qos.admit_submesh(req, pending, self.submesh)
            except (AdmissionError, ValueError) as exc:
                reason = getattr(exc, "reason", None)
                if reason not in ("no_submesh", "capacity"):
                    raise
                _tm.counter(
                    "fleet_submesh_rejected_total",
                    "submits rejected by sub-mesh admission",
                    reason=reason,
                ).inc()
                self._journal(
                    {
                        "event": "submesh_rejected",
                        "id": req.id,
                        "reason": reason,
                        "grid": [int(req.nx), int(req.ny)],
                    }
                )
                raise
        if self.fleet is not None:
            # stale cache is fine for a QUOTA (it only over/under-counts
            # by the race window), but refresh so peer-proxy submits count
            self.queue.invalidate()
            try:
                _qos.check_quota(req, self.queue.tenant_counts(), self.fleet)
            except AdmissionError as exc:
                _tm.counter(
                    "fleet_quota_rejected_total",
                    "submits rejected by per-tenant quota",
                    tenant=req.tenant,
                ).inc()
                self._journal(
                    {
                        "event": "quota_rejected",
                        "id": req.id,
                        "tenant": req.tenant,
                        "reason": exc.reason,
                    }
                )
                raise
        self.queue.submit(req)
        if getattr(req, "deduped", False):
            # lost a concurrent same-key race inside queue.submit
            return self._ack_deduped(req)
        _tm.counter(
            "fleet_proxy_admitted_total", "requests admitted via this proxy"
        ).inc()
        self._journal(
            {
                "event": "request_admitted",
                "id": req.id,
                "trace_id": req.trace_id,
                "tenant": req.tenant,
                "priority": req.priority,
                "key": list(req.compat_key),
                "via": "proxy",
            }
        )
        if self._vote_sampled(req):
            self._assign_vote(req)
        return req

    def _ack_deduped(self, req: SimRequest) -> SimRequest:
        _tm.counter(
            "fleet_proxy_deduped_total",
            "retries answered from the idempotency index via this proxy",
        ).inc()
        self._journal(
            {
                "event": "request_deduped",
                "id": req.id,
                "trace_id": req.trace_id,
                "idempotency_key": req.idempotency_key,
                "via": "proxy",
            }
        )
        return req

    # -- cross-replica voting (integrity/) ------------------------------------

    def _vote_sampled(self, req: SimRequest) -> bool:
        """Deterministic per-id sampling at ``vote_rate`` (never a vote of
        a vote): every proxy derives the same verdict from the id, so a
        retry routed through a different front cannot double-vote."""
        if self.vote_rate <= 0.0 or req.id.endswith(".vote"):
            return False
        h = int(hashlib.sha256(req.id.encode("utf-8")).hexdigest()[:8], 16)
        return (h / float(0xFFFFFFFF)) < self.vote_rate

    def _assign_vote(self, req: SimRequest) -> None:
        """Double-assign one sampled request: an independent ``.vote``
        twin (same physics, seed, and dt — a deterministic executable
        yields a bit-equal end state) is enqueued as ordinary work.  When
        both done-records exist, :meth:`check_votes` compares their state
        digests: a disagreement is silent corruption that BOTH executions'
        own audits missed — the strongest end-to-end check the fleet has.
        Best-effort: a twin the queue rejects (backpressure) is dropped,
        the original request is never affected."""
        twin = dataclasses.replace(
            req,
            id=f"{req.id}.vote",
            idempotency_key=None,
            trace=None,  # __post_init__ mints the twin its own trace
            dts=list(req.dts),
        )
        try:
            self.queue.submit(twin)
        except AdmissionError:
            return
        _tm.counter(
            "fleet_votes_assigned_total",
            "sampled requests double-assigned for digest voting",
        ).inc()
        self._journal(
            {"event": "vote_assigned", "id": req.id, "vote_id": twin.id}
        )

    def _done_record(self, rid: str) -> dict | None:
        path = os.path.join(self.run_dir, "queue", "done", f"{rid}.json")
        try:
            with open(path, encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def check_votes(self) -> list[dict]:
        """Resolve completed vote pairs: for every ``<id>.vote`` done
        record whose original is also done, compare the two
        ``state_digest`` values and journal the verdict —
        ``integrity_vote`` always, ``integrity_vote_mismatch`` on
        disagreement (match=None when either record carries no digest:
        the service ran without integrity armed).  Incomplete pairs wait
        for a later scan; each pair is verdicted once per proxy process.
        Called from ``stats()`` so any scrape advances the votes."""
        done_dir = os.path.join(self.run_dir, "queue", "done")
        try:
            names = os.listdir(done_dir)
        except OSError:
            return []
        out = []
        for name in sorted(names):
            if not name.endswith(".vote.json"):
                continue
            vid = name[: -len(".json")]
            rid = vid[: -len(".vote")]
            if rid in self._votes_seen:
                continue
            rec_v = self._done_record(vid)
            rec_o = self._done_record(rid)
            if rec_v is None or rec_o is None:
                continue  # pair incomplete — a later scan resolves it
            self._votes_seen.add(rid)
            d_orig = (rec_o.get("result") or {}).get("state_digest")
            d_vote = (rec_v.get("result") or {}).get("state_digest")
            match = (
                None
                if d_orig is None or d_vote is None
                else bool(int(d_orig) == int(d_vote))
            )
            verdict = {
                "id": rid,
                "vote_id": vid,
                "match": match,
                "digests": [d_orig, d_vote],
            }
            _tm.counter(
                "fleet_votes_resolved_total",
                "vote pairs verdicted by digest comparison",
                match=str(match).lower(),
            ).inc()
            self._journal({"event": "integrity_vote", **verdict})
            if match is False:
                self._journal(
                    {"event": "integrity_vote_mismatch", **verdict}
                )
            out.append(verdict)
        return out

    def stats(self) -> dict:
        self.queue.invalidate()  # other processes write the shared dir
        self.check_votes()  # advance pending digest votes on every scrape
        return {
            "proxy": self.proxy_id,
            "votes_checked": len(self._votes_seen),
            "queue": self.queue.counts(),
            "tenants": self.queue.tenant_counts(),
            "leases": self._leases.holders(),
            "replicas": read_replica_status(
                self.run_dir, 2.0 * self.ttl_s, journal=self._journal
            ),
        }

    def _make_handler(self):
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            timeout = 30.0

            def log_message(self, fmt, *args):  # journal is the log
                pass

            def do_GET(self):
                proxy.registry.counter(
                    "fleet_proxy_requests_total",
                    "HTTP requests served by the proxy tier",
                    method="GET",
                ).inc()
                if self.path == "/healthz":
                    replicas = read_replica_status(
                        proxy.run_dir, 2.0 * proxy.ttl_s
                    )
                    return reply_json(
                        self,
                        200,
                        {
                            "ok": True,
                            "proxy": proxy.proxy_id,
                            "queue": proxy.queue.counts(),
                            "replicas_alive": sum(
                                1 for r in replicas if not r["stale"]
                            ),
                            "replicas": replicas,
                        },
                    )
                if self.path == "/metrics":
                    return reply_text(
                        self,
                        200,
                        prometheus_text(proxy.registry),
                        PROMETHEUS_CONTENT_TYPE,
                    )
                if self.path == "/stats":
                    return reply_json(self, 200, proxy.stats())
                if self.path.startswith("/requests/") and self.path.endswith(
                    "/trace"
                ):
                    rid = self.path.strip("/").split("/")[-2]
                    payload = assemble_fleet_request_trace(proxy.run_dir, rid)
                    if payload is None:
                        return reply_json(
                            self, 404, {"error": "unknown request id"}
                        )
                    return reply_json(self, 200, payload)
                if self.path.startswith("/requests/"):
                    rid = self.path.strip("/").split("/")[-1]
                    proxy.queue.invalidate()  # replicas mutate behind us
                    found = proxy.queue.lookup(rid)
                    if found is None:
                        return reply_json(
                            self, 404, {"error": "unknown request id"}
                        )
                    state, record = found
                    return reply_json(
                        self, 200, {"id": rid, "state": state, **record}
                    )
                return reply_json(self, 404, {"error": "unknown endpoint"})

            def do_POST(self):
                proxy.registry.counter(
                    "fleet_proxy_requests_total",
                    "HTTP requests served by the proxy tier",
                    method="POST",
                ).inc()
                if self.path != "/requests":
                    return reply_json(self, 404, {"error": "unknown endpoint"})
                denied = proxy.auth_check(self.headers)
                if denied is not None:
                    code, payload, extra = denied
                    return reply_json(self, code, payload, extra)
                body, err = read_body(self)
                if err is not None:
                    code, message = err
                    return reply_json(self, code, {"error": message})
                try:
                    req = proxy.submit(json.loads(body or b"{}"))
                except AdmissionError as exc:
                    proxy.queue.invalidate()
                    payload, headers = rejection_payload(
                        exc, proxy.queue.counts()["queued"]
                    )
                    # storage_full is a 503 (the queue volume hit ENOSPC:
                    # service impairment, not client backpressure) so load
                    # balancers fail the proxy over instead of retrying it
                    code = 503 if exc.reason == "storage_full" else 429
                    return reply_json(self, code, payload, headers)
                except (RequestError, ValueError, TypeError) as exc:
                    payload = {"error": str(exc)}
                    reason = getattr(exc, "reason", None)
                    if reason:
                        payload["reason"] = reason
                    return reply_json(self, 400, payload)
                payload = {
                    "id": req.id,
                    "steps": req.steps,
                    "trace_id": req.trace_id,
                }
                if getattr(req, "deduped", False):
                    payload["deduped"] = True
                    return reply_json(self, 200, payload)
                return reply_json(self, 202, payload)

        return Handler
