"""HTTP demo API (counterpart of ``ratelimiter_tpu/service/app.py``).

The five endpoints of the reference's controller (DemoController.java:39-140)
with the same request/response shapes and 429 semantics:

- ``GET  /api/data``               — api limiter, key = X-User-ID or "anonymous"
- ``POST /api/login``              — auth limiter, key = body username
- ``POST /api/batch``              — burst limiter, permits = body size,
                                     key = required X-User-ID
- ``GET  /api/health``             — not rate limited
- ``DELETE /api/admin/reset/{id}`` — resets all three limiters for the user
  (also mounted at ``/admin/reset/{id}``, the path the reference's README
  documents)

Plus the actuator routes (``/actuator/health``, ``metrics``,
``prometheus``, ``tenants``, ``policies``, ``flightrecorder``, ``trace``
and the tier routes).  Every response is the reference app's, byte for
byte, with one difference: the reference's ``/actuator/health`` carries a
``pallas`` key (its fused TPU kernel's probe and fallback state) and its
registry a ``ratelimiter.pallas.fused_fallback`` gauge; the port has no
such probe (a CUDA tensor launches its kernel or raises), so it has
neither.  ``/actuator/edge`` serves the in-process edge aggregator's
status, and ``/actuator/tenants`` the lease manager's, when the wiring
built them.  ``/actuator/replication`` and
``POST /actuator/replication/promote`` serve the replication tier when the
wiring built it (``replication.*``), and ``/actuator/orchestrator`` and
``POST /actuator/orchestrator/unfence`` the in-process orchestrator
(``ratelimiter.orchestrator.*``).  ``/actuator/controller``, ``POST
/actuator/policies/<lid>/pin`` and the controller block of
``/actuator/policies`` serve the adaptive controller and the fleet control
plane (``ratelimiter.control.*``).  The tier the port does not have (the
fleet node manager) answers as the reference's does when it is off.

Fail-open on storage failure (configurable, on by default), the
``X-RateLimit-Limit`` / ``X-RateLimit-Remaining`` headers, the overload
429 with ``Retry-After`` and the health state machine UP / DEGRADED /
SHEDDING / DOWN are the reference's.

Implementation is a stdlib ThreadingHTTPServer: the service tier is a thin
shim — concurrency and throughput live in the micro-batched device engine,
not in the web framework.
"""

from __future__ import annotations

import json
import re
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ratelimiter_tpu_torch.engine.errors import OverloadedError, ShutdownError
from ratelimiter_tpu_torch.service.wiring import AppContext, build_app
from ratelimiter_tpu_torch.storage.errors import StorageException
from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("service.app")

_RESET_RE = re.compile(r"^/(?:api/)?admin/reset/([^/]+)$")
_PIN_RE = re.compile(r"^/actuator/policies/(\d+)/pin$")
# Actuator routes of tiers the port does not have: they answer as the
# reference's do with the tier off.
_OFF_TIERS = ("/actuator/fleet",)


def _now_ms() -> int:
    return time.time_ns() // 1_000_000


def _find(storage, name: str, want_callable: bool):
    """Walk the storage wrapper chain (retry -> breaker -> chaos -> ...)
    for a named surface: a callable (``policy_info``) or a value (the
    telemetry plane)."""
    seen = set()
    while storage is not None and id(storage) not in seen:
        seen.add(id(storage))
        value = getattr(storage, name, None)
        if (callable(value) if want_callable else value is not None):
            return value
        storage = getattr(storage, "_inner", None)
    return None


def health_payload(ctx: AppContext) -> dict:
    """UP / DEGRADED / SHEDDING / DOWN, most severe condition wins.

    - DOWN: the backend is unavailable, or the breaker is open with no
      degraded fallback and fail-open off, or the orchestrator holds a
      shard in terminal ``FAILED`` (fail-closed with every standby
      candidate spent: an outage of that keyspace until an operator
      unfences) — only DOWN returns 503.
    - DEGRADED: the breaker is open or half-open; decisions are served by
      the degraded host limiter (or fail-open).  Also a sharded
      deployment with a failed shard or one served by a promoted
      replacement: the other shards serve, so one dead shard is
      DEGRADED, never DOWN.  Also a member of the controller's cell
      serving a policy generation behind the leader's last broadcast
      (degraded correctness of its limits, never DOWN).
    - SHEDDING: admission control shed requests within the health
      window: the micro-batcher's queue bound or deadline sheds, and the
      sidecar's per-connection pipeline sheds (the TCP front door shares
      the HTTP tier's state machine).
    - UP: everything on the device path.

    Module-level so drills can evaluate the state machine without an
    HTTP server in the loop.
    """
    try:
        storage_up = bool(ctx.storage.is_available())
    except Exception:  # noqa: BLE001 — an erroring health probe is DOWN
        storage_up = False
    breaker = ctx.breaker
    batcher = getattr(ctx.storage, "_batcher", None)
    sidecar = getattr(ctx, "sidecar", None)
    payload: dict = {"storage": {"available": storage_up}}
    degraded_shards = []
    shard_health_fn = _find(ctx.storage, "shard_health", want_callable=True)
    if shard_health_fn is not None:
        shards = shard_health_fn()
        payload["shards"] = {str(q): v for q, v in shards.items()}
        degraded_shards = [q for q, v in shards.items() if v != "active"]
        status_fn = _find(ctx.storage, "shard_status", want_callable=True)
        if status_fn is not None:
            # The DEGRADED-shard detail: time in state and the last
            # transition's stamp a shard, so operators (and the
            # orchestrated drill) read promotion-window bounds from the
            # health payload alone.
            payload["shards_detail"] = {
                str(q): v for q, v in status_fn().items()}
    orch = getattr(ctx, "orchestrator", None)
    failed_terminal: list = []
    if orch is not None:
        st = orch.orchestrator.status()
        # Terminal FAILED: the orchestrator spent every standby candidate
        # and failed the shard closed, so that keyspace denies all of its
        # traffic with no recovery in flight (the operator's exit is
        # POST /actuator/orchestrator/unfence).
        failed_terminal = sorted(
            q for q, s in st["shards"].items() if s["state"] == "FAILED")
        payload["orchestrator"] = {
            "fence_epoch": st["fence_epoch"],
            "promotions": st["promotions"],
            "false_alarms": st["false_alarms"],
            "failed_shards": failed_terminal,
            "states": {q: s["state"] for q, s in st["shards"].items()},
        }
        if "shards_detail" in payload:
            for q, s in st["shards"].items():
                detail = payload["shards_detail"].get(str(q))
                if detail is not None:
                    detail["orchestrator_state"] = s["state"]
    controller = getattr(ctx, "controller", None)
    if controller is not None:
        # The control loop's mirror: pinned lids and the policy
        # generation, so an operator sees a frozen or scaling loop
        # without a second request.
        st = controller.status()
        payload["control"] = {
            "generation": st["generation"],
            "global_scale": st["global_scale"],
            "pinned": st["pinned"],
            "adjustments": st["adjustments"],
        }
    fc = getattr(ctx, "fleet_control", None)
    control_lagging: list = []
    if fc is not None:
        # Generation-convergence fold: a member whose applied policy
        # generation sits behind the leader's last broadcast serves stale
        # limits.  Reads the plane's cached per-node view; no RPC on the
        # health path.
        control_lagging = fc.lagging_nodes()
        plane = fc.plane
        payload["controller"] = {
            "node": plane.node,
            "is_leader": plane.is_leader,
            "epoch": plane.epoch,
            "last_broadcast_generation": plane.last_broadcast_generation,
            "lagging_nodes": control_lagging,
        }
    shedding = False
    window_s = ctx.props.get_float(
        "ratelimiter.overload.shed_health_window_ms", 5000.0) / 1000.0

    def _recent(stamp: float) -> bool:
        return stamp > 0 and (time.monotonic() - stamp) <= window_s

    if batcher is not None:
        shedding = _recent(float(getattr(batcher, "last_shed_s", 0.0)))
        payload["overload"] = {
            "queue_depth": batcher.queue_depth(),
            "max_pending": batcher.max_pending,
            "shed_total": batcher.shed_total,
            "deadline_expired_total": batcher.deadline_total,
        }
    if sidecar is not None:
        shedding = shedding or _recent(
            float(getattr(sidecar, "last_shed_s", 0.0)))
        payload["sidecar"] = {
            "connections": sidecar.connections(),
            "in_flight": sidecar.inflight(),
            "malformed_total": sidecar.malformed_total,
            "idle_closed_total": sidecar.idle_closed_total,
            "pipeline_shed_total": sidecar.pipeline_shed_total,
            "refused_total": sidecar.refused_total,
        }
    if breaker is not None:
        payload["breaker"] = breaker.status()
        if breaker.fallback is not None:
            payload["degraded"] = {
                "touched_keys": len(breaker.fallback.touched())}
    if failed_terminal:
        # A fail-closed shard with no standby left outranks every other
        # condition: part of the keyspace is down until an operator
        # unfences, so the instance reads DOWN (503).
        payload["status"] = "DOWN"
    elif breaker is not None and breaker.state != "closed":
        degraded_serving = (breaker.fallback is not None
                            or ctx.fail_open)
        payload["status"] = "DEGRADED" if degraded_serving else "DOWN"
    elif not storage_up:
        payload["status"] = "DOWN"
    elif degraded_shards or control_lagging:
        # One shard failed or served by a promoted replacement while the
        # others serve, or a cell member serving a policy generation
        # behind the controller's broadcast: degraded capacity (or
        # correctness), not an outage.
        payload["status"] = "DEGRADED"
    elif shedding:
        payload["status"] = "SHEDDING"
    else:
        payload["status"] = "UP"
    if ctx.recorder is not None:
        # Only transitions land in the flight recorder's timeline —
        # a steady-state health poll records nothing.
        ctx.recorder.record_transition("health", payload["status"])
    return payload


class RateLimiterHandler(BaseHTTPRequestHandler):
    ctx: AppContext  # injected by make_server

    # -- plumbing -------------------------------------------------------------
    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, status: int, payload: dict, headers: dict | None = None):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length == 0:
            return {}
        try:
            return json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return {}

    def _overloaded(self, exc: OverloadedError):
        """429 + Retry-After: the request was SHED by admission control
        (bounded queue / queue deadline), distinct from both the policy
        429 (_rate_limit_exceeded) and the storage-down 503."""
        retry_ms = float(getattr(exc, "retry_after_ms", 0.0)) or 1000.0
        secs = max(1, int(-(-retry_ms // 1000.0)))
        self.ctx.registry.counter(
            "ratelimiter.overload.rejected",
            "Requests answered 429 by overload admission control",
        ).increment()
        return self._json(429, {
            "error": "Overloaded",
            "message": "Server is shedding load. Please retry later.",
            "reason": getattr(exc, "reason", "overloaded"),
        }, headers={"Retry-After": secs})

    def _storage_unavailable(self):
        return self._json(503, {"error": "storage unavailable"},
                          headers={"Retry-After": 1})

    def _rate_limit_exceeded(self, limiter, key: str, limit: int):
        # 429 with the same error body shape (DemoController.java:129-140).
        remaining = self._safe_available(limiter, key)
        self._json(429, {
            "error": "Rate limit exceeded",
            "message": "Too many requests. Please try again later.",
            "remaining": remaining,
        }, headers={"X-RateLimit-Limit": limit,
                    "X-RateLimit-Remaining": remaining})

    def _safe_available(self, limiter, key: str) -> int:
        try:
            return int(limiter.get_available_permits(key))
        except StorageException:
            return -1  # "unable to determine" (core/RateLimiter.java:31-37)

    def _try_acquire(self, limiter, key: str, permits: int = 1) -> bool:
        """Apply the fail-open policy: on storage failure, allow (and count)
        rather than erroring the request — the availability-over-strictness
        trade the reference documents."""
        try:
            return limiter.try_acquire(key, permits)
        except StorageException as exc:
            if self.ctx.fail_open:
                _log.warning("storage failure for key=%s: %s — failing open",
                             key, exc)
                self.ctx.registry.counter(
                    "ratelimiter.failopen.allowed",
                    "Requests allowed due to fail-open on storage errors",
                ).increment()
                return True
            raise

    def _decide(self, name: str, key: str, permits: int, limit: int,
                ok_payload):
        """One limited route: the decision, then the 200 payload
        (``ok_payload(limiter)`` returns ``(body, headers)``), the policy
        429, the overload 429 or the 503."""
        limiter = self.ctx.limiters[name]
        try:
            if not self._try_acquire(limiter, key, permits):
                return self._rate_limit_exceeded(limiter, key, limit)
        except OverloadedError as exc:
            return self._overloaded(exc)
        except (ShutdownError, StorageException):
            return self._storage_unavailable()
        body, headers = ok_payload(limiter)
        self._json(200, body, headers=headers)

    # -- routes ---------------------------------------------------------------
    def do_GET(self):
        if self.path == "/api/data":
            return self._get_data()
        if self.path == "/api/health":
            return self._json(200, {"status": "UP",
                                    "timestamp": str(_now_ms())})
        if self.path == "/actuator/health":
            payload = health_payload(self.ctx)
            return self._json(503 if payload["status"] == "DOWN" else 200,
                              payload)
        if self.path == "/actuator/metrics":
            return self._json(200, {"meters": self.ctx.registry.scrape()})
        if self.path.startswith("/actuator/prometheus"):
            return self._prometheus()
        if self.path.startswith("/actuator/tenants"):
            return self._tenants()
        if self.path == "/actuator/policies":
            return self._policies()
        if self.path.startswith("/actuator/flightrecorder"):
            return self._flightrecorder()
        if self.path == "/actuator/replication":
            repl = self.ctx.replication
            if repl is None:
                return self._json(200, {"enabled": False})
            return self._json(200, {"enabled": True, **repl.status()})
        if self.path == "/actuator/orchestrator":
            orch = self.ctx.orchestrator
            if orch is None:
                return self._json(200, {"enabled": False})
            return self._json(200, orch.status())
        if self.path in _OFF_TIERS:
            return self._json(200, {"enabled": False})
        if self.path == "/actuator/controller":
            return self._controller_actuator()
        if self.path == "/actuator/edge":
            edge = self.ctx.edge
            if edge is None:
                return self._json(200, {"enabled": False})
            return self._json(200, {"enabled": True, **edge.status()})
        if self.path.startswith("/actuator/trace"):
            trace = getattr(self.ctx.storage, "trace", None)
            if trace is None:
                return self._json(200, {"total_dispatches": 0, "recent": []})
            return self._json(200, trace.snapshot())
        self._json(404, {"error": "not found"})

    def _prometheus(self):
        """Prometheus text exposition over every registered meter, plus
        the telemetry plane's labeled per-tenant / per-key-class
        series."""
        from ratelimiter_tpu_torch.observability import prometheus

        plane = _find(self.ctx.storage, "telemetry", want_callable=False)
        collectors = (plane,) if plane is not None else ()
        body = prometheus.render(self.ctx.registry,
                                 collectors=collectors).encode()
        self.send_response(200)
        self.send_header("Content-Type", prometheus.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _tenants(self):
        """Per-tenant usage accounting + telemetry staleness, and the
        lease manager's status when the lease tier is on."""
        plane = _find(self.ctx.storage, "telemetry", want_callable=False)
        if plane is None:
            return self._json(200, {"enabled": False, "tenants": {}})
        payload = {"enabled": True, **plane.tenants_payload()}
        if self.ctx.leases is not None:
            payload["leases"] = self.ctx.leases.status()
        return self._json(200, payload)

    def _policies(self):
        """Per-lid effective policy, generation and controller state.
        Serves the storage's ``policy_info`` with the controller off too,
        so the generation metadata is always inspectable."""
        info_fn = _find(self.ctx.storage, "policy_info", want_callable=True)
        payload: dict = {"enabled": False}
        if info_fn is not None:
            payload.update(info_fn())
        controller = self.ctx.controller
        if controller is not None:
            payload["enabled"] = True
            payload["controller"] = controller.status()
        return self._json(200, payload)

    def _controller_actuator(self):
        """Controller leadership: who leads the cell, at what fence epoch,
        the last broadcast policy generation and every member's applied
        generation.  Without fleet mode, the local controller's generation
        view."""
        fc = self.ctx.fleet_control
        if fc is not None:
            return self._json(200, fc.status())
        controller = self.ctx.controller
        if controller is None:
            return self._json(200, {"enabled": False})
        st = controller.status()
        return self._json(200, {
            "enabled": True, "fleet": False,
            "generation": st["generation"],
            "adjustments": st["adjustments"],
            "signals_stale_ticks": st["signals_stale_ticks"],
        })

    def _pin_policy(self, lid: str):
        """Operator override: freeze a lid out of the control loop (body
        ``{"pinned": false}`` releases it)."""
        controller = self.ctx.controller
        if controller is None:
            return self._json(409, {"error": "adaptive control not "
                                             "enabled"})
        pinned = bool(self._body().get("pinned", True))
        try:
            out = controller.pin(int(lid), pinned)
        except (KeyError, ValueError) as exc:
            return self._json(404, {"error": str(exc)})
        return self._json(200, out)

    def _flightrecorder(self):
        """Flight-recorder snapshot; ``?kind=`` (exact or dotted
        prefix), ``?since_ms=`` (wall-clock ms), and ``?last=`` filter
        ring-side."""
        recorder = self.ctx.recorder
        if recorder is None:
            return self._json(200, {"total_events": 0, "events": [],
                                    "anomalies": []})
        params = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)

        def _one(name):
            vals = params.get(name)
            return vals[0] if vals else None

        kind = _one("kind")
        since_ms = _one("since_ms")
        last = _one("last")
        try:
            since_ms = int(since_ms) if since_ms is not None else None
            last = int(last) if last is not None else 256
        except ValueError:
            return self._json(400, {
                "error": "since_ms and last must be integers"})
        return self._json(200, recorder.snapshot(
            last=last, kind=kind, since_ms=since_ms))

    def do_POST(self):
        if self.path == "/api/login":
            return self._login()
        if self.path == "/api/batch":
            return self._batch()
        if self.path == "/actuator/replication/promote":
            return self._promote()
        if self.path == "/actuator/orchestrator/unfence":
            return self._unfence()
        m = _PIN_RE.match(self.path)
        if m:
            return self._pin_policy(m.group(1))
        self._json(404, {"error": "not found"})

    def _unfence(self):
        """Operator recovery of a terminal FAILED shard: lift the fence,
        route the shard back to the primary, re-seed a fresh standby.
        Body: ``{"shard": N}``."""
        orch = self.ctx.orchestrator
        if orch is None:
            return self._json(409, {"error": "orchestrator not enabled"})
        shard = self._body().get("shard")
        if shard is None:
            return self._json(400, {"error": "body must carry {\"shard\": N}"})
        try:
            out = orch.orchestrator.unfence(int(shard))
        except (TypeError, ValueError) as exc:
            return self._json(409, {"error": str(exc)})
        return self._json(200, out)

    def _promote(self):
        """Failover control: promote a standby to serving primary."""
        repl = self.ctx.replication
        if repl is None or repl.receiver is None:
            return self._json(409, {"error": "not a replication standby"})
        from ratelimiter_tpu_torch.replication import ReplicationStateError

        force = bool(self._body().get("force", False))
        try:
            repl.receiver.promote(force=force)
        except ReplicationStateError as exc:
            return self._json(409, {"error": str(exc)})
        return self._json(200, repl.status())

    def do_DELETE(self):
        m = _RESET_RE.match(self.path)
        if m:
            return self._reset(m.group(1))
        self._json(404, {"error": "not found"})

    # -- endpoint bodies ------------------------------------------------------
    def _get_data(self):
        key = self.headers.get("X-User-ID") or "anonymous"

        def ok(limiter):
            remaining = self._safe_available(limiter, key)
            return ({"message": "Success!", "remaining": remaining,
                     "data": {"timestamp": _now_ms()}},
                    {"X-RateLimit-Limit": 100,
                     "X-RateLimit-Remaining": remaining})

        self._decide("api", key, 1, 100, ok)

    def _login(self):
        username = self._body().get("username", "unknown")
        self._decide("auth", username, 1, 10, lambda limiter: (
            {"message": "Login successful",
             "remaining_attempts": self._safe_available(limiter, username)},
            None))

    def _batch(self):
        user_id = self.headers.get("X-User-ID")
        if not user_id:
            return self._json(400, {"error": "X-User-ID header required"})
        size = int(self._body().get("size", 1))
        if size <= 0:
            return self._json(400, {"error": "size must be positive"})
        self._decide("burst", user_id, size, 50, lambda limiter: (
            {"message": "Batch processed", "items_processed": size,
             "tokens_remaining": self._safe_available(limiter, user_id)},
            None))

    def _reset(self, user_id: str):
        for limiter in self.ctx.limiters.values():
            limiter.reset(user_id)
        self._json(200, {"message": f"Rate limits reset for user: {user_id}"})


def make_server(ctx: AppContext | None = None,
                port: int | None = None) -> ThreadingHTTPServer:
    ctx = ctx or build_app()
    if port is None:
        port = ctx.props.get_int("server.port", 8080)
    handler = type("BoundHandler", (RateLimiterHandler,), {"ctx": ctx})
    server = ThreadingHTTPServer(("0.0.0.0", port), handler)
    server.ctx = ctx  # type: ignore[attr-defined]
    return server


def serve_forever(ctx: AppContext | None = None,
                  port: int | None = None) -> None:
    server = make_server(ctx, port)
    try:
        server.serve_forever()
    finally:
        server.ctx.close()  # type: ignore[attr-defined]


def main() -> None:  # python -m ratelimiter_tpu_torch
    import sys

    from ratelimiter_tpu_torch.service.props import AppProperties

    path = sys.argv[1] if len(sys.argv) > 1 else "application.properties"
    ctx = build_app(AppProperties.load(path))
    port = ctx.props.get_int("server.port", 8080)
    if ctx.warmup_s is not None:
        print(f"warmup (the kernels' first build included): "
              f"{ctx.warmup_s:.3f} s")
    print(f"ratelimiter_tpu_torch serving on :{port} "
          f"(backend={ctx.props.get('storage.backend')})", flush=True)
    serve_forever(ctx, port)


if __name__ == "__main__":
    main()
