"""The service tier, port against the JAX package: ``build_app`` and the
HTTP app of ``ratelimiter_tpu_torch/service`` against
``ratelimiter_tpu/service``.

- Both apps over the same manual clock (``GpuBatchedStorage(device=
  "cpu")`` and ``TpuBatchedStorage``, the same explicit
  ``host_parallel``) take a seeded sequence of more than 300 HTTP
  requests, each sent to both back to back: every route, both reset
  paths, 429s of each limiter, the actuators, and clock steps across
  window boundaries.  Status, headers and JSON bodies must be equal.
  The named exceptions: wall-clock stamps (``timestamp``, the flight
  recorder's and the trace ring's ``t_ms``), measured durations
  (``latency_us``), the ``Date`` header, and the reference's ``pallas``
  health key and ``ratelimiter.pallas.fused_fallback`` gauge (its TPU
  kernel's probe, which the port does not have) — with the
  ``Content-Length`` of the responses those change.
- The api limiter's local cache reads the wall clock (the wiring passes
  no clock, as the reference's does); both apps' caches are pointed at
  the manual clock, so a cached denial expires at the same step in both.
- ``build_app`` from ``application.properties`` composes the reference's
  chain; every unported tier refuses to boot; the lease and edge tiers
  boot over the device storage, stay off on the memory backend with the
  reference's warnings, and show in ``/actuator/tenants``; fail-open and the
  breaker's DEGRADED and DOWN states answer as the reference's do;
  ``AppProperties`` parses as the reference's on ``tests/test_props.py``'s
  cases.
"""

import json
import logging
import threading
import time
import http.client

import numpy as np
import pytest
import torch

from ratelimiter_tpu.observability import FlightRecorder as RefRecorder
from ratelimiter_tpu.service import app as ref_app
from ratelimiter_tpu.service.props import AppProperties as RefProps
from ratelimiter_tpu.service.wiring import build_app as ref_build_app
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu.utils import logging as ref_logging
from ratelimiter_tpu_torch.observability import FlightRecorder
from ratelimiter_tpu_torch.service import app as port_app
from ratelimiter_tpu_torch.service import wiring
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.service.wiring import build_app
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from ratelimiter_tpu_torch.utils import logging as port_logging
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_760_000_000_000
SEED = 20261017


# ---------------------------------------------------------------------------
# Two live apps, one request stream
# ---------------------------------------------------------------------------

class Server:
    """One package's app behind a ThreadingHTTPServer on a loopback port."""

    def __init__(self, ctx, app_module):
        self.ctx = ctx
        self.srv = app_module.make_server(ctx, port=0)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection(
            "127.0.0.1", self.srv.server_address[1], timeout=30)
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        out = (resp.status, data,
               [(k, v) for k, v in resp.getheaders() if k != "Date"])
        conn.close()
        return out

    def close(self):
        self.srv.shutdown()
        self.thread.join(timeout=5)
        assert not self.thread.is_alive()
        self.ctx.close()


def _drop_pallas_lines(text: str) -> str:
    return "".join(line + "\n" for line in text.splitlines()
                   if "ratelimiter_pallas_fused_fallback" not in line)


def normalize(path: str, resp, ref: bool):
    """A response with the named exceptions taken out (see the module
    docstring); every other byte is compared."""
    status, data, headers = resp
    route = path.split("?")[0]
    volatile = {"/actuator/health", "/actuator/metrics",
                "/actuator/prometheus", "/actuator/trace",
                "/actuator/flightrecorder"}
    if route in volatile:
        headers = [(k, v) for k, v in headers if k != "Content-Length"]
    if route == "/actuator/prometheus":
        text = data.decode()
        return status, _drop_pallas_lines(text) if ref else text, headers
    try:
        body = json.loads(data)
    except ValueError:
        return status, data, headers
    if route == "/api/data" and status == 200:
        body["data"]["timestamp"] = None
    elif route == "/api/health":
        body["timestamp"] = None
    elif route == "/actuator/health":
        body.pop("pallas", None)
    elif route == "/actuator/metrics":
        body["meters"].pop("ratelimiter.pallas.fused_fallback", None)
    elif route == "/actuator/trace":
        for rec in body["recent"]:
            rec.pop("t_ms")
            rec.pop("latency_us")
    elif route == "/actuator/flightrecorder" and "events" in body:
        for rec in body["events"]:
            rec.pop("t_ms")
    return status, json.dumps(body), headers


class Pair:
    """Both apps over one manual clock; each request goes to the
    reference, then to the port."""

    def __init__(self, host_parallel: int):
        self.clock = {"t": T0}
        now = lambda: self.clock["t"]  # noqa: E731
        ref_st = TpuBatchedStorage(num_slots=1024, clock_ms=now,
                                   host_parallel=host_parallel)
        port_st = GpuBatchedStorage(num_slots=1024, clock_ms=now,
                                    device="cpu",
                                    host_parallel=host_parallel)
        self.ref = Server(ref_build_app(RefProps({"server.port": "0"}),
                                        storage=ref_st), ref_app)
        self.port = Server(build_app(AppProperties({"server.port": "0"}),
                                     storage=port_st), port_app)
        # Each app gets a recorder of its own: the process-global ring
        # the wiring hands it also hears any thread other tests in this
        # process left behind.
        self.ref.ctx.recorder = RefRecorder()
        self.port.ctx.recorder = FlightRecorder()
        for server in (self.ref, self.port):
            server.ctx.limiters["api"]._local_cache._clock_ms = now

    def send(self, method, path, body=None, headers=None):
        ref = self.ref.request(method, path, body, headers)
        port = self.port.request(method, path, body, headers)
        return ref, port

    def close(self):
        self.ref.close()
        self.port.close()


def request_stream(rng):
    """The seeded sequence: (method, path, body, headers) requests and
    ("clock", ms) steps."""
    api_users = ["hot", "a1", "a2", None]
    auth_users = ["bob", "carol", "dave"]
    burst_users = ["eve", "frank"]
    actuators = ["/actuator/health", "/actuator/metrics",
                 "/actuator/prometheus", "/actuator/tenants",
                 "/actuator/policies", "/actuator/flightrecorder",
                 "/actuator/flightrecorder?kind=health",
                 "/actuator/flightrecorder?since_ms=oops",
                 "/actuator/trace", "/api/health"]
    ops = []
    for i in range(330):
        if i == 160:
            # A burst past the api limit inside one window, then a reset
            # of the user on each path and a few more.
            ops += [("GET", "/api/data", None, {"X-User-ID": "hot"})] * 106
            ops.append(("DELETE", "/api/admin/reset/hot", None, None))
            ops += [("GET", "/api/data", None, {"X-User-ID": "hot"})] * 2
            ops.append(("DELETE", "/admin/reset/bob", None, None))
        r = rng.random()
        if r < 0.08:
            ops.append(("clock", int(rng.choice(
                [1, 150, 900, 5_000, 20_000, 45_000, 61_000]))))
        elif r < 0.38:
            user = api_users[int(rng.integers(0, len(api_users)))]
            ops.append(("GET", "/api/data", None,
                        {"X-User-ID": user} if user else {}))
        elif r < 0.58:
            user = auth_users[int(rng.integers(0, len(auth_users)))]
            ops.append(("POST", "/api/login", {"username": user}, None))
        elif r < 0.76:
            user = burst_users[int(rng.integers(0, len(burst_users)))]
            ops.append(("POST", "/api/batch",
                        {"size": int(rng.integers(1, 31))},
                        {"X-User-ID": user}))
        elif r < 0.90:
            ops.append(("GET", actuators[int(rng.integers(0,
                                                          len(actuators)))],
                        None, None))
        else:
            ops.append([
                ("POST", "/api/batch", {"size": 0}, {"X-User-ID": "eve"}),
                ("POST", "/api/batch", {"size": 3}, None),
                ("POST", "/api/login", None, None),
                ("GET", "/nope", None, None),
                ("DELETE", "/api/admin/reset/eve", None, None),
                ("DELETE", "/admin/reset/carol", None, None),
                ("DELETE", "/api/admin/nope", None, None),
                ("POST", "/actuator/policies/1/pin", {"pinned": True}, None),
                ("POST", "/actuator/replication/promote", None, None),
                ("POST", "/actuator/orchestrator/unfence", {"shard": 0},
                 None),
                ("GET", "/actuator/replication", None, None),
                ("GET", "/actuator/orchestrator", None, None),
                ("GET", "/actuator/fleet", None, None),
                ("GET", "/actuator/controller", None, None),
                ("GET", "/actuator/edge", None, None),
            ][int(rng.integers(0, 15))])
    ops += [("GET", path, None, None) for path in actuators]
    return ops


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_http_responses_match_reference(host_parallel):
    require_reference_native()
    pair = Pair(host_parallel)
    try:
        ops = request_stream(np.random.default_rng(SEED + host_parallel))
        statuses = {}
        n_requests = 0
        for op in ops:
            if op[0] == "clock":
                pair.clock["t"] += op[1]
                continue
            method, path, body, headers = op
            ref, port = pair.send(method, path, body, headers)
            n_requests += 1
            assert normalize(path, port, False) == \
                normalize(path, ref, True), (n_requests, op)
            statuses.setdefault(path.split("?")[0], set()).add(ref[0])
        assert n_requests >= 300
        # The stream reached each limiter's 429 and the routes' errors.
        assert 429 in statuses["/api/data"]
        assert 429 in statuses["/api/login"]
        assert 429 in statuses["/api/batch"] and 400 in statuses["/api/batch"]
        assert statuses["/actuator/flightrecorder"] == {200, 400}
        cache_hits = json.loads(pair.port.request(
            "GET", "/actuator/metrics")[1])["meters"]["ratelimiter.cache.hits"]
        assert cache_hits > 0
    finally:
        pair.close()


# ---------------------------------------------------------------------------
# Wiring
# ---------------------------------------------------------------------------

def _chain(storage):
    """The wrapper chain's types, outermost first (the device storage
    named alike in both packages)."""
    out = []
    while storage is not None:
        out.append(type(storage).__name__.replace("Tpu", "Gpu"))
        storage = getattr(storage, "_inner", None)
    return out


def _composition(ctx):
    """What the wiring composed: the chain's types, the breaker's and the
    retry's settings, the degraded limiter and its subscriptions, the raw
    storage's batcher, tracing and telemetry settings, the trio."""
    raw = ctx.storage
    while hasattr(raw, "_inner"):
        raw = raw._inner
    b = raw._batcher
    fb = ctx.breaker.fallback
    return {
        "chain": _chain(ctx.storage),
        "breaker": (ctx.breaker.failure_threshold, ctx.breaker.open_ms,
                    ctx.breaker.half_open_probes, ctx.breaker.state),
        "retry": (ctx.storage.policy.max_retries,
                  ctx.storage.policy.retry_delay_ms),
        "fallback": (type(fb).__name__, fb.max_keys,
                     fb._telemetry is raw.telemetry,
                     fb.update_policy in raw._policy_listeners),
        "batcher": (b.max_batch, b.max_delay_s, b.max_inflight,
                    b.max_pending, b.deadline_ms,
                    b._controller.floor_s, b._controller.cap_s),
        "obs": (raw.lineage.sample_n, raw.lineage._capacity,
                raw.telemetry.usage.max_tenants, raw.table._capacity,
                raw.registry is ctx.registry),
        "trio": {name: (type(lim).__name__, lim._config.max_permits,
                        lim._config.window_ms, lim._config.refill_rate,
                        lim._config.enable_local_cache)
                 for name, lim in ctx.limiters.items()},
        "fail_open": ctx.fail_open,
    }


def test_build_app_from_properties_composes_reference_chain():
    """The repo's ``application.properties`` unchanged on the port (on the
    CPU); the reference with the overrides a CPU test needs (one device,
    no boot compile, no link probe, a small table).  The port's boot
    warmup ran."""
    port_ctx = build_app(AppProperties.load("application.properties"),
                         device="cpu")
    ref_ctx = ref_build_app(RefProps({
        **RefProps.load("application.properties")._values,
        "parallel.shard": "off", "warmup.enabled": "false",
        "link.probe.enabled": "false", "storage.num_slots": "4096"}))
    try:
        port, ref = _composition(port_ctx), _composition(ref_ctx)
        assert port == ref
        assert port["chain"] == ["RetryingStorage", "CircuitBreakerStorage",
                                 "GpuBatchedStorage"]
        assert port["fallback"][2:] == (True, True)
        assert port_ctx.warmup_s is not None and port_ctx.warmup_s > 0
        assert port_ctx.storage._inner._inner.engine.num_slots == 1 << 20
    finally:
        port_ctx.close()
        ref_ctx.close()


@pytest.mark.parametrize("key,value,item", [
    (key, "true", item) for key, item in wiring.UNPORTED_TIERS])
def test_unported_tier_refuses_to_boot(key, value, item):
    with pytest.raises(NotImplementedError, match="ROADMAP") as exc_info:
        build_app(AppProperties({key: value, "storage.backend": "memory"}),
                  device="cpu")
    assert key in str(exc_info.value) and item in str(exc_info.value)


def _lease_tier(ctx):
    """What the wiring built for the lease tier: the manager's storage
    (named alike in both packages) and settings, and the edge's."""
    mgr, edge = ctx.leases, ctx.edge
    return {
        "storage": type(mgr.storage).__name__.replace("Tpu", "Gpu"),
        "manager": (mgr.default_budget, mgr.max_budget, mgr.max_bulk_budget,
                    mgr.ttl_ms, mgr.deny_ttl_ms, mgr.table.max_leases,
                    mgr.default_concurrency),
        "edge": None if edge is None else (
            edge.bulk_budget, edge.slice_budget, edge.flush_ms),
    }


def test_lease_tier_boots_over_the_device_storage():
    """``ratelimiter.lease.enabled`` and ``ratelimiter.edge.enabled`` on
    ``application.properties``: both apps build the manager over the raw
    device storage, beneath the retry and breaker wrappers, with the
    shipped settings, and grant alike."""
    values = {"ratelimiter.lease.enabled": "true",
              "ratelimiter.edge.enabled": "true"}
    port_ctx = build_app(AppProperties({
        **AppProperties.load("application.properties")._values, **values}),
        device="cpu")
    ref_ctx = ref_build_app(RefProps({
        **RefProps.load("application.properties")._values, **values,
        "parallel.shard": "off", "warmup.enabled": "false",
        "link.probe.enabled": "false", "storage.num_slots": "4096"}))
    try:
        port, ref = _lease_tier(port_ctx), _lease_tier(ref_ctx)
        assert port == ref
        assert port["manager"][:2] == (64, 1024)
        assert port_ctx.leases.storage is port_ctx.storage._inner._inner
        grants = [tuple(ctx.leases.grant(ctx.limiters["burst"]._lid, "u", 16))
                  for ctx in (ref_ctx, port_ctx)]
        assert grants[1] == grants[0] == (16, 2000, 0)
    finally:
        port_ctx.close()
        ref_ctx.close()


class _Warnings(logging.Handler):
    """Warnings logged under one logger, through a handler of its own
    (``setup_logging`` turns the package root's propagation off at each
    boot)."""

    def __init__(self, name):
        super().__init__(logging.WARNING)
        self.root = logging.getLogger(name)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.root.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.root.removeHandler(self)


def test_memory_backend_leaves_leases_off():
    """The memory backend has no ``lease_reserve``: both apps warn alike
    and serve without leases (and so without the edge)."""
    warned = []
    # The reference's wiring warns on the "ratelimiter" logger, the port's
    # under its package root.
    for build, cls, name, kw in (
            (ref_build_app, RefProps, "ratelimiter", {}),
            (build_app, AppProperties, port_logging.ROOT, {"device": "cpu"})):
        with _Warnings(name) as logs:
            ctx = build(cls({"storage.backend": "memory",
                             "ratelimiter.lease.enabled": "true",
                             "ratelimiter.edge.enabled": "true"}), **kw)
        try:
            assert ctx.leases is None and ctx.edge is None
        finally:
            ctx.close()
        warned.append(sorted(m for m in logs.messages
                             if m.startswith(("ratelimiter.lease",
                                              "ratelimiter.edge"))))
    assert warned[1] == warned[0]
    assert len(warned[1]) == 2
    assert "InMemoryStorage backend has no lease_reserve" in warned[1][1]


def test_tenants_actuator_carries_lease_status():
    """``/actuator/tenants`` carries the lease manager's status when the
    tier is on, equal between the two apps, and no ``leases`` key when
    it is off."""
    require_reference_native()
    base = {"storage.backend": "tpu", "storage.num_slots": "1024",
            "parallel.shard": "off", "warmup.enabled": "false",
            "link.probe.enabled": "false"}
    got = []
    for lease_on in ("true", "false"):
        props = {**base, "ratelimiter.lease.enabled": lease_on}
        for ctx, app in ((ref_build_app(RefProps(dict(props))), ref_app),
                         (build_app(AppProperties(dict(props)),
                                    device="cpu"), port_app)):
            server = Server(ctx, app)
            try:
                if ctx.leases is not None:
                    ctx.leases.grant(ctx.limiters["burst"]._lid, "t", 8)
                status, body, _ = server.request("GET", "/actuator/tenants")
                assert status == 200
                got.append(json.loads(body).get("leases"))
            finally:
                server.close()
    assert got[0] == got[1] and got[0]["outstanding"] == 1
    assert got[2] is None and got[3] is None


def test_build_app_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    """No CUDA device: the device backend raises rather than run on the
    CPU; with several visible cards it asks for the sharded engine over
    all of them (``wiring.sharded_engine``, which ``parallel.shard``
    gates; tests/test_torch_sharded.py holds its choice)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_app(AppProperties({}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    asked = []

    def sharded_engine(props, devices):
        asked.append(devices)
        raise NotImplementedError("parallel.shard: no card in this test")
    monkeypatch.setattr(wiring, "sharded_engine", sharded_engine)
    with pytest.raises(NotImplementedError, match="parallel.shard"):
        wiring.build_storage(AppProperties({}))
    assert asked == [[torch.device("cuda", 0), torch.device("cuda", 1)]]
    with pytest.raises(ValueError, match="storage.backend"):
        wiring.build_storage(AppProperties({"storage.backend": "redis"}))


# ---------------------------------------------------------------------------
# Fail-open, the breaker's DEGRADED and DOWN
# ---------------------------------------------------------------------------

def _wait_off_window_edge():
    """The fail-open stacks run on the wall clock: start well inside a
    minute (the limiters' window) so both apps decide in the same one."""
    while (time.time_ns() // 1_000_000) % 60_000 > 40_000:
        time.sleep(0.2)


@pytest.mark.parametrize("case", ["degraded", "breaker_fail_open",
                                  "no_breaker_fail_open", "fail_closed"])
def test_fail_open_and_breaker_states_match_reference(case):
    """Both apps from the same properties (the device backend, chaos
    armed); the chaos layer then fails every call.  Per case: the
    breaker opens and the degraded host limiter serves (DEGRADED); the
    breaker opens with no degraded limiter and fail-open allows
    (DEGRADED); no breaker, retries exhausted, fail-open allows; no
    degraded limiter and fail-open off (503s, DOWN)."""
    require_reference_native()
    values = {
        "server.port": "0", "storage.num_slots": "1024",
        "parallel.shard": "off", "warmup.enabled": "false",
        "link.probe.enabled": "false", "chaos.failure_rate": "0.000001",
        "storage.retry.delay_ms": "0", "breaker.failure_threshold": "3",
        "breaker.enabled": "false" if case == "no_breaker_fail_open"
        else "true",
        "ratelimiter.degraded.enabled": "true" if case == "degraded"
        else "false",
        "ratelimiter.fail_open": "false" if case == "fail_closed"
        else "true",
    }
    _wait_off_window_edge()
    servers = [Server(ref_build_app(RefProps(values)), ref_app),
               Server(build_app(AppProperties(values), device="cpu"),
                      port_app)]
    try:
        script = [("GET", "/actuator/health", None, None),
                  ("POST", "/api/login", {"username": "fo"}, None),
                  ("GET", "/api/data", None, {"X-User-ID": "fo"}),
                  ("GET", "/actuator/health", None, None)]
        seen = []
        for step in range(2):
            if step == 1:
                for server in servers:
                    chaos = server.ctx.storage
                    while type(chaos).__name__ != "FaultInjectingStorage":
                        chaos = chaos._inner
                    chaos.failure_rate = 1.0
            for method, path, body, headers in script * (1 + step):
                ref, port = (s.request(method, path, body, headers)
                             for s in servers)
                assert normalize(path, port, False) == \
                    normalize(path, ref, True), (case, step, path)
                seen.append((path, ref[0], json.loads(ref[1]).get(
                    "status")))
        meters = [json.loads(s.request("GET", "/actuator/metrics")[1])
                  ["meters"] for s in servers]
        for name in ("ratelimiter.failopen.allowed",
                     "ratelimiter.breaker.opened",
                     "ratelimiter.degraded.decisions",
                     "ratelimiter.requests.allowed",
                     "ratelimiter.requests.rejected"):
            assert meters[1].get(name) == meters[0].get(name), name
        final = seen[-1]
        want = {"degraded": (200, "DEGRADED"),
                "breaker_fail_open": (200, "DEGRADED"),
                "no_breaker_fail_open": None,
                "fail_closed": (503, "DOWN")}[case]
        if want is not None:
            assert final[1:] == want, seen
        if case != "fail_closed":
            assert all(s == 200 for p, s, _ in seen if p.startswith("/api"))
        else:
            assert any(s == 503 for p, s, _ in seen if p.startswith("/api"))
    finally:
        for server in servers:
            server.close()


# ---------------------------------------------------------------------------
# Properties
# ---------------------------------------------------------------------------

@pytest.fixture()
def props_logs(caplog):
    """Warnings of both packages' ``service.props`` loggers (setup_logging,
    run by any app test, turns propagation off on each root)."""
    roots = [logging.getLogger(mod.ROOT) for mod in (ref_logging,
                                                     port_logging)]
    was = [r.propagate for r in roots]
    for r in roots:
        r.propagate = True
    for mod in (ref_logging, port_logging):
        caplog.set_level(logging.WARNING, logger=f"{mod.ROOT}.service.props")
    yield caplog
    for r, w in zip(roots, was):
        r.propagate = w


def _props_case(cls, case, monkeypatch, tmp_path):
    """One ``tests/test_props.py`` case on one package's class: the typed
    reads it makes."""
    if case == "malformed":
        p = cls({"batcher.max_batch": "81q2", "breaker.open_ms": "five",
                 "breaker.enabled": "maybe"})
        return (p.get_int("batcher.max_batch", -1),
                p.get_float("breaker.open_ms", -1.0),
                p.get_bool("breaker.enabled"))
    if case == "wellformed":
        p = cls({"batcher.max_batch": "1024", "breaker.open_ms": "250.5",
                 "breaker.enabled": "off",
                 "ratelimiter.overload.max_pending": "128"})
        return (p.get_int("batcher.max_batch"),
                p.get_float("breaker.open_ms"),
                p.get_bool("breaker.enabled"),
                p.get_int("ratelimiter.overload.max_pending"))
    if case == "unknown_key":
        p = cls({"ratelimiter.overlod.max_pending": "10"})
        return p.get("ratelimiter.overlod.max_pending")
    if case == "env":
        monkeypatch.setenv("RATELIMITER_BREAKER_FAILURE_THRESHOLD", "3")
        monkeypatch.setenv("RATELIMITER_BRAKER_OPEN_MS", "100")
        monkeypatch.setenv("RATELIMITER_PALLAS", "1")
        monkeypatch.setenv("RATELIMITER_SERVER_PORT", "eight-thousand")
        p = cls.load(str(tmp_path / "missing.properties"))
        return (p.get_int("breaker.failure_threshold"),
                p.get_int("server.port"))
    if case == "file":
        p = cls.load("application.properties")
        return dict(p._values)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["malformed", "wellformed", "unknown_key",
                                  "env", "file"])
def test_properties_parse_like_reference(case, props_logs, monkeypatch,
                                         tmp_path):
    got = []
    for cls in (RefProps, AppProperties):
        props_logs.clear()
        value = _props_case(cls, case, monkeypatch, tmp_path)
        warned = sorted(rec.getMessage() for rec in props_logs.records)
        got.append((value, warned))
    assert got[1] == got[0]
    if case in ("malformed", "unknown_key", "env"):
        assert got[0][1], "the case warned about nothing"
    else:
        assert not got[0][1]
