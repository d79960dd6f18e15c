"""The sidecar's ingress hardening, wiring and observability, port against
the JAX package: the fast cases of ``tests/test_sidecar_chaos.py`` on the
port (``storage/chaos.py:ingress_drill`` over
``GpuBatchedStorage(device="cpu")``, the TCP fault proxy's passthrough,
partition and flap, the batcher's ``forget``, the health state machine's
sidecar sheds, the wiring), ``build_app`` with the sidecar on beside the
reference's, and the sidecar cases of ``tests/test_telemetry.py`` and
``tests/test_observability.py`` (v4 trace ids into the lineage ring, op 9
into the telemetry plane).
"""

import functools
import socket
import socketserver
import threading
import time

import numpy as np
import pytest
import torch

from ratelimiter_tpu.service import wiring as ref_wiring
from ratelimiter_tpu.service.app import health_payload as ref_health
from ratelimiter_tpu.service.props import AppProperties as RefProps
from ratelimiter_tpu.service.sidecar import SidecarClient as RefClient
from ratelimiter_tpu.storage.chaos import ingress_drill as ref_ingress_drill
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine.batcher import MicroBatcher
from ratelimiter_tpu_torch.leases import LeaseClient, LeaseManager
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.observability import FlightRecorder
from ratelimiter_tpu_torch.observability.telemetry import mint_trace_id
from ratelimiter_tpu_torch.service import app as port_app
from ratelimiter_tpu_torch.service import sidecar as sc
from ratelimiter_tpu_torch.service import wiring
from ratelimiter_tpu_torch.service.app import health_payload
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.storage import (
    FaultInjectingProxy,
    GpuBatchedStorage,
)
from ratelimiter_tpu_torch.storage.chaos import ingress_drill
from ratelimiter_tpu_torch.utils import logging as port_logging
from test_torch_service import Server, _Warnings
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_753_000_000_000


def _storage(clock, **kw):
    return GpuBatchedStorage(clock_ms=lambda: clock["t"], device="cpu",
                             **{"num_slots": 256, "max_delay_ms": 0.2, **kw})


def _poll(cond, seconds: float = 10.0) -> bool:
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# ---------------------------------------------------------------------------
# The ingress drill and the fault proxy
# ---------------------------------------------------------------------------

def test_ingress_drill_fast():
    registry = MeterRegistry()
    report = ingress_drill(registry=registry, device="cpu")
    assert report["mismatches"] == 0
    assert set(report["faults"]) == {
        "malformed", "malformed_v5_columns", "slowloris", "garbage",
        "kill_mid_pipeline"}
    assert report["shed"] >= 1
    # 5 classic malformed frames + 4 malformed v5 columnar frames, every
    # one answered in-protocol with the stream staying in sync.
    assert report["malformed_answered"] == 9
    scrape = registry.scrape()
    assert scrape["ratelimiter.sidecar.malformed"] >= 9
    assert scrape["ratelimiter.sidecar.idle_closed"] >= 1
    assert scrape["ratelimiter.sidecar.pipeline_shed"] >= 1
    assert scrape["ratelimiter.sidecar.connections"] == 0


def test_ingress_drill_report_matches_reference():
    """Both packages' drills on the same seed: the same faults, the same
    oracle-checked decisions, the same malformed answers."""
    require_reference_native()
    keys = ("decisions", "mismatches", "faults", "malformed_answered")
    port = ingress_drill(seed=3, device="cpu")
    ref = ref_ingress_drill(seed=3)
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["decisions"] > 0


def test_fault_proxy_passthrough_is_transparent():
    clock = {"t": T0}
    storage = _storage(clock)
    server = sc.SidecarServer(storage, host="127.0.0.1").start()
    proxy = FaultInjectingProxy(server.port).start()
    try:
        lid = server.register("tb", RateLimitConfig(
            max_permits=50, window_ms=60_000, refill_rate=25.0))
        client = sc.SidecarClient("127.0.0.1", proxy.port, timeout=30.0)
        assert client.server_version >= 3  # handshake survives the hop
        got = client.acquire_batch(lid, [f"p{i}" for i in range(16)])
        assert all(s == sc.ST_OK and a for s, a, _ in got)
        client.close()
        assert proxy.connections == 1
        assert proxy.faults_injected == 0
    finally:
        proxy.stop()
        server.stop()
        storage.close()


def test_killed_client_leaves_no_queued_work():
    """A client killed mid-pipeline through the proxy: the server's
    in-flight count, the batcher's queue depth and waiter set, and its
    connections return to baseline (bounded polls), and the server
    still decides."""
    clock = {"t": T0}
    storage = _storage(clock, max_inflight=1)
    server = sc.SidecarServer(storage, host="127.0.0.1",
                              read_timeout_ms=300.0).start()
    proxy = FaultInjectingProxy(server.port, seed=1).start()
    batcher = storage._batcher
    try:
        lid = server.register("tb", RateLimitConfig(
            max_permits=1000, window_ms=60_000, refill_rate=100.0))
        proxy.set_fault("kill", after=120)
        kil = sc.SidecarClient("127.0.0.1", proxy.port, timeout=5.0,
                               protocol=1)
        try:
            kil.acquire_batch(lid, [f"k{i}" for i in range(48)])
        except (ConnectionError, OSError):
            pass
        finally:
            kil.close()

        def idle():
            with batcher._cv:
                waiters = len(batcher._waiters)
            return (waiters == 0 and batcher.queue_depth() == 0
                    and server.inflight() == 0
                    and server.connections() == 0)

        assert _poll(idle)
        proxy.heal()
        cli = sc.SidecarClient("127.0.0.1", server.port, timeout=30.0)
        assert cli.try_acquire(lid, "after-kill") is True
        cli.close()
    finally:
        proxy.stop()
        server.stop()
        storage.close()


def test_batcher_forget_withdraws_queued_requests():
    """``MicroBatcher.forget`` removes still-queued futures (cancelled, out
    of the waiter set, slots unpinned) and leaves dispatched ones alone."""
    gate = threading.Event()

    def answer(n):
        gate.wait(timeout=5.0)
        return {"allowed": np.ones(n, dtype=bool)}

    # Huge delay: nothing dispatches until flush is forced.
    batcher = MicroBatcher(
        dispatch={"sw": lambda s, l, p: answer(len(s))},
        dispatch_staged={"sw": lambda buf, n: answer(n)},
        drain={"sw": lambda h, n: h},
        clear={"sw": lambda s: None},
        max_batch=1024, max_delay_ms=10_000.0)
    try:
        futs = [batcher.submit("sw", i, 0, 1) for i in range(8)]
        assert batcher.queue_depth() == 8
        dropped = futs[:5]
        assert batcher.forget(dropped) == 5
        assert batcher.abandoned_total == 5
        assert batcher.queue_depth() == 3
        assert batcher.pending_slots("sw") == {5, 6, 7}
        assert all(f.cancelled() for f in dropped)
        gate.set()
        batcher.flush()
        for f in futs[5:]:
            assert f.result(timeout=5.0)["allowed"]
        with batcher._cv:
            assert not batcher._waiters
        # Forgetting already-resolved futures is a no-op.
        assert batcher.forget(futs[5:]) == 0
        # A forget that empties the queue drops its age: the flusher
        # finds nothing ready (the port's repair of the reference's spin).
        more = [batcher.submit("sw", 9, 0, 1)]
        assert batcher.forget(more) == 1
        with batcher._cv:
            assert batcher._pending["sw"].born is None
    finally:
        gate.set()
        batcher.close()


def _echo_server():
    class Echo(socketserver.BaseRequestHandler):
        def handle(self):
            while True:
                try:
                    data = self.request.recv(64)
                except OSError:
                    return
                if not data:
                    return
                try:
                    self.request.sendall(data)
                except OSError:
                    return

    class EchoServer(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    server = EchoServer(("127.0.0.1", 0), Echo)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.mark.parametrize("direction", ["both", "up", "down"])
def test_proxy_partition_drops_without_rst(direction):
    """partition(direction): the cut bytes vanish but neither socket is
    closed — recv times out, send succeeds — and heal() restores the same
    connection."""
    echo = _echo_server()
    proxy = FaultInjectingProxy(echo.server_address[1]).start()
    try:
        conn = socket.create_connection(("127.0.0.1", proxy.port),
                                        timeout=2.0)
        conn.sendall(b"ping")
        assert conn.recv(16) == b"ping"
        proxy.partition(direction)
        conn.settimeout(0.3)
        conn.sendall(b"lost")            # send succeeds: no RST came back
        with pytest.raises(socket.timeout):
            conn.recv(16)                # ...but nothing ever returns
        assert proxy.faults_injected >= 1
        proxy.heal()                     # same connection, live again
        conn.settimeout(2.0)
        conn.sendall(b"back")
        # The cut bytes never come back, whichever way they were cut.
        assert conn.recv(16) == b"back"
        conn.close()
    finally:
        proxy.stop()
        echo.shutdown()
        echo.server_close()


def test_proxy_flap_alternates_partition_and_passthrough():
    echo = _echo_server()
    proxy = FaultInjectingProxy(echo.server_address[1]).start()
    try:
        period = 0.4
        proxy.flap(period)
        conn = socket.create_connection(("127.0.0.1", proxy.port),
                                        timeout=2.0)
        conn.settimeout(0.15)
        ok = cut = 0
        deadline = time.monotonic() + 4 * period
        while time.monotonic() < deadline and not (ok and cut):
            try:
                conn.sendall(b"x")
                if conn.recv(16):
                    ok += 1
                else:
                    break
            except socket.timeout:
                cut += 1
            time.sleep(period / 8)
        assert ok >= 1, "flap never let a byte through"
        assert cut >= 1, "flap never cut the link"
        proxy.heal()
        conn.close()
    finally:
        proxy.stop()
        echo.shutdown()
        echo.server_close()


def test_proxy_rejects_unknown_modes():
    proxy = FaultInjectingProxy(1).start()
    try:
        with pytest.raises(ValueError):
            proxy.set_fault("melt")
        with pytest.raises(ValueError):
            proxy.set_fault("partition", direction="sideways")
    finally:
        proxy.stop()


# ---------------------------------------------------------------------------
# Health and wiring
# ---------------------------------------------------------------------------

def test_health_state_machine_includes_sidecar_sheds():
    """A pipeline shed flips the health payload to SHEDDING within the
    window and decays back to UP after it."""
    clock = {"t": T0}
    storage = _storage(clock)
    props = AppProperties({
        "ratelimiter.overload.shed_health_window_ms": "400"})
    ctx = wiring.build_app(props, storage=storage)
    server = sc.SidecarServer(storage, host="127.0.0.1",
                              max_pipeline=4).start()
    ctx.sidecar = server
    try:
        lid = server.register("tb", RateLimitConfig(
            max_permits=100, window_ms=60_000, refill_rate=50.0))
        assert health_payload(ctx)["status"] == "UP"
        client = sc.SidecarClient("127.0.0.1", server.port, timeout=30.0)
        got = client.acquire_batch(lid, [f"h{i}" for i in range(16)])
        assert any(s == sc.ST_SHED for s, _, _ in got)
        payload = health_payload(ctx)
        assert payload["status"] == "SHEDDING"
        assert payload["sidecar"]["pipeline_shed_total"] >= 1
        assert _poll(lambda: health_payload(ctx)["status"] == "UP", 5.0)
        client.close()
    finally:
        ctx.close()


def test_wiring_starts_sidecar_from_props():
    ctx = wiring.build_app(AppProperties({
        "storage.num_slots": "256",
        "warmup.enabled": "false",
        "ratelimiter.sidecar.enabled": "true",
        "ratelimiter.sidecar.port": "0",   # ephemeral
    }), device="cpu")
    try:
        assert ctx.sidecar is not None
        assert ctx.sidecar.storage is ctx.storage._inner._inner
        client = sc.SidecarClient("127.0.0.1", ctx.sidecar.port,
                                  timeout=30.0)
        assert client.server_version == sc.PROTOCOL_VERSION
        assert client.ping()
        client.close()
        assert "sidecar" in health_payload(ctx)
    finally:
        ctx.close()
    # close() stopped the listener.
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", ctx.sidecar.port),
                                 timeout=2.0).recv(1)


def test_sidecar_on_memory_backend_stays_off():
    """The memory backend has no batched decision protocol: both apps
    warn alike and serve without the sidecar."""
    warned = []
    for build, cls, name, kw in (
            (ref_wiring.build_app, RefProps, "ratelimiter", {}),
            (wiring.build_app, AppProperties, port_logging.ROOT,
             {"device": "cpu"})):
        with _Warnings(name) as logs:
            ctx = build(cls({"storage.backend": "memory",
                             "ratelimiter.sidecar.enabled": "true",
                             "ratelimiter.sidecar.port": "0"}), **kw)
        try:
            assert ctx.sidecar is None
        finally:
            ctx.close()
        warned.append([m for m in logs.messages if "sidecar" in m])
    assert warned[1] == warned[0]
    assert warned[1] == ["ratelimiter.sidecar.enabled but the "
                         "InMemoryStorage backend has no batched decision "
                         "protocol; sidecar disabled"]


def _sidecar_props(**extra):
    return {"storage.num_slots": "4096", "warmup.enabled": "false",
            "link.probe.enabled": "false", "parallel.shard": "off",
            "server.port": "0", "ratelimiter.sidecar.enabled": "true",
            "ratelimiter.sidecar.port": "0",
            "ratelimiter.lease.enabled": "true", **extra}


def test_build_app_sidecar_matches_reference(monkeypatch):
    """Both packages' ``build_app`` with the sidecar and leases on, on one
    manual clock: the trio is exposed under the same lids, a key spent
    through ``GET /api/data`` is seen by an AVAILABLE frame, lease frames
    ride the app's lease manager, the health payload's ``sidecar`` block
    has the reference's keys, and both answer alike."""
    require_reference_native()
    clock = {"t": T0}
    now = lambda: clock["t"]  # noqa: E731
    monkeypatch.setattr(wiring, "GpuBatchedStorage", functools.partial(
        GpuBatchedStorage, clock_ms=now, host_parallel=0))
    monkeypatch.setattr(ref_wiring, "TpuBatchedStorage", functools.partial(
        ref_wiring.TpuBatchedStorage, clock_ms=now, host_parallel=0))
    port_ctx = wiring.build_app(AppProperties(_sidecar_props()),
                                device="cpu")
    ref_ctx = ref_wiring.build_app(RefProps(_sidecar_props()))
    apps = [Server(ref_ctx, __import__("ratelimiter_tpu.service.app",
                                       fromlist=["app"])),
            Server(port_ctx, port_app)]
    try:
        out = []
        for app, client_cls in zip(apps, (RefClient, sc.SidecarClient)):
            ctx = app.ctx
            exposed = {lid: algo for lid, (algo, _cfg)
                       in ctx.sidecar._limiters.items()}
            assert ctx.sidecar._leases is ctx.leases
            cli = client_cls("127.0.0.1", ctx.sidecar.port, timeout=30.0)
            api = ctx.limiters["api"]._lid
            burst = ctx.limiters["burst"]._lid
            statuses = [app.request("GET", "/api/data", None,
                                    {"X-User-ID": "alice"})[0]
                        for _ in range(7)]
            seen = [cli.available(api, "alice"),
                    cli.try_acquire(api, "alice", 3),
                    cli.available(api, "alice")]
            grant = tuple(cli.lease_grant(burst, "leased", 20))
            after = app.request("POST", "/api/batch", {"size": 35},
                                {"X-User-ID": "leased"})[0]
            cli.lease_release(burst, "leased", 0)
            cli.close()
            assert _poll(lambda: ctx.sidecar.connections() == 0)
            health = (health_payload if app is apps[1]
                      else ref_health)(ctx)
            out.append((exposed, statuses, seen, grant, after,
                        sorted(health["sidecar"]), health["status"],
                        health["sidecar"]["connections"]))
        assert out[1] == out[0]
        exposed, statuses, seen, grant = out[1][:4]
        assert sorted(exposed.values()) == ["sw", "sw", "tb"]
        # The sliding window counts a decision once whatever its permits
        # (the reference's quirk Q1).
        assert statuses == [200] * 7 and seen == [93, True, 92]
        assert grant[0] == 20
        assert out[1][4] == 429  # the lease holds 20 of the 50 tokens
    finally:
        for app in apps:
            app.close()


# ---------------------------------------------------------------------------
# Observability through the sidecar
# ---------------------------------------------------------------------------

@pytest.fixture
def lease_stack():
    storage = GpuBatchedStorage(num_slots=1 << 10, max_delay_ms=0.2,
                                device="cpu")
    server = sc.SidecarServer(storage, host="127.0.0.1").start()
    lid = server.register("tb", RateLimitConfig(
        max_permits=1 << 18, window_ms=60_000, refill_rate=1e6))
    manager = LeaseManager(storage, default_budget=8, max_budget=8,
                           ttl_ms=60_000.0)
    server.attach_leases(manager)
    try:
        yield storage, server, manager, lid
    finally:
        server.stop()
        storage.close()


def test_trace_propagation_sidecar_with_lease_ops_interleaved(lease_stack):
    """grant -> local burns -> renew read back under one trace lineage,
    and a plain traced TRY_ACQUIRE shows its own sidecar -> batcher ->
    shard -> resolve path in the port's lineage ring."""
    storage, server, manager, lid = lease_stack
    wire = sc.SidecarClient("127.0.0.1", server.port, timeout=30.0)
    assert wire.server_version >= 4
    cli = LeaseClient(wire, lid, budget=8, trace_lineage=True,
                      telemetry_flush_ms=0.0)
    try:
        plain = mint_trace_id()
        for i in range(12):
            assert cli.try_acquire("trace:leased")
            if i == 5:
                assert wire.try_acquire(lid, f"plain{i}", trace_id=plain)
        tid = cli.trace_of("trace:leased")
        assert tid
        hops = storage.lineage.hops(tid)
        gi = hops.index("lease.grant")
        ci = hops.index("client")
        ri = hops.index("lease.renew")
        assert gi < ci < ri
        assert {"sidecar", "batcher", "shard", "resolve"} <= set(hops)
        burns = [h for h in storage.lineage.lineage(tid)
                 if h["hop"] == "client"]
        assert burns[0]["local_burns"] == 8   # the exhausted budget
        assert _poll(lambda: "resolve" in storage.lineage.hops(plain), 5.0)
        names = storage.lineage.hops(plain)
        assert names[0] == "sidecar"
        assert {"batcher", "shard", "resolve"} <= set(names)
        assert "lease.grant" not in names
    finally:
        cli.release_all()
        wire.close()


def test_fleet_counters_reconcile_over_wire(lease_stack):
    """After release_all's final flush, ratelimiter.decisions.* equals the
    client's ground-truth decision count exactly (op 9 folded into the
    port's telemetry plane)."""
    storage, server, manager, lid = lease_stack
    plane = storage.telemetry
    base = plane.allowed_total + plane.denied_total
    wire = sc.SidecarClient("127.0.0.1", server.port, timeout=30.0)
    cli = LeaseClient(wire, lid, budget=8)
    try:
        n = 50
        for i in range(n):
            assert cli.try_acquire(f"acct:k{i % 3}")
        cli.release_all()
        # The release frames serialize behind the final telemetry frame,
        # so the fold has landed by now.
        assert plane.allowed_total + plane.denied_total - base == n
        assert plane.lease_local_total >= cli.local_decisions
        assert server.telemetry_frames_total > 0
        assert plane.reports_total > 0
    finally:
        wire.close()


def test_v3_client_sees_no_telemetry_and_old_framing(lease_stack):
    storage, server, manager, lid = lease_stack
    client = sc.SidecarClient("127.0.0.1", server.port, protocol=3,
                              timeout=30.0)
    assert client.server_version == 3
    assert not client.telemetry_supported()
    assert client.telemetry_report(b"anything") is False
    g = client.lease_grant(lid, "v3:key", 8)
    assert g is not None and g.granted == 8
    client.lease_release(lid, "v3:key", 0)
    client._send(client._frame(sc.OP_TELEMETRY, 0, 0, "x"))
    status, _, errno = client._read_raw()
    assert (status, errno) == (sc.ST_BAD_FRAME, sc.ERR_UNKNOWN_OP)
    assert client.try_acquire(lid, "v3-still-works") is True
    client.close()


def test_trace_propagation_through_sidecar():
    """One pipelined sidecar acquire produces a sampled micro trace whose
    stages telescope to its total."""
    storage = GpuBatchedStorage(num_slots=256, max_delay_ms=0.1,
                                trace_sample=1, recorder=FlightRecorder(),
                                device="cpu")
    server = sc.SidecarServer(storage, host="127.0.0.1").start()
    try:
        lid = server.register("tb", RateLimitConfig(
            max_permits=50, window_ms=60_000, refill_rate=10.0))
        client = sc.SidecarClient("127.0.0.1", server.port, timeout=30.0)
        assert client.try_acquire(lid, "sidecar-trace-user") is True
        client.close()

        def entry():
            return next((e for e in storage.trace.snapshot()["recent"]
                         if e.get("path") == "micro"
                         and "stages_us" in e), None)

        assert _poll(lambda: entry() is not None, 5.0)
        stages = entry()["stages_us"]
        assert set(stages) == {"queue_wait", "assembly", "device",
                               "resolve"}
        assert all(v >= 0.0 for v in stages.values())
        assert abs(sum(stages.values()) - entry()["latency_us"]) <= 1.0
    finally:
        server.stop()
        storage.close()


@pytest.mark.slow
def test_ingress_soak_slow():
    """30 s soak: 8 pipelining clients sustain decisions while chaos
    clients hammer the proxy with cycling faults.  Healthy traffic never
    sees a non-OK status; everything drains to baseline at the end."""
    duration_s = 30.0
    n_clients = 8
    pipeline = 32
    storage = GpuBatchedStorage(num_slots=1 << 12, max_delay_ms=0.3,
                                max_inflight=1, device="cpu")
    server = sc.SidecarServer(
        storage, host="127.0.0.1",
        max_frame_bytes=512, max_key_bytes=64, max_pipeline=256,
        idle_timeout_ms=5_000.0, read_timeout_ms=500.0).start()
    proxy = FaultInjectingProxy(server.port, seed=3).start()
    stop = threading.Event()
    errors: list = []
    decisions = [0] * n_clients
    try:
        lid = server.register("tb", RateLimitConfig(
            max_permits=1_000_000, window_ms=60_000, refill_rate=1e6))
        lid_atk = server.register("tb", RateLimitConfig(
            max_permits=1000, window_ms=60_000, refill_rate=100.0))

        def healthy_loop(i: int) -> None:
            try:
                client = sc.SidecarClient("127.0.0.1", server.port,
                                          timeout=30.0)
                r = 0
                while not stop.is_set():
                    keys = [f"c{i}-k{(r * pipeline + j) % 512}"
                            for j in range(pipeline)]
                    got = client.acquire_batch(lid, keys)
                    for s, _, _ in got:
                        assert s == sc.ST_OK, f"healthy client saw {s}"
                    decisions[i] += len(got)
                    r += 1
                client.close()
            except Exception as exc:  # noqa: BLE001 — collected below
                errors.append((i, repr(exc)))

        def chaos_loop() -> None:
            faults = ["kill", "garbage", "truncate", None]
            k = 0
            while not stop.is_set():
                mode = faults[k % len(faults)]
                if mode == "kill":
                    proxy.set_fault("kill", after=100 + 40 * (k % 5))
                elif mode == "garbage":
                    proxy.set_fault("garbage", after=13 + 7 * (k % 9), n=32)
                elif mode == "truncate":
                    proxy.set_fault("truncate", after=9 + 5 * (k % 7))
                else:
                    proxy.set_fault(None)
                k += 1
                try:
                    atk = sc.SidecarClient("127.0.0.1", proxy.port,
                                           timeout=2.0, protocol=1)
                    atk.acquire_batch(lid_atk, [f"a{j}" for j in range(24)])
                    atk.close()
                except Exception:  # noqa: BLE001 — faults should break it
                    pass
                time.sleep(0.02)

        threads = [threading.Thread(target=healthy_loop, args=(i,),
                                    daemon=True) for i in range(n_clients)]
        threads += [threading.Thread(target=chaos_loop, daemon=True)
                    for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(duration_s)
        stop.set()
        for t in threads:
            t.join(timeout=15.0)
        assert not errors, f"healthy clients failed: {errors[:5]}"
        assert sum(decisions) > 0
        batcher = storage._batcher

        def idle():
            with batcher._cv:
                waiters = len(batcher._waiters)
            return (waiters == 0 and batcher.queue_depth() == 0
                    and server.inflight() == 0)

        assert _poll(idle)
        probe = sc.SidecarClient("127.0.0.1", server.port, timeout=30.0)
        assert probe.ping()
        probe.close()
    finally:
        stop.set()
        proxy.stop()
        server.stop()
        storage.close()
