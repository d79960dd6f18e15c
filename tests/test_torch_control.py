"""The port's control-plane RPC and its replication wiring against the JAX
package's, on the CPU.

- The control wire (``replication/control.py``): framed-JSON dispatch,
  in-protocol refusals, the lease-relay mailbox's relative age
  (``tests/test_cross_host.py:58``, ``:87``).
- ``primary_handlers``, ``standby_handlers`` and ``mux_handlers`` over the
  port's storage, answering as the reference's handlers over
  ``TpuBatchedStorage`` answer on the same clock (probe, fence, lease,
  restore, ship, promote, the mailbox).
- Policy replication across a failover (``tests/test_control.py:460``,
  ``:510``).
- ``build_app`` with ``ratelimiter.control.port`` (``tests/
  test_cross_host.py:475``), and both roles of ``replication.*`` served
  end to end: a standby app and a primary app of each package on one
  manual clock, the same HTTP requests to both packages, control calls
  (probe, fence, lease, restore, ship), ``/actuator/replication`` and the
  promotion over HTTP; statuses equal between the packages and, for the
  cache-less limiters, to the oracle rolled back to the promoted epoch.

Every socket wait is bounded (control calls time out in 2-5 s).
"""

import copy
import functools
import http.client
import json
import socket
import threading
import time

import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu import replication as ref_replication
from ratelimiter_tpu.replication import control as ref_control
from ratelimiter_tpu.service import app as ref_app
from ratelimiter_tpu.service import wiring as ref_wiring
from ratelimiter_tpu.service.props import AppProperties as RefProps
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch import replication as port_replication
from ratelimiter_tpu_torch.engine.checkpoint import apply_limiter_policies
from ratelimiter_tpu_torch.replication import (
    ControlClient,
    ControlServer,
    InProcessSink,
    LeaseMailbox,
    ReplicationLog,
    Replicator,
    StandbyReceiver,
    mux_handlers,
    primary_handlers,
)
from ratelimiter_tpu_torch.semantics import (
    SlidingWindowOracle,
    TokenBucketOracle,
)
from ratelimiter_tpu_torch.service import app as port_app
from ratelimiter_tpu_torch.service import wiring
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.service.wiring import build_app
from ratelimiter_tpu_torch.storage.errors import FencedError
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_753_000_000_000


def port_storage(clock, num_slots=512, **kw):
    kw.setdefault("host_parallel", 0)
    return GpuBatchedStorage(num_slots=num_slots, clock_ms=lambda: clock["t"],
                             device="cpu", **kw)


def ref_storage(clock, num_slots=512, **kw):
    require_reference_native()
    kw.setdefault("host_parallel", 0)
    return TpuBatchedStorage(num_slots=num_slots, clock_ms=lambda: clock["t"],
                             **kw)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# Control wire
# ---------------------------------------------------------------------------

def test_control_wire_roundtrip_and_refusals():
    """``tests/test_cross_host.py:58`` on the port's server and client."""
    calls = []

    def echo(**kw):
        calls.append(kw)
        return {"echo": kw}

    def boom():
        raise RuntimeError("handler exploded")

    server = ControlServer({"echo": echo, "boom": boom}).start()
    client = ControlClient("127.0.0.1", server.port, timeout=2.0)
    try:
        resp = client.call("echo", a=1, b="x")
        assert resp["ok"] and resp["echo"] == {"a": 1, "b": "x"}
        assert client.call("nope")["ok"] is False
        boomed = client.call("boom")
        assert boomed["ok"] is False and "handler exploded" in boomed["error"]
        assert client.call("echo", c=2)["ok"]
        with pytest.raises(RuntimeError, match="refused"):
            client.call_ok("boom")
        assert server.requests_served >= 4
    finally:
        client.close()
        server.stop()


def test_control_client_speaks_to_the_reference_server():
    """The wire is the reference's: each package's client drives the other
    package's server."""
    servers = [ControlServer({"echo": lambda **kw: {"got": kw}}).start(),
               ref_control.ControlServer(
                   {"echo": lambda **kw: {"got": kw}}).start()]
    try:
        for server, client_cls in ((servers[0], ref_control.ControlClient),
                                   (servers[1], ControlClient)):
            client = client_cls("127.0.0.1", server.port, timeout=2.0)
            assert client.call_ok("echo", n=3)["got"] == {"n": 3}
            assert client.try_call("missing")["ok"] is False
            client.close()
        dead = ControlClient("127.0.0.1", free_port(), timeout=0.5)
        assert dead.try_call("echo") is None
    finally:
        for server in servers:
            server.stop()


def test_lease_mailbox_age_is_relative():
    """``tests/test_cross_host.py:87``."""
    box = LeaseMailbox()
    assert box.fetch() == {"deposited": False}
    box.deposit(epoch=3, ttl_ms=500.0)
    time.sleep(0.03)
    got = box.fetch()
    assert got["deposited"] and got["epoch"] == 3
    assert 25.0 <= got["age_ms"] < 5000.0
    box.deposit(epoch=4, ttl_ms=500.0)
    assert box.fetch()["epoch"] == 4


# ---------------------------------------------------------------------------
# Role handlers over both packages' storages
# ---------------------------------------------------------------------------

def _pair_handlers(clock):
    """A primary and a standby of each package, replicated in process,
    with the role handler tables: {True: reference, False: port}."""
    out = {}
    for ref in (True, False):
        pkg = ref_replication if ref else port_replication
        prim = (ref_storage if ref else port_storage)(clock)
        stby = (ref_storage if ref else port_storage)(clock)
        cfg = (RefConfig if ref else RateLimitConfig)(
            max_permits=5, window_ms=1000, refill_rate=2.0)
        lid = prim.register_limiter("tb", cfg)
        rx = pkg.StandbyReceiver(stby)
        repl = pkg.Replicator(pkg.ReplicationLog(prim, journal_kind="host"),
                              pkg.InProcessSink(rx))
        out[ref] = dict(prim=prim, stby=stby, lid=lid,
                        ph=pkg.primary_handlers(prim, replicator=repl),
                        sh=pkg.standby_handlers(stby, rx))
    return out


def _same(calls, what):
    ref, port = calls
    assert port == ref, what
    return port


def test_role_handlers_answer_as_the_reference():
    """The primary's probe / fence / lease / restore / ship and the
    standby's probe / mailbox / promote / fence answer as the reference's
    handlers do, call for call on one clock; a fenced primary refuses
    decisions, and the promoted standby decides on the shipped state."""
    clock = {"t": T0}
    sides = _pair_handlers(clock)

    def both(fn):
        return [fn(sides[ref]) for ref in (True, False)]

    def decide(s, key="k"):
        return bool(s["prim"].acquire("tb", s["lid"], key, 1)["allowed"])

    try:
        _same(both(lambda s: s["ph"]["probe"]()), "first probe")
        clock["t"] += 10
        _same(both(lambda s: [decide(s) for _ in range(3)]), "decide")
        _same(both(lambda s: s["ph"]["ship"]()), "ship")
        _same(both(lambda s: s["ph"]["probe"]()), "probe after ship")
        _same(both(lambda s: s["ph"]["lease"](epoch=1, ttl_ms=5000.0)),
              "lease")
        clock["t"] += 100
        _same(both(lambda s: s["ph"]["probe"]()), "probe under a lease")
        _same(both(lambda s: s["ph"]["fence"](epoch=2)), "fence")
        for s in sides.values():
            with pytest.raises(Exception) as info:
                decide(s)
            assert type(info.value).__name__ == "FencedError"
        assert isinstance(info.value, FencedError)      # the port's, last
        for s in sides.values():
            with pytest.raises(ValueError):
                s["ph"]["lease"](epoch=3, ttl_ms=100.0)   # no resurrection
        _same(both(lambda s: s["ph"]["restore"](epoch=2)), "restore")
        _same(both(lambda s: s["ph"]["probe"]()), "probe after restore")
        _same(both(lambda s: [decide(s) for _ in range(4)]), "decide again")
        _same(both(lambda s: s["ph"]["ship"]()), "second ship")
        probes = _same(both(lambda s: s["sh"]["probe"]()), "standby probe")
        assert probes["consistent"] and not probes["promoted"]
        assert probes["last_epoch"] == 2
        _same(both(lambda s: s["sh"]["lease_deposit"](epoch=7,
                                                     ttl_ms=500.0)),
              "deposit")
        fetched = both(lambda s: s["sh"]["lease_fetch"]())
        assert [f["epoch"] for f in fetched] == [7, 7]
        for s in sides.values():
            s["prim"].close()
        _same(both(lambda s: s["sh"]["promote"]()), "promote")
        _same(both(lambda s: s["sh"]["probe"]()), "promoted probe")
        for s in sides.values():
            with pytest.raises(Exception, match="already promoted"):
                s["sh"]["promote"]()
        clock["t"] += 10
        _same(both(lambda s: [bool(s["stby"].acquire(
            "tb", s["lid"], "k", 1)["allowed"]) for _ in range(4)]),
            "promoted decisions")
        _same(both(lambda s: s["sh"]["fence"](epoch=9)), "standby fence")
        assert sorted(sides[False]["ph"]) == sorted(sides[True]["ph"])
        assert sorted(sides[False]["sh"]) == sorted(sides[True]["sh"])
    finally:
        for s in sides.values():
            s["stby"].close()


def test_mux_handlers_behind_one_port():
    """Two port storages' primary tables behind one control port: the
    ``shard`` field routes, ``probe_all`` answers both in one call, an
    unknown shard and an op a shard lacks answer in-protocol."""
    clock = {"t": T0}
    stores = [port_storage(clock, 256) for _ in range(2)]
    tables = {q: primary_handlers(st) for q, st in enumerate(stores)}
    tables[1]["only_one"] = lambda: {"one": True}
    server = ControlServer(mux_handlers(
        tables, extra={"hello": lambda: {"hi": 1}})).start()
    client = ControlClient("127.0.0.1", server.port, timeout=2.0)
    try:
        assert client.call_ok("fence", shard=1, epoch=4)["epoch"] == 4
        assert stores[1].fence_info()["all"]
        assert not stores[0].fence_info()["all"]
        assert client.call_ok("probe")["fence"]["epoch"] == 0  # shard 0
        every = client.call_ok("probe_all")["shards"]
        assert sorted(every) == ["0", "1"]
        assert every["1"]["ok"] and every["1"]["fence"]["epoch"] == 4
        assert client.call("probe", shard=5)["ok"] is False
        assert client.call("only_one", shard=0)["ok"] is False
        assert client.call_ok("only_one", shard=1)["one"] is True
        assert client.call_ok("hello")["hi"] == 1
        assert client.call_ok("restore", shard=1, epoch=4)["epoch"] == 4
        assert not stores[1].fence_info()["all"]
    finally:
        client.close()
        server.stop()
        for st in stores:
            st.close()


# ---------------------------------------------------------------------------
# Policy replication across failover
# ---------------------------------------------------------------------------

def test_policy_update_replicates_across_failover():
    """``tests/test_control.py:460``: a mid-stream ``set_policy`` crosses
    the stream; the promoted standby serves the post-update generation."""
    clock = {"t": T0}
    primary = port_storage(clock)
    standby = port_storage(clock)
    cfg0 = RateLimitConfig(max_permits=12, window_ms=1000)
    lid = primary.register_limiter("sw", cfg0)
    oracle = SlidingWindowOracle(cfg0)
    log = ReplicationLog(primary, journal_kind="device")
    receiver = StandbyReceiver(standby)
    repl = Replicator(log, InProcessSink(receiver))

    def wave(storage, n=24):
        keys = [f"w{i % 8}" for i in range(n)]
        out = storage.acquire_many("sw", [lid] * n, keys, [1] * n)
        expect = [oracle.try_acquire(k, 1, clock["t"]).allowed
                  for k in keys]
        assert out["allowed"].tolist() == expect

    wave(primary)
    repl.ship_now()
    new_cfg = RateLimitConfig(max_permits=4, window_ms=1000)
    gen = primary.set_policy(lid, new_cfg)
    oracle.reconfigure(new_cfg)
    clock["t"] += 400
    wave(primary)
    repl.ship_now()
    promoted = receiver.promote()
    assert promoted.policy_info()["generation"] == gen == 1
    assert promoted.policy_info()["lids"][lid]["max_permits"] == 4
    clock["t"] += 2000
    wave(promoted)
    repl.close()
    primary.close()
    standby.close()


def test_policy_update_after_bootstrap_frame_applies_on_standby():
    """``tests/test_control.py:510``."""
    st = port_storage({"t": T0})
    lid = st.register_limiter("sw", RateLimitConfig(max_permits=12,
                                                    window_ms=1000))
    apply_limiter_policies(st, {str(lid): {
        "algo": "sw", "max_permits": 5, "window_ms": 1000,
        "refill_rate": 0.0, "gen": 3}})
    assert st.policy_info()["lids"][lid]["max_permits"] == 5
    assert st.policy_info()["lids"][lid]["generation"] == 3
    apply_limiter_policies(st, {str(lid): {
        "algo": "sw", "max_permits": 5, "window_ms": 1000,
        "refill_rate": 0.0, "gen": 3}})
    with pytest.raises(ValueError, match="no newer policy generation"):
        apply_limiter_policies(st, {str(lid): {
            "algo": "sw", "max_permits": 7, "window_ms": 1000,
            "refill_rate": 0.0, "gen": 3}})
    with pytest.raises(ValueError, match="algo/window shape"):
        apply_limiter_policies(st, {str(lid): {
            "algo": "sw", "max_permits": 5, "window_ms": 2000,
            "refill_rate": 0.0, "gen": 9}})
    st.close()


# ---------------------------------------------------------------------------
# Wiring: the control port and both replication roles through build_app
# ---------------------------------------------------------------------------

def test_wiring_control_port_serves_fence_authority():
    """``tests/test_cross_host.py:475`` on the port's ``build_app``."""
    base = {"storage.num_slots": "256", "warmup.enabled": "false"}
    ctx = build_app(AppProperties({**base,
                                   "ratelimiter.control.port": "0"}),
                    device="cpu")
    try:
        assert ctx.control is None
    finally:
        ctx.close()
    port = free_port()
    ctx = build_app(AppProperties({**base,
                                   "ratelimiter.control.port": str(port)}),
                    device="cpu")
    try:
        assert ctx.control is not None and ctx.control.port == port
        client = ControlClient("127.0.0.1", port, timeout=2.0)
        probe = client.call_ok("probe")
        assert probe["role"] == "primary" and probe["available"]
        assert "replication" not in probe
        client.call_ok("lease", epoch=1, ttl_ms=60_000.0)
        assert client.call_ok("probe")["fence"]["epoch"] == 1
        client.close()
    finally:
        ctx.close()


class App:
    """One package's app behind a ThreadingHTTPServer on a loopback port."""

    def __init__(self, ctx, module):
        self.ctx = ctx
        self.srv = module.make_server(ctx, port=0)
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
        data = json.loads(resp.read() or b"{}")
        conn.close()
        return resp.status, data

    def close(self):
        self.srv.shutdown()
        self.thread.join(timeout=5)
        self.ctx.close()


def _boot(ref, props):
    """build_app of one package over the storage its properties name."""
    if ref:
        return App(ref_wiring.build_app(RefProps(props)), ref_app)
    return App(build_app(AppProperties(props), device="cpu"), port_app)


def test_build_app_serves_both_replication_roles(monkeypatch):
    """A standby app, then a primary app with ``replication.target``, each
    with a control port, for both packages on one manual clock.  The same
    HTTP requests go to both packages' primaries (logins, batches, data),
    a control ``ship`` pins the standby, one more login wave is lost with
    the primary, the primary is fenced (decisions refused alike on both
    packages), lease and restore, then ``POST
    /actuator/replication/promote`` on the standbys: their decisions equal
    each other's and the oracle rolled back to the promoted epoch."""
    clock = {"t": T0}
    now = lambda: clock["t"]  # noqa: E731
    monkeypatch.setattr(wiring, "GpuBatchedStorage",
                        functools.partial(GpuBatchedStorage, clock_ms=now,
                                          host_parallel=0))
    monkeypatch.setattr(ref_wiring, "TpuBatchedStorage",
                        functools.partial(TpuBatchedStorage, clock_ms=now,
                                          host_parallel=0))
    require_reference_native()
    base = {"storage.num_slots": "4096", "parallel.shard": "off",
            "warmup.enabled": "false", "link.probe.enabled": "false",
            "server.port": "0"}
    apps = {}
    try:
        for ref in (True, False):
            standby = _boot(ref, {
                **base, "replication.enabled": "true",
                "replication.role": "standby",
                "replication.listen_port": "0",
                "ratelimiter.control.port": str(free_port())})
            apps[ref, "standby"] = standby
            target = standby.ctx.replication.server.port
            apps[ref, "primary"] = _boot(ref, {
                **base, "replication.enabled": "true",
                "replication.role": "primary",
                "replication.target": f"127.0.0.1:{target}",
                "replication.interval_ms": "60000",
                "ratelimiter.control.port": str(free_port())})
        ctl = {k: ControlClient("127.0.0.1", app.ctx.control.port,
                                timeout=5.0) for k, app in apps.items()}

        def send(role, method, path, body=None, headers=None):
            out = [apps[ref, role].request(method, path, body, headers)
                   for ref in (True, False)]
            assert out[0][0] == out[1][0], (path, out)
            return out[1]

        auth = SlidingWindowOracle(RateLimitConfig(max_permits=10,
                                                   window_ms=60_000))
        burst = TokenBucketOracle(RateLimitConfig(
            max_permits=50, window_ms=60_000, refill_rate=10.0))

        def login(role, user, oracle=True):
            status, body = send(role, "POST", "/api/login",
                                {"username": user})
            if oracle:
                want = auth.try_acquire(user, 1, clock["t"]).allowed
                assert status == (200 if want else 429), (user, status)
            return status

        def batch(role, user, size):
            status, _ = send(role, "POST", "/api/batch", {"size": size},
                             {"X-User-ID": user})
            want = burst.try_acquire(user, size, clock["t"]).allowed
            assert status == (200 if want else 429), (user, size, status)

        users = [f"user{i}" for i in range(6)]
        for rnd in range(4):
            clock["t"] += 1_500
            for i, user in enumerate(users):
                for _ in range(1 + (i + rnd) % 3):
                    login("primary", user)
                batch("primary", user, 7 + 3 * i)
                status, _ = send("primary", "GET", "/api/data",
                                 headers={"X-User-ID": user})
                assert status == 200
        for ref in (True, False):
            assert ctl[ref, "primary"].call_ok("ship")["frames"] >= 1
        status, repl = send("primary", "GET", "/actuator/replication")
        assert repl["enabled"] and repl["role"] == "primary"
        assert repl["epoch"] == 1 and repl["errors"] == 0
        assert repl["journal"] == "host"
        status, repl = send("standby", "GET", "/actuator/replication")
        assert repl["role"] == "standby" and repl["applied_epoch"] == 1
        assert repl["consistent"] and not repl["promoted"]
        probes = [ctl[ref, "primary"].call_ok("probe") for ref in (1, 0)]
        assert probes[0] == probes[1]
        assert probes[1]["replication"]["link"] == "up"
        sprobes = [ctl[ref, "standby"].call_ok("probe") for ref in (1, 0)]
        for p in sprobes:
            p.pop("repl_rx_age_ms")
        assert sprobes[0] == sprobes[1] and sprobes[1]["last_epoch"] == 1
        # The loss wave: never shipped, it dies with the primary.
        rolled_back = copy.deepcopy(auth)
        clock["t"] += 100
        for user in users[:3]:
            for _ in range(2):
                login("primary", user)
        # The operator fences the primary: both packages refuse alike.
        for ref in (True, False):
            assert ctl[ref, "primary"].call_ok("fence", epoch=5)["epoch"] \
                == 5
            assert ctl[ref, "primary"].call("lease", epoch=6,
                                            ttl_ms=1000.0)["ok"] is False
        fenced = [send("primary", "POST", "/api/login",
                       {"username": user})[0] for user in users]
        raw = apps[False, "primary"].ctx.storage
        while hasattr(raw, "_inner"):
            raw = raw._inner
        with pytest.raises(FencedError):
            raw.acquire("sw", 2, "direct", 1)
        for ref in (True, False):
            ctl[ref, "primary"].call_ok("restore", epoch=5)
            ctl[ref, "primary"].call_ok("fence", epoch=6)
        status, body = send("standby", "POST",
                            "/actuator/replication/promote", {})
        assert status == 200 and body["promoted"] and \
            body["applied_epoch"] == 1
        status, _ = send("standby", "POST", "/actuator/replication/promote",
                         {})
        assert status == 409
        status, _ = send("primary", "POST", "/actuator/replication/promote",
                         {})
        assert status == 409
        auth = rolled_back
        clock["t"] += 200
        for user in users:
            for _ in range(5):
                login("standby", user)
            batch("standby", user, 12)
        # Through the HTTP stack a fenced storage's FencedError is a storage
        # failure: both packages fail open (ratelimiter.fail_open=true).
        assert fenced == [200] * len(users)
    finally:
        for client in locals().get("ctl", {}).values():
            client.close()
        for app in apps.values():
            app.close()
