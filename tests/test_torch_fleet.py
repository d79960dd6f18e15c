"""The fleet tier of the port against the reference's, on the CPU.

- ``fleet/executor.py``: every boot pathology of ``LocalExecutor`` is a
  typed ``SpawnError`` (``argv_prefix`` scripts), and a REAL port node
  (``hostproc --device cpu``) retires with rc 0 on stdin EOF and leaves
  its launch line;
- ``fleet/manager.py``: the same scripted probes (the fake control
  client below) through both packages' ``NodeManager``s give equal
  ``status()`` snapshots and equal transition sequences — lifecycle
  refusals, adopt refusals, the probe-fail streak, process exit,
  ``probe_all`` and the bare-probe fallback;
- ``fleet/autopilot.py``: ``witness_wrap`` and the re-seed deadline,
  both packages step by step; the orchestrator's misconfiguration
  warnings alike; ``parse_ready`` / ``mux_handlers`` cases;
- the service: ``build_app(props, device="cpu")`` with
  ``ratelimiter.fleet.enabled`` beside the reference's app — ``GET
  /actuator/fleet`` and the health ``fleet`` block equal but for pids,
  ports and wall stamps, a drained or failed adopted node folding both
  to DEGRADED, and the controller election riding the manager's tick;
- ROADMAP C15: the reference's probe (``TpuBatchedStorage.is_available``
  → ``engine.block_until_ready``) waits for the engine lock a step
  holds, the port's does not;
- the two drills on CPU nodes, with every claim of the reference's
  tests, and the partitioned drill's counts equal to the reference's.

Children are launched with standard streams of their own (the
executor's pipes and stderr file, ``hostproc.NodeProcess``), stopped by
stdin EOF and killed by their own pid.  Sockets are loopback port 0.
"""

import http.client
import json
import socket as socket_mod
import sys
import threading
import time
import types

import pytest
import torch

import ratelimiter_tpu.fleet as ref_fleet
import ratelimiter_tpu_torch.fleet as port_fleet
from ratelimiter_tpu.fleet import autopilot as ref_autopilot
from ratelimiter_tpu.replication import control as ref_control
from ratelimiter_tpu.replication import orchestrator as ref_orch
from ratelimiter_tpu.replication import remote as ref_remote
from ratelimiter_tpu.service import app as ref_app
from ratelimiter_tpu.service.props import AppProperties as RefProps
from ratelimiter_tpu.service.wiring import build_app as ref_build_app
from ratelimiter_tpu_torch.fleet import autopilot as port_autopilot
from ratelimiter_tpu_torch.replication import control as port_control
from ratelimiter_tpu_torch.replication import orchestrator as port_orch
from ratelimiter_tpu_torch.replication import remote as port_remote
from ratelimiter_tpu_torch.replication.hostproc import NodeProcess
from ratelimiter_tpu_torch.service import app as port_app
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.service.wiring import build_app
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
)

torch.set_num_threads(1)

REF = types.SimpleNamespace(name="ref", fleet=ref_fleet,
                            autopilot=ref_autopilot, control=ref_control,
                            orch=ref_orch, remote=ref_remote)
PORT = types.SimpleNamespace(name="port", fleet=port_fleet,
                             autopilot=port_autopilot,
                             control=port_control, orch=port_orch,
                             remote=port_remote)
PACKAGES = (REF, PORT)

BOOT_S = 120.0  # a torch import on a loaded host


class _Recorder:
    """Flight-recorder stub: captures (kind, fields) tuples."""

    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append((kind, dict(fields)))

    def kinds(self):
        return [k for k, _ in self.events]


class _Ctl:
    """ControlClient stub with a scripted probe answer."""

    def __init__(self, answer="ok", shards=1):
        self.answer = answer
        self.shards = shards
        self.closed = False
        self.calls = []

    def try_call(self, op, timeout=None, **kw):
        self.calls.append(op)
        if self.answer == "dead":
            return None
        if op == "probe_all":
            if self.answer == "bare":
                return None  # pre-fleet node: no mux, fall back
            return {"ok": True, "shards": {
                str(q): {"ok": True, "available": True}
                for q in range(self.shards)}}
        if op == "probe":
            return {"ok": True, "available": True}
        return None

    def close(self):
        self.closed = True


class _DeadExecutor:
    """Executor whose processes are never alive (exit-detection path)."""

    def alive(self, handle):
        return False

    def terminate(self, handle, grace_s=10.0):
        pass

    def kill(self, handle):
        pass


_READY = {"ready": True, "role": "primary", "control_port": 7001}


def _manager(pkg, clock, **kw):
    kw.setdefault("recorder", _Recorder())
    return pkg.fleet.NodeManager(executor=kw.pop("executor",
                                                 _DeadExecutor()),
                                 clock=lambda: clock["t"], **kw)


def _status(mgr):
    """``status()`` without the wall stamps (``since_ms``)."""
    st = mgr.status()
    for node in st["nodes"].values():
        node.pop("since_ms")
    return st


def _raises(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as exc:
        return f"ValueError: {exc}"
    return None


# ---------------------------------------------------------------------------
# parse_ready / mux_handlers: the fleet's cases, both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line", [
    {"ready": True, "role": "primary", "control_port": 1, "lids": [3, 4]},
    {"ready": True, "role": "primary", "control_port": 1, "lids": [3, 4],
     "lid_base": 1},
    {"ready": True, "role": "standby", "control_port": 1, "shards": 2,
     "lids": [[5, 6], [5, 6]], "lid_base": 5},
    {"ready": True, "role": "primary", "control_port": 1, "lids": [1, 2],
     "lid_base": 1},
    {"role": "primary", "control_port": 1},
    {"ready": True, "role": "primary"},
    {"ready": True, "role": "witness", "control_port": 1},
    "ready",
])
def test_parse_ready_fleet_cases_alike(line):
    out = []
    for pkg in PACKAGES:
        try:
            out.append(pkg.remote.parse_ready(json.loads(json.dumps(line))))
        except ValueError as exc:
            out.append(f"ValueError: {exc}")
    assert out[1] == out[0]
    if isinstance(out[1], dict):
        assert out[1]["shards"] in (1, 2) and "version" in out[1]


def _mux_script(pkg):
    handlers = pkg.control.mux_handlers({
        0: {"probe": lambda: {"available": True},
            "poke": lambda x: {"shard": 0, "x": x}},
        1: {"probe": lambda: {"available": False}},
        2: {"probe": lambda: (_ for _ in ()).throw(RuntimeError("boom"))},
    }, extra={"version": lambda: {"v": "v1"}})
    out = [handlers["poke"](x=9), handlers["probe_all"](),
           handlers["version"]()]
    for kw in ({"shard": 7}, {"shard": 1, "x": 1}):
        op = "probe" if "x" not in kw else "poke"
        try:
            handlers[op](**kw)
        except ValueError as exc:
            out.append(str(exc))
    return out


def test_mux_dispatch_and_probe_all_alike():
    ref, port = (_mux_script(pkg) for pkg in PACKAGES)
    assert port == ref
    assert port[1]["shards"]["2"]["ok"] is False
    assert "boom" in port[1]["shards"]["2"]["error"]


# ---------------------------------------------------------------------------
# LocalExecutor: boot pathologies, a real node's stdin-EOF retirement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script,timeout,match", [
    ("import time; time.sleep(60)", 0.5, "no ready line within"),
    ("raise SystemExit(3)", 30.0, "before printing a ready line"),
    ("print('not json', flush=True); import time; time.sleep(60)", 30.0,
     "malformed ready line"),
    ("print('[1, 2]', flush=True); import time; time.sleep(60)", 30.0,
     "not a JSON object"),
])
def test_boot_pathologies_are_spawn_errors(script, timeout, match):
    ex = port_fleet.LocalExecutor(argv_prefix=[sys.executable, "-c", script],
                                  boot_timeout_s=timeout)
    with pytest.raises(port_fleet.SpawnError, match=match):
        ex.spawn([])


def test_default_argv_is_the_port_node_on_the_card():
    ex = port_fleet.LocalExecutor()
    assert ex.argv_prefix[1:] == [
        "-m", "ratelimiter_tpu_torch.replication.hostproc",
        "--device", "cuda"]
    assert port_fleet.LocalExecutor(device="cpu").argv_prefix[-1] == "cpu"


def test_a_node_without_a_card_is_a_spawn_error():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the node would boot on it")
    ex = port_fleet.LocalExecutor(boot_timeout_s=BOOT_S)
    with pytest.raises(port_fleet.SpawnError, match="before printing"):
        ex.spawn(["--role", "standby", "--num-slots", "128"])


def test_port_node_honors_stdin_eof():
    """A real standby node spawned through the manager retires with a
    clean rc 0 on stdin EOF and leaves its launch-count line."""
    mgr = port_fleet.NodeManager(
        executor=port_fleet.LocalExecutor(device="cpu",
                                          boot_timeout_s=BOOT_S),
        probe_interval_ms=60_000.0, recorder=_Recorder())
    try:
        node = mgr.spawn("n", "standby", shards=1, num_slots=128,
                         version="v3")
        assert node.state == port_fleet.READY and node.role == "standby"
        assert node.version == "v3" and node.boot_s > 0
        mgr.tick()
        assert list(node.last_probe) == ["0"]
        mgr.retire("n", grace_s=30.0)
        assert node.state == port_fleet.RETIRED
        assert node.handle.proc.returncode == 0, (
            "hostproc ignored stdin EOF (escalated to terminate/kill)")
        assert node.handle.launch_counts is not None
        assert set(node.handle.launch_counts) >= {"solver",
                                                  "block_scatter"}
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# NodeManager: the same scripted probes through both packages
# ---------------------------------------------------------------------------

def _lifecycle(pkg, clock, rec):
    f = pkg.fleet
    mgr = _manager(pkg, clock, recorder=rec)
    out = []
    node = mgr.adopt("a", dict(_READY), ctl=_Ctl())
    out.append(_status(mgr))
    clock["t"] += 1.5
    mgr.mark_serving("a")
    clock["t"] += 0.25
    mgr.mark_draining("a")
    out += [_status(mgr), mgr.degraded_nodes(), mgr.live_nodes()]
    out.append(_raises(mgr.mark_serving, "a"))
    mgr.retire("a")
    out += [_status(mgr), node.ctl.closed]
    out.append(_raises(mgr.mark_draining, "a"))
    mgr.retire("a")  # terminal retire is idempotent
    assert node.state == f.RETIRED
    return out


def _adopt_refusals(pkg, clock, rec):
    mgr = _manager(pkg, clock, recorder=rec)
    mgr.adopt("a", dict(_READY), ctl=_Ctl())
    out = [_raises(mgr.adopt, "a", {"ready": True, "role": "primary",
                                    "control_port": 7002}, ctl=_Ctl()),
           _raises(mgr.adopt, "b", dict(_READY), ctl=_Ctl())]
    # A FAILED node releases its endpoint: the replacement can re-bind.
    mgr.fail("a")
    mgr.adopt("b", dict(_READY), ctl=_Ctl())
    out += [mgr.live_nodes(), _status(mgr)]
    return out


def _probe_fail_streak(pkg, clock, rec):
    mgr = _manager(pkg, clock, recorder=rec, probe_fail_threshold=3)
    ctl = _Ctl(answer="dead")
    node = mgr.adopt("a", dict(_READY), ctl=ctl)
    out = []
    for _ in range(4):  # the fourth tick leaves the terminal node alone
        clock["t"] += 0.5
        mgr.tick()
        out += [_status(mgr), ctl.closed, list(ctl.calls)]
    assert node.state == pkg.fleet.FAILED
    assert "3 consecutive probe failures" in node.last_error
    out.append(mgr.degraded_nodes())
    return out


def _process_exit(pkg, clock, rec):
    mgr = _manager(pkg, clock, recorder=rec)
    node = mgr.adopt("a", dict(_READY), ctl=_Ctl(), handle=object())
    mgr.tick()
    assert node.state == pkg.fleet.FAILED
    return [_status(mgr), node.last_error]


def _probe_all_fallback(pkg, clock, rec):
    mgr = _manager(pkg, clock, recorder=rec)
    muxed = mgr.adopt("m", {"ready": True, "role": "primary",
                            "control_port": 7001, "shards": 2},
                      ctl=_Ctl(shards=2))
    bare = mgr.adopt("b", {"ready": True, "role": "primary",
                           "control_port": 7002}, ctl=_Ctl(answer="bare"))
    clock["t"] += 0.125
    mgr.tick()
    clock["t"] += 0.5
    assert sorted(muxed.last_probe) == ["0", "1"]
    assert list(bare.last_probe) == ["0"]  # pre-fleet single-shard shape
    assert bare.ctl.calls == ["probe_all", "probe"]
    return [_status(mgr), muxed.last_probe, bare.last_probe,
            bare.ctl.calls, muxed.ctl.calls]


@pytest.mark.parametrize("scenario", [
    _lifecycle, _adopt_refusals, _probe_fail_streak, _process_exit,
    _probe_all_fallback])
def test_manager_scripted_probes_match_reference(scenario):
    outs, events = [], []
    for pkg in PACKAGES:
        rec = _Recorder()
        outs.append(scenario(pkg, {"t": 100.0}, rec))
        events.append(rec.events)
    assert outs[1] == outs[0]
    assert events[1] == events[0]
    assert any(k == "fleet.transition" for k, _ in events[1]) or \
        scenario is _probe_all_fallback


def test_manager_meters_alike():
    from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
    from ratelimiter_tpu_torch.metrics import MeterRegistry

    snaps = []
    for pkg, reg in ((REF, RefRegistry()), (PORT, MeterRegistry())):
        mgr = _manager(pkg, {"t": 0.0}, registry=reg)
        mgr.adopt("a", dict(_READY), ctl=_Ctl())
        mgr.adopt("b", {"ready": True, "role": "standby",
                        "control_port": 7002}, ctl=_Ctl())
        mgr.fail("b")
        mgr.note_reseed()
        mgr.note_upgrade_step()
        mgr.note_upgrade_step()
        snaps.append({name: reg.gauge(name).value() if "nodes" in name
                      else reg.counter(name).count()
                      for name in ("ratelimiter.fleet.nodes",
                                   "ratelimiter.fleet.reseeds",
                                   "ratelimiter.fleet.upgrade_steps",
                                   "ratelimiter.fleet.respawns")})
    assert snaps[1] == snaps[0]
    assert snaps[1]["ratelimiter.fleet.nodes"] == 1.0


# ---------------------------------------------------------------------------
# FleetAutopilot: drain-aware witness, the re-seed deadline
# ---------------------------------------------------------------------------

def _autopilot(pkg, mgr, standby_set, clock, **kw):
    orch = kw.pop("orch", types.SimpleNamespace(
        router=types.SimpleNamespace(serving=lambda q: object()),
        cfg=types.SimpleNamespace(fence_lease_ttl_ms=0.0)))
    return pkg.fleet.FleetAutopilot(mgr, orch, standby_set, witness_ctls={},
                                    recorder=kw.pop("recorder", _Recorder()),
                                    clock=lambda: clock["t"], **kw)


def test_witness_wrap_folds_draining_to_dead_alike():
    out = []
    for pkg in PACKAGES:
        mgr = types.SimpleNamespace(
            nodes={"P": types.SimpleNamespace(state=pkg.fleet.DRAINING)})
        standby_set = types.SimpleNamespace(n_shards=2, receivers=[])
        pilot = _autopilot(pkg, mgr, standby_set, {"t": 0.0})
        pilot.bind(0, ("P", 0), ("S", 0))
        witness = pilot.witness_wrap(lambda q: "alive")
        seen = [witness(0), witness(1)]
        mgr.nodes["P"].state = pkg.fleet.SERVING
        seen.append(witness(0))
        out.append(seen)
    assert out[1] == out[0] == ["dead", "alive", "alive"]


def _reseed_deadline(pkg):
    class _Mgr:
        nodes = {}

        def mark_serving(self, name):
            pass

        def spawn(self, *a, **kw):
            raise RuntimeError("no capacity")

    rx = types.SimpleNamespace(promoted=True, consistent=False)
    standby_set = types.SimpleNamespace(n_shards=1, receivers=[rx])
    clock = {"t": 0.0}
    rec = _Recorder()
    pilot = _autopilot(pkg, _Mgr(), standby_set, clock, recorder=rec,
                       reseed_deadline_s=5.0)
    pilot.bind(0, ("P", 0), ("S", 0))
    out = []
    pilot.tick()
    job = dict(pilot._jobs[0])
    assert job.pop("backend") is not None  # the serving side resolved
    out += [pilot.status(), job, pilot.serving_placement(0)]
    clock["t"] = 6.0
    pilot.tick()  # past the deadline: loud failure, job slot released
    out += [dict(pilot._jobs), list(pilot.failed_jobs), pilot.status()]
    pilot.tick()  # the standby is still consumed: a fresh job reopens
    out += [pilot.status(), rec.events]
    return out


def test_reseed_deadline_fails_loudly_alike():
    ref, port = (_reseed_deadline(pkg) for pkg in PACKAGES)
    assert port == ref
    assert port[0]["jobs"]["0"]["state"] == "spawn"
    assert "RuntimeError: no capacity" in port[1]["error"]
    assert port[2] == ("S", 0)
    assert port[3] == {} and len(port[4]) == 1
    assert port[4][0]["q"] == 0 and "no capacity" in port[4][0]["error"]
    assert "fleet.reseed_deadline" in [k for k, _ in port[7]]
    assert port[6]["jobs"]["0"]["state"] == "spawn"


# ---------------------------------------------------------------------------
# Orchestrator timing validation (warn, never raise), both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw,kw,expect", [
    ({}, {"witness_fresh_ms": 100.0, "repl_heartbeat_ms": 100.0},
     "under the replication"),
    ({}, {"witness_fresh_ms": 900.0, "repl_heartbeat_ms": 100.0},
     "at or past the detection"),
    ({"fence_lease_ttl_ms": 800.0}, {}, "fence_lease_ttl_ms"),
    ({"fence_lease_ttl_ms": 2000.0},
     {"witness_fresh_ms": 400.0, "repl_heartbeat_ms": 100.0}, None),
])
def test_misconfiguration_warnings_alike(cfg_kw, kw, expect):
    problems = []
    for pkg in PACKAGES:
        rec = _Recorder()
        pkg.orch.FailoverOrchestrator(
            types.SimpleNamespace(n_shards=1), None, None,
            config=pkg.orch.OrchestratorConfig(
                probe_interval_ms=100.0, suspect_threshold=3,
                hysteresis_ms=500.0, **cfg_kw),
            recorder=rec, **kw)
        problems.append([f["problem"] for k, f in rec.events
                         if k == "orchestrator.misconfigured"])
    assert problems[1] == problems[0]
    if expect is None:
        assert problems[1] == []
    else:
        assert any(expect in p for p in problems[1])


# ---------------------------------------------------------------------------
# ROADMAP C15: a probe must not wait for the engine lock a step holds
# ---------------------------------------------------------------------------

def _returns_within(fn, seconds):
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("v", fn()),
                         daemon=True)
    t.start()
    t.join(seconds)
    return "v" in box, t


def test_probe_answers_while_a_step_holds_the_engine_lock():
    """The reference's ``is_available`` (``storage/tpu.py:3890``) calls
    ``engine.block_until_ready``, which takes the engine lock
    (``engine/engine.py:894-896``).  A step holds that lock for its
    whole dispatch, its first jit compile included (1.1-2.2 s on a
    freshly promoted CPU node), so the probe RPC waits that long; the
    orchestrator's one-thread tick then renews no shard's serving lease,
    the 1.2 s lease of a promoted replica runs out, and its next decision
    self-fences (``ST_ERROR`` in the rolling-upgrade drill).  The port's
    probe only synchronizes the device queue and answers at once."""
    from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    ref = TpuBatchedStorage(num_slots=128)
    port = GpuBatchedStorage(num_slots=128, device="cpu", host_parallel=0)
    try:
        for storage, blocks in ((ref, True), (port, False)):
            handlers = (ref_control if storage is ref
                        else port_control).primary_handlers(storage)
            held, release = threading.Event(), threading.Event()

            def hold(engine=storage.engine):
                with engine._lock:  # a step in flight
                    held.set()
                    release.wait(10.0)

            holder = threading.Thread(target=hold, daemon=True)
            holder.start()
            assert held.wait(5.0)
            try:
                done, t = _returns_within(handlers["probe"], 0.5)
                assert done is (not blocks), (storage, done)
            finally:
                release.set()
                holder.join(5.0)
            t.join(5.0)
            assert handlers["probe"]()["available"] is True
    finally:
        ref.close()
        port.close()


# ---------------------------------------------------------------------------
# ROADMAP C16: a silent control peer costs one deadline, not two
# ---------------------------------------------------------------------------

def test_a_silent_control_peer_fails_within_one_deadline():
    """A control call whose reused connection goes silent (a partition:
    no RST, no FIN) fails after its one deadline in the port; the
    reference's client retries it on a fresh connection and waits twice
    (``replication/control.py:ControlClient.call``).  The doubled wait is
    what let a partitioned primary's first relayed lease renewal land
    ~1.1 s after its last direct grant, past a 1.2 s lease once the
    keeper's poll was added (``chip_smoke.py`` phase 16 (a)).  A
    connection the peer closed is still retried at once in both."""
    from ratelimiter_tpu_torch.storage.chaos import FaultInjectingProxy

    deadline_s = 0.5
    server = port_control.ControlServer(
        {"probe": lambda: {"available": True}}).start()
    try:
        spent = []
        for pkg in PACKAGES:
            proxy = FaultInjectingProxy(server.port).start()
            client = pkg.control.ControlClient("127.0.0.1", proxy.port,
                                               timeout=deadline_s)
            try:
                assert client.call_ok("probe")["available"] is True
                proxy.partition()
                t0 = time.monotonic()
                with pytest.raises(pkg.control.ControlError):
                    client.call("probe")
                spent.append(time.monotonic() - t0)
                # Healed: the next call connects afresh (the failed call
                # dropped its socket).
                proxy.heal()
                assert client.call_ok("probe")["available"] is True
            finally:
                client.close()
                proxy.stop()
        ref_s, port_s = spent
        assert ref_s >= 2 * deadline_s * 0.95, ref_s
        assert deadline_s * 0.95 <= port_s < 1.8 * deadline_s, port_s
    finally:
        server.stop()

    # A connection that reads as closed is still retried once on a
    # fresh one, in both packages.
    server = port_control.ControlServer(
        {"probe": lambda: {"available": True}}).start()
    try:
        for pkg in PACKAGES:
            client = pkg.control.ControlClient("127.0.0.1", server.port,
                                               timeout=deadline_s)
            try:
                assert client.call_ok("probe")["available"] is True
                client._sock.shutdown(socket_mod.SHUT_RD)
                assert client.call_ok("probe")["available"] is True
            finally:
                client.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# The service: /actuator/fleet, the health fold, the election on the tick
# ---------------------------------------------------------------------------

_VOLATILE = ("since_ms", "in_state_ms", "probe_age_ms", "pid",
             "control_port")


def _scrub(doc):
    doc = json.loads(json.dumps(doc))
    for node in doc.get("nodes", {}).values():
        for key in _VOLATILE:
            node.pop(key, None)
    return doc


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _serve(make_server, ctx):
    srv = make_server(ctx, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_fleet_actuator_and_health_fold_match_reference():
    off = [build_app(AppProperties({"storage.backend": "memory"}),
                     device="cpu"),
           ref_build_app(RefProps({"storage.backend": "memory"}))]
    try:
        for ctx, app in zip(off, (port_app, ref_app)):
            assert ctx.fleet is None
            assert "fleet" not in app.health_payload(ctx)
    finally:
        for ctx in off:
            ctx.close()
    props = {"storage.backend": "memory",
             "ratelimiter.fleet.enabled": "true",
             "ratelimiter.fleet.probe_interval_ms": "60000"}
    node = NodeProcess(["--role", "primary", "--num-slots", "128",
                        "--limiters", json.dumps([{
                            "algo": "tb", "max_permits": 5,
                            "window_ms": 60000, "refill_rate": 1}])],
                       device="cpu", boot_timeout_s=BOOT_S)
    ctxs = [build_app(AppProperties(props), device="cpu"),
            ref_build_app(RefProps(props))]
    servers = []
    try:
        assert type(ctxs[0].fleet).__name__ == "NodeManager"
        assert ctxs[0].fleet.executor.argv_prefix[-1] == "cpu"
        servers = [_serve(port_app.make_server, ctxs[0]),
                   _serve(ref_app.make_server, ctxs[1])]
        ports = [s.server_address[1] for s in servers]

        def both(path):
            got = [_get(p, path) for p in ports]
            assert got[0][0] == got[1][0] == 200
            return [g[1] for g in got]

        for ctx in ctxs:
            ctx.fleet.adopt("n1", dict(node.info))
            ctx.fleet.tick()
        steps = []
        for action in (None, "draining", "failed"):
            for ctx in ctxs:
                if action == "draining":
                    ctx.fleet.mark_draining("n1")
                elif action == "failed":
                    ctx.fleet.fail("n1", "declared dead by test")
            fleet = [_scrub(b) for b in both("/actuator/fleet")]
            health = both("/actuator/health")
            assert fleet[0] == fleet[1]
            assert health[0]["fleet"] == health[1]["fleet"]
            assert health[0]["status"] == health[1]["status"]
            steps.append((fleet[0]["nodes"]["n1"]["state"],
                          health[0]["status"],
                          health[0]["fleet"]["degraded_nodes"]))
        assert fleet[0]["enabled"] is True
        assert steps == [("READY", "UP", []),
                         ("DRAINING", "DEGRADED", ["n1"]),
                         ("FAILED", "DEGRADED", ["n1"])]
    finally:
        for srv in servers:
            srv.shutdown()
        for ctx in ctxs:
            ctx.close()
        node.close()


def test_election_rides_the_fleet_tick():
    """With the fleet tier on, fleet control's election is attached to
    the node manager (no cadence thread of its own) and a manager tick
    seats the controller; without it the election runs its own thread,
    both packages alike."""
    node = NodeProcess(["--role", "primary", "--num-slots", "128"],
                       device="cpu", boot_timeout_s=BOOT_S)
    seen = []
    try:
        peer = f"127.0.0.1:{node.info['control_port']}"
        for fleet_on in (True, False):
            for name, build in (("port", lambda p: build_app(
                    AppProperties(p), device="cpu")),
                    ("ref", lambda p: ref_build_app(RefProps(p)))):
                props = {
                    "storage.backend": "memory",
                    "ratelimiter.control.enabled": "true",
                    "ratelimiter.control.interval_ms": "600000",
                    "ratelimiter.control.fleet.enabled": "true",
                    "ratelimiter.control.fleet.peers": peer,
                    "ratelimiter.control.fleet.node":
                        f"ctrl-{name}-{fleet_on}",
                    "ratelimiter.control.fleet.interval_ms": "600000",
                    "ratelimiter.fleet.probe_interval_ms": "600000",
                    "ratelimiter.fleet.enabled": str(fleet_on).lower()}
                ctx = build(props)
                try:
                    election = ctx.fleet_control.election
                    plane = ctx.fleet_control.plane
                    row = [name, fleet_on, election._thread is None]
                    if fleet_on:
                        row.append(ctx.fleet._autopilots == [election])
                        was = plane.is_leader
                        ctx.fleet.tick()
                        row += [was, plane.is_leader]
                    seen.append(row)
                finally:
                    ctx.close()
    finally:
        node.close()
    assert seen == [["port", True, True, True, False, True],
                    ["ref", True, True, True, False, True],
                    ["port", False, False], ["ref", False, False]]


# ---------------------------------------------------------------------------
# The drills on CPU nodes
# ---------------------------------------------------------------------------

def test_rolling_upgrade_drill_fast():
    """The reference test's claims, at its arguments.  The reference's
    own run does not reach its end on the CPU (ROADMAP C15), so nothing
    is compared with it here."""
    from ratelimiter_tpu_torch.storage.chaos import rolling_upgrade_drill

    report = rolling_upgrade_drill(device="cpu")
    assert report["mismatches"] == 0 and report["decisions"] > 0
    assert report["promotions"] == 4
    assert report["respawns"] == 4 and report["reseeds"] == 4
    assert report["upgrade_steps"] == 2
    # The mid-upgrade kill's fence was undeliverable: promotion waited
    # out the dead node's serving lease.
    assert report["kill_promote_s"] >= 0.6
    fleet = report["fleet"]
    live = [n for n in fleet["nodes"].values()
            if n["state"] in ("READY", "SERVING", "DRAINING")]
    assert live and all(n["version"] == "v2" for n in live)
    # N+1 on both shards: each shard served by one node, shadowed by a
    # fresh one, and no re-seed job failed or overran.
    auto = fleet["autopilot"][0]
    assert set(auto["serving"]) == set(auto["standby"]) == {"0", "1"}
    assert auto["failed"] == 0 and auto["jobs"] == {}
    assert all(s <= 90.0 for s in report["reseed_elapsed_s"])
    assert len(report["boot_s"]) == 7
    # Every node but the SIGKILLed one exited cleanly with its counts.
    lost = [n for n, c in report["launches"].items() if c is None]
    assert lost == ["S2"]


def test_partitioned_controller_drill_fast():
    from ratelimiter_tpu.storage.chaos import (
        partitioned_controller_drill as ref_drill,
    )
    from ratelimiter_tpu_torch.storage.chaos import (
        partitioned_controller_drill,
    )

    report = partitioned_controller_drill(device="cpu", pre_waves=2,
                                          storm_waves=2)
    assert report["mismatches"] == 0 and report["decisions"] > 0
    assert report["epochs"]["ctrl-b"] == report["epochs"]["ctrl-a"] + 1
    assert report["demote_reason"] == "lease_expired"
    assert report["stale_refused"] == 2
    assert report["goodput_ratio"] >= 0.8
    assert report["elections"] == 2
    assert report["detect_s"] <= 10.0
    assert report["demote_s"] <= report["detect_s"] <= report["converge_s"]
    assert all(c is not None for c in report["launches"].values())
    ref = ref_drill(pre_waves=2, storm_waves=2)
    # What the drill's script fixes.  The generations are not among it:
    # each counts the cut plus the well tenant's first actuation when its
    # waves still lie in the controller's 3 s usage window at the tick, a
    # question of the wall clock (ROADMAP C17; under load the reference's
    # nodes stall in their first storm waves).
    keys = ("decisions", "mismatches", "waves", "epochs", "demote_reason",
            "stale_refused", "stale_rejected_total", "pre_goodput",
            "storm_goodput", "goodput_ratio", "elections")
    assert {k: report[k] for k in keys} == {k: ref[k] for k in keys}
    for r in (report, ref):
        assert 1 <= r["cut_generation"] <= 2
        assert r["cut_generation"] < r["final_generation"] <= (
            r["cut_generation"] + 2)


@pytest.mark.parametrize("gap_ms,generation", [(1_000, 2), (4_000, 1)])
def test_drill_generations_follow_the_usage_window(gap_ms, generation):
    """ROADMAP C17, the partitioned-controller drill's tick in small, on
    both packages on one manual clock: the well tenant's wave (the drill's
    order-only bucket, registered with refill 1e-9, which the controller
    actuates as 1e-6) and then, ``gap_ms`` later, the storm tenant's.  One
    controller tick over the drill's 3 s window broadcasts the storm cut,
    and the well tenant's first actuation too only while its wave is
    inside the window: the generation is the gap's, not the script's."""
    from test_torch_adaptive_control import PKG, T0

    giant = 1 << 30
    gens = {}
    for name, pkg in PKG.items():
        clock = {"t": T0}
        st = pkg.storage(clock)
        try:
            well = st.register_limiter("tb", pkg.Config(
                max_permits=30, window_ms=giant, refill_rate=1e-9))
            storm = st.register_limiter("sw", pkg.Config(
                max_permits=18, window_ms=giant, enable_local_cache=False))
            ctl = pkg.controller(st, clock, interval_ms=50.0,
                                 window_ms=3000, target_excess=0.5,
                                 decrease_factor=0.5, floor_fraction=0.1,
                                 min_load_per_s=0.5)
            keys = [f"w:k{i % 12}" for i in range(40)]
            st.acquire_many("tb", [well] * 40, keys, [1, 1, 2, 3] * 10)
            clock["t"] += gap_ms
            st.acquire_many("sw", [storm] * 50, ["s:hot"] * 50, [1] * 50)
            ctl.tick()
            gens[name] = int(st.policy_info()["generation"])
            ctl.close()
        finally:
            st.close()
    assert gens == {"ref": generation, "port": generation}
