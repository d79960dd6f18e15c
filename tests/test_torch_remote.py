"""The cross-host adapters and the controller seat, port against the JAX
package: ``replication/remote.py``, ``control.py``'s ``ControllerSeat`` /
``controller_handlers``, the node's extra ops and ready line
(``replication/hostproc.py``), and the clock-skew hooks of
``storage/gpu.py``.

- ``ControllerSeat`` of both packages on one scripted sequence of claims
  and checks, on one simulated clock.
- ``controller_handlers`` over both packages' storages: the same claims,
  policy writes (stale epoch, stale generation, duplicate) and reads.
- A node's control port of either package (shard handlers + RETARGET /
  SHIP + the ``skew`` op behind ``mux_handlers``) driven over TCP by
  either package's ``ControlClient`` / ``RemoteBackend`` /
  ``RemoteReceiver`` / ``FanoutLeaseChannel`` / ``standby_witness``: all
  four pairings answer alike, and the op sets are equal.
- Both ``parse_ready`` on both packages' ready lines, refusals included;
  ``RemoteShardDirectory`` bookkeeping; the witness's verdicts; the
  lease keeper's relay; one storage pair under a clock skew.

Every storage pair pins ``host_parallel=0`` and one manual clock;
sockets are loopback on OS-chosen ports with client timeouts.
"""

import json
import types

import pytest
import torch

from ratelimiter_tpu import replication as ref_replication
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.replication import control as ref_control
from ratelimiter_tpu.replication import hostproc as ref_hostproc
from ratelimiter_tpu.replication import remote as ref_remote
from ratelimiter_tpu.storage import tpu as ref_tpu
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch import replication as port_replication
from ratelimiter_tpu_torch.replication import control as port_control
from ratelimiter_tpu_torch.replication import hostproc as port_hostproc
from ratelimiter_tpu_torch.replication import remote as port_remote
from ratelimiter_tpu_torch.storage import gpu as port_gpu
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_753_000_000_000


def _pkg(port: bool):
    return types.SimpleNamespace(
        port=port,
        replication=port_replication if port else ref_replication,
        control=port_control if port else ref_control,
        remote=port_remote if port else ref_remote,
        hostproc=port_hostproc if port else ref_hostproc,
        Config=RateLimitConfig if port else RefConfig)


REF, PORT = _pkg(False), _pkg(True)
PACKAGES = (REF, PORT)


def _storage(pkg, clock, num_slots=512, **kw):
    kw.setdefault("host_parallel", 0)
    if pkg.port:
        return GpuBatchedStorage(num_slots=num_slots, device="cpu",
                                 clock_ms=lambda: clock["t"], **kw)
    require_reference_native()
    return TpuBatchedStorage(num_slots=num_slots,
                             clock_ms=lambda: clock["t"], **kw)


def _limiters(pkg, storage):
    tb = storage.register_limiter("tb", pkg.Config(
        max_permits=5, window_ms=1000, refill_rate=2.0))
    sw = storage.register_limiter("sw", pkg.Config(
        max_permits=4, window_ms=1000))
    return tb, sw


def _scrub(obj):
    """Drop the fields that read a process's own monotonic clock (the
    seat's remaining TTL, the mailbox's deposit age, a witness age)."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()
                if k not in ("ttl_remaining_ms", "age_ms", "repl_rx_age_ms")
                or not isinstance(v, float)}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# ControllerSeat and controller_handlers
# ---------------------------------------------------------------------------

SEAT_SCRIPT = (
    ("claim", "a", 1, 1000.0), ("info",), ("check", 1), ("check", 0),
    ("claim", "b", 1, 1000.0), ("tick", 0.4), ("claim", "a", 1, 500.0),
    ("info",), ("tick", 0.6), ("info",), ("claim", "b", 1, 1000.0),
    ("claim", "b", 2, 2000.0), ("check", 1), ("check", 2), ("check", 3),
    ("claim", "a", 1, 1000.0), ("tick", 2.5), ("info",),
    ("claim", "c", 2, 100.0), ("claim", "b", 2, 100.0), ("info",),
)


def _run_seat(pkg):
    sim = {"s": 10.0}
    seat = pkg.control.ControllerSeat(clock=lambda: sim["s"])
    out = []
    for step in SEAT_SCRIPT:
        if step[0] == "claim":
            out.append(seat.claim(*step[1:]))
        elif step[0] == "check":
            out.append(seat.check(step[1]))
        elif step[0] == "tick":
            sim["s"] += step[1]
        else:
            out.append(seat.info())
    return out


def test_controller_seat_scripted_sequence():
    """One scripted claim / renew / supersede / stale-write sequence on a
    simulated clock: every answer of the port's seat equals the
    reference's, refusals and expiry included."""
    ref, port = _run_seat(REF), _run_seat(PORT)
    assert port == ref
    assert port[-1]["epoch"] == 2 and port[-1]["stale_rejected"] == 2


def _controller_script(pkg, clock):
    st = _storage(pkg, clock, observability=True)
    try:
        tb, sw = _limiters(pkg, st)
        for i in range(6):
            st.acquire("tb", tb, f"k{i % 3}", 1)
            st.acquire("sw", sw, f"k{i % 2}", 1)
        ops = pkg.control.controller_handlers(
            st, pkg.control.ControllerSeat(clock=lambda: 5.0))
        rows = {str(tb): {"algo": "tb", "max_permits": 5, "window_ms": 1000,
                          "refill_rate": 4.0, "gen": 1}}
        older = {str(tb): {"algo": "tb", "max_permits": 5, "window_ms": 1000,
                           "refill_rate": 3.0, "gen": 0}}
        drift = {str(sw): {"algo": "sw", "max_permits": 4, "window_ms": 999,
                           "refill_rate": 0.0, "gen": 5}}
        out = [
            sorted(ops),
            ops["controller_claim"]("n1", 2, 3000.0),
            ops["controller_claim"]("n0", 1),
            ops["set_policy"](rows, epoch=1, node="n0"),
            ops["set_policy"](rows, epoch=2, node="n1"),
            ops["set_policy"](rows, epoch=2, node="n1"),
            ops["set_policy"](older, epoch=2, node="n1"),
            ops["set_policy"](drift, epoch=3, node="n1"),
            ops["policy_info"](),
            ops["signals"](2000),
            ops["signals"](),
        ]
        out.append([bool(st.acquire("tb", tb, "fresh", 1)["allowed"])
                    for _ in range(7)])
        return json.loads(json.dumps(out))
    finally:
        st.close()


def test_controller_handlers_answer_alike():
    """``controller_handlers`` over a storage of each package: the claim
    and its refusal, a stale-epoch write refused untouched, a live policy
    update at a newer generation, a duplicate, an older generation and a
    shape drift refused in-protocol, ``policy_info`` with the seat and
    ``signals`` — equal answers, and the update decides alike."""
    ref = _controller_script(REF, {"t": T0})
    port = _controller_script(PORT, {"t": T0})
    assert port == ref
    assert port[3]["stale_epoch"] and not port[3]["applied"]
    assert port[4] == {"applied": True, "generation": 1}
    assert port[6]["stale_generation"] and port[7]["stale_generation"]


def test_role_handler_op_sets_equal():
    """A primary's and a standby's handler tables, and a node's mux
    with its node-wide ops, name the same ops in both packages."""
    clock = {"t": T0}
    sets = []
    for pkg in PACKAGES:
        st = _storage(pkg, clock)
        try:
            rx = pkg.replication.StandbyReceiver(st)
            args = types.SimpleNamespace(repl_interval_ms=100.0,
                                         ack_timeout_ms=1000.0)
            extra = pkg.hostproc._shard_extras(st, {"replicator": None},
                                               args)
            prim = pkg.control.primary_handlers(st, extra=extra)
            stby = pkg.control.standby_handlers(st, rx, extra=extra)
            mux = pkg.control.mux_handlers(
                {0: prim}, extra=pkg.hostproc._node_extras())
            sets.append((sorted(prim), sorted(stby), sorted(mux)))
        finally:
            st.close()
    assert sets[1] == sets[0]
    assert {"controller_claim", "set_policy", "policy_info",
            "signals"} <= set(sets[1][0]) & set(sets[1][1])
    assert {"skew", "probe_all", "retarget", "ship"} <= set(sets[1][2])


# ---------------------------------------------------------------------------
# Either package's client against either package's node, over TCP
# ---------------------------------------------------------------------------

class _Node:
    """A primary and a standby control port of one package, as a hostproc
    node builds them, over two storages on one manual clock."""

    def __init__(self, pkg, clock):
        self.pkg = pkg
        self.prim = _storage(pkg, clock)
        self.stby = _storage(pkg, clock)
        self.tb, self.sw = _limiters(pkg, self.prim)
        args = types.SimpleNamespace(repl_interval_ms=60_000.0,
                                     ack_timeout_ms=5000.0)
        self.box = {"replicator": None}
        self.rx = pkg.replication.StandbyReceiver(self.stby)
        self.repl_server = pkg.replication.ReplicationServer(
            self.rx, host="127.0.0.1").start()
        self.prim_ctl = pkg.control.ControlServer(pkg.control.mux_handlers(
            {0: pkg.control.primary_handlers(
                self.prim, extra=pkg.hostproc._shard_extras(
                    self.prim, self.box, args))},
            extra=pkg.hostproc._node_extras()),
            host="127.0.0.1").start()
        self.stby_ctl = pkg.control.ControlServer(pkg.control.mux_handlers(
            {0: pkg.control.standby_handlers(
                self.stby, self.rx, repl_server=self.repl_server,
                mailbox=pkg.control.LeaseMailbox(),
                on_promote=lambda: {"serve_port": 4242},
                extra=pkg.hostproc._shard_extras(
                    self.stby, {"replicator": None}, args,
                    allowed=lambda: self.rx.promoted))},
            extra=pkg.hostproc._node_extras()),
            host="127.0.0.1").start()

    def close(self):
        if self.box["replicator"] is not None:
            self.box["replicator"].close()
        self.prim_ctl.stop()
        self.stby_ctl.stop()
        self.repl_server.stop()
        self.prim.close()
        self.stby.close()


def _drive_node(cpkg, node, clock):
    """One scripted session of ``cpkg``'s client classes against
    ``node``; returns every answer, scrubbed of monotonic ages."""
    ControlClient = cpkg.control.ControlClient
    ctl = ControlClient("127.0.0.1", node.prim_ctl.port, timeout=10.0)
    sctl = ControlClient("127.0.0.1", node.stby_ctl.port, timeout=10.0)
    backend = cpkg.remote.RemoteBackend(ctl)
    rx = cpkg.remote.RemoteReceiver(sctl, cache_ttl_s=0.0)
    chan = cpkg.remote.FanoutLeaseChannel(backend, sctl, shard=0)
    witness = cpkg.remote.standby_witness({0: sctl, 1: (sctl, 0)},
                                          fresh_ms=60_000.0)
    out = []
    try:
        out.append(backend.probe())
        out.append([backend.is_available(), backend.fence_info(),
                    backend.serving_lease_info()])
        chan.grant(1, 500.0)
        chan.deposit(1, 500.0)
        out.append(sctl.call_ok("lease_fetch"))
        out.append(backend.serving_lease_info())
        out.append(backend.controller_claim("n1", 3, ttl_ms=2000.0))
        out.append(backend.controller_claim("n0", 2))
        rows = {str(node.tb): {"algo": "tb", "max_permits": 5,
                               "window_ms": 1000, "refill_rate": 3.0,
                               "gen": 1}}
        out.append(backend.set_policy_rows(rows, epoch=2, node="n0"))
        out.append(backend.set_policy_rows(rows, epoch=3, node="n1"))
        out.append(backend.policy_info())
        out.append(backend.signals(window_ms=1000))
        clock["t"] += 10
        out.append([bool(node.prim.acquire("tb", node.tb, f"k{i % 3}", 1)
                         ["allowed"]) for i in range(9)])
        out.append(ctl.call("skew"))
        out.append(ctl.call("skew", skew_ms=7))
        out.append(ctl.call("skew", skew_ms=0))
        out.append(ctl.call("nope"))
        out.append(ctl.call("probe", shard=3))
        out.append(sctl.call("retarget", host="127.0.0.1", port=1))
        moved = ctl.call_ok("retarget", host="127.0.0.1",
                            port=node.repl_server.port)
        assert moved.pop("target") == f"127.0.0.1:{node.repl_server.port}"
        out.append(moved)
        out.append(ctl.call_ok("ship"))
        out.append([rx.consistent, rx.promoted, rx.last_epoch])
        out.append([witness(0), witness(1), witness(2)])
        out.append(backend.fence(5))
        out.append(backend.probe())
        out.append(ctl.call("lease", epoch=6, ttl_ms=100.0))
        backend.lift_fence(5)
        out.append(backend.fence_info())
        promoted = rx.promote()
        out.append([promoted.label, rx.serve_port, rx.promote_info,
                    rx.promoted])
        with pytest.raises(RuntimeError, match="already promoted"):
            rx.promote()
        out.append(promoted.probe())
        out.append(promoted.grant_serving_lease(7, 1000.0))
        clock["t"] += 10
        out.append([bool(node.stby.acquire("tb", node.tb, f"k{i % 3}", 1)
                         ["allowed"]) for i in range(9)])
        out.append(cpkg.remote.RemoteBackend(
            ControlClient("127.0.0.1", node.stby_ctl.port, timeout=10.0),
            label="x", shard=0).label)
        return _scrub(json.loads(json.dumps(out)))
    finally:
        for c in (ctl, sctl):
            c.close()


@pytest.mark.parametrize("server", ["reference", "port"])
def test_clients_of_either_package_against_a_node(server):
    """Both packages' ``ControlClient`` / ``RemoteBackend`` /
    ``RemoteReceiver`` / ``FanoutLeaseChannel`` / ``standby_witness``
    drive one package's node control ports (probe, fence, lease, relay
    mailbox, controller seat, policy rows, signals, skew, refusals,
    RETARGET into the standby's listener, SHIP, the witness, remote
    promotion) and get the same answers; the port's node answers as the
    reference's node does."""
    answers = {}
    for cpkg in PACKAGES:
        for spkg in PACKAGES:
            if (server == "port") != spkg.port:
                continue
            clock = {"t": T0}
            node = _Node(spkg, clock)
            try:
                answers[cpkg.port] = _drive_node(cpkg, node, clock)
            finally:
                node.close()
    assert answers[True] == answers[False]
    if server == "port":
        # Held against the reference's node as well.
        clock = {"t": T0}
        node = _Node(REF, clock)
        try:
            assert _drive_node(PORT, node, clock) == answers[True]
        finally:
            node.close()
    a = answers[True]
    assert a[16] == {"ok": False, "error": "RuntimeError: retarget refused: "
                     "shard is an "
                     "unpromoted standby (re-seeding from a shadow would "
                     "fork authority)"}
    assert a[20] == ["alive", "alive", "unknown"]


# ---------------------------------------------------------------------------
# Ready lines, the directory, the witness, the keeper
# ---------------------------------------------------------------------------

def _ready_lines(pkg):
    class _Ctl:
        port = 7001

    one = types.SimpleNamespace(version="v3", shards=1)
    two = types.SimpleNamespace(version="v0", shards=2)
    return [
        pkg.hostproc._ready_line("primary", _Ctl, one, sidecar_ports=[7002],
                                 lids=[[1, 2]]),
        pkg.hostproc._ready_line("standby", _Ctl, one, repl_ports=[7003]),
        pkg.hostproc._ready_line("primary", _Ctl, two,
                                 sidecar_ports=[7004, 7005],
                                 lids=[[1, 2], [1]]),
        pkg.hostproc._ready_line("standby", _Ctl, two,
                                 repl_ports=[7006, 7007]),
    ]


BAD_LINES = [
    {"ready": False, "control_port": 1, "role": "primary"},
    {"ready": True, "role": "primary"},
    {"ready": True, "control_port": 1, "role": "edge"},
    {"ready": True, "control_port": 1, "role": "primary", "lids": [1, 2]},
    {"ready": True, "control_port": 1, "role": "primary", "lids": [2, 3],
     "lid_base": 1},
    "not a dict",
]


def test_parse_ready_reads_both_packages_lines():
    """Each package's node ready line has the same keys and values, and
    either package's ``parse_ready`` reads either line (and refuses the
    same malformed lines with the same message)."""
    ref_lines, port_lines = _ready_lines(REF), _ready_lines(PORT)
    assert port_lines == ref_lines
    for line in ref_lines + port_lines:
        parsed = [pkg.remote.parse_ready(json.loads(json.dumps(line)))
                  for pkg in PACKAGES]
        assert parsed[1] == parsed[0]
    assert ref_remote.parse_ready({"ready": True, "control_port": 1,
                                   "role": "standby"}) == \
        port_remote.parse_ready({"ready": True, "control_port": 1,
                                 "role": "standby"})
    for bad in BAD_LINES:
        errs = []
        for pkg in PACKAGES:
            with pytest.raises(ValueError) as info:
                pkg.remote.parse_ready(bad)
            errs.append(str(info.value))
        assert errs[1] == errs[0]
    for pkg in PACKAGES:
        class _Ctl:
            port = 1
        with pytest.raises(RuntimeError, match="lid base"):
            pkg.hostproc._ready_line(
                "primary", _Ctl, types.SimpleNamespace(version="v0",
                                                       shards=2),
                lids=[[1], [2]])


def _directory_script(pkg):
    class _B:
        def __init__(self, up):
            self.up = up

        def is_available(self):
            return self.up

        def close(self):
            pass

    primaries = {0: _B(True), 1: _B(True)}
    replacement = _B(True)
    d = pkg.remote.RemoteShardDirectory(primaries)
    out = [d.shard_health(), d.serving(0) is primaries[0], d.is_available()]
    d.fail_shard(1)
    out += [d.shard_health(), d.serving(1), d.degraded_shards()]
    d.install_replacement(1, replacement)
    out += [d.shard_health(), d.serving(1) is replacement,
            d.degraded_shards(), d.primary is primaries[0]]
    primaries[0].up = False
    out.append(d.is_available())
    d.repair_shard(1)
    out += [d.shard_health(), d.serving(1) is primaries[1],
            {q: s["state"] for q, s in d.shard_status().items()}]
    with pytest.raises(ValueError, match="dense"):
        pkg.remote.RemoteShardDirectory({1: _B(True)})
    sset = pkg.remote.RemoteStandbySet([_B(True), _B(True)])
    sset.replace(1, None, "rx")
    out += [sset.n_shards, sset.receivers[1]]
    d.close()
    return out


def test_remote_directory_bookkeeping_alike():
    """``RemoteShardDirectory`` / ``RemoteStandbySet`` through one scripted
    fail / install / repair sequence: equal health, serving backends and
    status states; the port's flight recorder logs the shard marks."""
    from ratelimiter_tpu_torch.observability import flight_recorder

    before = len(flight_recorder().events(kind="shard.failed")) \
        if hasattr(flight_recorder(), "events") else None
    assert _directory_script(PORT) == _directory_script(REF)
    if before is not None:
        assert len(flight_recorder().events(kind="shard.failed")) > before


class _ScriptedCtl:
    """A control client double answering ``probe`` from a script."""

    def __init__(self, answers):
        self.answers = list(answers)
        self.calls = 0

    def try_call(self, op, **kw):
        self.calls += 1
        return self.answers.pop(0) if self.answers else None


WITNESS_CASES = [
    [{"ok": True, "repl_rx_age_ms": 10.0}],
    [{"ok": True, "repl_rx_age_ms": 400.0}],
    [{"ok": True, "repl_rx_age_ms": 400.5}],
    [{"ok": True}],
    [None, {"ok": True, "repl_rx_age_ms": 5.0}],
    [None, None],
    [{"ok": False}, {"ok": False}],
]


def test_standby_witness_verdicts_alike():
    """The second witness's verdicts — fresh, stale at the edge, no age,
    one dropped poll retried, unreachable — are equal in both packages,
    for bare and (client, shard) entries."""
    for case in WITNESS_CASES:
        got = []
        for pkg in PACKAGES:
            ctls = {0: _ScriptedCtl(case), 1: (_ScriptedCtl(case), 2)}
            w = pkg.remote.standby_witness(ctls, fresh_ms=400.0)
            got.append((w(0), w(1), w(5), ctls[0].calls))
        assert got[1] == got[0], case


def test_lease_keeper_relay_alike():
    """The primary's lease keeper of each package over its storage and a
    mailbox of deposits: applied only while installed, only a deposit
    that extends the deadline, never a stale epoch."""
    results = []
    for pkg in PACKAGES:
        clock = {"t": T0}
        st = _storage(pkg, clock)
        box = pkg.control.LeaseMailbox()
        ctl = types.SimpleNamespace(
            try_call=lambda op, box=box, **kw: {"ok": True, **box.fetch()})
        keeper = pkg.hostproc.LeaseKeeper(st, ctl, slack_ms=25.0)
        out = []
        try:
            keeper._poll_once()                  # no lease yet
            st.grant_serving_lease(2, 300.0)
            keeper._poll_once()                  # nothing deposited
            box.deposit(epoch=2, ttl_ms=1000.0)
            keeper._poll_once()                  # extends
            out.append(st.serving_lease_info()["ttl_remaining_ms"] > 300)
            box.deposit(epoch=2, ttl_ms=100.0)
            keeper._poll_once()                  # would shorten: skipped
            box.deposit(epoch=1, ttl_ms=5000.0)
            keeper._poll_once()                  # stale epoch: refused
            clock["t"] += 5000
            out.append(st.serving_lease_info()["expired"])
            out += [keeper.fetches, keeper.applied,
                    st.serving_lease_info()["epoch"]]
        finally:
            st.close()
        results.append(out)
    assert results[1] == results[0]
    assert results[1][2:] == [4, 1, 2]


# ---------------------------------------------------------------------------
# Clock skew
# ---------------------------------------------------------------------------

def test_storage_pair_decides_alike_under_a_clock_skew():
    """Both modules' skew hooks on their default wall clocks: a storage of
    each package (no ``clock_ms``) decides alike as the skew steps the
    clock forward past a refill and a window, and back."""
    require_reference_native()
    old = (ref_tpu.clock_skew_ms(), port_gpu.clock_skew_ms())
    pair = [TpuBatchedStorage(num_slots=256, host_parallel=0),
            GpuBatchedStorage(num_slots=256, host_parallel=0, device="cpu")]
    try:
        lids = []
        for st, Config in zip(pair, (RefConfig, RateLimitConfig)):
            lids.append((
                st.register_limiter("tb", Config(
                    max_permits=4, window_ms=60_000, refill_rate=0.05)),
                st.register_limiter("sw", Config(
                    max_permits=3, window_ms=30_000))))

        def burst(n=6):
            return [[(bool(st.acquire("tb", tb, "k", 1)["allowed"]),
                      bool(st.acquire("sw", sw, "k", 1)["allowed"]))
                     for _ in range(n)]
                    for st, (tb, sw) in zip(pair, lids)]

        steps = []
        for skew in (0, 90_000, 90_000, 200_000, -50_000):
            prev = (ref_tpu.set_clock_skew_ms(skew),
                    port_gpu.set_clock_skew_ms(skew))
            assert prev[0] == prev[1]
            assert ref_tpu.clock_skew_ms() == port_gpu.clock_skew_ms() == skew
            wall = (ref_tpu._wall_clock_ms(), port_gpu._wall_clock_ms())
            assert abs(wall[0] - wall[1]) < 1000
            ref_got, port_got = burst()
            assert port_got == ref_got, skew
            steps.append(port_got)
        assert steps[0][:4] == [(True, True)] * 3 + [(True, False)]
        assert steps[1][0] == (True, True)   # +90 s refilled, new window
        assert steps[2][0] == (False, False)  # no further step
        assert steps[4][0] == (False, False)  # a step back adds nothing
    finally:
        ref_tpu.set_clock_skew_ms(old[0])
        port_gpu.set_clock_skew_ms(old[1])
        for st in pair:
            st.close()
