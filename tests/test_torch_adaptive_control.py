"""The port's adaptive control plane (``control/``) and its wiring against
the JAX package's, on the CPU.

Both packages get the same limiters, keys, permits, storage clock and
simulated controller clocks, and every step compares the controllers'
``status()``, the policy generations and the effective policies:

- the AIMD storm cut and recovery, the pinned lid, the global cap and its
  trigger on raw observed load, the lease tier's concurrency slots
  (``tests/test_control.py:203``, ``:250``, ``:281``, ``:318``, ``:351``);
- decisions across a controller's cuts on the micro route and the stream
  routes equal to an oracle rebuilt from the policy listener's rows and
  to the reference's (``tests/test_control.py:66``);
- ``_configs`` adopted through the storage, the shard failover router and
  the fleet plane;
- the fleet plane's election, supersession, own-clock self-demotion,
  anti-entropy, ``ControllerElection`` and the controller over the plane
  (``tests/test_fleet_control.py:164-400``), members being the in-process
  ``controller_handlers`` of either package;
- control across the packages over the control wire: either package's
  plane drives seats of both packages to one generation, and a stale
  epoch moves no row;
- ``build_app`` with ``ratelimiter.control.enabled`` and
  ``ratelimiter.control.fleet.enabled``: ``/actuator/policies``, the pin
  actuator, ``/actuator/controller``, the health ``control`` and
  ``controller`` blocks and the lagging fold; ``ratelimiter.fleet.enabled``
  still refused.

Controllers are ticked by hand; no test sleeps on a cadence thread.
Every socket wait is bounded.
"""

import functools
import socket

import numpy as np
import pytest
import torch

from ratelimiter_tpu import control as ref_control
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.leases import LeaseManager as RefLeaseManager
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.observability.flightrecorder import (
    FlightRecorder as RefRecorder,
)
from ratelimiter_tpu.replication import control as ref_rctl
from ratelimiter_tpu.replication.remote import RemoteBackend as RefRemote
from ratelimiter_tpu.service import app as ref_app
from ratelimiter_tpu.service import wiring as ref_wiring
from ratelimiter_tpu.service.props import AppProperties as RefProps
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch import control
from ratelimiter_tpu_torch.control.fleet import STALE_UNREACHABLE_MS
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.leases import LeaseManager
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.observability.flightrecorder import FlightRecorder
from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine
from ratelimiter_tpu_torch.replication import ShardFailoverRouter
from ratelimiter_tpu_torch.replication import control as rctl
from ratelimiter_tpu_torch.replication.remote import RemoteBackend
from ratelimiter_tpu_torch.semantics import (
    SlidingWindowOracle,
    TokenBucketOracle,
)
from ratelimiter_tpu_torch.service import app as port_app
from ratelimiter_tpu_torch.service import wiring
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from test_torch_control import App
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_700_000_000_000
PACKAGES = ("ref", "port")


# -- the two packages ---------------------------------------------------------
class Pkg:
    """One package's names, so a scenario is written once and run on both."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.Config = RefConfig if ref else RateLimitConfig
        self.ctl = ref_control if ref else control
        self.rctl = ref_rctl if ref else rctl
        self.Registry = RefRegistry if ref else MeterRegistry
        self.Recorder = RefRecorder if ref else FlightRecorder
        self.LeaseManager = RefLeaseManager if ref else LeaseManager
        self.Remote = RefRemote if ref else RemoteBackend

    def storage(self, clock, num_slots=512, **kw):
        kw.setdefault("max_delay_ms", 0.2)
        kw.setdefault("host_parallel", 0)
        if self.ref:
            require_reference_native()
            return TpuBatchedStorage(num_slots=num_slots,
                                     clock_ms=lambda: clock["t"], **kw)
        return GpuBatchedStorage(num_slots=num_slots,
                                 clock_ms=lambda: clock["t"], device="cpu",
                                 **kw)

    def controller(self, st, clock, registry=None, recorder=None, **cfg):
        cfg.setdefault("interval_ms", 1000.0)
        cfg.setdefault("window_ms", 2000)
        cfg.setdefault("min_load_per_s", 1.0)
        return self.ctl.AdaptivePolicyController(
            st, self.ctl.ControlConfig(**cfg), registry=registry,
            recorder=recorder, clock_ms=lambda: clock["t"])


PKG = {"ref": Pkg(True), "port": Pkg(False)}


def _drive(st, lid, key, demand):
    out = st.acquire_many("sw", [lid] * demand, [key] * demand,
                          [1] * demand)
    return int(out["allowed"].sum())


def _policies(st):
    """The storage's policy table, lid keys as ints."""
    info = st.policy_info()
    return {"generation": int(info["generation"]),
            "lids": {int(k): v for k, v in info["lids"].items()}}


def _same(pairs, what):
    """Assert both packages' values equal; return one."""
    assert pairs["ref"] == pairs["port"], (what, pairs)
    return pairs["port"]


def _events(recorder, kind):
    return [e for e in recorder.snapshot(last=256)["events"]
            if e["kind"] == kind]


# -- the AIMD controller (tests/test_control.py) --------------------------------
def test_aimd_storm_cut_and_recovery_matches_reference():
    """Storm -> multiplicative cut to the floor -> additive recovery to the
    ceiling on a simulated clock; status, generations and effective
    policies equal tick by tick; coalesced ``policy.adjusted`` events and
    the ``ratelimiter.control.*`` meters equal."""
    clock = {"t": T0}
    sts, ctls, regs, recs, lids = {}, {}, {}, {}, {}
    for name, pkg in PKG.items():
        sts[name] = pkg.storage(clock)
        regs[name] = pkg.Registry()
        recs[name] = pkg.Recorder(256)
        lids[name] = sts[name].register_limiter(
            "sw", pkg.Config(max_permits=100, window_ms=1000))
        ctls[name] = pkg.ctl.AdaptivePolicyController(
            sts[name], pkg.ctl.ControlConfig(
                interval_ms=1000.0, window_ms=2000, floor_fraction=0.1,
                decrease_factor=0.5, increase_fraction=0.1,
                min_load_per_s=1.0),
            registry=regs[name], recorder=recs[name],
            clock_ms=lambda: clock["t"])
    lid = _same(lids, "lid")
    try:
        fractions = []
        for sec in range(24):
            clock["t"] += 1000
            demand = 1000 if sec < 8 else 20   # storm, then normal load
            _same({n: _drive(sts[n], lid, "t", demand) for n in PKG},
                  ("admitted", sec))
            for c in ctls.values():
                c.tick()
            status = _same({n: ctls[n].status() for n in PKG},
                           ("status", sec))
            _same({n: _policies(sts[n]) for n in PKG}, ("policies", sec))
            fractions.append(status["lids"][str(lid)]["fraction"])
        assert min(fractions[:8]) == pytest.approx(0.1)
        assert fractions[-1] == pytest.approx(1.0)
        assert fractions[10] < fractions[14] < fractions[-1]
        assert 0 < status["adjustments"]
        assert status["generation"] == _policies(sts["port"])["generation"]
        assert status["lids"][str(lid)]["effective_max_permits"] == 100
        adjusted = _same({n: [{k: e[k] for k in (
            "lid", "verdict", "max_permits", "fraction", "global_scale",
            "generation", "n_coalesced")} for e in _events(
                recs[n], "policy.adjusted")] for n in PKG}, "events")
        assert 0 < len(adjusted) < status["adjustments"]
        meters = {n: regs[n].scrape() for n in PKG}
        for key in ("ratelimiter.control.adjustments",
                    "ratelimiter.control.generation",
                    "ratelimiter.control.global_scale",
                    "ratelimiter.control.pinned"):
            _same({n: meters[n].get(key) for n in PKG}, key)
        assert meters["port"]["ratelimiter.control.adjustments"] \
            == status["adjustments"]
    finally:
        for n in PKG:
            ctls[n].close()
            sts[n].close()


def test_pinned_lid_is_immune_to_the_loop_as_in_reference():
    clock = {"t": T0}
    sts, ctls = {}, {}
    for name, pkg in PKG.items():
        sts[name] = pkg.storage(clock)
        for _ in range(2):
            sts[name].register_limiter("sw", pkg.Config(max_permits=50,
                                                        window_ms=1000))
        ctls[name] = pkg.controller(sts[name], clock)
    lid_a, lid_b = 1, 2
    try:
        assert _same({n: ctls[n].pin(lid_b) for n in PKG}, "pin") == {
            "lid": lid_b, "pinned": True}
        for _ in range(4):
            clock["t"] += 1000
            for n in PKG:
                _drive(sts[n], lid_a, "a", 500)
                _drive(sts[n], lid_b, "b", 500)
                ctls[n].tick()
            s = _same({n: ctls[n].status() for n in PKG}, "status")
            _same({n: _policies(sts[n]) for n in PKG}, "policies")
        assert s["lids"][str(lid_a)]["fraction"] < 1.0
        assert s["lids"][str(lid_b)]["fraction"] == 1.0
        assert s["lids"][str(lid_b)]["state"] == "PINNED"
        assert s["pinned"] == [lid_b]
        info = _policies(sts["port"])["lids"][lid_b]
        assert info["generation"] == 0 and info["max_permits"] == 50
        clock["t"] += 1000
        for n in PKG:
            ctls[n].pin(lid_b, pinned=False)
            _drive(sts[n], lid_b, "b", 500)
            ctls[n].tick()
        s = _same({n: ctls[n].status() for n in PKG}, "unpinned")
        assert s["lids"][str(lid_b)]["fraction"] < 1.0
        for n in PKG:
            with pytest.raises(KeyError):
                ctls[n].pin(99)
    finally:
        for n in PKG:
            ctls[n].close()
            sts[n].close()


@pytest.mark.parametrize("case", ["every_tenant", "raw_observed_load"])
def test_global_cap_matches_reference(case):
    """``every_tenant``: three tenants at 240/s aggregate over a 120/s cap
    scale every effective rate, then load under the cap releases the
    scale.  ``raw_observed_load``: one tenant's 200/s storm denied to its
    limit of 30 still engages the cap, sized on the raw load."""
    clock = {"t": T0}
    sts, ctls, regs, recs = {}, {}, {}, {}
    per = 100 if case == "every_tenant" else 30
    tenants = 3 if case == "every_tenant" else 1
    for name, pkg in PKG.items():
        sts[name] = pkg.storage(clock)
        regs[name] = pkg.Registry()
        recs[name] = pkg.Recorder(64)
        for _ in range(tenants):
            sts[name].register_limiter("sw", pkg.Config(max_permits=per,
                                                        window_ms=1000))
        ctls[name] = pkg.controller(
            sts[name], clock, registry=regs[name], recorder=recs[name],
            global_cap_per_s=120.0, target_excess=0.99)
    lids = list(range(1, tenants + 1))
    try:
        for _ in range(3):
            clock["t"] += 1000
            admitted = _same({n: [
                _drive(sts[n], lid, f"k{i}", 80 if tenants > 1 else 200)
                for i, lid in enumerate(lids)] for n in PKG}, "admitted")
            for n in PKG:
                ctls[n].tick()
            s = _same({n: ctls[n].status() for n in PKG}, "status")
            _same({n: _policies(sts[n]) for n in PKG}, "policies")
        assert s["global_scale"] < 1.0 and s["global_cap_engagements"] > 0
        engaged = _same({n: [{k: e[k] for k in (
            "observed_per_s", "admitted_per_s", "scale")} for e in _events(
                recs[n], "control.global_cap_engaged")] for n in PKG},
            "events")
        assert engaged
        assert _same({n: regs[n].scrape()[
            "ratelimiter.control.global_scale"] for n in PKG}, "gauge") < 1
        if case == "every_tenant":
            for lid in lids:
                assert s["lids"][str(lid)]["effective_max_permits"] < 100
            for _ in range(6):
                clock["t"] += 1000
                for n in PKG:
                    _drive(sts[n], lids[0], "k0", 30)
                    ctls[n].tick()
                _same({n: ctls[n].status() for n in PKG}, "release")
            assert ctls["port"].status()["global_scale"] == 1.0
        else:
            assert admitted[0] <= 30
            assert s["global_scale"] == pytest.approx(120.0 / 200.0,
                                                      rel=0.2)
            assert engaged[-1]["observed_per_s"] > 120.0
            assert engaged[-1]["admitted_per_s"] < 120.0
    finally:
        for n in PKG:
            ctls[n].close()
            sts[n].close()


def test_concurrency_slots_bound_outstanding_lease_budget_as_in_reference():
    clock = {"t": T0}
    sts, mgrs, lids = {}, {}, {}
    for name, pkg in PKG.items():
        sts[name] = pkg.storage(clock)
        lids[name] = sts[name].register_limiter("tb", pkg.Config(
            max_permits=1000, window_ms=60_000, refill_rate=100.0))
        mgrs[name] = pkg.LeaseManager(sts[name], default_budget=8,
                                      max_budget=64, ttl_ms=60_000.0,
                                      clock_ms=lambda: clock["t"])
    lid = _same(lids, "lid")

    def both(fn):
        out = {}
        for n in PKG:
            g = fn(mgrs[n])
            out[n] = None if g is None else (g.granted, g.epoch)
        return _same(out, fn)

    try:
        for n in PKG:
            mgrs[n].set_concurrency_cap(lid, 16)
        assert both(lambda m: m.grant(lid, "worker-a", requested=8))[0] == 8
        assert both(lambda m: m.grant(lid, "worker-b", requested=8))[0] == 8
        assert both(lambda m: m.grant(lid, "worker-c", requested=8))[0] == 0
        assert _same({n: (mgrs[n].concurrency_refused_total,
                          mgrs[n].table.outstanding_budget_for("tb", lid))
                      for n in PKG}, "refused") == (1, 16)
        for n in PKG:
            mgrs[n].release(lid, "worker-a", used=8)
        assert both(lambda m: m.grant(lid, "worker-c", requested=8))[0] == 8
        assert both(lambda m: m.renew(lid, "worker-b", used=8,
                                      requested=8))[0] == 8
        for n in PKG:
            mgrs[n].set_concurrency_cap(lid, 8)
        assert both(lambda m: m.renew(lid, "worker-c", used=0,
                                      requested=8))[0] == 0
        assert all(mgrs[n].table.get("tb", lid, "worker-c") is None
                   for n in PKG)
        caps = _same({n: mgrs[n].status()["concurrency_caps"] for n in PKG},
                     "caps")
        assert caps == {lid: 8}
        _same({n: _policies(sts[n]) for n in PKG}, "policies")
    finally:
        for n in PKG:
            sts[n].close()


def test_decisions_across_controller_cuts_equal_oracle_and_reference():
    """A controller cuts and raises a sliding-window and a token-bucket
    tenant while micro bursts (``acquire_many``) and the stream routes
    (``acquire_stream_ids`` over int keys: the relay; ``acquire_stream_strs``
    over string keys) decide on both sides of every cut.  Each decision
    equals the reference's and an oracle rebuilt from the policy
    listener's rows, per-key state carried across the cuts."""
    clock = {"t": T0}
    sts, ctls, oracles = {}, {}, {}
    sw0 = dict(max_permits=8, window_ms=1000)
    tb0 = dict(max_permits=10, window_ms=1000, refill_rate=5.0)
    for name, pkg in PKG.items():
        st = sts[name] = pkg.storage(clock, num_slots=1024)
        st.register_limiter("sw", pkg.Config(**sw0))
        st.register_limiter("tb", pkg.Config(**tb0))
        ctls[name] = pkg.controller(st, clock, decrease_factor=0.5,
                                    increase_fraction=0.25)
    lid_sw, lid_tb = 1, 2
    orc = {lid_sw: SlidingWindowOracle(RateLimitConfig(**sw0)),
           lid_tb: TokenBucketOracle(RateLimitConfig(**tb0))}
    gens = []
    sts["port"].add_policy_listener(
        lambda lid, algo, cfg, gen: (orc[lid].reconfigure(cfg),
                                     gens.append((gen, lid,
                                                  cfg.max_permits))))
    rng = np.random.default_rng(7)
    str_keys = [f"u{i}" for i in range(256)]
    try:
        for step in range(14):
            clock["t"] += int(rng.choice([250, 400, 999, 1000]))
            now = clock["t"]
            storm = step < 5   # a few hot keys, then traffic spread thin
            hot = 2 if storm else 256
            ks = [str_keys[i] for i in rng.integers(0, hot, 48)]
            for lid, algo in ((lid_sw, "sw"), (lid_tb, "tb")):
                outs = {n: sts[n].acquire_many(algo, [lid] * 48, ks,
                                               [1] * 48) for n in PKG}
                want = [orc[lid].try_acquire(k, 1, now) for k in ks]
                got = _same({n: outs[n]["allowed"].tolist() for n in PKG},
                            ("micro", step, algo))
                assert got == [d.allowed for d in want], (step, algo)
            ids = rng.integers(0, 8 if storm else 4096,
                               512 if storm else 64).astype(np.int64)
            got = _same({n: np.asarray(sts[n].acquire_stream_ids(
                "tb", lid_tb, ids)).tolist() for n in PKG},
                ("relay", step))
            assert got == [orc[lid_tb].try_acquire(int(k), 1, now).allowed
                           for k in ids.tolist()], step
            sk = [str_keys[i] for i in rng.integers(0, hot, 256 if storm
                                                    else 16)]
            got = _same({n: np.asarray(sts[n].acquire_stream_strs(
                "sw", lid_sw, sk)).tolist() for n in PKG},
                ("strs", step))
            assert got == [orc[lid_sw].try_acquire(k, 1, now).allowed
                           for k in sk], step
            for n in PKG:
                ctls[n].tick()
            _same({n: ctls[n].status() for n in PKG}, ("status", step))
            _same({n: _policies(sts[n]) for n in PKG}, ("policies", step))
        assert len(gens) >= 4 and gens == sorted(gens)
        assert ctls["port"].status()["adjustments"] == len(gens)
        # Decisions crossed cuts and raises on both tenants.
        for lid in (lid_sw, lid_tb):
            seq = [mp for _, l, mp in gens if l == lid]
            assert any(b < a for a, b in zip(seq, seq[1:])) or seq[0] < 10
            assert any(b > a for a, b in zip(seq, seq[1:])), (lid, seq)
    finally:
        for n in PKG:
            ctls[n].close()
            sts[n].close()


# -- _configs adoption ----------------------------------------------------------
def test_controller_adopts_every_lid_through_storage_router_and_plane():
    """The controller finds its lids through the surface's ``_configs``: a
    surface without one would be adopted as empty and never act.  Over the
    port's storage, over its shard failover router (``__getattr__`` to the
    sharded primary) and over a fleet plane that converged from a member,
    every registered lid is adopted and cut by a storm."""
    clock = {"t": T0}
    flat = PKG["port"].storage(clock)
    engine = ShardedDeviceEngine(128, LimiterTable(device="cpu"),
                                 devices=["cpu"] * 2)
    router = ShardFailoverRouter(GpuBatchedStorage(
        engine=engine, clock_ms=lambda: clock["t"]))
    member = PKG["port"].storage(clock, num_slots=256)
    surfaces = {"storage": flat, "router": router, "member": member}
    specs = [("sw", dict(max_permits=20, window_ms=1000)),
             ("tb", dict(max_permits=30, window_ms=1000, refill_rate=5.0)),
             ("sw", dict(max_permits=50, window_ms=1000))]
    for st in surfaces.values():
        for algo, cfg in specs:
            st.register_limiter(algo, RateLimitConfig(**cfg))
    want = [str(lid) for lid in range(1, len(specs) + 1)]
    plane = control.FleetControlPlane(
        "ctrl-a", {"n0": TableBackend(rctl.controller_handlers(member))})
    assert plane.elect() and set(plane._configs) == {1, 2, 3}
    ctls = {name: PKG["port"].controller(st, clock) for name, st in (
        ("storage", flat), ("router", router), ("plane", plane))}
    try:
        for c in ctls.values():
            c.tick()
            assert sorted(c.status()["lids"]) == want
        clock["t"] += 1000
        for st in surfaces.values():
            for lid, (algo, _) in enumerate(specs, start=1):
                st.acquire_many(algo, [lid] * 200, ["hot"] * 200, [1] * 200)
        for name, c in ctls.items():
            c.tick()
            s = c.status()
            assert s["adjustments"] == len(specs), (name, s)
            assert all(s["lids"][l]["state"] == "CUTTING" for l in want)
        for st in surfaces.values():
            info = _policies(st)
            assert info["generation"] == len(specs)
            assert [info["lids"][l]["max_permits"] for l in (1, 2, 3)] \
                == [10, 15, 25]
    finally:
        for c in ctls.values():
            c.close()
        for st in surfaces.values():
            st.close()


# -- the fleet plane (tests/test_fleet_control.py) -----------------------------
class TableBackend:
    """An in-process member: the ``RemoteBackend`` duck over a node's
    ``controller_handlers`` table (no sockets)."""

    def __init__(self, table):
        self.table = table
        self.unreachable = False

    def _call(self, op, **kw):
        if self.unreachable:
            raise OSError("partitioned")
        return self.table[op](**kw)

    def controller_claim(self, node, epoch, ttl_ms=3000.0):
        return self._call("controller_claim", node=node, epoch=epoch,
                          ttl_ms=ttl_ms)

    def set_policy_rows(self, rows, epoch, node=""):
        return self._call("set_policy", rows=rows, epoch=epoch, node=node)

    def policy_info(self):
        return self._call("policy_info")

    def signals(self, window_ms=2000):
        return self._call("signals", window_ms=window_ms)

    def close(self):
        pass


class Cell:
    """One package's cell: ``n`` member storages with the same limiter,
    their seats and an in-process backend each."""

    def __init__(self, pkg: Pkg, clock, n=2, max_permits=40):
        self.pkg = pkg
        self.limiter = pkg.Config(max_permits=max_permits, window_ms=1000)
        self.storages, self.seats, self.members = [], [], {}
        for i in range(n):
            self.add(f"n{i}", clock)

    def add(self, name, clock, seat=None):
        st = self.pkg.storage(clock, num_slots=256)
        assert st.register_limiter("sw", self.limiter) == 1
        seat = seat if seat is not None else self.pkg.rctl.ControllerSeat()
        self.storages.append(st)
        self.seats.append(seat)
        backend = TableBackend(self.pkg.rctl.controller_handlers(st, seat))
        self.members[name] = backend
        return st, backend

    def plane(self, node="ctrl-a", members=None, mono=None, **kw):
        if mono is not None:
            kw["clock_ms"] = lambda: mono["t"]
        return self.pkg.ctl.FleetControlPlane(
            node, dict(members or self.members),
            limiters={1: ("sw", self.limiter)}, **kw)

    def rows(self):
        return [_policies(st) for st in self.storages]

    def close(self):
        for st in self.storages:
            st.close()


def _plane_view(plane):
    return {"epoch": plane.epoch, "is_leader": plane.is_leader,
            "generation": plane.generation,
            "last_broadcast_generation": plane.last_broadcast_generation,
            "node_generations": dict(plane.node_generations),
            "demote_reason": plane.demote_reason,
            "elections": plane.elections, "demotions": plane.demotions,
            "stale_refusals": plane.stale_refusals}


def test_plane_elects_broadcasts_supersedes_and_converges_as_in_reference():
    """``tests/test_fleet_control.py:164``, ``:191``, ``:203``, ``:275``:
    majority election and one-generation broadcast, no lead without a
    quorum, a superseded plane demoting and refusing to actuate while its
    forced stale-epoch frames move no row, and anti-entropy of a fresh
    member after a re-election."""
    clock = {"t": T0}
    cells = {n: Cell(PKG[n], clock) for n in PKG}
    lid = 1

    def step(fn, what):
        return _same({n: fn(n) for n in PKG}, what)

    try:
        planes = {n: cells[n].plane() for n in PKG}
        for n in PKG:
            with pytest.raises(PKG[n].ctl.NotLeader):
                planes[n].set_policy(lid, PKG[n].Config(max_permits=10,
                                                        window_ms=1000))
        assert step(lambda n: planes[n].elect(), "elect")
        assert step(lambda n: planes[n].set_policy(
            lid, PKG[n].Config(max_permits=10, window_ms=1000)), "gen") == 1
        view = step(lambda n: _plane_view(planes[n]), "view")
        assert view["node_generations"] == {"n0": 1, "n1": 1}
        rows = step(lambda n: cells[n].rows(), "rows")
        assert all(r["lids"][lid]["max_permits"] == 10 for r in rows)
        for n in PKG:
            with pytest.raises(KeyError):
                planes[n].set_policy(99, PKG[n].Config(max_permits=5,
                                                       window_ms=1000))
        # Supersession: a rival elects at epoch 2; the old leader demotes
        # at its next heartbeat and its forced frames die at the seats.
        rivals = {n: cells[n].plane(node="ctrl-new") for n in PKG}
        assert step(lambda n: (rivals[n].elect(), rivals[n].epoch),
                    "rival") == (True, 2)
        assert not step(lambda n: planes[n].maintain(), "maintain")
        assert step(lambda n: _plane_view(planes[n]),
                    "demoted")["demote_reason"] == "superseded"
        for n in PKG:
            with pytest.raises(PKG[n].ctl.NotLeader):
                planes[n].set_policy(lid, PKG[n].Config(max_permits=5,
                                                        window_ms=1000))
        row = {str(lid): {"algo": "sw", "max_permits": 5,
                          "window_ms": 1000, "refill_rate": 0.0, "gen": 9}}
        resps = step(lambda n: [m.set_policy_rows(row, 1, "ctrl-new")
                                for m in cells[n].members.values()], "zombie")
        assert all(r["stale_epoch"] and not r["applied"] for r in resps)
        assert all(r["lids"][lid]["max_permits"] == 10
                   for r in step(lambda n: cells[n].rows(), "rows"))
        assert step(lambda n: [s.info()["stale_rejected"]
                               for s in cells[n].seats], "seats") == [1, 1]
        assert step(lambda n: rivals[n].set_policy(
            lid, PKG[n].Config(max_permits=20, window_ms=1000)), "new") == 2
        # Anti-entropy: a re-seeded member at generation 0 joins; the
        # rival re-claims every seat at epoch 3 and converges it.
        for n in PKG:
            _, backend = cells[n].add("n2", clock)
            rivals[n].add_member("n2", backend)
        assert step(lambda n: (rivals[n].elect(), rivals[n].epoch),
                    "re-elect") == (True, 3)
        rows = step(lambda n: cells[n].rows(), "converged")
        assert [r["generation"] for r in rows] == [2, 2, 2]
        assert all(r["lids"][lid]["max_permits"] == 20 for r in rows)
        assert step(lambda n: rivals[n].converged(), "converged")
        status = step(lambda n: rivals[n].fleet_status(), "fleet_status")
        assert status["stale_rejected"] == 2 and status["epoch"] == 3
        # No majority: one reachable seat of three.
        for n in PKG:
            cells[n].members["n1"].unreachable = True
            cells[n].members["n2"].unreachable = True
        lone = {n: cells[n].plane(node="ctrl-lone") for n in PKG}
        assert not step(lambda n: lone[n].elect(), "no quorum")
        assert not step(lambda n: lone[n].is_leader, "not leader")
    finally:
        for c in cells.values():
            c.close()


def test_plane_own_clock_lease_expiry_and_election_failover_as_in_reference():
    """``tests/test_fleet_control.py:242`` and ``:298``: a plane whose
    renewals stop landing self-demotes once its own clock passes the TTL;
    the election ticks demote ``ctrl-a`` and seat ``ctrl-b`` at the next
    epoch, meters included; the healed zombie's writes die at the seats."""
    clock = {"t": T0}
    cells = {n: Cell(PKG[n], clock) for n in PKG}
    lid = 1

    def step(fn, what):
        return _same({n: fn(n) for n in PKG}, what)

    try:
        mono = {"t": 0.0}
        solo = {n: cells[n].plane(mono=mono, ttl_ms=500.0) for n in PKG}
        assert step(lambda n: solo[n].elect(), "elect")
        mono["t"] += 499.0
        assert step(lambda n: solo[n].self_check(), "fresh")
        for n in PKG:
            for m in cells[n].members.values():
                m.unreachable = True
        mono["t"] += 2.0
        assert not step(lambda n: solo[n].renew(), "renew")
        assert step(lambda n: solo[n].is_leader, "still")
        mono["t"] += 500.0
        assert not step(lambda n: solo[n].self_check(), "expired")
        assert step(lambda n: _plane_view(solo[n]),
                    "view")["demote_reason"] == "lease_expired"
        for n in PKG:
            with pytest.raises(PKG[n].ctl.NotLeader):
                solo[n].set_policy(lid, PKG[n].Config(max_permits=5,
                                                      window_ms=1000))
            for m in cells[n].members.values():
                m.unreachable = False

        # ControllerElection over fresh cells: ctrl-a leads, loses its
        # links, ctrl-b takes epoch 2 in the same repair pass.
        cells2 = {n: Cell(PKG[n], clock) for n in PKG}
        mono = {"t": 0.0}
        regs = {n: PKG[n].Registry() for n in PKG}
        planes, elections = {}, {}
        for n in PKG:
            a = cells2[n].plane(node="ctrl-a", mono=mono, ttl_ms=500.0)
            b = cells2[n].plane(node="ctrl-b", members={
                name: TableBackend(m.table)
                for name, m in cells2[n].members.items()})
            planes[n] = (a, b)
            elections[n] = PKG[n].ctl.ControllerElection(
                [a, b], registry=regs[n])
        try:
            for dt in (0.0, 400.0, 400.0):
                mono["t"] += dt
                for n in PKG:
                    elections[n].tick()
                assert step(lambda n: elections[n].leader().node,
                            "leader") == "ctrl-a"
            for n in PKG:
                for m in cells2[n].members.values():
                    m.unreachable = True
            mono["t"] += 600.0
            for n in PKG:
                elections[n].tick()
            st = step(lambda n: {k: v for k, v in elections[n].status()
                                 .items() if k != "converge_ms"}, "status")
            assert st["leader"] == "ctrl-b" and st["epoch"] == 2
            assert st["elections"] == 2
            assert st["candidates"][0]["demote_reason"] == "lease_expired"
            meters = step(lambda n: {k: v for k, v in regs[n].scrape().items()
                                     if k.startswith("ratelimiter.control")
                                     and k != "ratelimiter.control."
                                     "converge_ms"}, "meters")
            assert meters["ratelimiter.control.leader"] == 1.0
            assert meters["ratelimiter.control.elections"] == 2
            for n in PKG:
                assert regs[n].scrape()["ratelimiter.control.converge_ms"] \
                    >= 0.0
                for m in cells2[n].members.values():
                    m.unreachable = False
            row = {str(lid): {"algo": "sw", "max_permits": 5,
                              "window_ms": 1000, "refill_rate": 0.0,
                              "gen": 9}}
            assert step(lambda n: [m.set_policy_rows(row, 1, "ctrl-a")[
                "stale_epoch"] for m in cells2[n].members.values()],
                "zombie") == [True, True]
            for n in PKG:
                elections[n].tick()
            assert step(lambda n: regs[n].scrape()[
                "ratelimiter.control.stale_rejected"], "stale") == 0
            assert all(r["lids"][lid]["max_permits"] == 40 for r in
                       step(lambda n: cells2[n].rows(), "rows"))
            # note_join converges a newcomer whose seat granted the leader.
            for n in PKG:
                lead = elections[n].leader()
                lead.set_policy(lid, PKG[n].Config(max_permits=10,
                                                   window_ms=1000))
                seat = PKG[n].rctl.ControllerSeat()
                seat.claim(lead.node, lead.epoch)
                st_new = PKG[n].storage(clock, num_slots=256)
                st_new.register_limiter("sw", cells2[n].limiter)
                cells2[n].storages.append(st_new)
                elections[n].note_join("n2", TableBackend(
                    PKG[n].rctl.controller_handlers(st_new, seat)))
            rows = step(lambda n: cells2[n].rows(), "joined")
            assert rows[2]["generation"] == 1
            assert rows[2]["lids"][lid]["max_permits"] == 10
            assert step(lambda n: elections[n].leader().node_generations[
                "n2"], "n2") == 1
        finally:
            for n in PKG:
                elections[n].close()
                cells2[n].close()
    finally:
        for c in cells.values():
            c.close()


def test_controller_over_plane_cuts_fleet_wide_and_freezes_on_stale():
    """``tests/test_fleet_control.py:352`` and ``:375``: the controller
    over the plane cuts once for the whole cell at one generation; with a
    member unreachable the plane's staleness is infinite, raises freeze,
    cuts stay allowed, one coalesced ``control.signals_stale`` event."""
    clock = {"t": T0}
    cells = {n: Cell(PKG[n], clock) for n in PKG}
    lid = 1

    def step(fn, what):
        return _same({n: fn(n) for n in PKG}, what)

    ctls, recs = {}, {}
    try:
        for n in PKG:
            plane = cells[n].plane()
            assert plane.elect()
            recs[n] = PKG[n].Recorder(64)
            ctls[n] = PKG[n].ctl.AdaptivePolicyController(
                plane, PKG[n].ctl.ControlConfig(
                    interval_ms=1000.0, window_ms=2000, target_excess=0.5,
                    decrease_factor=0.5, staleness_bound_ms=10_000.0,
                    event_coalesce_ms=10_000.0, min_load_per_s=1.0),
                clock_ms=lambda: clock["t"], recorder=recs[n])
        clock["t"] += 1000
        for n in PKG:
            for st in cells[n].storages:
                _drive(st, lid, "hot", 300)
            ctls[n].tick()
        step(lambda n: ctls[n].status(), "status")
        rows = step(lambda n: cells[n].rows(), "cut")
        cut = rows[0]["lids"][lid]["max_permits"]
        assert cut < 40 and rows[0] == rows[1]
        clock["t"] += 5000
        for n in PKG:
            cells[n].members["n1"].unreachable = True
            plane = ctls[n].storage
            plane.telemetry.all_signals(2000)
            assert plane.telemetry.staleness_ms() == STALE_UNREACHABLE_MS
        for _ in range(3):
            clock["t"] += 1000
            for n in PKG:
                _drive(cells[n].storages[0], lid, "hot", 5)
                ctls[n].tick()
            step(lambda n: ctls[n].status(), "frozen")
        assert ctls["port"].signals_stale_ticks >= 3
        assert step(lambda n: cells[n].rows()[0]["lids"][lid][
            "max_permits"], "held") == cut
        clock["t"] += 1000
        for n in PKG:
            _drive(cells[n].storages[0], lid, "hot", 300)
            ctls[n].tick()
        step(lambda n: ctls[n].status(), "cut again")
        assert step(lambda n: cells[n].rows()[0]["lids"][lid][
            "max_permits"], "cut2") < cut
        assert step(lambda n: len(_events(recs[n], "control.signals_stale")),
                    "events") == 1
    finally:
        for n in PKG:
            if n in ctls:
                ctls[n].close()
            cells[n].close()


# -- control across the packages ------------------------------------------------
@pytest.mark.parametrize("plane_pkg", PACKAGES)
def test_plane_drives_the_other_package_over_the_wire(plane_pkg):
    """One package's plane drives a cell of two seats of the other package
    and one of its own, each behind a ``ControlServer`` of its package,
    through its own ``RemoteBackend`` / ``ControlClient``.  One broadcast
    leaves every seat at one generation with equal ``policy_info`` rows; a
    write stamped with a stale epoch is counted in ``stale_rejected`` and
    moves no row."""
    other = "ref" if plane_pkg == "port" else "port"
    me = PKG[plane_pkg]
    clock = {"t": T0}
    storages, servers, members = [], [], {}
    try:
        for i, pkg_name in enumerate((other, other, plane_pkg)):
            pkg = PKG[pkg_name]
            st = pkg.storage(clock, num_slots=256)
            st.register_limiter("sw", pkg.Config(max_permits=40,
                                                 window_ms=1000))
            st.register_limiter("tb", pkg.Config(max_permits=30,
                                                 window_ms=1000,
                                                 refill_rate=5.0))
            srv = pkg.rctl.ControlServer(pkg.rctl.controller_handlers(st),
                                         port=0).start()
            storages.append(st)
            servers.append(srv)
            members[f"{pkg_name}{i}"] = me.Remote(
                me.rctl.ControlClient("127.0.0.1", srv.port, timeout=5.0))
        plane = me.ctl.FleetControlPlane("ctrl-x", members)
        assert plane.elect() and plane.epoch == 1
        assert set(plane._configs) == {1, 2}
        gen = plane.set_policy(2, me.Config(max_permits=12, window_ms=1000,
                                            refill_rate=2.5))
        assert gen == 1 and set(plane.node_generations.values()) == {1}
        infos = [members[name].policy_info() for name in members]
        assert {i["generation"] for i in infos} == {1}
        rows = [{str(k): v for k, v in i["lids"].items()} for i in infos]
        assert rows[0] == rows[1] == rows[2]
        assert rows[0]["2"] == {"algo": "tb", "generation": 1,
                                "max_permits": 12, "window_ms": 1000,
                                "refill_rate": 2.5}
        # A rival takes epoch 2; the old epoch's frame moves nothing.
        rival = me.ctl.FleetControlPlane("ctrl-y", {
            name: me.Remote(me.rctl.ControlClient(
                "127.0.0.1", srv.port, timeout=5.0))
            for name, srv in zip(members, servers)})
        assert rival.elect() and rival.epoch == 2
        before = [_policies(st) for st in storages]
        stale = {"1": {"algo": "sw", "max_permits": 3, "window_ms": 1000,
                       "refill_rate": 0.0, "gen": 7}}
        for m in members.values():
            resp = m.set_policy_rows(stale, 1, "ctrl-x")
            assert resp["stale_epoch"] and not resp["applied"]
        assert [_policies(st) for st in storages] == before
        status = rival.fleet_status()
        assert status["stale_rejected"] == 3
        assert [v["stale_rejected"] for v in status["nodes"].values()] \
            == [1, 1, 1]
        with pytest.raises(me.ctl.NotLeader):
            plane.set_policy(1, me.Config(max_permits=3, window_ms=1000))
        assert plane.demote_reason == "superseded"
        assert rival.converge() == 1
        rival.close()
        plane.close()
    finally:
        for srv in servers:
            srv.stop()
        for st in storages:
            st.close()


# -- build_app ------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _boot(ref, props):
    if ref:
        return App(ref_wiring.build_app(RefProps(props)), ref_app)
    return App(wiring.build_app(AppProperties(props), device="cpu"),
               port_app)


def test_build_app_serves_the_controller_as_the_reference(monkeypatch):
    """``tests/test_control.py:547`` for both apps on one manual clock:
    ``/actuator/policies`` with the controller block, the pin actuator
    (404 on an unknown lid), the health ``control`` block; then fleet
    control over each app's own control port: ``/actuator/controller``,
    the health ``controller`` block, a storm cut broadcast at a new
    generation, and a member that missed it folding health to DEGRADED
    until it is converged.  ``ratelimiter.fleet.enabled`` still refuses
    to boot on the port."""
    clock = {"t": T0}
    now = lambda: clock["t"]  # noqa: E731
    monkeypatch.setattr(wiring, "GpuBatchedStorage",
                        functools.partial(GpuBatchedStorage, clock_ms=now,
                                          host_parallel=0))
    monkeypatch.setattr(ref_wiring, "TpuBatchedStorage",
                        functools.partial(TpuBatchedStorage, clock_ms=now,
                                          host_parallel=0))
    require_reference_native()
    base = {"storage.backend": "tpu", "storage.num_slots": "4096",
            "parallel.shard": "off", "warmup.enabled": "false",
            "link.probe.enabled": "false",
            "ratelimiter.control.enabled": "true",
            "ratelimiter.control.interval_ms": "600000"}
    apps = {}

    def send(method, path, body=None, headers=None, keep=()):
        out = {n: apps[n].request(method, path, body, headers) for n in PKG}
        for n in PKG:
            out[n][1].pop("pallas", None)
            for key in keep:
                out[n][1].pop(key, None)
        return _same(out, path)

    try:
        for n in PKG:
            apps[n] = _boot(n == "ref", base)
        assert send("GET", "/api/data", headers={"X-User-ID": "ctl"},
                    keep=("data",))[0] == 200
        for n in PKG:
            apps[n].ctx.controller.tick()
        status, body = send("GET", "/actuator/policies")
        assert status == 200 and body["enabled"]
        assert body["generation"] == 0
        lid = next(iter(body["controller"]["lids"]))
        assert body["controller"]["lids"][lid]["state"] in ("IDLE",
                                                            "STEADY")
        status, out = send("POST", f"/actuator/policies/{lid}/pin")
        assert status == 200 and out == {"lid": int(lid), "pinned": True}
        status, body = send("GET", "/actuator/policies")
        assert int(lid) in body["controller"]["pinned"]
        status, health = send("GET", "/actuator/health")
        assert health["control"] == {"generation": 0, "global_scale": 1.0,
                                     "pinned": [int(lid)], "adjustments": 0}
        assert "controller" not in health
        status, body = send("GET", "/actuator/controller")
        assert body == {"enabled": True, "fleet": False, "generation": 0,
                        "adjustments": 0, "signals_stale_ticks": 0}
        assert send("POST", f"/actuator/policies/{lid}/pin",
                    {"pinned": False})[1] == {"lid": int(lid),
                                              "pinned": False}
        assert send("POST", "/actuator/policies/12345/pin")[0] == 404
        for n in PKG:
            apps.pop(n).close()

        # Fleet control over each app's own control port.
        for n in PKG:
            apps[n] = _boot(n == "ref", {
                **base, "ratelimiter.control.port": str(_free_port()),
                "ratelimiter.control.fleet.enabled": "true",
                "ratelimiter.control.fleet.node": "ctrl-app",
                "ratelimiter.control.fleet.interval_ms": "600000"})
            fc = apps[n].ctx.fleet_control
            assert fc is not None
            assert apps[n].ctx.controller.storage is fc.plane
            fc.election.tick()
            assert fc.plane.is_leader and set(fc.plane._configs) == {
                1, 2, 3}
        status, health = send("GET", "/actuator/health", keep=("control",))
        assert health["status"] == "UP"
        assert health["controller"] == {
            "node": "ctrl-app", "is_leader": True, "epoch": 1,
            "last_broadcast_generation": 0, "lagging_nodes": []}
        status, body = send("GET", "/actuator/controller",
                            keep=("nodes", "election"))
        assert body["enabled"] and body["fleet"] and body["is_leader"]
        clock["t"] += 1000
        for _ in range(30):  # 20 of 30 denied: over target_excess
            send("POST", "/api/login", {"username": "storm"})
        fleets = {}
        for n in PKG:
            apps[n].ctx.controller.tick()
            fleets[n] = apps[n].ctx.fleet_control.plane
        gens = _same({n: fleets[n].last_broadcast_generation for n in PKG},
                     "broadcast")
        assert gens == 1
        info = send("GET", "/actuator/policies")[1]
        assert info["generation"] == 1
        cut = [v for v in info["lids"].values() if v["generation"] == 1]
        assert len(cut) == 1 and cut[0]["max_permits"] < 10
        # A member that joined at generation 0 and missed the broadcast
        # (its registrations as the apps made them).
        for n in PKG:
            lagger = apps[n].lagger = PKG[n].storage(clock, num_slots=256)
            for _, row in sorted(info["lids"].items(),
                                 key=lambda kv: int(kv[0])):
                base_permits = 10 if row["generation"] else \
                    row["max_permits"]
                lagger.register_limiter(row["algo"], PKG[n].Config(
                    max_permits=base_permits, window_ms=row["window_ms"],
                    refill_rate=row["refill_rate"]))
            fleets[n].node_generations["lagger"] = 0
            fleets[n].add_member("lagger", TableBackend(
                PKG[n].rctl.controller_handlers(lagger)))
        status, health = send("GET", "/actuator/health", keep=("control",))
        assert health["status"] == "DEGRADED"
        assert health["controller"]["lagging_nodes"] == ["lagger"]
        for n in PKG:
            fleets[n].elect()  # the new seat grants; converge lands gen 1
            assert _policies(apps[n].lagger)["generation"] == 1
        status, health = send("GET", "/actuator/health", keep=("control",))
        assert health["status"] == "UP"
        assert health["controller"]["lagging_nodes"] == []
        assert health["controller"]["epoch"] == 2
    finally:
        for app in apps.values():
            lagger = getattr(app, "lagger", None)
            app.close()
            if lagger is not None:
                lagger.close()
    with pytest.raises(NotImplementedError, match="A7 b"):
        wiring.build_app(AppProperties({"ratelimiter.fleet.enabled": "true",
                                        "storage.backend": "memory"}),
                         device="cpu")
    assert [key for key, _ in wiring.UNPORTED_TIERS] == [
        "ratelimiter.fleet.enabled"]
