"""The failover orchestrator, port against the JAX package:
``replication/orchestrator.py``'s state machine driven by one scripted
probe and witness sequence on a simulated clock, with the fakes of
``tests/test_cross_host.py`` (backend, router, receiver) and the cases
of ``tests/test_orchestrator.py`` that need no sharded engine.

Each case runs both packages' ``FailoverOrchestrator`` over their own
copies of the same fakes and compares the transition logs (every flight
event the machine records, with its fields) and ``status()`` (without
the wall-clock ``since_ms``): flap damping, a single blip, the witness
veto, fencing that waits out an unreachable zombie's lease, an unknown
witness, the spare fallback, exhausted candidates, unfence, the
re-seed of a fresh standby from a promoted storage of each package, the
timing warnings, and the default probe.
"""

import types

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.metrics.registry import MeterRegistry as RefRegistry
from ratelimiter_tpu.replication import orchestrator as ref_orch
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.metrics.registry import MeterRegistry
from ratelimiter_tpu_torch.replication import orchestrator as port_orch
from ratelimiter_tpu_torch.replication.log import engine_state_fingerprint
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_753_000_000_000
PACKAGES = (False, True)  # reference, port


class _Recorder:
    """Flight-recorder double: keeps every event in order."""

    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append((kind, fields))


class _FakeBackend:
    def __init__(self, fence_reachable=True):
        self.fence_reachable = fence_reachable
        self.fences = []
        self.grants = []
        self.lifts = []
        self.fence_rejected = 0

    def fence(self, epoch, shards=None):
        if not self.fence_reachable:
            raise ConnectionError("partitioned: fence undeliverable")
        self.fences.append((int(epoch), shards))
        return int(epoch)

    def grant_serving_lease(self, epoch, ttl_ms):
        self.grants.append((int(epoch), float(ttl_ms)))

    def is_available(self):
        return True

    def fence_info(self):
        epoch = self.fences[-1][0] if self.fences else 0
        shards = list(self.fences[-1][1] or []) if self.fences else []
        live = bool(self.fences) and len(self.lifts) < len(self.fences)
        return {"epoch": epoch, "all": False,
                "shards": shards if live else []}

    def lift_fence(self, epoch, shards=None):
        self.lifts.append((int(epoch), shards))


class _FakeRouter:
    def __init__(self, backend):
        self.n_shards = 1
        self.primary = backend
        self.replacements = {}
        self.failed = set()
        self.repairs = 0

    def shard_primary(self, q):
        return self.primary

    def shard_health(self):
        return {0: "failed" if 0 in self.failed
                else "promoted" if 0 in self.replacements else "active"}

    def fail_shard(self, q):
        self.failed.add(int(q))

    def install_replacement(self, q, backend):
        self.replacements[int(q)] = backend
        self.failed.discard(int(q))

    def repair_shard(self, q):
        self.failed.discard(int(q))
        self.replacements.pop(int(q), None)
        self.repairs += 1

    def _backend(self, q):
        if q in self.failed:
            return None
        return self.replacements.get(int(q), self.primary)


class _FakeReceiver:
    def __init__(self, consistent=True, fails=0):
        self.consistent = consistent
        self.promoted = False
        self.last_epoch = 7
        self.backend = _FakeBackend()
        self.fails = fails
        self.attempts = 0

    def promote(self, force=False):
        self.attempts += 1
        if self.attempts <= self.fails:
            raise RuntimeError(f"promote refused (attempt {self.attempts})")
        self.promoted = True
        return self.backend


def _fake_orch(mod, backend, witness=None, spares=None, rx=None,
               registry=None, standby_factory=None, replicator=None,
               **cfg_kw):
    rx = rx or _FakeReceiver()
    router = _FakeRouter(backend)
    replaced = []
    standby_set = types.SimpleNamespace(
        receivers=[rx], replace=lambda q, st, r: (
            replaced.append((q, st, r)),
            standby_set.receivers.__setitem__(q, r)))
    sim = {"s": 0.0}
    cfg_kw.setdefault("reseed", False)
    cfg = mod.OrchestratorConfig(probe_interval_ms=50.0, suspect_threshold=2,
                                 hysteresis_ms=100.0, promote_backoff_ms=1.0,
                                 **cfg_kw)
    probe_ok = {"v": True}
    rec = _Recorder()
    sleeps = []
    # An installed replacement answers probes (else the machine would
    # immediately re-suspect what it just promoted).
    orch = mod.FailoverOrchestrator(
        router, standby_set, replicator, config=cfg,
        standby_factory=standby_factory,
        probe=lambda q: probe_ok["v"] or bool(router.replacements),
        witness=witness, spares=spares, registry=registry, recorder=rec,
        lease_channels={0: types.SimpleNamespace(
            grant=backend.grant_serving_lease)},
        clock=lambda: sim["s"], sleep=sleeps.append)

    def tick(n=1):
        for _ in range(n):
            sim["s"] += cfg.probe_interval_ms / 1000.0
            orch.tick()

    return types.SimpleNamespace(orch=orch, router=router, rx=rx,
                                 probe_ok=probe_ok, tick=tick, sim=sim,
                                 rec=rec, sleeps=sleeps, replaced=replaced)


def _status(orch):
    st = orch.status()
    for shard in st["shards"].values():
        shard.pop("since_ms")
    return st


def _both(run):
    """``run(mod)`` for the reference's module and the port's; returns
    the port's result after checking it equals the reference's."""
    ref = run(ref_orch)
    port = run(port_orch)
    assert port == ref
    return port


def test_transient_fault_is_flap_damped():
    """Fail for exactly the suspect threshold, heal inside the hysteresis
    window: one false alarm, no fence, no promotion."""
    def run(mod):
        t = _fake_orch(mod, _FakeBackend())
        t.tick(3)
        t.probe_ok["v"] = False
        t.tick(2)
        mid = _status(t.orch)["shards"][0]["state"]
        t.probe_ok["v"] = True
        t.tick()
        return mid, _status(t.orch), t.rec.events, t.orch.fence_epoch

    mid, st, events, epoch = _both(run)
    assert mid == "SUSPECT" and st["shards"][0]["state"] == "MONITORING"
    assert st["false_alarms"] == 1 and st["promotions"] == 0 and epoch == 0
    assert [k for k, _ in events].count("orchestrator.false_alarm") == 1


def test_single_blip_never_reaches_suspect():
    def run(mod):
        t = _fake_orch(mod, _FakeBackend())
        t.probe_ok["v"] = False
        t.tick()
        t.probe_ok["v"] = True
        t.tick(3)
        return _status(t.orch), t.rec.events

    st, events = _both(run)
    assert st["shards"][0]["state"] == "MONITORING"
    assert st["false_alarms"] == 0 and events == []


def test_witness_veto_then_dead_verdict_promotes():
    """The standby still hears the primary: every hysteresis expiry is
    vetoed; once the witness reads dead the same probe verdict fences and
    promotes, and the replacement's lease epoch is past the zombie's."""
    def run(mod):
        backend = _FakeBackend()
        verdict = {"v": "alive"}
        t = _fake_orch(mod, backend, witness=lambda q: verdict["v"],
                       fence_lease_ttl_ms=400.0)
        t.tick(2)
        t.probe_ok["v"] = False
        t.tick(12)
        vetoed = (_status(t.orch), list(backend.fences),
                  sorted(t.router.failed))
        verdict["v"] = "dead"
        t.tick(12)
        return (vetoed, _status(t.orch), t.rec.events, backend.grants,
                t.rx.backend.grants, t.rx.promoted)

    vetoed, st, events, grants, new_grants, promoted = _both(run)
    assert vetoed[0]["witness_vetoes"] >= 1 and vetoed[0]["promotions"] == 0
    assert vetoed[1] == [] and vetoed[2] == []
    assert st["fence_epoch"] == 1 and st["promotions"] == 1 and promoted
    assert new_grants[0][0] == 2 and all(ep < 2 for ep, _ in grants)


def test_fencing_waits_out_an_unreachable_zombies_lease():
    def run(mod):
        backend = _FakeBackend(fence_reachable=False)
        t = _fake_orch(mod, backend, witness=lambda q: "dead",
                       fence_lease_ttl_ms=1000.0, fence_wait_slack_ms=100.0)
        t.tick(2)
        granted_at = t.orch._watch[0].lease_granted_at
        t.probe_ok["v"] = False
        t.tick(6)
        held = []
        while t.sim["s"] < granted_at + 1.1 - 0.05:
            t.tick(1)
            held.append((_status(t.orch)["shards"][0]["state"],
                         t.orch.promotions))
        t.tick(3)
        return held, _status(t.orch), t.rec.events, sorted(t.router.failed)

    held, st, events, failed = _both(run)
    assert held and all(s == "FENCING" and p == 0 for s, p in held)
    assert st["promotions"] == 1 and failed == []
    waits = [f for k, f in events if k == "orchestrator.fence_wait"]
    assert len(waits) == 1 and waits[0]["wait_ms"] > 0


def test_unknown_witness_never_vetoes():
    def run(mod):
        t = _fake_orch(mod, _FakeBackend(), witness=lambda q: "unknown")
        t.probe_ok["v"] = False
        t.tick(12)
        return _status(t.orch), t.rec.events

    st, _ = _both(run)
    assert st["promotions"] == 1 and st["witness_vetoes"] == 0


def test_promotion_falls_back_to_a_spare():
    """The primary standby is stale (not consistent) and the first spare
    refuses every attempt: the machine skips to the second spare within
    its bounded retries, with the same backoff sleeps in both."""
    def run(mod):
        stale = _FakeReceiver(consistent=False)
        bad = _FakeReceiver(fails=99)
        good = _FakeReceiver(fails=1)
        t = _fake_orch(mod, _FakeBackend(), rx=stale,
                       spares={0: [bad, good]}, promote_retries=2)
        t.probe_ok["v"] = False
        t.tick(8)
        return (_status(t.orch), t.rec.events, t.sleeps,
                [stale.attempts, bad.attempts, good.attempts],
                t.router.replacements[0] is good.backend)

    st, events, sleeps, attempts, installed = _both(run)
    assert installed and st["promotions"] == 1
    assert attempts == [0, 3, 2] and len(sleeps) == 3
    assert [k for k, _ in events].count("orchestrator.standby_stale") == 1


def test_exhausted_candidates_fail_closed_and_unfence_recovers():
    """Every candidate refuses: the shard fails closed (FAILED sticks);
    ``unfence`` is refused on a live shard of another machine and lifts
    the fence, repairs the router and re-arms the lease here."""
    def run(mod):
        backend = _FakeBackend()
        registry = (MeterRegistry if mod is port_orch else RefRegistry)()
        t = _fake_orch(mod, backend, rx=_FakeReceiver(fails=99),
                       registry=registry, fence_lease_ttl_ms=500.0)
        t.tick(2)
        t.probe_ok["v"] = False
        t.tick(12)
        failed = (_status(t.orch), registry.scrape()[
            "ratelimiter.orchestrator.state"])
        t.tick(3)
        sticky = _status(t.orch)["shards"][0]["state"]
        other = _fake_orch(mod, _FakeBackend())
        with pytest.raises(ValueError, match="not FAILED"):
            other.orch.unfence(0)
        t.probe_ok["v"] = True
        out = t.orch.unfence(0)
        t.tick(3)
        return (failed, sticky, out, _status(t.orch), t.rec.events,
                backend.fences, backend.lifts, backend.grants,
                t.router.repairs, registry.scrape()[
                    "ratelimiter.orchestrator.state"])

    (failed, sticky, out, st, events, fences, lifts, grants, repairs,
     gauge) = _both(run)
    assert failed[0]["shards"][0]["state"] == "FAILED" and failed[1] == 5.0
    assert sticky == "FAILED" and out["state"] == "MONITORING"
    assert fences == [(1, (0,))] and lifts == [(1, (0,))] and repairs == 1
    assert st["shards"][0]["state"] == "MONITORING" and gauge == 0.0
    assert grants[-1][0] == 2


def _storage(port, clock, num_slots=256):
    if port:
        return GpuBatchedStorage(num_slots=num_slots, host_parallel=0,
                                 device="cpu", clock_ms=lambda: clock["t"])
    require_reference_native()
    return TpuBatchedStorage(num_slots=num_slots, host_parallel=0,
                             clock_ms=lambda: clock["t"])


def test_reseed_restores_a_fresh_standby():
    """A promoted storage of each package: the machine goes RESTORED,
    re-seeds a fresh standby through its own ``ReplicationLog`` /
    ``Replicator`` / ``StandbyReceiver`` / ``InProcessSink`` from tick(),
    and returns to MONITORING once it is consistent; the fresh standby
    then decides as the promoted storage."""
    results = []
    for port in PACKAGES:
        mod = port_orch if port else ref_orch
        clock = {"t": T0}
        promoted = _storage(port, clock)
        fresh_storages = []

        def factory(port=port, clock=clock, fresh=fresh_storages):
            st = _storage(port, clock)
            fresh.append(st)
            return st

        Config = RateLimitConfig if port else RefConfig
        lid = promoted.register_limiter("tb", Config(
            max_permits=5, window_ms=1000, refill_rate=1.0))
        for i in range(12):
            promoted.acquire("tb", lid, f"k{i % 4}", 1)
        rx = _FakeReceiver()
        rx.backend = promoted
        t = _fake_orch(mod, _FakeBackend(), rx=rx, reseed=True,
                       standby_factory=factory)
        try:
            t.probe_ok["v"] = False
            t.tick(6)
            st = _status(t.orch)
            fresh = fresh_storages[0]
            clock["t"] += 50
            got = [[bool(s.acquire("tb", lid, f"k{i % 4}", 1)["allowed"])
                    for i in range(8)] for s in (promoted, fresh)]
            same = None
            if port:
                a, b = (engine_state_fingerprint(s.engine)
                        for s in (promoted, fresh))
                same = sorted(a) == sorted(b) and all(
                    np.array_equal(a[k], b[k]) for k in a)
            results.append((st, t.rec.events, got, len(t.replaced), same))
        finally:
            t.orch.close()
            promoted.close()
            for s in fresh_storages:
                s.close()
    ref, port = results
    assert port[:4] == ref[:4]
    st, events, got, replaced, same = port
    assert st["reseeds"] == 1 and st["shards"][0]["state"] == "MONITORING"
    assert got[0] == got[1] and replaced == 1 and same
    assert ("orchestrator.reseeded" in [k for k, _ in events])


def test_timing_validation_warns_alike():
    """The two tuning hazards (a witness freshness outside the heartbeat
    / detection-budget window, a lease TTL under the budget) raise the
    same flight events in both packages, and a sane setting raises
    none."""
    cases = [
        dict(witness_fresh_ms=50.0, repl_heartbeat_ms=100.0),
        dict(witness_fresh_ms=5000.0, repl_heartbeat_ms=100.0),
        dict(witness_fresh_ms=300.0, repl_heartbeat_ms=100.0),
        dict(fence_lease_ttl_ms=100.0),
        dict(fence_lease_ttl_ms=2000.0),
    ]

    def run(mod):
        out = []
        for case in cases:
            kw = dict(case)
            cfg = {k: kw.pop(k) for k in ("fence_lease_ttl_ms",)
                   if k in kw}
            rec = _Recorder()
            router = _FakeRouter(_FakeBackend())
            mod.FailoverOrchestrator(
                router, types.SimpleNamespace(receivers=[_FakeReceiver()]),
                None, config=mod.OrchestratorConfig(**cfg), recorder=rec,
                clock=lambda: 0.0, sleep=lambda s: None, **kw)
            out.append(rec.events)
        return out

    out = _both(run)
    assert [len(e) for e in out] == [1, 1, 0, 1, 0]
    assert port_orch.OrchestratorConfig().detection_budget_ms == \
        ref_orch.OrchestratorConfig().detection_budget_ms == 900.0


def test_default_probe_counts_ship_error_growth_as_failure():
    def run(mod):
        router = _FakeRouter(_FakeBackend())
        replicator = types.SimpleNamespace(
            shard_errors=[0], shard_link_state=lambda q: "up")
        orch = mod.FailoverOrchestrator(
            router, types.SimpleNamespace(receivers=[_FakeReceiver()]),
            replicator, clock=lambda: 0.0, sleep=lambda s: None,
            recorder=_Recorder())
        out = [orch._default_probe(0)]
        replicator.shard_errors[0] += 1
        out += [orch._default_probe(0), orch._default_probe(0),
                orch.standby_ok(0)]
        router.fail_shard(0)
        out.append(orch._default_probe(0))
        return out

    assert _both(run) == [True, False, True, True, False]
