"""Sharded replication, the shard failover router and the in-process
orchestrator of the port (``replication/sharded.py``, the wiring's
``_maybe_replication`` / ``_maybe_orchestrator``, the health and breaker
shard blocks, ``storage/chaos.py``'s shard drills) against the JAX
package's, on the CPU.

The reference's sharded primaries run on ``make_mesh(n_devices=2 or 4)``
of the forced host devices (``tests/conftest.py``); the port's shards are
CPU tensors.  Both get the same configs, keys, permits and clock, with
duplicate keys, eviction churn (more keys than slots) and the clock
stepping back:

- per-shard cuts: decisions equal, each shard's frames equal field for
  field (epoch, full, local slots, rows, the shard's index fingerprints,
  limiters), every standby byte-equal to its shard after each cut, and
  frames crossing the packages both ways (a port primary's shard into
  the reference's flat standby and back) with rows and, after promotion,
  the index equal to the primary shard's;
- a failed ship stays on its shard; a cut racing a dispatch ships the
  row in a later epoch (ROADMAP C10);
- the routers' decisions, denials, ``shard_health`` and
  ``degraded_shards`` before, during and after ``fail_shard`` /
  ``install_replacement`` / ``repair_shard``; the breaker's and the
  health payload's shard blocks;
- the three drills: counts and the simulated-clock timelines equal on
  one seed;
- the wiring: one ``replication.targets`` entry a shard over TCP, the
  warning on another count, the orchestrator off by default and refused
  over a flat engine, the N+1 topology, ``build_app`` serving through the
  router with ``/actuator/orchestrator`` and the unfence actuator.

Slots stay at most 2^8 a shard; every storage is closed in a ``finally``.
"""

import contextlib
import http.client
import json
import logging
import threading

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.parallel import ShardedDeviceEngine as RefEngine
from ratelimiter_tpu.parallel import make_mesh
from ratelimiter_tpu.replication import (
    ShardedReplicationLog as RefShardedLog,
)
from ratelimiter_tpu.replication import ShardFailoverRouter as RefRouter
from ratelimiter_tpu.replication import StandbyReceiver as RefReceiver
from ratelimiter_tpu.service.app import health_payload as ref_health
from ratelimiter_tpu.service.props import AppProperties as RefProps
from ratelimiter_tpu.service.wiring import AppContext as RefContext
from ratelimiter_tpu.storage import chaos as ref_chaos
from ratelimiter_tpu.storage.breaker import (
    CircuitBreakerStorage as RefBreaker,
)
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine.checkpoint import (
    dump_shard_slot_indexes,
    dump_slot_indexes,
)
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine
from ratelimiter_tpu_torch.replication import (
    ReplicationServer,
    ShardedReplicationLog,
    ShardedReplicator,
    ShardFailoverRouter,
    ShardStandbySet,
    StandbyReceiver,
    decode_frame,
    encode_frame,
    engine_state_fingerprint,
)
from ratelimiter_tpu_torch.service import wiring
from ratelimiter_tpu_torch.service.app import health_payload, make_server
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.storage import chaos
from ratelimiter_tpu_torch.storage.breaker import CircuitBreakerStorage
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)


@contextlib.contextmanager
def _warnings():
    """The port's warnings logged inside the block (the app's logging
    setup stops them propagating to pytest's capture)."""
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger("ratelimiter_tpu_torch")
    logger.addHandler(handler)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)

T0 = 1_753_000_000_000
SPS = 128  # slots a shard: the traffic's keys outnumber them
TB = dict(max_permits=20, window_ms=1000, refill_rate=5.0)
SW = dict(max_permits=15, window_ms=1000)


# -- the two packages' topologies -------------------------------------------------
# The sharded engines, one pair a shard count, kept for the module: the
# reference compiles its jitted shard_map steps per engine, so each test
# takes the pair with its state zeroed and a fresh limiter table (a
# standby registers the limiters its primary storage registered).
_ENGINES: dict = {}


def _engine(ref: bool, n: int):
    if n not in _ENGINES:
        require_reference_native()
        _ENGINES[n] = {
            True: RefEngine(SPS, RefTable(), mesh=make_mesh(n_devices=n)),
            False: ShardedDeviceEngine(SPS, LimiterTable(device="cpu"),
                                       devices=["cpu"] * n)}
    eng = _ENGINES[n][ref]
    eng.journal = None
    eng.table = RefTable() if ref else LimiterTable(device="cpu")
    for algo in ("sw", "tb"):
        state = getattr(eng, f"{algo}_state")
        setattr(eng, f"{algo}_state", type(state)(*(
            np.zeros(np.shape(f), dtype=np.int64) if ref
            else torch.zeros_like(f) for f in state)))
    return eng


def _primary(ref: bool, n: int, clock):
    if ref:
        return TpuBatchedStorage(engine=_engine(True, n),
                                 clock_ms=lambda: clock["t"],
                                 observability=False)
    return GpuBatchedStorage(engine=_engine(False, n),
                             clock_ms=lambda: clock["t"])


def _flat(ref: bool, clock, sps: int = SPS):
    if ref:
        require_reference_native()
        return TpuBatchedStorage(num_slots=sps, clock_ms=lambda: clock["t"],
                                 host_parallel=0, observability=False)
    return GpuBatchedStorage(num_slots=sps, clock_ms=lambda: clock["t"],
                             device="cpu", host_parallel=0)


def _register(storage, ref: bool) -> dict:
    cfg = RefConfig if ref else RateLimitConfig
    return {"tb": storage.register_limiter("tb", cfg(**TB)),
            "sw": storage.register_limiter("sw", cfg(**SW))}


def _rows(storage, q=None, sps=SPS) -> dict:
    """Packed rows of a flat storage, or of shard ``q`` of a sharded one
    (either package), both algorithms."""
    eng = storage.engine
    out = {}
    for algo in ("sw", "tb"):
        if q is None:
            out[algo] = np.asarray(getattr(eng, f"{algo}_packed"))
            if isinstance(out[algo], torch.Tensor):
                out[algo] = out[algo].numpy()
        elif hasattr(eng, "packed_host"):
            out[algo] = eng.packed_host(algo)[q * sps:(q + 1) * sps]
        else:
            out[algo] = np.asarray(getattr(eng, f"{algo}_packed"))[q]
    return out


def _same_rows(a, b, msg="") -> None:
    for algo in ("sw", "tb"):
        np.testing.assert_array_equal(a[algo], b[algo], err_msg=(msg, algo))


def _same_frames(fa, fb) -> None:
    """Two packages' frames of one cut, field for field (the cut stamp is
    the wall clock's)."""
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        a, b = decode_frame(encode_frame(a)), decode_frame(encode_frame(b))
        for k in ("epoch", "seq", "last", "full", "num_slots", "shard",
                  "n_shards", "limiters"):
            assert a.get(k) == b.get(k), k
        assert a["algos"].keys() == b["algos"].keys()
        for algo in a["algos"]:
            for f in ("slots", "rows"):
                np.testing.assert_array_equal(a["algos"][algo][f],
                                              b["algos"][algo][f])
        if "index" in a:
            for algo, pa in a["index"]["algos"].items():
                pb = b["index"]["algos"][algo]
                assert pa["kind"] == pb["kind"] == "native_fp"
                for f in ("h1", "h2", "slots"):
                    np.testing.assert_array_equal(pa[f], pb[f])


def _traffic(rng, steps=4, n_keys=400):
    """Seeded steps: a clock move (back as well), Zipf int keys for the
    token bucket (duplicates), string keys and permits for the sliding
    window; more keys than the shards' slots (eviction churn)."""
    out = []
    for _ in range(steps):
        zipf = (rng.zipf(1.2, 600) - 1) % n_keys
        skeys = [f"u{k}" for k in rng.integers(0, n_keys, 48)]
        perms = [int(p) for p in rng.integers(1, 4, 48)]
        out.append((int(rng.choice([1, 250, 999, 2001, -40])),
                    zipf.astype(np.int64), skeys, perms))
    return out


def _drive(storage, lids, step):
    _, zipf, skeys, perms = step
    a = storage.acquire_stream_ids("tb", lids["tb"], zipf)
    b = storage.acquire_many("sw", [lids["sw"]] * len(skeys), skeys, perms)
    return a, np.asarray(b["allowed"]), np.asarray(b["observed"])


# -- per-shard cuts ----------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4])
def test_per_shard_cuts_match_reference_across_packages(n):
    """Each cut's frames equal the reference's; every standby (its own
    package's and the other's) is byte-equal to its shard after each cut;
    promoted across packages, a standby's index equals its shard's."""
    clock = {"t": T0}
    prims = {ref: _primary(ref, n, clock) for ref in (True, False)}
    # standbys[(primary's package, standby's package)][q]
    standbys = {(p, s): [_flat(s, clock) for _ in range(n)]
                for p in (True, False) for s in (True, False)}
    receivers = {k: [(RefReceiver if k[1] else StandbyReceiver)(st)
                     for st in v] for k, v in standbys.items()}
    try:
        lids = {ref: _register(prims[ref], ref) for ref in prims}
        assert lids[True] == lids[False]
        logs = {True: RefShardedLog(prims[True], journal_kind="host"),
                False: ShardedReplicationLog(prims[False],
                                             journal_kind="host")}
        for step in _traffic(np.random.default_rng(n), steps=3):
            clock["t"] += step[0]
            got = {ref: _drive(prims[ref], lids[ref], step) for ref in prims}
            for x, y in zip(got[True], got[False]):
                np.testing.assert_array_equal(x, y)
            for q in range(n):
                frames = {ref: logs[ref].cut_shard(q) for ref in prims}
                _same_frames(frames[True], frames[False])
                for (p, s), rxs in receivers.items():
                    for f in frames[p]:
                        rxs[q].apply_bytes(encode_frame(f))
                    _same_rows(_rows(standbys[(p, s)][q]),
                               _rows(prims[p], q), (p, s, q))
        assert logs[True].epochs == logs[False].epochs
        for (p, s), rxs in receivers.items():
            for q, rx in enumerate(rxs):
                assert rx.consistent and rx.last_epoch == logs[p].epochs[q]
        # Promote the cross-package standbys: the index each rebuilds is
        # its primary shard's (the port's dump of either standby).
        for q in range(n):
            want = dump_shard_slot_indexes(prims[False], q)
            for p in (True, False):
                st = receivers[(p, False)][q].promote()
                for algo, pa in dump_slot_indexes(st)["algos"].items():
                    for f in ("h1", "h2", "slots"):
                        np.testing.assert_array_equal(
                            pa[f], want["algos"][algo][f])
            receivers[(False, True)][q].promote()
    finally:
        for st in prims.values():
            st.close()
        for v in standbys.values():
            for st in v:
                st.close()


class _FlakySink:
    def __init__(self, inner):
        self.inner = inner
        self.fail = False

    def send(self, data):
        if self.fail:
            raise ConnectionError("standby 1 unreachable")
        self.inner.send(data)


def test_failed_ship_is_isolated_to_one_shard():
    clock = {"t": T0}
    primary = _primary(False, 4, clock)
    standbys = ShardStandbySet(4, lambda: _flat(False, clock))
    try:
        lid = _register(primary, False)["tb"]
        log = ShardedReplicationLog(primary)
        sinks = standbys.in_process_sinks()
        sinks[1] = _FlakySink(sinks[1])
        repl = ShardedReplicator(log, sinks)
        clock["t"] += 9
        primary.acquire_stream_ids("tb", lid, np.arange(400))
        sinks[1].fail = True
        repl.ship_now()  # shard 1 fails, the others ship
        assert repl.shard_errors == [0, 1, 0, 0]
        assert repl.shard_status()[1]["last_error"]
        for q in (0, 2, 3):
            _same_rows(_rows(standbys.storages[q]), _rows(primary, q))
        assert not standbys.receivers[1].consistent
        # The link heals: the next cycle re-baselines shard 1 with a full
        # frame and the other shards ship deltas only.
        sinks[1].fail = False
        clock["t"] += 9
        primary.acquire_stream_ids("tb", lid, np.arange(50))
        repl.ship_now()
        assert [c["full"] for c in log.last_cuts] == [False, True, False,
                                                      False]
        for q in range(4):
            _same_rows(_rows(standbys.storages[q]), _rows(primary, q))
        assert standbys.receivers[1].consistent
    finally:
        primary.close()
        standbys.close()


class _WatchedLock:
    """A re-entrant lock that records when another thread had to wait."""

    def __init__(self):
        self._lock = threading.RLock()
        self.waiting = threading.Event()

    def __enter__(self):
        if not self._lock.acquire(blocking=False):
            self.waiting.set()
            self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def acquire(self):
        self._lock.acquire()

    def release(self):
        self._lock.release()


@pytest.mark.parametrize("kind", ["host", "device"])
def test_cut_racing_a_dispatch_ships_its_row_later(kind):
    """ROADMAP C10.  A stream call is held at one shard's lock while that
    shard's cut drains the journal and reads the rows, then runs.  The
    port marks a step's slots after enqueueing it under the shard lock,
    so the held call's slots miss that cut and the next cut ships their
    new rows: the standby ends equal to its shard."""
    clock = {"t": T0}
    primary = _primary(False, 2, clock)
    standbys = ShardStandbySet(2, lambda: _flat(False, clock))
    try:
        lid = _register(primary, False)["tb"]
        log = ShardedReplicationLog(primary, journal_kind=kind)
        sinks = standbys.in_process_sinks()
        keys = np.arange(40, dtype=np.int64)
        clock["t"] += 10
        primary.acquire_stream_ids("tb", lid, keys)
        for q in range(2):
            for f in log.cut_shard(q):
                sinks[q].send(encode_frame(f))
        lock = _WatchedLock()
        primary.engine._shard_locks[1] = lock
        lock.acquire()
        try:
            clock["t"] += 10
            worker = threading.Thread(target=primary.acquire_stream_ids,
                                      args=("tb", lid, keys))
            worker.start()
            assert lock.waiting.wait(30)
            held = log.cut_shard(1)
            for f in held:
                sinks[1].send(encode_frame(f))
        finally:
            lock.release()
        worker.join(30)
        assert not worker.is_alive()
        assert not held or not any(f["algos"] for f in held)
        later = log.cut_shard(1)
        assert later and later[0]["algos"]["tb"]["slots"].size
        for f in later:
            sinks[1].send(encode_frame(f))
        _same_rows(_rows(standbys.storages[1]), _rows(primary, 1))
    finally:
        primary.close()
        standbys.close()


# -- the router ----------------------------------------------------------------------
def _router_calls(router, lids, rng, clock, leases: bool):
    """One round of every routed decision surface; returns the answers."""
    clock["t"] += int(rng.choice([1, 250, 999, -20]))
    ikeys = ((rng.zipf(1.2, 300) - 1) % 300).astype(np.int64)
    skeys = [f"s{k}" for k in rng.integers(0, 300, 40)]
    perms = rng.integers(1, 4, 40)
    out = [router.acquire_stream_ids("tb", lids["tb"], ikeys),
           router.acquire_stream_ids("sw", lids["sw"], ikeys[:64],
                                     rng.integers(0, 4, 64)),
           router.acquire_stream_strs("tb", lids["tb"], skeys),
           router.acquire_many("sw", [lids["sw"]] * 40, skeys,
                               [int(p) for p in perms])["allowed"],
           router.acquire_many_ids("tb", lids["tb"], ikeys[:40],
                                   perms)["allowed"],
           router.available_many("sw", lids["sw"], skeys[:10])]
    for k in skeys[:6]:
        d = router.acquire("tb", lids["tb"], k, 2)
        out.append(np.array([bool(d["allowed"]), int(d["remaining"])]))
    router.reset_key("tb", lids["tb"], skeys[7])
    if leases:
        g = router.lease_reserve("tb", lids["tb"], skeys[8], 3)
        c = router.lease_credit("tb", lids["tb"], skeys[8], 1, g["ws"])
        out.append(np.array([g["granted"], c["credited"]]))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("n", [2, 4])
def test_router_matches_reference(n):
    """Decisions, denials and shard health of both routers before, during
    and after a shard fails, its standby is promoted and installed, and
    the operator repairs it back to the primary."""
    clock = {"t": T0}
    prims, routers, sets, repls = {}, {}, {}, {}
    for ref in (True, False):
        prims[ref] = _primary(ref, n, clock)
    from ratelimiter_tpu.replication import (
        ShardedReplicator as RefReplicator,
    )
    from ratelimiter_tpu.replication import ShardStandbySet as RefSet
    try:
        lids = {ref: _register(prims[ref], ref) for ref in prims}
        for ref in prims:
            routers[ref] = (RefRouter if ref else ShardFailoverRouter)(
                prims[ref])
            sets[ref] = (RefSet if ref else ShardStandbySet)(
                n, lambda ref=ref: _flat(ref, clock))
            log = (RefShardedLog(prims[ref], journal_kind="host") if ref
                   else ShardedReplicationLog(prims[ref]))
            repls[ref] = (RefReplicator if ref else ShardedReplicator)(
                log, sets[ref].in_process_sinks())
        victim = n - 1
        rngs = {ref: np.random.default_rng(5) for ref in prims}

        def round_(phase):
            t = clock["t"]
            got = {}
            for ref in prims:
                clock["t"] = t
                got[ref] = _router_calls(routers[ref], lids[ref], rngs[ref],
                                         clock, leases=True)
            for a, b in zip(got[True], got[False]):
                np.testing.assert_array_equal(a, b, err_msg=phase)
            assert routers[True].unavailable_denies == \
                routers[False].unavailable_denies
            assert routers[True].shard_health() == \
                routers[False].shard_health()
            assert routers[True].degraded_shards() == \
                routers[False].degraded_shards()
            assert ({q: s["state"] for q, s in
                     routers[True].shard_status().items()}
                    == {q: s["state"] for q, s in
                        routers[False].shard_status().items()})

        for _ in range(2):
            round_("healthy")
            for ref in prims:
                repls[ref].ship_now()
        for ref in prims:
            routers[ref].fail_shard(victim)
        round_("failed")
        assert routers[False].unavailable_denies > 0
        assert routers[False].degraded_shards() == [victim]
        for ref in prims:
            routers[ref].install_replacement(victim,
                                             sets[ref].promote(victim))
        for _ in range(2):
            round_("promoted")
        assert routers[False].shard_health()[victim] == "promoted"
        # A lid array splits with its keys: one lid repeated decides as
        # the reference router's one lid does (the reference passes the
        # whole array to each part).
        clock["t"] += 7
        keys = np.arange(120, dtype=np.int64)
        np.testing.assert_array_equal(
            routers[False].acquire_stream_ids(
                "tb", np.full(120, lids[False]["tb"]), keys),
            routers[True].acquire_stream_ids("tb", lids[True]["tb"], keys))
        for ref in prims:
            gen = routers[ref].set_policy(lids[ref]["tb"], (
                RefConfig if ref else RateLimitConfig)(
                max_permits=9, window_ms=1000, refill_rate=2.0))
            assert gen == routers[ref].replacements[victim].policy_info()[
                "lids"][lids[ref]["tb"]]["generation"]
        round_("policy")
        for ref in prims:
            routers[ref].repair_shard(victim)
        round_("repaired")
        assert routers[False].degraded_shards() == []
        with pytest.raises(ValueError, match="negative token-bucket"):
            routers[False].acquire_stream_ids("tb", lids[False]["tb"],
                                              np.arange(4),
                                              np.array([1, -1, 1, 1]))
    finally:
        for ref in prims:
            repls[ref].stop()
            if ref in routers:
                routers[ref].close()
            else:
                prims[ref].close()
            if ref in sets:
                sets[ref].close(except_shards=(victim,))


def test_breaker_and_health_report_shard_state():
    """The breaker's ``status()`` and the health payload read the router's
    shard health as the reference's do: one failed shard is DEGRADED with
    its detail, never DOWN."""
    clock = {"t": T0}
    prims = {ref: _primary(ref, 4, clock) for ref in (True, False)}
    try:
        routers = {True: RefRouter(prims[True]),
                   False: ShardFailoverRouter(prims[False])}
        breakers = {True: RefBreaker(routers[True]),
                    False: CircuitBreakerStorage(routers[False])}
        ctxs = {True: RefContext(props=RefProps({}), storage=routers[True],
                                 registry=RefRegistry(), limiters={},
                                 fail_open=True),
                False: wiring.AppContext(
                    props=AppProperties({}), storage=routers[False],
                    registry=MeterRegistry(), limiters={}, fail_open=True)}
        for failed in ((), (1,), (1, 2)):
            for ref in prims:
                for q in failed:
                    routers[ref].fail_shard(q)
            assert breakers[True].status() == breakers[False].status()
            a, b = ref_health(ctxs[True]), health_payload(ctxs[False])
            for key in ("status", "shards", "storage"):
                assert a[key] == b[key], key
            assert ({q: d["state"] for q, d in a["shards_detail"].items()}
                    == {q: d["state"] for q, d in
                        b["shards_detail"].items()})
        assert b["status"] == "DEGRADED"
        assert breakers[False].status()["degraded_shards"] == ["1", "2"]
    finally:
        for st in prims.values():
            st.close()


# -- the drills ---------------------------------------------------------------------
_SHARD_DRILL = dict(n_shards=4, slots_per_shard=256, n_keys=64, waves=4,
                    kill_after_wave=2, post_waves=2, stream_n=768, batch=24)


def test_shard_failover_drill_matches_reference():
    require_reference_native()
    regs = (RefRegistry(), MeterRegistry())
    want = ref_chaos.shard_failover_drill(registry=regs[0], **_SHARD_DRILL)
    got = chaos.shard_failover_drill(registry=regs[1], device="cpu",
                                     **_SHARD_DRILL)
    for key in ("decisions", "mismatches", "frames", "loss_wave_decisions",
                "loss_wave_admitted", "window_decisions", "window_denied",
                "promoted_epoch", "undrained_at_kill", "flight_timeline",
                "victim_shard", "shard_health"):
        assert got[key] == want[key], key
    assert got["mismatches"] == 0 and got["decisions"] > 1000
    assert got["standby_checks"] == len(got["cuts"]) == 3
    assert all(c["full"] for c in got["cuts"][0])
    for reg in regs:
        meters = reg.scrape()
        assert meters["ratelimiter.replication.failovers"] == 1.0
        assert meters["ratelimiter.replication.epoch_gap"] == 0.0
    for key in ("bootstrap_ms", "promote_ms", "kill_to_first_answer_ms",
                "wall_s"):
        assert got[key] > 0


def test_orchestrated_failover_drill_matches_reference():
    require_reference_native()
    args = dict(n_shards=4, slots_per_shard=256, n_keys=64, waves=2,
                stream_n=512, batch=16, cycles=2)
    want = ref_chaos.orchestrated_failover_drill(**args)
    got = chaos.orchestrated_failover_drill(device="cpu", **args)
    for key in ("decisions", "mismatches", "frames", "false_alarms",
                "flight_transitions", "promotions", "reseeds",
                "fence_rejected", "manual_promotions"):
        assert got[key] == want[key], key
    assert [{k: c[k] for k in ("victim", "detection_ms", "fence_epoch")}
            for c in got["cycles"]] == want["cycles"]
    assert got["reseeds"] == got["promotions"] == 2
    assert all(c["kill_to_restored_ms"] > 0 for c in got["cycles"])


def test_orchestrator_flap_drill_matches_reference():
    require_reference_native()
    args = dict(flap_cycles=2, seed=3)
    want = ref_chaos.orchestrator_flap_drill(**args)
    got = chaos.orchestrator_flap_drill(device="cpu", **args)
    for key in ("decisions", "mismatches", "false_alarms", "fence_rejected",
                "victim"):
        assert got[key] == want[key], key
    assert got["false_alarms"] == 2 and got["promotions"] == 0
    assert len(got["flap_ms"]) == 2


# -- the wiring ---------------------------------------------------------------------
def test_wiring_sharded_primary_targets_over_tcp():
    """``replication.targets`` wires one socket sink a shard and the status
    reports an epoch a shard; each flat standby converges on its shard.
    Another count of targets warns and disables replication."""
    clock = {"t": T0}
    primary = _primary(False, 2, clock)
    standbys = [_flat(False, clock) for _ in range(2)]
    receivers = [StandbyReceiver(s) for s in standbys]
    servers = [ReplicationServer(r, host="127.0.0.1", port=0).start()
               for r in receivers]
    handle = None
    try:
        props = {"replication.enabled": "true",
                 "replication.role": "primary",
                 "replication.interval_ms": "60000"}
        with _warnings() as seen:
            assert wiring._maybe_replication(primary, AppProperties(dict(
                props, **{"replication.targets": f"127.0.0.1:"
                          f"{servers[0].port}"})), MeterRegistry()) is None
        assert any("one replication.targets entry per shard" in m
                   for m in seen)
        handle = wiring._maybe_replication(primary, AppProperties(dict(
            props, **{"replication.targets": ",".join(
                f"127.0.0.1:{s.port}" for s in servers)})), MeterRegistry())
        assert handle is not None and handle.role == "primary"
        lid = _register(primary, False)["tb"]
        clock["t"] += 9
        primary.acquire_stream_ids("tb", lid, np.arange(100))
        handle.replicator.ship_now()
        status = handle.status()
        assert status["epochs"] == [1, 1]
        assert set(status["shards"]) == {0, 1}
        assert status["journal"] == "host"
        for q in (0, 1):
            _same_rows(_rows(standbys[q]), _rows(primary, q))
    finally:
        if handle is not None:
            handle.close()
        for s in servers:
            s.stop()
        primary.close()
        for st in standbys:
            st.close()


def test_wiring_orchestrator_off_by_default_and_refused_over_flat():
    clock = {"t": T0}
    storage = _flat(False, clock, 256)
    try:
        handle, serving = wiring._maybe_orchestrator(
            storage, AppProperties({}), MeterRegistry())
        assert handle is None and serving is storage
        with _warnings() as seen:
            handle, serving = wiring._maybe_orchestrator(
                storage, AppProperties(
                    {"ratelimiter.orchestrator.enabled": "true"}),
                MeterRegistry())
        assert handle is None and serving is storage
        assert any("no sharded engine" in m for m in seen)
        assert not any(key == "ratelimiter.orchestrator.enabled"
                       for key, _ in wiring.UNPORTED_TIERS)
    finally:
        storage.close()


def test_wiring_orchestrator_builds_n_plus_one_topology():
    clock = {"t": T0}
    storage = _primary(False, 2, clock)
    props = AppProperties({
        "ratelimiter.orchestrator.enabled": "true",
        "ratelimiter.orchestrator.probe_interval_ms": "60000",
        "replication.interval_ms": "60000",
    })
    registry = MeterRegistry()
    handle, serving = wiring._maybe_orchestrator(storage, props, registry)
    assert handle is not None
    try:
        assert serving is handle.router
        assert handle.standby_set.n_shards == 2
        assert all(st._host_parallel == 0 and st.engine.num_slots == SPS
                   for st in handle.standby_set.storages)
        status = handle.status()
        assert status["enabled"] is True
        assert status["shards"][0]["state"] == "MONITORING"
        assert status["config"]["suspect_threshold"] == 3
        assert set(status["router"]) == set(status["replication"]) == {
            "0", "1"}
        ctx = wiring.AppContext(props=props, storage=serving,
                                registry=registry, limiters={},
                                fail_open=True, orchestrator=handle)
        payload = health_payload(ctx)
        assert payload["status"] == "UP"
        assert payload["orchestrator"]["promotions"] == 0
        assert payload["shards_detail"]["0"]["state"] == "active"
        assert payload["shards_detail"]["0"]["orchestrator_state"] == \
            "MONITORING"
    finally:
        handle.close()
        serving.close()


def test_standbys_take_one_index():
    """A shard's frames carry one C index's fingerprints, which a
    partitioned index cannot restore; the standbys the wiring builds take
    one index at every size (the reference's factory elects partitions
    from 2^16 slots on a host of more than two cores)."""
    clock = {"t": T0}
    primary = _primary(False, 2, clock)
    parted = GpuBatchedStorage(num_slots=1 << 16, device="cpu",
                               host_parallel=4,
                               clock_ms=lambda: clock["t"])
    try:
        _register(primary, False)
        primary.acquire_stream_ids("tb", 0, np.arange(50))
        from ratelimiter_tpu_torch.engine.checkpoint import (
            restore_slot_indexes,
        )

        with pytest.raises(ValueError, match="host-partitioned"):
            restore_slot_indexes(parted, dump_shard_slot_indexes(primary, 0))
        props = AppProperties({"ratelimiter.orchestrator.enabled": "true",
                               "ratelimiter.orchestrator.probe_interval_ms":
                               "60000", "replication.interval_ms": "60000"})
        eng = ShardedDeviceEngine(1 << 16, LimiterTable(device="cpu"),
                                  devices=["cpu"] * 2)
        big = GpuBatchedStorage(engine=eng, clock_ms=lambda: clock["t"])
        handle, serving = wiring._maybe_orchestrator(big, props,
                                                     MeterRegistry())
        try:
            assert [st._host_parallel for st in
                    handle.standby_set.storages] == [0, 0]
        finally:
            handle.close()
            serving.close()
    finally:
        primary.close()
        parted.close()


def _sharded_build_storage(props, meter_registry=None, device=None):
    """``build_storage`` as several cards would make it: the sharded
    engine over two CPU devices."""
    eng = wiring.sharded_engine(props, [torch.device("cpu")] * 2)
    return GpuBatchedStorage(engine=eng, meter_registry=meter_registry)


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def test_build_app_serves_through_the_router(monkeypatch):
    """``build_app`` with the orchestrator on over a sharded engine: the
    trio serves through retry(breaker(router)), ``/actuator/orchestrator``
    answers, a failed shard reads DEGRADED (the breaker lists it), a shard
    left FAILED (its standby never bootstrapped) reads DOWN, and the
    unfence actuator recovers it.  Over a flat engine the orchestrator
    stays off."""
    monkeypatch.setattr(wiring, "build_storage", _sharded_build_storage)
    props = AppProperties({
        "storage.num_slots": "512",
        "warmup.enabled": "false",
        "ratelimiter.orchestrator.enabled": "true",
        "ratelimiter.orchestrator.probe_interval_ms": "60000",
        "ratelimiter.orchestrator.suspect_threshold": "1",
        "ratelimiter.orchestrator.hysteresis_ms": "0",
        "ratelimiter.orchestrator.promote_retries": "0",
        "replication.enabled": "true",
        "replication.interval_ms": "60000",
    })
    ctx = wiring.build_app(props)
    srv = make_server(ctx, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    try:
        assert ctx.orchestrator is not None and ctx.replication is None
        router = ctx.orchestrator.router
        assert ctx.breaker._inner is router
        assert ctx.limiters["api"].try_acquire("user-1") is True
        assert ctx.limiters["burst"].try_acquire("user-1", 2) is True
        status, body = _http(port, "GET", "/actuator/orchestrator")
        assert status == 200 and body["enabled"] is True
        assert set(body["router"]) == {"0", "1"}
        status, body = _http(port, "GET", "/actuator/health")
        assert status == 200 and body["status"] == "UP"
        assert _http(port, "POST", "/actuator/orchestrator/unfence",
                     {})[0] == 400
        status, body = _http(port, "POST", "/actuator/orchestrator/unfence",
                             {"shard": 0})
        assert status == 409 and "not FAILED" in body["error"]

        router.fail_shard(1)
        status, body = _http(port, "GET", "/actuator/health")
        assert status == 200 and body["status"] == "DEGRADED"
        assert body["shards"]["1"] == "failed"
        assert body["breaker"]["degraded_shards"] == ["1"]
        orch = ctx.orchestrator.orchestrator
        orch.tick()
        orch.tick()  # SUSPECT -> FENCING -> no promotable standby: FAILED
        assert orch.status()["shards"][1]["state"] == "FAILED"
        status, body = _http(port, "GET", "/actuator/health")
        assert status == 503 and body["status"] == "DOWN"
        assert body["orchestrator"]["failed_shards"] == [1]
        status, body = _http(port, "POST", "/actuator/orchestrator/unfence",
                             {"shard": 1})
        assert status == 200 and body["state"] == "MONITORING"
        status, body = _http(port, "GET", "/actuator/health")
        assert status == 200 and body["status"] == "UP"
        assert ctx.limiters["auth"].try_acquire("user-9") is True
    finally:
        srv.shutdown()
        srv.server_close()
        ctx.close()
    monkeypatch.undo()
    flat = wiring.build_app(AppProperties({
        "storage.num_slots": "512", "warmup.enabled": "false",
        "ratelimiter.orchestrator.enabled": "true"}), device="cpu")
    srv = make_server(flat, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        assert flat.orchestrator is None
        assert _http(srv.server_address[1], "GET",
                     "/actuator/orchestrator") == (200, {"enabled": False})
        assert _http(srv.server_address[1], "POST",
                     "/actuator/orchestrator/unfence",
                     {"shard": 0})[0] == 409
    finally:
        srv.shutdown()
        srv.server_close()
        flat.close()
