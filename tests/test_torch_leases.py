"""Token leases, port against the JAX package (``ops/lease.py``,
``DeviceEngine.lease_reserve`` / ``lease_credit``, the storage's lease
surface, ``leases/``).

- (a) The four device steps against ``ratelimiter_tpu/ops/lease.py``'s
  ``RESERVE_STEPS`` / ``CREDIT_STEPS`` at buckets of 32 and 1024 lanes:
  duplicate slots, padding lanes (at the end and among live lanes), zero
  and negative requests and credits, window rollover and ``now`` stepping
  back, credits with a stale or foreign ``grant_ws``, token buckets at
  capacity.  Granted, ws and credited must be equal, and the whole packed
  state byte-equal, after every call.  The reference runs on the CPU as
  its own tests run it: its block scatter is off there, so its rows go
  through XLA's drop-mode scatter.
- (b) ``GpuBatchedStorage(device="cpu")`` against ``TpuBatchedStorage``
  (the same explicit ``host_parallel``, 0 and 4, and one manual clock),
  with ``LeaseManager`` and ``LeaseClient`` over ``DirectTransport``: the
  cases of ``tests/test_leases.py``.  Every grant, stamp, ``manager.ops``
  and ``status()`` must be equal, and the oracle must agree.  The
  manager's fence-epoch revocation is held on both packages through one
  thin double that exposes ``fence_info``, and over the storage's own
  epoch, moved by a fence and its lift or by a serving-lease grant, with
  a fenced storage refusing a grant.
- (c) The eviction order (ROADMAP C8): on a full 64-slot table, every
  fresh key's grant and its credit equal the oracle's.  Nothing is
  asserted about the reference's answer there, which races its flusher.
"""

import random
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ratelimiter_tpu import leases as ref_leases
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine.engine import DeviceEngine as RefEngine
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.ops import lease as ref_lease
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch import leases
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.state import (
    LimiterTable,
    load_reference_state,
)
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.ops import lease
from ratelimiter_tpu_torch.semantics import (
    SlidingWindowOracle,
    TokenBucketOracle,
)
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_753_000_000_000

# ---------------------------------------------------------------------------
# (a) The device steps
# ---------------------------------------------------------------------------

NUM_SLOTS = 1024
POLICIES = {  # lid -> (algo, config kwargs)
    1: ("sw", dict(max_permits=20, window_ms=1_000)),
    2: ("sw", dict(max_permits=100, window_ms=60_000)),
    3: ("tb", dict(max_permits=50, window_ms=2_000, refill_rate=10.0)),
    4: ("tb", dict(max_permits=5, window_ms=1_000, refill_rate=2.5)),
}
# Window rollover of the 1 s windows, a backward step, and a jump past
# every window (each token bucket refilled to capacity).
NOW = [10_000, 10_400, 10_999, 11_000, 11_600, 10_700, 12_050, 13_999,
       75_000, 75_001]


def _engines():
    ref_table = RefTable()
    for lid in sorted(POLICIES):
        assert ref_table.register(RefConfig(**POLICIES[lid][1])) == lid
    ref = RefEngine(NUM_SLOTS, ref_table)
    port = DeviceEngine(NUM_SLOTS, LimiterTable(device="cpu"), device="cpu")
    load_reference_state(
        port, np.asarray(ref.sw_packed), np.asarray(ref.tb_packed),
        [ref_table.host_policy(l) for l in range(len(ref_table))])
    return ref, ref_table, port


def _lanes(rng, algo, bucket):
    """One call's lanes: live lanes over 40 hot slots (Zipf duplicates)
    and a few never-touched ones, padding (slot -1) among them and at the
    end, limiter ids of the algorithm."""
    lids = [l for l, (a, _) in POLICIES.items() if a == algo]
    n = int(rng.integers(bucket // 2 + 1, bucket + 1))
    slots = np.full(bucket, -1, dtype=np.int64)
    slots[:n] = (rng.zipf(1.3, n) - 1) % 40 * 7
    fresh = rng.random(n) < 0.05
    slots[:n][fresh] = rng.integers(600, NUM_SLOTS, int(fresh.sum()))
    slots[:n][rng.random(n) < 0.05] = -1
    lid = np.zeros(bucket, dtype=np.int64)
    lid[:n] = rng.choice(lids, n)
    return slots, lid, n


def _amounts(rng, slots, lid, n):
    """Requests or credits: zero, negative, around max_permits, small."""
    maxp = np.array([POLICIES[l][1]["max_permits"] if l else 0
                     for l in lid])
    pick = rng.integers(0, 5, len(slots))
    out = np.select(
        [pick == 0, pick == 1, pick == 2],
        [np.zeros(len(slots)), -rng.integers(1, 4, len(slots)),
         maxp + rng.integers(-1, 2, len(slots))],
        rng.integers(1, 12, len(slots))).astype(np.int64)
    out[n:] = 0
    return out


def _ref_step(step, ref, table, algo, *lanes, now):
    packed = "sw_packed" if algo == "sw" else "tb_packed"
    slots, lids, *rest = lanes
    out = step(getattr(ref, packed), table.device_arrays,
               jnp.asarray(slots.astype(np.int32)),
               jnp.asarray(lids.astype(np.int32)),
               *(jnp.asarray(x) for x in rest), jnp.int64(now))
    setattr(ref, packed, out[0])
    return [np.asarray(x) for x in out[1:]]


def _port_step(step, port, algo, *lanes, now):
    packed = port.sw_packed if algo == "sw" else port.tb_packed
    out = step(packed, port.table.device_arrays,
               *(torch.from_numpy(x.copy()) for x in lanes), now)
    return [x.numpy() for x in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("bucket", [32, 1024])
@pytest.mark.parametrize("algo", ["sw", "tb"])
def test_lease_steps_byte_equal_after_every_call(algo, bucket):
    rng = np.random.default_rng(bucket + (0 if algo == "sw" else 1))
    ref, ref_table, port = _engines()
    packed = "sw_packed" if algo == "sw" else "tb_packed"
    ws_seen = {}
    credited_any = written_any = 0
    for now in NOW:
        slots, lid, n = _lanes(rng, algo, bucket)
        req = _amounts(rng, slots, lid, n)
        want = _ref_step(ref_lease.RESERVE_STEPS[algo], ref, ref_table, algo,
                         slots, lid, req, now=now)
        got = _port_step(lease.RESERVE_STEPS[algo], port, algo, slots, lid,
                         req, now=now)
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(getattr(port, packed).numpy(),
                                      np.asarray(getattr(ref, packed)))
        for s, ws in zip(slots[:n], got[1][:n]):
            ws_seen.setdefault(int(s), []).append(int(ws))
        written_any += int(got[0].sum())

        # Credits a little later: the charged window, a stale one (a
        # window earlier), or none at all.
        slots, lid, n = _lanes(rng, algo, bucket)
        cr = _amounts(rng, slots, lid, n)
        gws = np.zeros(bucket, dtype=np.int64)
        for j in range(n):
            seen = ws_seen.get(int(slots[j]), [0])
            gws[j] = (seen[-1] - 1_000 if rng.random() < 0.2
                      else seen[int(rng.integers(0, len(seen)))])
        want = _ref_step(ref_lease.CREDIT_STEPS[algo], ref, ref_table, algo,
                         slots, lid, cr, gws, now=now + 3)
        got = _port_step(lease.CREDIT_STEPS[algo], port, algo, slots, lid,
                         cr, gws, now=now + 3)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(getattr(port, packed).numpy(),
                                      np.asarray(getattr(ref, packed)))
        credited_any += int(got[0].sum())
    assert written_any > 0 and credited_any > 0


@pytest.mark.parametrize("algo", ["sw", "tb"])
def test_engine_lease_calls_pad_and_return_their_lanes(algo):
    """The engines' ``lease_reserve`` / ``lease_credit`` pad each call to
    its bucket (1, 5, 33 and 300 lanes) and return numpy arrays of the
    call's length, equal to the reference's."""
    rng = np.random.default_rng(11)
    ref, _, port = _engines()
    lids = [l for l, (a, _) in POLICIES.items() if a == algo]
    for i, n in enumerate((1, 5, 33, 300, 300)):
        now = 20_000 + 400 * i
        slots = (rng.zipf(1.3, n) - 1) % 50
        lid = rng.choice(lids, n)
        req = rng.integers(-2, 30, n)
        want = ref.lease_reserve(algo, slots, lid, req, now)
        got = port.lease_reserve(algo, slots, lid, req, now)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.shape == (n,)
            np.testing.assert_array_equal(g, w)
        cr = rng.integers(-2, 20, n)
        want = ref.lease_credit(algo, slots, lid, cr, got[1], now + 1)
        got = port.lease_credit(algo, slots, lid, cr, got[1], now + 1)
        assert got.shape == (n,)
        np.testing.assert_array_equal(got, want)
        for packed in ("sw_packed", "tb_packed"):
            np.testing.assert_array_equal(getattr(port, packed).numpy(),
                                          np.asarray(getattr(ref, packed)))


# ---------------------------------------------------------------------------
# (b) The storage, the manager and the client
# ---------------------------------------------------------------------------

class Fenced:
    """A storage seen through a fence epoch the test moves: the manager
    reads ``fence_info`` / ``lease_scope_epoch`` from here (one scope for
    every key), and everything else from the storage."""

    def __init__(self, storage):
        self._storage = storage
        self.epoch = 0

    def fence_info(self):
        return {"epoch": self.epoch}

    def lease_scope_epoch(self, lid, key):
        return self.epoch

    def __getattr__(self, name):
        return getattr(self._storage, name)


def _package(port: bool):
    pkg = ref_leases if not port else leases

    def storage(clock, host_parallel, num_slots=1024, **kw):
        kw.update(num_slots=num_slots, clock_ms=lambda: clock["t"],
                  host_parallel=host_parallel)
        if port:
            return GpuBatchedStorage(device="cpu", **kw)
        return TpuBatchedStorage(**kw)

    return types.SimpleNamespace(
        port=port, storage=storage,
        Config=RateLimitConfig if port else RefConfig,
        Manager=pkg.LeaseManager, Client=pkg.LeaseClient,
        Transport=pkg.DirectTransport,
        Registry=MeterRegistry if port else RefRegistry)


PACKAGES = (_package(False), _package(True))


def _both(scenario, host_parallel):
    """Run ``scenario(pkg, host_parallel)`` on the reference and on the
    port; their transcripts must be equal.  Returns the port's."""
    require_reference_native()
    ref, port = (scenario(pkg, host_parallel) for pkg in PACKAGES)
    assert port == ref
    return port


def _avail(st, algo, lid, key):
    return int(st.available_many(algo, lid, [key])[0])


def _stream(pkg, hp):
    clock = {"t": T0}
    st = pkg.storage(clock, hp)
    sw = dict(max_permits=20, window_ms=2000, enable_local_cache=False)
    tb = dict(max_permits=50, window_ms=2000, refill_rate=10.0)
    lsw = st.register_limiter("sw", pkg.Config(**sw))
    ltb = st.register_limiter("tb", pkg.Config(**tb))
    osw = SlidingWindowOracle(RateLimitConfig(**sw))
    otb = TokenBucketOracle(RateLimitConfig(**tb))
    rng = random.Random(hp)
    ws_store = {}
    out = []
    try:
        for step in range(200):
            clock["t"] += rng.choice([1, 7, 250, 999, 2000, 2501])
            now = clock["t"]
            key = f"k{rng.randrange(4)}"
            kind = rng.choice(["res_sw", "res_tb", "cred_sw", "cred_tb"])
            if kind == "res_sw":
                req = rng.randrange(-1, 30)
                got = st.lease_reserve("sw", lsw, key, req)
                assert (got["granted"], got["ws"]) == osw.reserve(
                    key, req, now), (step, kind)
                ws_store[key] = got["ws"]
            elif kind == "res_tb":
                req = rng.randrange(-1, 60)
                got = st.lease_reserve("tb", ltb, key, req)
                assert got["granted"] == otb.reserve(key, req, now)[0], (
                    step, kind)
            elif kind == "cred_sw":
                ws = ws_store.get(key, 0)
                c = rng.randrange(-1, 10)
                got = st.lease_credit("sw", lsw, key, c, ws)
                assert got["credited"] == osw.credit(key, c, ws, now), (
                    step, kind)
            else:
                c = rng.randrange(-1, 20)
                got = st.lease_credit("tb", ltb, key, c, 0)
                assert got["credited"] == otb.credit(key, c, 0, now), (
                    step, kind)
            avail = (_avail(st, "sw", lsw, key), _avail(st, "tb", ltb, key))
            assert avail == (osw.get_available_permits(key, now),
                             otb.get_available_permits(key, now)), step
            out.append((kind, key, got, avail))
    finally:
        st.close()
    return out


def _duplicates(pkg, hp):
    clock = {"t": T0}
    st = pkg.storage(clock, hp)
    lid = st.register_limiter("tb", pkg.Config(
        max_permits=25, window_ms=2000, refill_rate=8.0))
    try:
        slot = st._assign_slot("tb", lid, "dup", hold_pin=False)
        granted, ws = st.engine.lease_reserve(
            "tb", [slot, slot], [lid, lid], [20, 20], clock["t"])
        return [int(g) for g in granted], [int(w) for w in ws]
    finally:
        st.close()


def _one_lease_per_key(pkg, hp):
    clock = {"t": T0}
    st = pkg.storage(clock, hp)
    lid = st.register_limiter("tb", pkg.Config(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    mgr = pkg.Manager(st, default_budget=16, ttl_ms=1000.0,
                      record_ops=True, clock_ms=lambda: clock["t"])
    try:
        out = [tuple(mgr.grant(lid, "k", 16))]
        # A second grant on a live lease is refused (one burner a key).
        out.append(tuple(mgr.grant(lid, "k", 16)))
        clock["t"] += 5
        # Renew credits the unused remainder and charges again.
        out.append(tuple(mgr.renew(lid, "k", used=10)))
        out.append(_avail(st, "tb", lid, "k"))
        clock["t"] += 5
        mgr.release(lid, "k", used=4)
        out += [_avail(st, "tb", lid, "k"), mgr.status(), mgr.ops]
        return out
    finally:
        st.close()


def _sw_ttl_clamp(pkg, hp):
    clock = {"t": (T0 // 2000) * 2000 + 1500}  # 500 ms left in the window
    st = pkg.storage(clock, hp)
    lid = st.register_limiter("sw", pkg.Config(
        max_permits=100, window_ms=2000, enable_local_cache=False))
    mgr = pkg.Manager(st, default_budget=8, ttl_ms=60_000.0,
                      record_ops=True, clock_ms=lambda: clock["t"])
    try:
        g = mgr.grant(lid, "k", 8)
        clock["t"] += 600  # the charged window rolled: no credit lands
        mgr.release(lid, "k", used=2)
        return [tuple(g), _avail(st, "sw", lid, "k"), mgr.status(), mgr.ops]
    finally:
        st.close()


def _fence_epoch(pkg, hp):
    clock = {"t": T0}
    raw = pkg.storage(clock, hp)
    st = Fenced(raw)
    lid = raw.register_limiter("tb", pkg.Config(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    registry = pkg.Registry()
    mgr = pkg.Manager(st, default_budget=16, ttl_ms=10_000.0,
                      record_ops=True, clock_ms=lambda: clock["t"],
                      registry=registry)
    try:
        out = [tuple(mgr.grant(lid, "k", 16))]
        st.epoch = 3
        clock["t"] += 10
        out.append(mgr.renew(lid, "k", used=5))  # revoked: None
        out.append(tuple(mgr.grant(lid, "k", 16)))
        meters = registry.scrape()
        out += [meters["ratelimiter.lease.revoked"],
                meters["ratelimiter.lease.over_admission"],
                _avail(raw, "tb", lid, "k"), mgr.status(), mgr.ops]
        return out
    finally:
        raw.close()


def _fence_epoch_real(pkg, hp, advance):
    """:func:`_fence_epoch` over the storage itself: ``advance`` moves its
    fence epoch to 3 (a fence and its lift, or a serving-lease grant),
    which the manager reads from ``lease_scope_epoch``; then a fenced
    storage revokes the renewal (the epoch moved on) and refuses a grant
    (``FencedError``), charging nothing, and the manager grants again
    after the lift."""
    clock = {"t": T0}
    st = pkg.storage(clock, hp)
    lid = st.register_limiter("tb", pkg.Config(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    registry = pkg.Registry()
    mgr = pkg.Manager(st, default_budget=16, ttl_ms=10_000.0,
                      record_ops=True, clock_ms=lambda: clock["t"],
                      registry=registry)
    try:
        out = [tuple(mgr.grant(lid, "k", 16))]
        advance(st)
        clock["t"] += 10
        out.append(mgr.renew(lid, "k", used=5))  # revoked: None
        out.append(tuple(mgr.grant(lid, "k", 16)))
        st.fence(4)
        clock["t"] += 10
        out.append(mgr.renew(lid, "k", used=2))  # fenced: revoked
        out.append(tuple(mgr.grant(lid, "j", 16)))  # fenced: denied
        st.lift_fence(4)
        out.append(tuple(mgr.grant(lid, "j", 16)))
        meters = registry.scrape()
        out += [meters["ratelimiter.lease.revoked"],
                meters["ratelimiter.lease.over_admission"],
                _avail(st, "tb", lid, "k"), _avail(st, "tb", lid, "j"),
                st.fence_info(), mgr.status(), mgr.ops]
        return out
    finally:
        st.close()


def _advance_by_fence(st):
    st.fence(3)
    st.lift_fence(3)


def _advance_by_serving_lease(st):
    st.grant_serving_lease(3, 3_600_000.0)


def _table_bound(pkg, hp):
    clock = {"t": T0}
    st = pkg.storage(clock, hp)
    lid = st.register_limiter("tb", pkg.Config(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    mgr = pkg.Manager(st, default_budget=8, ttl_ms=10_000.0, max_leases=2,
                      record_ops=True, clock_ms=lambda: clock["t"])
    try:
        out = [tuple(mgr.grant(lid, k, 8)) for k in "abc"]
        # The refused grant's charge was credited back.
        out += [_avail(st, "tb", lid, "c"), mgr.status(), mgr.ops]
        return out
    finally:
        st.close()


def _replay(ops, oracle):
    for op in ops:
        if op[0] == "reserve":
            _, _a, _l, key, req, granted, _ws, stamp = op
            assert oracle.reserve(key, req, stamp)[0] == granted, op
        else:
            _, _a, _l, key, unused, ws, stamp = op
            oracle.credit(key, unused, ws, stamp)


def _wire_collapse(pkg, hp):
    clock = {"t": T0}
    st = pkg.storage(clock, hp)
    cfg = dict(max_permits=500, window_ms=2000, refill_rate=100.0)
    lid = st.register_limiter("tb", pkg.Config(**cfg))
    mgr = pkg.Manager(st, default_budget=32, ttl_ms=5000.0,
                      record_ops=True, clock_ms=lambda: clock["t"])
    cli = pkg.Client(pkg.Transport(mgr), lid, budget=32,
                     clock_ms=lambda: clock["t"], direct_fallback=False)
    try:
        allowed = 0
        for _ in range(300):
            clock["t"] += 1
            allowed += bool(cli.try_acquire("hot"))
        cli.release_all()
        st.flush()
        oracle = TokenBucketOracle(RateLimitConfig(**cfg))
        _replay(mgr.ops, oracle)
        avail = _avail(st, "tb", lid, "hot")
        assert avail == oracle.get_available_permits("hot", clock["t"])
        return [allowed, cli.wire_ops, cli.local_decisions, avail,
                mgr.status(), mgr.ops]
    finally:
        st.close()


def _contended(pkg, hp):
    clock = {"t": T0}
    st = pkg.storage(clock, hp)
    lid = st.register_limiter("tb", pkg.Config(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    mgr = pkg.Manager(st, default_budget=16, ttl_ms=10_000.0,
                      record_ops=True, clock_ms=lambda: clock["t"])
    holder = pkg.Client(pkg.Transport(mgr), lid, budget=16,
                        clock_ms=lambda: clock["t"])
    contender = pkg.Client(pkg.Transport(mgr), lid, budget=16,
                           clock_ms=lambda: clock["t"],
                           direct_fallback=True)
    try:
        out = [holder.try_acquire("shared"), contender.try_acquire("shared")]
        clock["t"] += 30  # past the deny hint: the contender asks again
        out += [contender.try_acquire("shared") for _ in range(5)]
        out += [contender.wire_ops, contender.local_decisions,
                _avail(st, "tb", lid, "shared")]
        holder.release_all()
        contender.release_all()
        out += [_avail(st, "tb", lid, "shared"), mgr.status(), mgr.ops]
        return out
    finally:
        st.close()


HOST_PARALLEL = [0, 4]


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_reserve_credit_stream_matches_reference_and_oracle(host_parallel):
    out = _both(_stream, host_parallel)
    kinds = {kind for kind, *_ in out}
    assert kinds == {"res_sw", "res_tb", "cred_sw", "cred_tb"}
    assert any(o[2].get("credited", 0) > 0 for o in out)


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_duplicate_slots_grant_greedily(host_parallel):
    """One batch reserving the same slot twice grants sequentially:
    two back-to-back oracle reserves at one timestamp."""
    granted, ws = _both(_duplicates, host_parallel)
    assert granted == [20, 5] and ws == [0, 0]


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_manager_one_lease_per_key_and_release(host_parallel):
    first, second, renewed, avail, avail_after, status, ops = _both(
        _one_lease_per_key, host_parallel)
    assert first[0] == 16 and second[0] == 0 and renewed[0] == 16
    assert avail == 100 - 10 - 16 and avail_after == 100 - 14
    assert status["outstanding"] == 0
    assert [op[0] for op in ops] == ["reserve", "credit", "reserve",
                                     "credit"]


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_manager_sw_ttl_clamps_to_remaining_window(host_parallel):
    grant, avail, status, ops = _both(_sw_ttl_clamp, host_parallel)
    assert grant[0] == 8 and grant[1] <= 500  # the lease ends with the window
    assert ops[0][6] == ops[1][5] > 0  # the credit presents the charged ws
    assert status["outstanding"] == 0


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_manager_fence_epoch_revokes_on_renew(host_parallel):
    (first, renewed, regrant, revoked, over, avail, status,
     ops) = _both(_fence_epoch, host_parallel)
    assert first[0] == 16 and first[2] == 0
    assert renewed is None  # revoked
    assert regrant[0] == 16 and regrant[2] == 3
    assert (revoked, over) == (1.0, 5.0)
    assert status["revoked"] == 1 and status["over_admission"] == 5


@pytest.mark.parametrize("advance", [_advance_by_fence,
                                     _advance_by_serving_lease],
                         ids=["fence", "serving_lease"])
@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_manager_reads_the_storage_fence_epoch(host_parallel, advance):
    """The counterpart of the ``Fenced`` double over the storage's own
    epoch: the same grants, revocations and stamps on both packages."""
    out = _both(lambda pkg, hp: _fence_epoch_real(pkg, hp, advance),
                host_parallel)
    first, renewed, regrant, renewed_fenced, denied, again = out[:6]
    assert first[0] == 16 and first[2] == 0
    assert renewed is None and regrant[0] == 16 and regrant[2] == 3
    assert renewed_fenced is None and denied[0] == 0
    assert again[0] == 16 and again[2] == 4
    assert out[10]["epoch"] == 4 and out[10]["rejected"] == 1


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_manager_table_bound_refuses_and_uncharges(host_parallel):
    a, b, c, avail_c, status, ops = _both(_table_bound, host_parallel)
    assert (a[0], b[0], c[0]) == (8, 8, 0)
    assert avail_c == 100 and status["outstanding"] == 2


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_client_wire_collapse_and_oracle_replay(host_parallel):
    allowed, wire_ops, local, avail, status, ops = _both(_wire_collapse,
                                                         host_parallel)
    assert allowed == 300 and wire_ops * 10 <= 300
    assert status["outstanding"] == 0 and len(ops) >= 300 // 32


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_client_falls_back_per_decision_on_contended_key(host_parallel):
    out = _both(_contended, host_parallel)
    assert out[0] and out[1]      # holder leased; contender per decision
    wire_ops, local = out[7], out[8]
    assert wire_ops >= 2 and local == 0


# ---------------------------------------------------------------------------
# (c) Eviction order on a full table (ROADMAP C8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_fresh_key_grants_on_a_full_table_equal_the_oracle(algo,
                                                           host_parallel):
    """A 64-slot table full of per-decision keys charged 90 of 100
    permits: each of 300 fresh keys reserves 64 (the assignment evicts a
    charged key), and its credit of a random remainder follows while
    per-decision traffic on other fresh keys waits in the batcher.  Every
    grant, credit and availability equals the oracle's: the reserve never
    reads the evicted key's row, and no queued clear lands on the slot
    after it."""
    clock = {"t": T0}
    st = GpuBatchedStorage(num_slots=64, max_delay_ms=50, device="cpu",
                           host_parallel=host_parallel,
                           clock_ms=lambda: clock["t"])
    cfg = (dict(max_permits=100, window_ms=60_000, refill_rate=10.0)
           if algo == "tb" else
           dict(max_permits=100, window_ms=60_000, enable_local_cache=False))
    lid = st.register_limiter(algo, RateLimitConfig(**cfg))
    oracle = (TokenBucketOracle if algo == "tb"
              else SlidingWindowOracle)(RateLimitConfig(**cfg))
    rng = random.Random(5)
    try:
        for i in range(200):
            assert st.acquire(algo, lid, f"per{i}", 90)["allowed"]
        pending = []
        for i in range(300):
            clock["t"] += 1
            key = f"lease{i}"
            got = st.lease_reserve(algo, lid, key, 64)
            assert (got["granted"], got["ws"]) == oracle.reserve(
                key, 64, got["stamp"]), i
            assert got["granted"] == 64
            pending.append(st.acquire_async(algo, lid, f"more{i}", 90))
            unused = rng.randrange(0, 65)
            cred = st.lease_credit(algo, lid, key, unused, got["ws"])
            assert cred["credited"] == oracle.credit(
                key, unused, got["ws"], cred["stamp"]), i
            assert _avail(st, algo, lid, key) == \
                oracle.get_available_permits(key, clock["t"]), i
        assert all(f.result(timeout=30)["allowed"] for f in pending)
    finally:
        st.close()
