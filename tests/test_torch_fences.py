"""Fences, the serving lease and the promotion window of the port's
storage, against the JAX package's, on the CPU.

- ``fence`` is monotonic and refuses every decision surface the port
  has, the lease calls included, with ``FencedError`` on every index kind
  (one C index, partitions, the keyed index); a stale fence or lift
  raises ``ValueError``; ``lift_fence`` re-arms.
- The serving lease: monotonic grants, self-fencing on the first decision
  past its deadline on a manual clock, no resurrection by a grant, the
  operator's re-arm, an explicit fence superseding it, a graceful
  release; ``fence_info`` / ``serving_lease_info`` / ``lease_scope_epoch``
  equal the reference's at every step, and the flight recorder's events.
- ``promote_from_replica`` rebuilds a standby's index from the primary's
  dump while every decision surface refuses with
  ``PromotionInProgressError``; afterwards the standby decides as the
  primary.

The surfaces' fenced and promotion refusals count the same on both
packages.  Every storage pair pins ``host_parallel``.
"""

import threading

import numpy as np
import pytest
import torch

from ratelimiter_tpu.engine import checkpoint as ref_ckpt
from ratelimiter_tpu.observability.flightrecorder import (
    FlightRecorder as RefRecorder,
)
from ratelimiter_tpu.storage.errors import FencedError as RefFencedError
from ratelimiter_tpu.storage.errors import (
    PromotionInProgressError as RefPromotionError,
)
from ratelimiter_tpu_torch.engine import checkpoint as ckpt
from ratelimiter_tpu_torch.observability.flightrecorder import (
    FlightRecorder,
)
from ratelimiter_tpu_torch.storage.errors import (
    FencedError,
    PromotionInProgressError,
)
from test_torch_checkpoint import (
    LIDS,
    T0,
    close,
    oracle,
    plan,
    run,
    same,
    same_storages,
    storage,
)
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
)

torch.set_num_threads(1)

INDEXES = {"native": dict(host_parallel=0),
           "partitioned": dict(host_parallel=4),
           "keyed": dict(host_parallel=0, checkpointable=True)}


def surfaces(st):
    """Every decision surface of the port's storage, as the reference's
    storage has it too: (name, call)."""
    tb, sw = LIDS["tb"], LIDS["sw"]
    return [
        ("acquire", lambda: st.acquire("tb", tb, "a", 1)),
        ("acquire_many", lambda: st.acquire_many("tb", [tb], ["a"], [1])),
        ("acquire_many_ids", lambda: st.acquire_many_ids(
            "tb", tb, np.array([1]), np.array([1]))),
        ("acquire_stream_ids", lambda: st.acquire_stream_ids(
            "tb", tb, np.array([1]))),
        ("acquire_stream_ids_permits", lambda: st.acquire_stream_ids(
            "sw", sw, np.array([1, 2]), np.array([2, 3]))),
        ("acquire_stream_strs", lambda: st.acquire_stream_strs(
            "sw", sw, ["a"])),
        ("lease_reserve", lambda: st.lease_reserve("tb", tb, "a", 4)),
        ("lease_credit", lambda: st.lease_credit("tb", tb, "a", 2, 0)),
    ]


def errors(ref: bool):
    return ((RefFencedError, RefPromotionError) if ref
            else (FencedError, PromotionInProgressError))


@pytest.mark.parametrize("index", sorted(INDEXES))
def test_fence_is_monotonic_and_refuses_every_surface(index):
    clock = {"t": T0}
    counts = {}
    for ref in (False, True):
        st = storage(ref, clock, **INDEXES[index])
        fenced, _ = errors(ref)
        try:
            for name, call in surfaces(st):
                call()  # every surface decides before the fence
            assert st.fence(3) == 3
            for name, call in surfaces(st):
                with pytest.raises(fenced):
                    call()
            counts[ref] = (st.fence_rejected, st.fence_info())
            # Monotonic: a stale orchestrator replaying an old epoch is
            # refused, and so is a stale lift.
            with pytest.raises(ValueError, match="monotonic"):
                st.fence(3)
            with pytest.raises(ValueError, match="monotonic"):
                st.fence(2)
            with pytest.raises(ValueError, match="behind"):
                st.lift_fence(2)
            st.lift_fence(3)
            for name, call in surfaces(st):
                call()  # re-armed
            assert st.fence_info()["all"] is False
        finally:
            st.close()
    same(counts[False], counts[True])
    assert counts[False][0] == len(surfaces(None))
    assert counts[False][1] == {"epoch": 3, "all": True, "shards": [],
                                "shard_epochs": {}, "rejected": 8}


def test_fence_refuses_the_hybrid_tier_and_a_scoped_fence_passes():
    """A key the hybrid tier serves host-side is refused like a device
    decision; a shard-scoped fence refuses nothing on one engine (no
    shards), as in the reference, but moves the epoch."""
    clock = {"t": T0}
    for ref in (False, True):
        st = storage(ref, clock, serving_cache=True, max_delay_ms=0.1)
        fenced, _ = errors(ref)
        try:
            for _ in range(3):
                st.acquire("tb", LIDS["tb"], "hot", 1)
            assert st._serving.stats()["served"] > 0
            st.fence(1, shards=(0,))
            assert st.acquire("tb", LIDS["tb"], "hot", 1)["allowed"]
            assert st.fence_info()["epoch"] == 1
            assert st.lease_scope_epoch(LIDS["tb"], "hot") == 1
            st.fence(2)
            with pytest.raises(fenced):
                st.acquire("tb", LIDS["tb"], "hot", 1)
            assert st.fence_rejected == 1
        finally:
            st.close()


def _lease_steps(st, clock, fenced) -> list:
    """The reference's serving-lease scenario, step by step: each step's
    observable state."""
    lid = LIDS["tb"]
    out = [st.serving_lease_info()]
    out.append(st.grant_serving_lease(2, 500.0))
    out.append(st.fence_info()["epoch"])
    out.append(bool(st.acquire("tb", lid, "a", 1)["allowed"]))
    with pytest.raises(ValueError, match="monotonic"):
        st.grant_serving_lease(1, 500.0)
    clock["t"] += 400
    out.append(st.grant_serving_lease(2, 500.0))  # a renewal extends
    clock["t"] += 400  # past the first deadline, inside the renewed one
    out.append(bool(st.acquire("tb", lid, "a", 1)["allowed"]))
    out.append(st.serving_lease_info())
    clock["t"] += 600
    with pytest.raises(fenced):  # the first decision past it self-fences
        st.acquire("tb", lid, "a", 1)
    out.append(st.serving_lease_info())
    for name, call in surfaces(st):
        with pytest.raises(fenced):
            call()
    with pytest.raises(ValueError, match="resurrect"):
        st.grant_serving_lease(9, 500.0)
    out.append((st.fence_info(), st.lease_scope_epoch(lid, "a"),
                st.fence_rejected))
    st.lift_fence(9)  # the operator's exit
    out.append(st.grant_serving_lease(9, 500.0))
    out.append(len(st.acquire_many("tb", [lid], ["a"], [1])["allowed"]))
    out.append(st.release_serving_lease())
    clock["t"] += 10_000  # released, not expired: decisions go on
    out.append(bool(st.acquire("tb", lid, "b", 1)["allowed"]))
    out.append(st.grant_serving_lease(9, 100.0))
    st.fence(12)  # an explicit fence supersedes the lease
    out.append((st.serving_lease_info(), st.fence_info(),
                st.lease_scope_epoch(lid, "a")))
    with pytest.raises(ValueError, match="resurrect"):
        st.grant_serving_lease(13, 500.0)
    return out


def test_serving_lease_is_monotonic_and_expiry_self_fences():
    """The reference's serving-lease cases on both packages, step by step
    equal, with the flight recorder's fence and lease events in the same
    order."""
    clock = {"t": T0}
    outs, events = {}, {}
    for ref in (False, True):
        clock["t"] = T0
        recorder = RefRecorder() if ref else FlightRecorder()
        st = storage(ref, clock, observability=True, recorder=recorder)
        try:
            outs[ref] = _lease_steps(st, clock, errors(ref)[0])
        finally:
            st.close()
        events[ref] = [(e["kind"], e.get("epoch"))
                       for e in recorder.events()
                       if e["kind"].split(".")[0] in ("fence", "lease")]
    same(outs[False], outs[True])
    assert outs[False][7]["self_fenced"] is True
    assert events[False] == events[True]
    assert [k for k, _ in events[False]] == [
        "fence.lease_expired", "fence.lifted", "lease.released",
        "fence.installed"]


def test_lease_scope_epoch_unsharded_tracks_full_fence():
    clock = {"t": T0}
    for ref in (False, True):
        st = storage(ref, clock)
        try:
            lid = LIDS["tb"]
            e0 = st.lease_scope_epoch(lid, "k")
            st.fence(5)
            st.lift_fence(5)
            assert st.lease_scope_epoch(lid, "k") >= max(e0, 5)
            assert (st.lease_scope_epoch(lid, "other")
                    == st.lease_scope_epoch(lid, "k"))
            st.grant_serving_lease(7, 1000.0)
            assert st.lease_scope_epoch(lid, "k") == 7
        finally:
            st.close()


def _standby(ref, clock, primary, **kw):
    """A standby of ``primary``'s geometry holding its rows (as a
    replication stream leaves one: the state without the index)."""
    st = storage(ref, clock, **kw)
    snap = (ckpt if not ref else ref_ckpt).snapshot_engine_state(
        primary.engine)
    arrays = {f"{a}_{f}": v for a in ("sw", "tb")
              for f, v in snap[a].items()}
    (ckpt if not ref else ref_ckpt).restore_engine_state(
        st.engine, {"meta": snap["meta"], "arrays": arrays})
    return st


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_promotion_refuses_racing_dispatch(monkeypatch, host_parallel):
    """A decision racing ``promote_from_replica`` gets the typed,
    retryable refusal on every surface; after the window the standby
    decides as the primary does."""
    rng = np.random.default_rng(21)
    clock = {"t": T0}
    calls = plan(rng, 4, 300)
    after = plan(rng, 4, 300)
    refused = {}
    for ref in (False, True):
        pkg = ref_ckpt if ref else ckpt
        _, promoting = errors(ref)
        primary = storage(ref, clock, host_parallel=host_parallel)
        standby = None
        try:
            run([primary], "tb", calls, clock, oracle("tb"))
            standby = _standby(ref, clock, primary,
                               host_parallel=host_parallel,
                               serving_cache=True)
            in_restore, release = threading.Event(), threading.Event()
            real = pkg.restore_slot_indexes

            def slow_restore(storage_, dump, real=real, gate=in_restore,
                             go=release):
                gate.set()
                assert go.wait(10.0)
                return real(storage_, dump)

            monkeypatch.setattr(pkg, "restore_slot_indexes", slow_restore)
            dump = pkg.dump_slot_indexes(primary)
            t = threading.Thread(target=standby.promote_from_replica,
                                 args=(dump,), daemon=True)
            t.start()
            assert in_restore.wait(10.0)
            n = 0
            for name, call in surfaces(standby):
                with pytest.raises(promoting):
                    call()
                n += 1
            release.set()
            t.join(timeout=10.0)
            assert not t.is_alive()
            monkeypatch.setattr(pkg, "restore_slot_indexes", real)
            refused[ref] = (n, standby.fence_rejected)
            same_storages(standby, primary)
            run([standby, primary], "tb", after, clock)
            same_storages(standby, primary)
        finally:
            close(primary, *([standby] if standby is not None else []))
    assert refused[False] == refused[True] == (len(surfaces(None)), 0)


def test_promotion_forgets_the_hybrid_tier():
    clock = {"t": T0}
    primary = storage(False, clock)
    standby = storage(False, clock, serving_cache=True, max_delay_ms=0.1)
    try:
        for _ in range(3):
            standby.acquire("tb", LIDS["tb"], "hot", 1)
        assert standby._serving.stats()["tracked"] == 1
        standby.promote_from_replica(ckpt.dump_slot_indexes(primary))
        assert standby._serving.stats()["tracked"] == 0
    finally:
        close(primary, standby)
