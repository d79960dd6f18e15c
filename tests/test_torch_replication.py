"""The port's flat replication against the JAX package's, on the CPU.

- The journals: ``SlotJournal`` and ``DeviceSlotJournal`` (on CPU
  tensors) drain what the reference's ``SlotJournal`` drains — padding -1,
  ids out of range, ``mark_all``, ``pending``, the oldest stamp, and relay
  words whose slot sets bit 31 beside the all-ones padding word.
- Every dispatch path of the engine marks its slots: micro, relay digest,
  resident digest, words, weighted, coalesced, flat fallback, flat, scan,
  lease reserve and credit, reset, ``write_rows``, the state views.  On
  the same traffic both packages' journals drain the same ids, journal
  kind pinned on both sides, one index and four partitions.
- Frames: both packages encode equal bytes from the same traffic (the
  wall stamps pinned), a frame of either applies in the other with the
  primary's fingerprint, chunking, bad magic.
- The flat cases of ``tests/test_replication.py`` on the port: continuous
  and stream convergence, the failover drill, checkpoint then catch-up,
  epoch gaps, ship failure, geometry, TCP failover and reconnects, the
  wiring, the gauge, heartbeats and a silently dead standby.

Every socket wait is bounded (ack deadlines of a second or less, polls).
Every comparison is exact.
"""

import contextlib
import copy
import random
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine.state import DeviceSlotJournal as RefDeviceJournal
from ratelimiter_tpu.engine.state import SlotJournal as RefSlotJournal
from ratelimiter_tpu.replication import log as ref_log_mod
from ratelimiter_tpu.replication import (
    ReplicationLog as RefReplicationLog,
)
from ratelimiter_tpu.replication import StandbyReceiver as RefReceiver
from ratelimiter_tpu.replication import encode_frame as ref_encode
from ratelimiter_tpu.replication import (
    engine_state_fingerprint as ref_fingerprint,
)
from ratelimiter_tpu.storage import tpu as ref_storage_mod
from ratelimiter_tpu.storage.chaos import FaultInjectingProxy
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine.state import DeviceSlotJournal, SlotJournal
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.replication import (
    FrameArchive,
    InProcessSink,
    ReplicationLog,
    ReplicationServer,
    ReplicationStateError,
    Replicator,
    SocketSink,
    StandbyReceiver,
    TeeSink,
    chunk_frames,
    decode_frame,
    device_journal_elected,
    encode_frame,
    engine_state_fingerprint,
    make_journal,
)
from ratelimiter_tpu_torch.replication import log as log_mod
from ratelimiter_tpu_torch.semantics import SlidingWindowOracle
from ratelimiter_tpu_torch.storage import gpu as gpu_mod
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_753_000_000_000
KINDS = ("host", "device")
ON_BOTH = pytest.mark.parametrize(
    "kind,host_parallel", [(k, hp) for hp in (0, 4) for k in KINDS],
    ids=[f"{k}-hp{hp}" for hp in (0, 4) for k in KINDS])


def port_storage(clock, num_slots=512, host_parallel=0, **kw):
    return GpuBatchedStorage(num_slots=num_slots, clock_ms=lambda: clock["t"],
                             device="cpu", host_parallel=host_parallel, **kw)


def ref_storage(clock, num_slots=512, host_parallel=0, **kw):
    require_reference_native()
    return TpuBatchedStorage(num_slots=num_slots, clock_ms=lambda: clock["t"],
                             host_parallel=host_parallel, **kw)


def make_pair(num_slots=512, clock=None, **kw):
    clock = clock if clock is not None else {"t": T0}
    return (clock, port_storage(clock, num_slots, **kw),
            port_storage(clock, num_slots, **kw))


def assert_same_state(a, b, algos=("sw", "tb")):
    fa, fb = engine_state_fingerprint(a.engine), engine_state_fingerprint(
        b.engine)
    for algo in algos:
        np.testing.assert_array_equal(fa[algo], fb[algo])


def fingerprint(storage) -> dict:
    """Either package's ``engine_state_fingerprint`` of a storage."""
    if isinstance(storage, GpuBatchedStorage):
        return engine_state_fingerprint(storage.engine)
    return ref_fingerprint(storage.engine)


def drained(journal) -> dict:
    ids, _, was_all = journal.drain()
    return {a: np.asarray(v).tolist() for a, v in ids.items()}, was_all


@contextlib.contextmanager
def pinned_stamps(monkeypatch):
    """Both logs' cut stamps and the npz archive's member times held
    still, so two encodings of the same frame are byte-equal."""
    real = time

    class _Time:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def time():
            return 1_753_000_000.0

    monkeypatch.setattr(log_mod, "_wall_ms", lambda: T0)
    monkeypatch.setattr(ref_log_mod, "_wall_ms", lambda: T0)
    monkeypatch.setattr(zipfile, "time", _Time())
    yield


# ---------------------------------------------------------------------------
# Journals
# ---------------------------------------------------------------------------

def port_journal(kind, num_slots):
    return (SlotJournal(num_slots) if kind == "host"
            else DeviceSlotJournal(num_slots, device="cpu"))


@pytest.mark.parametrize("kind", KINDS)
def test_journal_marks_and_drains(kind):
    """``tests/test_replication.py:59`` on the port's journals, every
    drain equal to the reference ``SlotJournal``'s on the same marks."""
    journals = [RefSlotJournal(64), port_journal(kind, 64)]
    for j in journals:
        j.mark("sw", [3, 5, 5, -1, 999, -7, 64, 63, 1 << 40])
        j.mark("tb", np.array([7], dtype=np.int32))
        j.mark("tb", np.array([], dtype=np.int64))
    assert [j.pending() for j in journals] == [4, 4]
    outs = []
    for j in journals:
        ids, oldest, was_all = j.drain()
        assert oldest is not None and not was_all
        outs.append({a: sorted(v.tolist()) for a, v in ids.items()})
    assert outs[0] == outs[1] == {"sw": [3, 5, 63], "tb": [7]}
    for j in journals:
        ids, oldest, _ = j.drain()
        assert ids == {} and oldest is None
        j.mark_all("sw")
        assert j.pending() == 64
        ids, oldest, was_all = j.drain()
        assert was_all and oldest is not None
        assert ids["sw"].tolist() == list(range(64)) and "tb" not in ids
        assert j.pending() == 0


@pytest.mark.parametrize("kind", KINDS)
def test_journal_words_with_bit_31(kind):
    """Relay words of a table past 2^(slot_bits - 1) slots: a slot at or
    above 2^12 in a 4097-slot table sets bit 31 of its word.  Marked from
    uint32 host words and (device journal) from the int32 tensor of the
    same bits the engine uploads, the port drains what the reference's
    host and device journals drain; the all-ones padding word marks
    nothing."""
    num_slots = (1 << 12) + 1
    slot_bits = num_slots.bit_length()
    rank_bits = 31 - slot_bits
    slots = np.array([0, 1, 2047, 4095, 4096, 4096, 3000], dtype=np.uint32)
    counts = np.array([1, 5, 0, 3, 2, 7, (1 << rank_bits) - 1],
                      dtype=np.uint32)
    words = np.r_[(slots << np.uint32(rank_bits + 1))
                  | (counts << np.uint32(1)) | np.uint32(1),
                  np.full(5, 0xFFFFFFFF, dtype=np.uint32)].astype(np.uint32)
    assert (words[4] >> 31) == 1
    ref_host, ref_dev = RefSlotJournal(num_slots), RefDeviceJournal(num_slots)
    ref_host.mark_words("tb", words, rank_bits)
    ref_dev.mark_words("tb", jnp.asarray(words), rank_bits)
    port = port_journal(kind, num_slots)
    port.mark_words("tb", words, rank_bits)
    want = drained(ref_host)
    assert want == ({"tb": [0, 1, 2047, 3000, 4095, 4096]}, False)
    assert drained(ref_dev) == want
    assert drained(port) == want
    if kind == "device":
        port.mark_words("sw", torch.from_numpy(words.view(np.int32)),
                        rank_bits)
        assert drained(port) == ({"sw": want[0]["tb"]}, False)


@pytest.mark.parametrize("kind", KINDS)
def test_journal_loses_no_mark_under_concurrent_drains(kind):
    """More marking threads than cores race a draining thread, with a short
    switch interval: the union of every drain equals the union of every
    mark (a mark racing a swap lands in this epoch or the next, never
    nowhere)."""
    import os
    import sys

    num_slots, workers = 1 << 14, (os.cpu_count() or 4) + 2
    journal = port_journal(kind, num_slots)
    rng = np.random.default_rng(11)
    batches = [[rng.integers(-3, num_slots + 3, 64) for _ in range(40)]
               for _ in range(workers)]
    drained_ids = {"sw": set(), "tb": set()}
    stop = threading.Event()

    def mark(w):
        for i, batch in enumerate(batches[w]):
            algo = ("sw", "tb")[(w + i) % 2]
            if kind == "device" and i % 3 == 0:
                journal.mark(algo, torch.from_numpy(batch))
            else:
                journal.mark(algo, batch)

    def drain():
        while True:
            done = stop.is_set()
            for algo, ids in journal.drain()[0].items():
                drained_ids[algo].update(ids.tolist())
            if done:
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        drainer = threading.Thread(target=drain)
        drainer.start()
        threads = [threading.Thread(target=mark, args=(w,))
                   for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        drainer.join(timeout=60)
        assert not drainer.is_alive()
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    want = {"sw": set(), "tb": set()}
    for w in range(workers):
        for i, batch in enumerate(batches[w]):
            live = batch[(batch >= 0) & (batch < num_slots)]
            want[("sw", "tb")[(w + i) % 2]].update(live.tolist())
    assert drained_ids == want
    assert journal.pending() == 0


# ---------------------------------------------------------------------------
# Every dispatch path marks (both packages, same ids)
# ---------------------------------------------------------------------------

CFG_TB = dict(max_permits=30, window_ms=2_000, refill_rate=10.0)
CFG_SW = dict(max_permits=40, window_ms=2_000, enable_local_cache=False)


class Both:
    """A reference and a port storage on one clock with the same limiters
    (tb lids 1-2, sw lids 3-4) and the same host index, each journaled by
    its own package's ``ReplicationLog`` of journal ``kind``."""

    def __init__(self, kind, host_parallel, num_slots):
        self.clock = {"t": T0}
        self.ref = ref_storage(self.clock, num_slots, host_parallel,
                               observability=False)
        self.port = port_storage(self.clock, num_slots, host_parallel)
        self.lids = {}
        for algo, cfgs in (("tb", (CFG_TB, dict(CFG_TB, max_permits=9))),
                           ("sw", (CFG_SW, dict(CFG_SW, max_permits=9)))):
            for cfg in cfgs:
                lid = self.ref.register_limiter(algo, RefConfig(**cfg))
                assert self.port.register_limiter(
                    algo, RateLimitConfig(**cfg)) == lid
                self.lids.setdefault(algo, []).append(lid)
        self.ref_log = RefReplicationLog(self.ref, journal_kind=kind)
        self.port_log = ReplicationLog(self.port, journal_kind=kind)
        assert self.ref_log.journal_kind == self.port_log.journal_kind == kind

    def both(self, fn):
        """``fn(storage)`` on each; returns the two results."""
        return fn(self.ref), fn(self.port)

    def same_marks(self, what):
        """Flush both, drain both journals: equal ids; returns them."""
        self.ref.flush()
        self.port.flush()
        want = drained(self.ref_log.journal)
        got = drained(self.port_log.journal)
        assert got == want, what
        return got[0]

    def close(self):
        self.ref.close()
        self.port.close()


@pytest.fixture
def small_chunks(monkeypatch):
    """Stream chunks of 256 growing to 2048 requests and flat steps of
    512 lanes in both storages (words mode and the flat fallback at a
    test's size)."""
    for mod in (ref_storage_mod, gpu_mod):
        monkeypatch.setattr(mod, "_RELAY_CHUNK", 256)
        monkeypatch.setattr(mod, "_RELAY_CHUNK_MAX", 2048)
        monkeypatch.setattr(mod, "_FLAT_MAX_LANES", 512)


def _zipf(rng, n, n_keys):
    return ((rng.zipf(1.1, n) - 1) % n_keys).astype(np.int64)


@ON_BOTH
def test_every_dispatch_path_marks_like_reference(kind, host_parallel,
                                                  small_chunks):
    """``tests/test_replication.py:76`` widened to every route: after each
    call both journals drain the same ids.  4100 slots, so the relay
    words of slots 4096-4099 set bit 31, and 6000-key uniform traffic
    fills the table (evictions clear, and mark, too)."""
    rng = np.random.default_rng(7 + host_parallel + (kind == "device"))
    b = Both(kind, host_parallel, num_slots=4100)
    tb, tb9 = b.lids["tb"]
    sw, sw9 = b.lids["sw"]
    modes = set()

    def stream(algo, lid, keys, permits=None, **kw):
        b.clock["t"] += 300
        want, got = b.both(lambda st: np.asarray(st.acquire_stream_ids(
            algo, lid, keys, permits, **kw)))
        np.testing.assert_array_equal(got, want)
        modes.update(c["mode"] for c in b.port.last_stream_chunks)

    try:
        def micro(st):
            st.acquire("sw", sw, "solo", 1)
            return st.acquire_many("tb", [tb] * 6, list("abcdea"),
                                   [1, 2, 3, 1, 40, 1])["allowed"]
        b.clock["t"] += 5
        want, got = b.both(micro)
        np.testing.assert_array_equal(got, want)
        marks = b.same_marks("micro")
        assert len(marks["tb"]) == 5 and len(marks["sw"]) == 1
        uniform = rng.permutation(np.r_[rng.integers(0, 6_000, 2_970),
                                        np.full(30, 7)])
        stream("tb", tb, uniform)
        assert "words" in modes
        b.same_marks("words")
        stream("tb", tb, np.arange(6_000, 10_200))      # fill, evictions
        marks = b.same_marks("fill")
        assert max(marks["tb"]) >= 4096                 # bit-31 words
        stream("sw", sw, _zipf(rng, 3_000, 300))
        assert "relay" in modes
        b.same_marks("relay")
        keys = _zipf(rng, 2_000, 200)
        stream("tb", np.asarray([tb, tb9])[keys % 2], keys)
        assert "resident" in modes
        b.same_marks("resident")
        stream("sw", sw, rng.integers(0, 3_000, 2_000),
               rng.integers(1, 46, 2_000))
        assert "weighted" in modes
        b.same_marks("weighted")
        keys = _zipf(rng, 3_000, 300)
        stream("tb", tb, keys, 1 + keys % 25)
        assert "weighted_coal" in modes
        b.same_marks("weighted_coal")
        stream("sw", sw, _zipf(rng, 3_000, 300), rng.integers(1, 46, 3_000))
        assert "flat_fb" in modes
        b.same_marks("flat_fb")
        keys = _zipf(rng, 3_000, 500)
        ones = np.ones(len(keys), dtype=np.int64)
        stream("tb", np.asarray([tb, tb9])[keys % 2], keys, ones,
               batch=512, subbatches=1)
        assert "flat" in modes
        b.same_marks("flat")
        stream("sw", sw, keys, rng.integers(1, 300, 3_000), batch=256,
               subbatches=8)
        assert "scan" in modes
        b.same_marks("scan")

        def leases(st):
            r = st.lease_reserve("tb", tb, "lease-key", 7)
            st.lease_reserve("sw", sw, "lease-key", 3)
            return st.lease_credit("tb", tb, "lease-key", 2, r["ws"])
        # The table is full: the reserve evicts.  Its grants may differ
        # from the reference's (ROADMAP C8); the marks may not.
        b.both(leases)
        marks = b.same_marks("lease")
        assert len(marks["tb"]) == 1 and len(marks["sw"]) == 1
        b.both(lambda st: st.reset_key("tb", tb, "lease-key"))
        assert len(b.same_marks("reset")["tb"]) == 1
        slots = np.array([3, 9, 4099], dtype=np.int64)
        rows = np.arange(12, dtype=np.int32).reshape(3, 4)
        b.both(lambda st: st.engine.write_rows("tb", slots, rows))
        assert b.same_marks("write_rows") == {"tb": [3, 9, 4099]}
        b.both(lambda st: setattr(st.engine, "sw_state", st.engine.sw_state))
        ids, was_all = drained(b.port_log.journal)
        assert drained(b.ref_log.journal) == (ids, was_all)
        assert was_all and ids == {"sw": list(range(4100))}
    finally:
        b.close()


class WatchedLock:
    """A re-entrant lock that records when another thread had to wait for
    it (the engines take theirs as ``with self._lock``)."""

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


@pytest.mark.parametrize("kind", KINDS)
def test_cut_racing_a_dispatch_ships_its_row_later(kind):
    """ROADMAP C10.  A stream call is held at the engine lock while a cut
    drains the journal and reads the rows, then runs.  The port marks a
    step's slots after enqueueing the step, under the engine lock, so the
    held call's slots are not in that cut and the next cut ships their
    new rows: the standby ends equal to the primary.  The reference marks
    before taking the lock, so its cut drains the marks and reads the
    rows before the step; nothing marks them again and its standby keeps
    the old rows."""
    clock = {"t": T0}
    keys = np.arange(40, dtype=np.int64)
    standby_equal = {}
    for ref in (False, True):
        make = ref_storage if ref else port_storage
        primary, standby = make(clock, 512), make(clock, 512)
        cfg = (RefConfig if ref else RateLimitConfig)(**CFG_TB)
        lid = primary.register_limiter("tb", cfg)
        log = (RefReplicationLog if ref else ReplicationLog)(
            primary, journal_kind=kind)
        receiver = (RefReceiver if ref else StandbyReceiver)(standby)
        try:
            clock["t"] += 10
            primary.acquire_stream_ids("tb", lid, keys)
            for f in log.cut():
                receiver.apply(f)
            lock = WatchedLock()
            primary.engine._lock = lock
            lock.acquire()
            try:
                worker = threading.Thread(
                    target=primary.acquire_stream_ids, args=("tb", lid, keys))
                worker.start()
                assert lock.waiting.wait(30)
                for f in log.cut():
                    receiver.apply(f)
            finally:
                lock.release()
            worker.join(30)
            assert not worker.is_alive()
            for f in log.cut():
                receiver.apply(f)
            standby_equal[ref] = np.array_equal(fingerprint(primary)["tb"],
                                                fingerprint(standby)["tb"])
        finally:
            primary.close()
            standby.close()
    assert standby_equal == {False: True, True: False}


# ---------------------------------------------------------------------------
# Frames: equal bytes, cross-package apply, chunking, bad magic
# ---------------------------------------------------------------------------

def _traffic(rng, calls=4):
    out = []
    for _ in range(calls):
        keys = [f"k{k}" for k in rng.integers(0, 300, 48)]
        out.append((int(rng.choice([1, 250, 999, 2001])), keys,
                    [int(p) for p in rng.integers(1, 4, 48)],
                    _zipf(rng, 2_000, 400)))
    return out


def _drive(st, clock, call, lids):
    dt, keys, permits, ids = call
    clock["t"] += dt
    st.acquire_many("sw", [lids["sw"]] * len(keys), keys, permits)
    st.acquire_many("tb", [lids["tb"]] * len(keys), keys, permits)
    st.acquire_stream_ids("tb", lids["tb"], ids)


def _registered(st, ref):
    cfg = RefConfig if ref else RateLimitConfig
    return {"tb": st.register_limiter("tb", cfg(**CFG_TB)),
            "sw": st.register_limiter("sw", cfg(**CFG_SW))}


@ON_BOTH
def test_frames_equal_bytes_and_apply_across_packages(kind, host_parallel,
                                                      monkeypatch):
    """From the same traffic both packages cut frames of equal bytes, one
    cut after each call (the bootstrap chunked to a 20 KB budget); each
    package's frames applied by the other package's standby give the
    primary's fingerprint, and the two promoted standbys decide alike."""
    rng = np.random.default_rng(21 + host_parallel)
    calls = _traffic(rng)
    # Side True: a reference primary into a port standby; side False: a
    # port primary into a reference standby.  One clock a side.
    clocks = {True: {"t": T0}, False: {"t": T0}}
    prim = {True: ref_storage(clocks[True], 4096, host_parallel,
                              observability=False),
            False: port_storage(clocks[False], 4096, host_parallel)}
    stby = {True: port_storage(clocks[True], 4096, host_parallel),
            False: ref_storage(clocks[False], 4096, host_parallel,
                               observability=False)}
    lids = {ref: _registered(st, ref) for ref, st in prim.items()}
    assert lids[True] == lids[False]
    logs = {True: RefReplicationLog(prim[True], max_frame_bytes=20_000,
                                    journal_kind=kind),
            False: ReplicationLog(prim[False], max_frame_bytes=20_000,
                                  journal_kind=kind)}
    rx = {True: StandbyReceiver(stby[True]), False: RefReceiver(stby[False])}
    encode = {True: ref_encode, False: encode_frame}
    try:
        with pinned_stamps(monkeypatch):
            for i, call in enumerate(calls):
                frames = {}
                for ref, st in prim.items():
                    _drive(st, clocks[ref], call, lids[ref])
                    frames[ref] = [encode[ref](f) for f in logs[ref].cut()]
                assert len(frames[True]) == len(frames[False]) > 0
                if i == 0:
                    assert len(frames[False]) > 2    # chunked bootstrap
                for got, want in zip(frames[False], frames[True]):
                    assert got == want
                for ref in (True, False):
                    for data in frames[ref]:
                        rx[ref].apply_bytes(data)
        for ref in (True, False):
            assert rx[ref].consistent and rx[ref].last_epoch == len(calls)
            want, got = fingerprint(prim[ref]), fingerprint(stby[ref])
            for algo in ("sw", "tb"):
                np.testing.assert_array_equal(got[algo], want[algo])
            assert rx[ref].promote() is stby[ref]
        keys = _zipf(rng, 1_000, 500)
        strs = [f"k{k}" for k in range(0, 300, 3)]
        outs = []
        for ref in (True, False):
            clocks[ref]["t"] += 700
            outs.append((
                np.asarray(stby[ref].acquire_stream_ids(
                    "tb", lids[ref]["tb"], keys)),
                np.asarray(stby[ref].acquire_many(
                    "sw", [lids[ref]["sw"]] * len(strs), strs,
                    [1] * len(strs))["allowed"])))
        for got, want in zip(outs[1], outs[0]):
            np.testing.assert_array_equal(got, want)
    finally:
        for st in (*prim.values(), *stby.values()):
            st.close()


def test_frame_roundtrip_and_chunking():
    """``tests/test_replication.py:116`` on the port's wire."""
    deltas = {
        "sw": {"slots": np.arange(10, dtype=np.int64),
               "rows": np.arange(60, dtype=np.int32).reshape(10, 6)},
        "tb": {"slots": np.array([3, 9], dtype=np.int64),
               "rows": np.arange(8, dtype=np.int32).reshape(2, 4)},
    }
    index_dump = {"algos": {"sw": {"kind": "flat",
                                   "entries": [[[1, "k"], 4]]}}}
    limiters = {"1": {"algo": "sw", "max_permits": 5, "window_ms": 1000,
                      "refill_rate": 0.0}}
    frames = chunk_frames(7, 123456, 512, deltas, index_dump, limiters,
                          max_bytes=40)
    assert len(frames) > 3
    assert all(f["epoch"] == 7 for f in frames)
    assert [f["seq"] for f in frames] == list(range(len(frames)))
    assert sum(1 for f in frames if f["last"]) == 1
    assert frames[-1]["last"] and "index" in frames[-1]
    assert all("index" not in f for f in frames[:-1])
    got = {"sw": [], "tb": []}
    for f in frames:
        data = encode_frame(f)
        assert data[:4] == b"RLRP"
        rt = decode_frame(data)
        assert rt["epoch"] == 7 and rt["num_slots"] == 512
        for algo, p in rt["algos"].items():
            got[algo].append((p["slots"], p["rows"]))
        if rt["last"]:
            assert rt["index"]["algos"]["sw"]["entries"] == [[[1, "k"], 4]]
            assert rt["limiters"] == limiters
    for algo in ("sw", "tb"):
        slots = np.concatenate([s for s, _ in got[algo]])
        rows = np.concatenate([r for _, r in got[algo]])
        np.testing.assert_array_equal(slots, deltas[algo]["slots"])
        np.testing.assert_array_equal(rows, deltas[algo]["rows"])


@pytest.mark.parametrize("data", [b"XXXX" + b"\0" * 16,
                                  b"RLRP\x02\x00" + b"\0" * 16])
def test_frame_rejects_bad_magic_and_version(data):
    """``tests/test_replication.py:153``, and a wire version the port does
    not speak."""
    with pytest.raises(ValueError):
        decode_frame(data)


def test_make_journal_kinds():
    """``device`` and ``host`` as given; ``auto`` takes the device journal
    on CUDA and the host journal on the CPU, with no measured election."""
    assert isinstance(make_journal(64, "host", device="cpu"), SlotJournal)
    dev = make_journal(64, "device", device="cpu")
    assert isinstance(dev, DeviceSlotJournal) and dev.device
    assert isinstance(make_journal(64, "auto", device="cpu"), SlotJournal)
    assert device_journal_elected("cuda") and device_journal_elected()
    assert not device_journal_elected("cpu")
    with pytest.raises(ValueError, match="journal kind"):
        make_journal(64, "elected", device="cpu")


# ---------------------------------------------------------------------------
# Continuous replication -> state convergence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_continuous_replication_converges_state(kind):
    """``tests/test_replication.py:162``."""
    clock, primary, standby = make_pair()
    lid = primary.register_limiter("sw", RateLimitConfig(
        max_permits=10, window_ms=1000, enable_local_cache=False))
    lid_tb = primary.register_limiter("tb", RateLimitConfig(
        max_permits=30, window_ms=1000, refill_rate=5.0))
    log = ReplicationLog(primary, journal_kind=kind)
    receiver = StandbyReceiver(standby)
    repl = Replicator(log, InProcessSink(receiver))
    rng = random.Random(1)
    for _ in range(5):
        clock["t"] += rng.choice([1, 500, 1000, 2500])
        keys = [f"k{rng.randrange(24)}" for _ in range(32)]
        primary.acquire_many("sw", [lid] * 32, keys, [1] * 32)
        primary.acquire_many("tb", [lid_tb] * 32, keys,
                             [rng.choice([1, 2]) for _ in range(32)])
        repl.ship_now()
    assert_same_state(primary, standby)
    assert receiver.last_epoch == log.epoch > 0
    primary.close()
    standby.close()


@pytest.mark.parametrize("kind", KINDS)
def test_stream_paths_replicate(kind):
    """``tests/test_replication.py:190``."""
    clock, primary, standby = make_pair(num_slots=1024)
    lid = primary.register_limiter("tb", RateLimitConfig(
        max_permits=100, window_ms=1000, refill_rate=50.0))
    log = ReplicationLog(primary, journal_kind=kind)
    receiver = StandbyReceiver(standby)
    repl = Replicator(log, InProcessSink(receiver))
    rng = np.random.default_rng(3)
    for _ in range(3):
        clock["t"] += 137
        keys = rng.integers(0, 500, size=4096)
        primary.acquire_stream_ids("tb", lid, keys)
        repl.ship_now()
    assert_same_state(primary, standby, ("tb",))
    primary.close()
    standby.close()


# ---------------------------------------------------------------------------
# Failover drill
# ---------------------------------------------------------------------------

def test_failover_drill_fast():
    """``tests/test_replication.py:216`` on the port's drill."""
    from ratelimiter_tpu_torch.storage.chaos import failover_drill

    registry = MeterRegistry()
    report = failover_drill(
        num_slots=1024, n_keys=32, batch=24, registry=registry,
        storage_factory=lambda n, c: GpuBatchedStorage(
            num_slots=n, clock_ms=c, device="cpu", host_parallel=0))
    assert report["mismatches"] == 0
    assert report["decisions"] > 200
    assert report["loss_wave_decisions"] > 0
    assert max(report["lag_ms_samples"]) > 0
    meters = registry.scrape()
    assert meters["ratelimiter.replication.failovers"] == 1.0
    assert meters["ratelimiter.replication.epoch_gap"] == 0.0
    assert meters["ratelimiter.replication.frames"] >= report["frames"]


@pytest.mark.slow
def test_failover_soak_slow():
    """``tests/test_replication.py:233`` on the port: the async replicator
    thread runs mid-soak."""
    from ratelimiter_tpu_torch.storage.chaos import failover_drill

    registry = MeterRegistry()
    report = failover_drill(
        num_slots=4096, n_keys=256, waves=12, kill_after_wave=10,
        post_waves=6, batch=128, registry=registry,
        background_interval_ms=20.0,
        storage_factory=lambda n, c: GpuBatchedStorage(
            num_slots=n, clock_ms=c, device="cpu"))
    assert report["mismatches"] == 0
    assert report["decisions"] > 4000
    meters = registry.scrape()
    assert meters["ratelimiter.replication.failovers"] == 1.0
    assert meters["ratelimiter.replication.epoch_gap"] == 0.0


# ---------------------------------------------------------------------------
# Checkpoint x replication interplay
# ---------------------------------------------------------------------------

def test_checkpoint_then_catchup_equals_continuous(tmp_path):
    """``tests/test_replication.py:254`` on the port."""
    clock = {"t": T0}
    primary = port_storage(clock)
    cont = port_storage(clock)
    cfg = RateLimitConfig(max_permits=15, window_ms=2000,
                          enable_local_cache=False)
    lid = primary.register_limiter("sw", cfg)
    log = ReplicationLog(primary, journal_kind="device")
    receiver = StandbyReceiver(cont)
    archive = FrameArchive()
    repl = Replicator(log, TeeSink(InProcessSink(receiver), archive))
    oracle = SlidingWindowOracle(cfg)
    rng = random.Random(7)

    def wave(st, check_observed=False):
        clock["t"] += rng.choice([1, 999, 2000])
        keys = [f"u{rng.randrange(20)}" for _ in range(24)]
        out = st.acquire_many("sw", [lid] * 24, keys, [1] * 24)
        for j, k in enumerate(keys):
            d = oracle.try_acquire(k, 1, clock["t"])
            assert bool(out["allowed"][j]) == d.allowed
            if check_observed:
                assert int(out["observed"][j]) == d.observed

    for _ in range(3):
        wave(primary)
        repl.ship_now()
    ckpt_epoch = log.epoch
    primary.save_checkpoint(str(tmp_path / "ckpt"))
    for _ in range(3):
        wave(primary)
        repl.ship_now()

    late = port_storage(clock)
    late.register_limiter("sw", cfg)
    late.restore_checkpoint(str(tmp_path / "ckpt"))
    late_rx = StandbyReceiver(late, start_epoch=ckpt_epoch)
    for data in archive.frames:
        if decode_frame(data)["epoch"] > ckpt_epoch:
            late_rx.apply_bytes(data)
    assert late_rx.consistent and late_rx.last_epoch == log.epoch
    assert_same_state(cont, late)
    primary.close()
    promoted = late_rx.promote()
    for _ in range(3):
        wave(promoted, check_observed=True)
    promoted.close()
    cont.close()


# ---------------------------------------------------------------------------
# Gap detection & recovery, ship failure, geometry
# ---------------------------------------------------------------------------

def test_epoch_gap_refuses_promotion_until_full_frame():
    """``tests/test_replication.py:325``."""
    registry = MeterRegistry()
    clock, primary, standby = make_pair()
    lid = primary.register_limiter("tb", RateLimitConfig(
        max_permits=40, window_ms=1000, refill_rate=10.0))
    log = ReplicationLog(primary, journal_kind="device")
    receiver = StandbyReceiver(standby, registry=registry)

    def traffic():
        clock["t"] += 77
        primary.acquire_many("tb", [lid] * 8,
                             [f"g{i}" for i in range(8)], [1] * 8)

    traffic()
    for f in log.cut():
        receiver.apply(f)
    assert receiver.consistent
    traffic()
    assert log.cut()                          # epoch 2: lost in transit
    traffic()
    for f in log.cut():                       # epoch 3 arrives -> gap
        receiver.apply(f)
    assert not receiver.consistent
    assert registry.scrape()["ratelimiter.replication.epoch_gap"] == 1.0
    with pytest.raises(ReplicationStateError):
        receiver.promote()
    log.request_full()
    for f in log.cut():
        receiver.apply(f)
    assert receiver.consistent
    assert_same_state(primary, standby, ("tb",))
    receiver.promote()
    # A stale delta after promotion is refused, as a zombie's frames are.
    with pytest.raises(ReplicationStateError, match="promoted"):
        receiver.apply(log.cut()[0] if log.pending() else {
            "epoch": 99, "num_slots": 512, "algos": {}})
    primary.close()
    standby.close()


def test_ship_failure_remarks_and_requests_full():
    """``tests/test_replication.py:366``."""
    class FlakySink:
        def __init__(self):
            self.fail = False
            self.delivered = []

        def send(self, data):
            if self.fail:
                raise ConnectionError("standby unreachable")
            self.delivered.append(data)

    clock, primary, standby = make_pair()
    lid = primary.register_limiter("sw", RateLimitConfig(
        max_permits=9, window_ms=1000, enable_local_cache=False))
    log = ReplicationLog(primary, journal_kind="device")
    sink = FlakySink()
    repl = Replicator(log, sink)
    clock["t"] += 5
    primary.acquire_many("sw", [lid] * 4, list("abcd"), [1] * 4)
    repl.ship_now()
    n_ok = len(sink.delivered)
    clock["t"] += 5
    primary.acquire_many("sw", [lid] * 4, list("efgh"), [1] * 4)
    sink.fail = True
    with pytest.raises(ConnectionError):
        repl.ship_now()
    assert repl.errors == 1
    assert log.pending() > 0
    sink.fail = False
    repl.ship_now()
    assert len(sink.delivered) > n_ok
    receiver = StandbyReceiver(standby)
    for data in sink.delivered:
        receiver.apply_bytes(data)
    assert receiver.consistent
    assert_same_state(primary, standby, ("sw",))
    primary.close()
    standby.close()


def test_geometry_mismatch_rejected():
    """``tests/test_replication.py:412``."""
    clock, primary, _ = make_pair(num_slots=512)
    other = port_storage(clock, 256)
    lid = primary.register_limiter("sw", RateLimitConfig(
        max_permits=5, window_ms=1000, enable_local_cache=False))
    clock["t"] += 1
    primary.acquire("sw", lid, "x", 1)
    log = ReplicationLog(primary)
    receiver = StandbyReceiver(other)
    with pytest.raises(ValueError, match="geometry"):
        for f in log.cut():
            receiver.apply(f)
    primary.close()
    other.close()


# ---------------------------------------------------------------------------
# TCP transport
# ---------------------------------------------------------------------------

def test_tcp_transport_failover_vs_oracle():
    """``tests/test_replication.py:432``."""
    clock, primary, standby = make_pair()
    cfg = RateLimitConfig(max_permits=12, window_ms=1500,
                          enable_local_cache=False)
    lid = primary.register_limiter("sw", cfg)
    log = ReplicationLog(primary, journal_kind="device")
    receiver = StandbyReceiver(standby)
    server = ReplicationServer(receiver, host="127.0.0.1").start()
    sink = SocketSink("127.0.0.1", server.port, ack_timeout=2.0)
    repl = Replicator(log, sink)
    oracle = SlidingWindowOracle(cfg)
    rng = random.Random(11)
    try:
        for _ in range(4):
            clock["t"] += rng.choice([3, 700, 1500])
            keys = [f"t{rng.randrange(16)}" for _ in range(20)]
            out = primary.acquire_many("sw", [lid] * 20, keys, [1] * 20)
            for j, k in enumerate(keys):
                d = oracle.try_acquire(k, 1, clock["t"])
                assert bool(out["allowed"][j]) == d.allowed
            repl.ship_now()
        snap = copy.deepcopy(oracle)
        clock["t"] += 3
        primary.acquire_many("sw", [lid] * 4, ["t0", "t1", "t2", "t3"],
                             [1] * 4)
    finally:
        primary.close()
        sink.close()
        server.stop()
    oracle = snap
    promoted = receiver.promote()
    for _ in range(3):
        clock["t"] += rng.choice([3, 700, 1500])
        keys = [f"t{rng.randrange(16)}" for _ in range(20)]
        out = promoted.acquire_many("sw", [lid] * 20, keys, [1] * 20)
        for j, k in enumerate(keys):
            d = oracle.try_acquire(k, 1, clock["t"])
            assert bool(out["allowed"][j]) == d.allowed
            assert int(out["observed"][j]) == d.observed
    promoted.close()


def test_socket_sink_reconnects_and_rebaselines_after_link_drop():
    """``tests/test_replication.py:477``: the standby dies mid-stream and
    an empty one binds the same port; the sink reconnects with its capped
    backoff (no error), and the next cycle re-baselines with a full
    frame."""
    clock, primary, standby = make_pair()
    cfg = RateLimitConfig(max_permits=12, window_ms=1500,
                          enable_local_cache=False)
    lid = primary.register_limiter("sw", cfg)
    log = ReplicationLog(primary)
    receiver1 = StandbyReceiver(standby)
    server1 = ReplicationServer(receiver1, host="127.0.0.1").start()
    sink = SocketSink("127.0.0.1", server1.port, max_retries=8,
                      backoff_ms=5.0, backoff_cap_ms=50.0, ack_timeout=2.0)
    repl = Replicator(log, sink)
    rng = random.Random(5)
    boot = {}
    standby2 = port_storage(clock)

    def wave():
        clock["t"] += rng.choice([3, 700, 1500])
        keys = [f"t{rng.randrange(16)}" for _ in range(20)]
        primary.acquire_many("sw", [lid] * 20, keys, [1] * 20)

    def restart_standby_later(port, delay_s):
        time.sleep(delay_s)
        boot["receiver"] = StandbyReceiver(standby2)
        boot["server"] = ReplicationServer(
            boot["receiver"], host="127.0.0.1", port=port).start()

    try:
        wave()
        assert repl.ship_now() > 0
        assert receiver1.consistent
        sink._drop()
        server1.stop()
        standby.close()
        t = threading.Thread(target=restart_standby_later,
                             args=(server1.port, 0.1), daemon=True)
        t.start()
        wave()
        assert repl.ship_now() > 0
        t.join(timeout=5.0)
        receiver2 = boot["receiver"]
        assert sink.reconnects >= 1
        assert repl.errors == 0
        assert not receiver2.consistent
        with pytest.raises(ReplicationStateError):
            receiver2.promote()
        wave()
        assert repl.ship_now() > 0
        assert receiver2.consistent
        assert repl.errors == 0
        assert_same_state(primary, standby2, ("sw",))
    finally:
        primary.close()
        sink.close()
        if "server" in boot:
            boot["server"].stop()
        standby2.close()


# ---------------------------------------------------------------------------
# Service wiring & metrics exposure
# ---------------------------------------------------------------------------

def test_wiring_replication_disabled_by_default():
    """``tests/test_replication.py:569``."""
    from ratelimiter_tpu_torch.service.props import AppProperties
    from ratelimiter_tpu_torch.service.wiring import _maybe_replication

    props = AppProperties({"storage.backend": "memory"})
    storage = port_storage({"t": T0}, 256)
    assert _maybe_replication(storage, props, MeterRegistry()) is None
    assert storage.engine.journal is None
    storage.close()


def test_wiring_primary_standby_roundtrip_over_tcp():
    """``tests/test_replication.py:581``."""
    from ratelimiter_tpu_torch.service.props import AppProperties
    from ratelimiter_tpu_torch.service.wiring import _maybe_replication

    clock = {"t": T0}
    registry = MeterRegistry()
    standby = port_storage(clock, 256)
    h_standby = _maybe_replication(standby, AppProperties({
        "replication.enabled": "true", "replication.role": "standby",
        "replication.listen_port": "0"}), registry)
    assert h_standby is not None and h_standby.role == "standby"
    port = h_standby.server.port
    primary = port_storage(clock, 256)
    h_primary = _maybe_replication(primary, AppProperties({
        "replication.enabled": "true", "replication.role": "primary",
        "replication.target": f"127.0.0.1:{port}",
        "replication.interval_ms": "10000"}), registry)
    assert h_primary is not None and h_primary.role == "primary"
    lid = primary.register_limiter("tb", RateLimitConfig(
        max_permits=25, window_ms=1000, refill_rate=10.0))
    clock["t"] += 9
    primary.acquire_many("tb", [lid] * 6, [f"w{i}" for i in range(6)],
                         [1] * 6)
    h_primary.replicator.ship_now()
    assert h_standby.receiver.last_epoch == 1
    status = h_primary.status()
    assert status["epoch"] == 1 and status["frames_shipped"] >= 1
    assert status["journal"] == "host"     # a CPU engine's "auto"
    meters = registry.scrape()
    assert meters["ratelimiter.replication.frames"] >= 1
    assert meters["ratelimiter.replication.bytes"] > 0
    assert "ratelimiter.replication.lag_ms" in meters
    assert_same_state(primary, standby, ("tb",))
    h_primary.close()
    h_standby.close()
    primary.close()
    standby.close()


def test_wiring_refuses_a_sharded_target_list():
    """``replication.targets`` with one standby a shard needs the sharded
    engine (ROADMAP A5): refused at boot."""
    from ratelimiter_tpu_torch.service.props import AppProperties
    from ratelimiter_tpu_torch.service.wiring import build_app

    with pytest.raises(NotImplementedError, match="A5"):
        build_app(AppProperties({
            "storage.num_slots": "256", "warmup.enabled": "false",
            "replication.enabled": "true",
            "replication.targets": "127.0.0.1:7401,127.0.0.1:7402"}),
            device="cpu")


def test_gauge_meter():
    """``tests/test_replication.py:625`` on the port's registry."""
    registry = MeterRegistry()
    g = registry.gauge("x.lag", "test gauge")
    g.set(12.5)
    assert registry.scrape()["x.lag"] == 12.5
    assert registry.gauge("x.lag") is g
    with pytest.raises(TypeError):
        registry.counter("x.lag")


# ---------------------------------------------------------------------------
# Link liveness: ack deadline + heartbeat
# ---------------------------------------------------------------------------

def test_heartbeat_acks_and_keeps_link_up():
    """``tests/test_replication.py:639``."""
    clock, primary, standby = make_pair(num_slots=256)
    receiver = StandbyReceiver(standby)
    server = ReplicationServer(receiver, host="127.0.0.1").start()
    sink = SocketSink("127.0.0.1", server.port, ack_timeout=1.0)
    try:
        assert sink.link_state() == "unknown"
        assert sink.heartbeat() is True
        assert sink.link_state() == "up"
        assert receiver.frames_applied == 0
        assert server.rx_age_ms() is not None
    finally:
        sink.close()
        server.stop()
        primary.close()
        standby.close()


def test_silently_dead_standby_marks_link_dead():
    """``tests/test_replication.py:654``: a partition fails the heartbeat
    at the ack deadline, and two consecutive failures read DEAD."""
    clock, primary, standby = make_pair(num_slots=256)
    receiver = StandbyReceiver(standby)
    server = ReplicationServer(receiver, host="127.0.0.1").start()
    proxy = FaultInjectingProxy(server.port).start()
    sink = SocketSink("127.0.0.1", proxy.port, ack_timeout=0.25,
                      dead_after=2, max_retries=0)
    try:
        assert sink.heartbeat() is True
        assert sink.link_state() == "up"
        proxy.partition()
        t0 = time.monotonic()
        assert sink.heartbeat() is False
        assert time.monotonic() - t0 < 2.0
        assert sink.link_state() == "up"
        assert sink.heartbeat() is False
        assert sink.link_state() == "dead"
        proxy.heal()
        deadline = time.monotonic() + 5.0
        while not sink.heartbeat() and time.monotonic() < deadline:
            pass
        assert sink.link_state() == "up"
    finally:
        sink.close()
        proxy.stop()
        server.stop()
        primary.close()
        standby.close()


def test_replicator_idle_cycles_heartbeat_and_flag_dead_link():
    """``tests/test_replication.py:696``: with no deltas flowing, idle
    cycles heartbeat and flag a silently dead standby (gauge 0, flight
    event)."""
    from ratelimiter_tpu_torch.observability import flight_recorder

    frec = flight_recorder()
    fmark = frec.mark()
    registry = MeterRegistry()
    clock, primary, standby = make_pair(num_slots=256)
    lid = primary.register_limiter("tb", RateLimitConfig(
        max_permits=20, window_ms=1000, refill_rate=10.0))
    receiver = StandbyReceiver(standby)
    server = ReplicationServer(receiver, host="127.0.0.1").start()
    proxy = FaultInjectingProxy(server.port).start()
    sink = SocketSink("127.0.0.1", proxy.port, ack_timeout=0.2,
                      dead_after=2, max_retries=0)
    repl = Replicator(ReplicationLog(primary), sink, interval_ms=30.0,
                      registry=registry).start()

    def wait(cond, seconds):
        deadline = time.monotonic() + seconds
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.02)
        return cond()

    try:
        clock["t"] += 5
        primary.acquire_many("tb", [lid] * 2, ["a", "b"], [1, 1])
        assert wait(lambda: receiver.last_epoch >= 1, 10.0)
        assert registry.scrape()["ratelimiter.replication.link_up"] == 1.0
        proxy.partition()
        assert wait(lambda: sink.link_state() == "dead", 15.0)
        assert wait(lambda: registry.scrape()[
            "ratelimiter.replication.link_up"] == 0.0, 5.0)
        assert any(e["kind"] == "replication.link_dead"
                   for e in frec.events(since=fmark))
    finally:
        repl.stop()
        sink.close()
        proxy.stop()
        server.stop()
        primary.close()
        standby.close()
