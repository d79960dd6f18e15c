"""The decision sidecar, port against the JAX package
(``service/sidecar.py``, the batcher's ``submit_many`` / ``submit_block`` /
``forget``, the storage's ``acquire_async_many`` / ``acquire_async_block``
and the native index's ``assign_batch_bytes``).

- The same bytes in, the same bytes out: one seeded frame stream (every
  op of wire v1-v6, v1 without HELLO, pipelined bursts, BATCH frames with
  and without a permits column, lease and bulk-renew frames, TELEMETRY,
  malformed frames of each class, the clock crossing windows and
  stepping back) goes through a raw socket to the reference's server over
  ``TpuBatchedStorage`` and to the port's over
  ``GpuBatchedStorage(device="cpu")``, on one manual clock, each with its
  package's ``LeaseManager``.  The response streams must be byte-equal,
  every decision equal to ``semantics/oracle.py`` and the engines' states
  and indexes equal at the end, at ``host_parallel`` 0 (the BATCH frames
  ride ``acquire_async_block``) and 4 (``acquire_async_many``).
- Across packages: each package's ``SidecarClient`` against the other's
  server, with the results of each package's own pair.
- The batcher's bulk surfaces and ``forget``, and the storage's async
  many / block submits, against the reference's.
- The cases of ``tests/test_sidecar.py``, on the port's server.
"""

import socket
import struct
import threading
import types

import numpy as np
import pytest
import torch

from ratelimiter_tpu import leases as ref_leases
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine.batcher import MicroBatcher as RefBatcher
from ratelimiter_tpu.observability import telemetry as ref_telemetry
from ratelimiter_tpu.service import sidecar as ref_sc
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch import leases
from ratelimiter_tpu_torch.engine.batcher import MicroBatcher
from ratelimiter_tpu_torch.engine.native_index import NativeSlotIndex
from ratelimiter_tpu_torch.observability import telemetry
from ratelimiter_tpu_torch.semantics import (
    SlidingWindowOracle,
    TokenBucketOracle,
)
from ratelimiter_tpu_torch.service import sidecar as sc
from ratelimiter_tpu_torch.storage.errors import FencedError
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from test_torch_checkpoint import packed, same_storages
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_753_000_000_000
HOST_PARALLEL = [0, 4]
# The decision limiters (oracle-checked) and the leased one.
DEC_TB = dict(max_permits=20, window_ms=2_000, refill_rate=8.0)
DEC_SW = dict(max_permits=10, window_ms=2_000, enable_local_cache=False)
LEASED = dict(max_permits=5_000, window_ms=60_000, refill_rate=100.0)


def _package(port: bool):
    """One package's sidecar stack, under one namespace."""
    return types.SimpleNamespace(
        port=port, sc=sc if port else ref_sc,
        Config=RateLimitConfig if port else RefConfig,
        leases=leases if port else ref_leases,
        telemetry=telemetry if port else ref_telemetry)


PACKAGES = (_package(False), _package(True))


def _storage(pkg, clock, host_parallel, num_slots=2048, **kw):
    kw = dict(num_slots=num_slots, clock_ms=lambda: clock["t"],
              host_parallel=host_parallel, **kw)
    return (GpuBatchedStorage(device="cpu", **kw) if pkg.port
            else TpuBatchedStorage(**kw))


def _stack(pkg, clock, host_parallel, **server_kw):
    """Storage, server (port 0 on loopback) with the three limiters, and a
    lease manager on the manual clock."""
    st = _storage(pkg, clock, host_parallel, max_delay_ms=0.2)
    server = pkg.sc.SidecarServer(st, host="127.0.0.1", **server_kw).start()
    lids = [server.register("tb", pkg.Config(**DEC_TB)),
            server.register("sw", pkg.Config(**DEC_SW)),
            server.register("tb", pkg.Config(**LEASED))]
    mgr = pkg.leases.LeaseManager(
        st, default_budget=16, max_budget=64, max_bulk_budget=256,
        ttl_ms=10_000.0, clock_ms=lambda: clock["t"])
    server.attach_leases(mgr)
    return types.SimpleNamespace(st=st, server=server, lids=lids, mgr=mgr)


def _close(*stacks):
    for s in stacks:
        s.server.stop()
        s.st.close()


# ---------------------------------------------------------------------------
# The frame stream
# ---------------------------------------------------------------------------

class Raw:
    """A raw socket speaking framed bytes: responses are read as whole
    ``u32 len | body`` frames, and returned as the stream's bytes."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=30.0)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.buf = b""

    def exchange(self, payload: bytes, n_resp: int) -> list:
        self.sock.sendall(payload)
        out = []
        while len(out) < n_resp:
            while len(self.buf) < 4 or \
                    len(self.buf) < 4 + struct.unpack_from("<I",
                                                           self.buf)[0]:
                chunk = self.sock.recv(65536)
                assert chunk, "the server closed the connection"
                self.buf += chunk
            n = 4 + struct.unpack_from("<I", self.buf)[0]
            out.append(self.buf[:n])
            self.buf = self.buf[n:]
        return out

    def close(self) -> None:
        self.sock.close()


def _frame(version, op, a, b, key=b"", tid=0, ext=None) -> bytes:
    """One request frame as a client of ``version`` writes it (HELLO keeps
    the v1 shape)."""
    raw = key if isinstance(key, bytes) else key.encode()
    if ext is not None and version >= 6:
        raw = struct.pack("<I", ext) + raw
    if version >= 4 and op != sc.OP_HELLO:
        body = struct.pack("<BIIQ", op, a, b, tid) + raw
    else:
        body = struct.pack("<BII", op, a, b) + raw
    return struct.pack("<I", len(body)) + body


def _columns(keys):
    kb = [k.encode() for k in keys]
    offs = np.zeros(len(kb) + 1, dtype=np.uint32)
    np.cumsum([len(k) for k in kb], out=offs[1:])
    col = b"".join(kb)
    return struct.pack("<I", len(col)) + col + offs.tobytes()


def _batch(lid, keys, permits=None, tid=0) -> bytes:
    payload = _columns(keys) + (
        b"\x00" if permits is None
        else b"\x01" + np.asarray(permits, dtype=np.uint32).tobytes())
    body = struct.pack("<BIIQ", sc.OP_BATCH, lid, len(keys), tid) + payload
    return struct.pack("<I", len(body)) + body


def _bulk(lid, keys, used, req, epochs, tid=0) -> bytes:
    payload = (_columns(keys) + np.asarray(used, np.uint64).tobytes()
               + np.asarray(req, np.uint64).tobytes()
               + np.asarray(epochs, np.uint32).tobytes())
    body = struct.pack("<BIIQ", sc.OP_BULK_RENEW, lid, len(keys),
                       tid) + payload
    return struct.pack("<I", len(body)) + body


def _raw_batch(version, lid, rows, klen, col, offs, flags, perms=b""):
    """A BATCH frame whose columns lie about themselves."""
    payload = (struct.pack("<I", klen) + col
               + np.asarray(offs, dtype=np.uint32).tobytes()
               + bytes([flags]) + perms)
    hdr = (struct.pack("<BIIQ", sc.OP_BATCH, lid, rows, 0) if version >= 4
           else struct.pack("<BII", sc.OP_BATCH, lid, rows))
    body = hdr + payload
    return struct.pack("<I", len(body)) + body


def _telemetry_blob(seed: int) -> bytes:
    tel = telemetry.ClientTelemetry(client_id=1000 + seed)
    for i in range(3):
        tel.record_burn(3, f"L{(seed + i) % 5}", 1 + i)
    tel.record_deny(3, f"L{seed % 5}")
    return tel.encode_and_reset()


MAX_FRAME = 512
VERSIONS = (1, 2, 3, 4, 5, 6)


def _stream(seed: int, n_bursts: int):
    """A seeded list of bursts: (clock step, version, [(frame bytes,
    kind, fields)])."""
    rng = np.random.default_rng(seed)
    users = [f"u{i}" for i in range(12)]
    leased = [f"L{i}" for i in range(5)]
    out = []

    def user():
        return users[min(int(rng.zipf(1.3)) - 1, len(users) - 1)]

    for i in range(n_bursts):
        step = int(rng.choice([0, 3, 17, 250, 999, 2_000, 4_100, -300]))
        version = VERSIONS[i % len(VERSIONS)] if i < 12 else int(
            rng.choice(VERSIONS))
        tid = lambda: int(rng.integers(1, 1 << 62)) if (  # noqa: E731
            version >= 4 and rng.random() < 0.3) else 0
        frames = []
        for _ in range(int(rng.integers(1, 16))):
            r = rng.random()
            which = int(rng.integers(0, 2))  # 0: tb, 1: sw decision lid
            lid = which + 1
            if r < 0.35:
                p = int(rng.choice([0, 1, 1, 2, 5, 25]))
                k = user()
                frames.append((_frame(version, sc.OP_TRY_ACQUIRE, lid, p, k,
                                      tid()), "acq", (which, k, max(p, 1))))
            elif r < 0.45:
                k = user()
                frames.append((_frame(version, sc.OP_AVAILABLE, lid, 0, k,
                                      tid()), "avail", (which, k)))
            elif r < 0.48:
                k = user()
                frames.append((_frame(version, sc.OP_RESET, lid, 0, k,
                                      tid()), "reset", (which, k)))
            elif r < 0.51:
                frames.append((_frame(version, sc.OP_PING, 0, 0, b"",
                                      tid()), "other", None))
            elif r < 0.63:
                rows = int(rng.choice([1, 2, 7, 16, 33]))
                keys = [user() for _ in range(rows)]
                perms = (None if rng.random() < 0.5 else
                         [int(x) for x in rng.choice([0, 1, 2, 3, 9], rows)])
                if version >= 4:
                    fb = _batch(lid, keys, perms, tid())
                else:
                    fb = _frame(version, sc.OP_BATCH, lid, rows, b"xx")
                frames.append((fb, "batch" if version >= 5 else "other",
                               (which, keys, [max(p, 1) for p in perms]
                                if perms else [1] * rows)))
            elif r < 0.78:
                op = int(rng.choice([sc.OP_LEASE, sc.OP_RENEW,
                                     sc.OP_RELEASE]))
                k = leased[int(rng.integers(0, len(leased)))]
                if version >= 6:
                    b = int(rng.integers(0, 80))
                    ext = (int(rng.integers(0, 2)) if op == sc.OP_LEASE
                           else int(rng.integers(0, 80)))
                else:
                    b = int(rng.integers(0, 40)) | (
                        int(rng.integers(0, 40)) << 16)
                    ext = None
                frames.append((_frame(version, op, 3, b, k, tid(), ext),
                               "other", None))
            elif r < 0.82:
                rows = int(rng.integers(1, 4))
                keys = [leased[int(rng.integers(0, 5))] for _ in range(rows)]
                fb = (_bulk(3, keys, rng.integers(0, 20, rows),
                            rng.integers(0, 200, rows),
                            rng.choice([0, 1, 0xFFFFFFFF], rows), tid())
                      if version >= 4 else
                      _frame(version, sc.OP_BULK_RENEW, 3, rows, b"zz"))
                frames.append((fb, "other", None))
            elif r < 0.86:
                fb = _frame(version, sc.OP_TELEMETRY, 0, 0,
                            _telemetry_blob(int(rng.integers(0, 5))), tid())
                frames.append((fb, "tel" if version >= 4 else "other",
                               None))
            else:
                frames.append((_malformed(rng, version), "other", None))
        # A decision in every burst reads the clock, so the storage's
        # monotonic stamp follows each step (the oracle reads the same).
        k = user()
        frames.insert(int(rng.integers(0, len(frames) + 1)),
                      (_frame(version, sc.OP_TRY_ACQUIRE, 1, 1, k), "acq",
                       (0, k, 1)))
        out.append((step, version, frames))
    return out


def _malformed(rng, version) -> bytes:
    """One malformed frame of a seeded class (the length prefix keeps the
    stream in sync through each)."""
    kind = int(rng.integers(0, 12))
    if kind == 0:    # key over max_key_bytes
        return _frame(version, sc.OP_TRY_ACQUIRE, 1, 1, b"x" * 80)
    if kind == 1:    # shorter than the header
        return struct.pack("<I", 4) + b"abc\x00"
    if kind == 2:    # unknown op
        return _frame(version, 42, 1, 1, b"k")
    if kind == 3:    # invalid UTF-8 key
        return _frame(version, sc.OP_TRY_ACQUIRE, 1, 1, b"\xff\xfe\xff")
    if kind == 4:    # declared length over max_frame_bytes, payload sent
        n = MAX_FRAME + 100
        return struct.pack("<I", n) + bytes(rng.integers(0, 256, n,
                                                         dtype=np.uint8))
    if kind == 5:    # unknown limiter
        return _frame(version, sc.OP_TRY_ACQUIRE, 9999, 1, b"k")
    if kind == 6:    # v5 columns: a permits column the frame lacks
        return _raw_batch(version, 1, 2, 4, b"abcd", [0, 2, 4], 1)
    if kind == 7:    # offsets past the key column
        return _raw_batch(version, 1, 2, 4, b"abcd", [0, 2, 9], 0)
    if kind == 8:    # offsets not monotonic / offs[0] != 0
        return _raw_batch(version, 1, 2, 4, b"abcd", [4, 2, 4], 0)
    if kind == 9:    # rows over the pipeline cap
        return _raw_batch(version, 1, 2000, 4, b"abcd", [0] * 2001, 0)
    if kind == 10:   # trailing bytes after the columns
        return _raw_batch(version, 1, 2, 4, b"abcd", [0, 2, 4], 0,
                          b"junk")
    # a v6 bulk renew cut short
    body = struct.pack("<BIIQ", sc.OP_BULK_RENEW, 3, 2, 0) + b"\x01"
    return struct.pack("<I", len(body)) + body


def _run_stream(pkg, host_parallel, bursts, clock):
    """Drive the bursts through one package's server; returns (the stack,
    [the response frames of each burst])."""
    s = _stack(pkg, clock, host_parallel, max_frame_bytes=MAX_FRAME,
               max_key_bytes=64)
    conns = {}
    got = []
    try:
        for step, version, frames in bursts:
            clock["t"] += step
            if version not in conns:
                conns[version] = Raw(s.server.port)
                if version >= 2:
                    hello = conns[version].exchange(
                        _frame(1, sc.OP_HELLO, version, 0), 1)
                    got.append(hello)
            n = sum(1 for _, kind, _ in frames if kind != "tel")
            got.append(conns[version].exchange(
                b"".join(f for f, _, _ in frames), n))
        return s, got
    finally:
        for c in conns.values():
            c.close()


def _check_oracle(bursts, got):
    """Every TRY_ACQUIRE, BATCH and AVAILABLE answer on the decision
    limiters against the oracle, on the storage's monotonic clock."""
    oracles = [TokenBucketOracle(RateLimitConfig(**DEC_TB)),
               SlidingWindowOracle(RateLimitConfig(**DEC_SW))]
    t, now = T0, 0
    responses = iter(got)
    seen = set()
    n_checked = 0
    for step, version, frames in bursts:
        t += step
        now = max(now, t)
        if version not in seen:
            seen.add(version)
            if version >= 2:
                next(responses)
        resp = iter(next(responses))
        for _, kind, fields in frames:
            if kind == "tel":
                continue
            r = next(resp)
            _, status, allowed, remaining = struct.unpack_from("<IBBq", r)
            if kind == "acq":
                which, key, p = fields
                want = oracles[which].try_acquire(key, p, now)
                assert status == sc.ST_OK
                assert bool(allowed) == want.allowed, (key, p, now)
                if which == 0:
                    assert remaining == want.remaining_hint
                n_checked += 1
            elif kind == "avail":
                which, key = fields
                assert status == sc.ST_OK
                assert remaining == oracles[which].get_available_permits(
                    key, now)
                n_checked += 1
            elif kind == "reset":
                which, key = fields
                assert status == sc.ST_OK
                oracles[which].reset(key, now)
            elif kind == "batch":
                which, keys, perms = fields
                assert status == sc.ST_OK and remaining == len(keys)
                bits = np.unpackbits(np.frombuffer(r[14:], np.uint8))
                for j, (key, p) in enumerate(zip(keys, perms)):
                    want = oracles[which].try_acquire(key, p, now)
                    assert bool(bits[j]) == want.allowed, (key, p, now)
                    n_checked += 1
    return n_checked


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_frame_stream_byte_equal_and_oracle(host_parallel):
    """The same seeded frame stream into both servers: byte-equal response
    streams, every decision equal to the oracle, equal states, indexes,
    lease books and server counters at the end."""
    require_reference_native()
    bursts = _stream(11 + host_parallel, 90)
    runs = []
    for pkg in PACKAGES:
        clock = {"t": T0}
        runs.append(_run_stream(pkg, host_parallel, bursts, clock))
    (ref, ref_got), (port, port_got) = runs
    try:
        assert port_got == ref_got
        assert _check_oracle(bursts, port_got) > 300
        for s in (ref, port):
            s.st.flush()
        same_storages(port.st, ref.st)
        assert port.mgr.status() == ref.mgr.status()
        counters = ("malformed_total", "idle_closed_total",
                    "pipeline_shed_total", "drained_total",
                    "telemetry_frames_total", "telemetry_dropped_total")
        assert [getattr(port.server, c) for c in counters] == \
            [getattr(ref.server, c) for c in counters]
        assert port.server.malformed_total > 10
        assert port.server.telemetry_frames_total > 0
        # Every kind of decision frame was served, and a BATCH frame took
        # the route the storage's index elects.
        assert port.st._batcher.abandoned_total == 0
    finally:
        _close(ref, port)


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_batch_frames_take_the_elected_route(host_parallel, monkeypatch):
    """One BATCH frame: on one index it rides ``acquire_async_block`` (one
    future), on partitions ``acquire_async_many`` (a future a row), as on
    the reference's storage; the allow bits are equal."""
    require_reference_native()
    calls = {}
    for pkg, cls in zip(PACKAGES, (TpuBatchedStorage, GpuBatchedStorage)):
        seen = []
        for name in ("acquire_async_block", "acquire_async_many"):
            orig = getattr(cls, name)

            def spy(self, *a, _orig=orig, _name=name, _seen=seen, **kw):
                out = _orig(self, *a, **kw)
                _seen.append((_name, out is None))
                return out

            monkeypatch.setattr(cls, name, spy)
        clock = {"t": T0}
        s = _stack(pkg, clock, host_parallel)
        try:
            cli = pkg.sc.SidecarClient("127.0.0.1", s.server.port,
                                       timeout=30.0)
            keys = [f"b{i % 9}" for i in range(30)]
            got = cli.acquire_block(1, keys, permits=[1 + i % 4
                                                      for i in range(30)],
                                    max_rows=30)
            cli.close()
        finally:
            _close(s)
        calls[pkg.port] = (got, seen)
    assert calls[True] == calls[False]
    want = ([("acquire_async_block", False)] if host_parallel == 0 else
            [("acquire_async_block", True), ("acquire_async_many", False)])
    assert calls[True][1] == want


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def _client_script(cpkg, port, lids, clock):
    """One client's traffic over every surface; returns what it saw."""
    cli = cpkg.sc.SidecarClient("127.0.0.1", port, timeout=30.0)
    out = [cli.server_version, cli.server_max_frame, cli.ping()]
    try:
        keys = [f"x{i % 7}" for i in range(40)]
        out.append(cli.acquire_batch(lids[0], keys,
                                     [1 + i % 5 for i in range(40)]))
        out.append(cli.acquire_block(lids[1], keys))
        out.append(cli.acquire_block(lids[0], keys,
                                     permits=[i % 3 for i in range(40)]))
        clock["t"] += 1_500
        out.append(cli.available(lids[0], "x1"))
        cli.reset(lids[0], "x1")
        out.append(cli.try_acquire(lids[0], "x1", 20))
        g = cli.lease_grant(lids[2], "lease-a", 40)
        out.append(tuple(g))
        out.append(tuple(cli.lease_grant(lids[2], "bulk-a", 200,
                                         bulk=True)))
        out.append(tuple(cli.lease_renew(lids[2], "lease-a", 30, 50)))
        out.append(cli.lease_bulk_renew(lids[2], ["bulk-a", "lease-a"],
                                        [150, 10], [256, 64],
                                        epochs=[g.epoch, 0xFFFFFFFF]))
        blob = telemetry.ClientTelemetry(client_id=77)
        blob.record_burn(lids[2], "lease-a", 5)
        out.append(cli.telemetry_report(blob.encode_and_reset()))
        cli.lease_release(lids[2], "lease-a", 5)
        cli.lease_release(lids[2], "bulk-a", 20)
        out.append(cli.try_acquire(lids[1], "after", trace_id=99))
    finally:
        cli.close()
    return out


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_clients_and_servers_across_packages(host_parallel):
    """Each package's client against each package's server: the same
    answers on every surface, the same device state after."""
    require_reference_native()
    results, stacks = {}, {}
    try:
        for cpkg in PACKAGES:
            for spkg in PACKAGES:
                clock = {"t": T0}
                s = _stack(spkg, clock, host_parallel)
                stacks[(cpkg.port, spkg.port)] = s
                results[(cpkg.port, spkg.port)] = _client_script(
                    cpkg, s.server.port, s.lids, clock)
                s.st.flush()
        base = results[(False, False)]
        assert all(r == base for r in results.values()), results
        assert base[0] == sc.PROTOCOL_VERSION
        for key, s in stacks.items():
            for algo in ("tb", "sw"):
                np.testing.assert_array_equal(
                    packed(s.st, algo), packed(stacks[(False, False)].st,
                                               algo))
            assert s.server.telemetry_frames_total == 1
    finally:
        _close(*stacks.values())


def test_lease_clients_across_packages():
    """A ``LeaseClient`` of each package over a ``SidecarClient`` of each
    package, served by the other package's server: the decisions and the
    frames they cost are equal, and every budget returns."""
    require_reference_native()
    results = {}
    for cpkg in PACKAGES:
        for spkg in PACKAGES:
            clock = {"t": T0}
            s = _stack(spkg, clock, 0)
            try:
                wire = cpkg.sc.SidecarClient("127.0.0.1", s.server.port,
                                             timeout=30.0)
                cli = cpkg.leases.LeaseClient(
                    wire, s.lids[2], budget=16, clock_ms=lambda: clock["t"],
                    direct_fallback=False)
                got = []
                for i in range(300):
                    clock["t"] += 7
                    got.append(cli.try_acquire(f"k{i % 4}"))
                got.append(cli.try_acquire_many([f"m{i % 5}"
                                                 for i in range(60)]))
                cli.release_all()
                wire.close()
                results[(cpkg.port, spkg.port)] = (
                    got, cli.wire_ops, s.mgr.status()["outstanding"])
            finally:
                _close(s)
    base = results[(False, False)]
    assert all(r == base for r in results.values())
    assert base[2] == 0


# ---------------------------------------------------------------------------
# The batcher's bulk surfaces and the storage's async many / block
# ---------------------------------------------------------------------------

def _held_batcher(port: bool, gate):
    """A batcher whose dispatch waits on ``gate`` and answers every lane
    with its slot (so a lane's result names it), and a huge flush
    deadline: nothing dispatches until a flush is forced."""

    def answer(slots):
        gate.wait(timeout=10.0)
        s = np.asarray(slots, dtype=np.int64)
        return {"allowed": s % 3 != 0, "remaining": s * 10}

    if port:
        return MicroBatcher(
            dispatch={"sw": lambda s, l, p: answer(s)},
            dispatch_staged={"sw": lambda buf, n: answer(buf[0, :n].copy())},
            drain={"sw": lambda h, n: h},
            clear={"sw": lambda s: None},
            max_batch=1024, max_delay_ms=10_000.0)
    return RefBatcher(dispatch={"sw": lambda s, l, p: answer(s)},
                      clear={"sw": lambda s: None},
                      max_batch=1024, max_delay_ms=10_000.0)


def _outcome(fut):
    if fut.cancelled():
        return "cancelled"
    exc = fut.exception(timeout=10.0)
    if exc is not None:
        return type(exc).__name__
    out = fut.result()
    return {k: np.asarray(v).tolist() for k, v in out.items()}


@pytest.mark.parametrize("order", ["block_first", "singles_first"])
def test_batcher_block_and_many_match_reference(order):
    """submit_block (one future over its lanes) and submit_many sharing a
    flush with single submits, in both orders; forget of a block and of
    queued singles; counters — equal to the reference batcher's."""
    outcomes = []
    for port in (False, True):
        gate = threading.Event()
        b = _held_batcher(port, gate)
        try:
            futs = []
            if order == "singles_first":
                futs += [b.submit("sw", i, 0, 1) for i in range(3)]
            blk = b.submit_block("sw", np.arange(10, 17), np.zeros(7),
                                 np.ones(7))
            many = b.submit_many("sw", np.arange(20, 24), np.zeros(4),
                                 np.ones(4), trace_ids=[5, 6, 7, 8])
            gone = b.submit_block("sw", np.arange(30, 35), np.zeros(5),
                                  np.ones(5))
            one = b.submit_block("sw", [40], [0], [1])
            empty = b.submit_block("sw", [], [], [])
            if order == "block_first":
                futs += [b.submit("sw", i, 0, 1) for i in range(3)]
            depth = b.queue_depth()
            withdrawn = b.forget([gone, many[1]])
            slots_left = sorted(b.pending_slots("sw"))
            gate.set()
            b.flush()
            got = [_outcome(f) for f in futs + [blk] + many + [gone, one,
                                                                empty]]
            with b._cv:
                waiters = len(b._waiters)
            outcomes.append((depth, withdrawn, slots_left, got,
                             b.abandoned_total, waiters,
                             b.forget([blk]), b.max_depth_seen))
        finally:
            gate.set()
            b.close()
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][1] == 6  # the block's 5 lanes and one of many


def test_batcher_block_close_and_deadline_fail_once():
    """close() fails a queued block's future once; an expired shared
    deadline fails every lane of a block at once (deadline_total counts
    lanes), as in the reference."""
    outcomes = []
    for port in (False, True):
        gate = threading.Event()
        b = _held_batcher(port, gate)
        b.deadline_ms = 1.0
        blk = b.submit_block("sw", np.arange(4), np.zeros(4), np.ones(4))
        keep = b.submit_block("sw", np.arange(4, 8), np.zeros(4),
                              np.ones(4), deadline_ms=0)
        import time

        time.sleep(0.05)
        gate.set()
        b.flush()
        first = (_outcome(blk), _outcome(keep), b.deadline_total)
        gate.clear()
        late = b.submit_block("sw", np.arange(8, 11), np.zeros(3),
                              np.ones(3), deadline_ms=0)
        # A wedged dispatch holds the lock: close() fails the block.
        b._dispatch_lock.acquire()
        try:
            b.close(timeout=0.05)
        finally:
            b._dispatch_lock.release()
            gate.set()
        outcomes.append(first + (_outcome(late),))
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][2] == 4


def _many_stack(pkg, clock, host_parallel, num_slots):
    st = _storage(pkg, clock, host_parallel, num_slots=num_slots,
                  max_delay_ms=0.2)
    lid = st.register_limiter("tb", pkg.Config(**DEC_TB))
    return st, lid


def _block_args(keys):
    kb = [k.encode() for k in keys]
    offs = np.zeros(len(kb) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in kb], out=offs[1:])
    return np.frombuffer(b"".join(kb), np.uint8), offs


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_storage_async_many_and_block_match_reference(host_parallel):
    """acquire_async_many and acquire_async_block on a table that evicts:
    decisions, returns (None where the reference returns None), the
    states and indexes equal."""
    require_reference_native()
    steps = np.random.default_rng(3).integers(0, 700, 12)
    runs = []
    for pkg in PACKAGES:
        clock = {"t": T0}
        st, lid = _many_stack(pkg, clock, host_parallel, 128)
        try:
            got = []
            for r in range(12):
                clock["t"] += int(steps[r])
                keys = [f"e{int(k)}" for k in
                        np.random.default_rng(r).integers(0, 200, 24)]
                perms = np.random.default_rng(r).integers(1, 6, 24)
                futs = st.acquire_async_many("tb", lid, keys, perms)
                got.append([_outcome(f) for f in futs])
                data, offs = _block_args(keys[::-1])
                fut = st.acquire_async_block("tb", lid, data, offs,
                                             perms[::-1])
                got.append(None if fut is None else _outcome(fut))
            st.flush()
            runs.append((st, got))
        except BaseException:
            st.close()
            raise
    (ref, ref_got), (port, port_got) = runs
    try:
        assert port_got == ref_got
        same_storages(port, ref, algos=("tb",))
        assert (port_got[1] is None) == (host_parallel != 0)
    finally:
        ref.close()
        port.close()


def test_storage_async_surfaces_clock_steps_match_reference():
    """The many / block surfaces under a clock crossing windows (the same
    steps on both sides) decide as the reference's."""
    require_reference_native()
    steps = [0, 999, 1, 2_000, 30, 4_100, 0]
    runs = []
    for pkg in PACKAGES:
        clock = {"t": T0}
        st, lid = _many_stack(pkg, clock, 0, 512)
        try:
            got = []
            for i, step in enumerate(steps):
                clock["t"] += step
                keys = [f"w{j % 5}" for j in range(i, i + 12)]
                data, offs = _block_args(keys)
                got.append(_outcome(st.acquire_async_block(
                    "tb", lid, data, offs, None)))
                got.append([_outcome(f) for f in st.acquire_async_many(
                    "tb", lid, keys)])
            runs.append(got)
        finally:
            st.close()
    assert runs[1] == runs[0]


def test_fenced_and_promoting_storage_refuse_many_and_block():
    """A whole-fenced storage refuses both surfaces, and so does one in a
    promotion window, on both packages."""
    require_reference_native()
    from ratelimiter_tpu.storage.errors import FencedError as RefFenced
    from ratelimiter_tpu.storage.errors import (
        PromotionInProgressError as RefPromoting,
    )
    from ratelimiter_tpu_torch.storage.errors import (
        PromotionInProgressError,
    )

    data, offs = _block_args(["a", "b"])
    for pkg, fenced, promoting in ((PACKAGES[0], RefFenced, RefPromoting),
                                   (PACKAGES[1], FencedError,
                                    PromotionInProgressError)):
        clock = {"t": T0}
        st, lid = _many_stack(pkg, clock, 0, 256)
        try:
            st._promoting = True
            with pytest.raises(promoting):
                st.acquire_async_many("tb", lid, ["a"])
            with pytest.raises(promoting):
                st.acquire_async_block("tb", lid, data, offs)
            st._promoting = False
            st.fence(3)
            with pytest.raises(fenced):
                st.acquire_async_many("tb", lid, ["a"])
            with pytest.raises(fenced):
                st.acquire_async_block("tb", lid, data, offs)
            st.lift_fence(3)
            assert _outcome(st.acquire_async_many("tb", lid, ["a"])[0])[
                "allowed"] is True
        finally:
            st.close()


def test_assign_batch_bytes_matches_string_batch_assign():
    """The columnar assign maps a key to the slot the string batch assign
    gives it (the same lid seed), evicting in the same order, and equals
    the reference's; the partitioned index has no such method, as the
    reference's has none."""
    from ratelimiter_tpu.engine import native_index as ref_native
    from ratelimiter_tpu.engine.partitioned import (
        PartitionedSlotIndex as RefPartitioned,
    )
    from ratelimiter_tpu_torch.engine.partitioned import (
        PartitionedSlotIndex,
    )

    require_reference_native()
    rng = np.random.default_rng(5)
    col = NativeSlotIndex(32)
    strs = NativeSlotIndex(32)
    ref = ref_native.NativeSlotIndex(32)
    for r in range(8):
        keys = [f"k{int(k)}é" for k in rng.integers(0, 60, 20)]
        data, offs = _block_args(keys)
        slots, ev = col.assign_batch_bytes(data, offs, 7)
        rslots, rev = ref.assign_batch_bytes(data, offs, 7)
        np.testing.assert_array_equal(slots, rslots)
        np.testing.assert_array_equal(ev, rev)
        want, want_ev = strs.assign_batch_strs(keys, 7)
        np.testing.assert_array_equal(slots, want)
        np.testing.assert_array_equal(ev, want_ev)
    assert not hasattr(PartitionedSlotIndex, "assign_batch_bytes")
    assert not hasattr(RefPartitioned, "assign_batch_bytes")


# ---------------------------------------------------------------------------
# The cases of tests/test_sidecar.py, on the port's server
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture()
def sidecar():
    clock = FakeClock()
    storage = GpuBatchedStorage(num_slots=512, max_delay_ms=0.2,
                                clock_ms=clock, device="cpu")
    server = sc.SidecarServer(storage, host="127.0.0.1").start()
    try:
        yield server, clock
    finally:
        server.stop()
        storage.close()


def _client(server, **kw):
    return sc.SidecarClient("127.0.0.1", server.port,
                            **{"timeout": 30.0, **kw})


def test_ping_and_basic_acquire(sidecar):
    server, clock = sidecar
    lid = server.register("sw", RateLimitConfig(
        max_permits=3, window_ms=60_000, enable_local_cache=False))
    client = _client(server)
    assert client.ping()
    clock.t = (T0 // 60_000) * 60_000
    results = [client.try_acquire(lid, "alice") for _ in range(5)]
    assert results == [True, True, True, False, False]
    assert client.available(lid, "alice") == 0
    client.reset(lid, "alice")
    assert client.try_acquire(lid, "alice")
    client.close()


def test_pipelined_batch_matches_oracle(sidecar):
    server, clock = sidecar
    cfg = RateLimitConfig(max_permits=20, window_ms=2000, refill_rate=30.0)
    lid = server.register("tb", cfg)
    oracle = TokenBucketOracle(cfg)
    client = _client(server)
    rng = np.random.default_rng(8)
    for step in range(10):
        clock.t += int(rng.integers(0, 500))
        n = int(rng.integers(1, 24))
        keys = [f"u{rng.integers(0, 5)}" for _ in range(n)]
        perms = [int(rng.integers(1, 8)) for _ in range(n)]
        got = client.acquire_batch(lid, keys, perms)
        for j, (status, allowed, rem) in enumerate(got):
            assert status == 0
            want = oracle.try_acquire(keys[j], perms[j], clock.t)
            assert allowed == want.allowed, (step, j)
            assert rem == want.remaining_hint
    client.close()


def test_concurrent_clients_share_one_authority(sidecar):
    server, clock = sidecar
    lid = server.register("sw", RateLimitConfig(
        max_permits=10, window_ms=60_000, enable_local_cache=False))
    clock.t = (T0 // 60_000) * 60_000
    n_clients, per_client = 8, 10
    allowed = np.zeros(n_clients, dtype=np.int64)
    barrier = threading.Barrier(n_clients)

    def worker(i):
        client = _client(server)
        barrier.wait()
        for _ in range(per_client):
            if client.try_acquire(lid, "shared"):
                allowed[i] += 1
        client.close()

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    # 80 requests across 8 connections -> exactly 10 allowed: all clients
    # funnel into the same device batches.
    assert allowed.sum() == 10


def test_error_paths(sidecar):
    server, _ = sidecar
    client = _client(server)
    with pytest.raises(RuntimeError):
        client.try_acquire(9999, "nobody")  # unknown limiter id
    client.close()


def test_v3_handshake_negotiates(sidecar):
    server, _ = sidecar
    client = _client(server)
    assert client.server_version == sc.PROTOCOL_VERSION == 6
    pinned = _client(server, protocol=3)
    assert pinned.server_version == 3
    pinned.close()
    assert client.server_max_frame == server.max_frame_bytes
    client.close()


def test_v2_client_negotiates_down_and_never_sees_lease_ops(sidecar):
    server, _ = sidecar
    lid = server.register("tb", RateLimitConfig(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    server.attach_leases(leases.LeaseManager(server.storage))
    client = _client(server, protocol=2)
    assert client.server_version == 2
    for op in (sc.OP_LEASE, sc.OP_RENEW, sc.OP_RELEASE):
        client._send(client._frame(op, lid, 8, "k"))
        status, _, errno = client._read_raw()
        assert (status, errno) == (sc.ST_BAD_FRAME, sc.ERR_UNKNOWN_OP), op
    assert client.try_acquire(lid, "v2-still-works") is True
    client.close()


def test_unknown_op_on_v3_connection_is_bad_frame(sidecar):
    server, _ = sidecar
    lid = server.register("tb", RateLimitConfig(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    client = _client(server, protocol=3)
    assert client.server_version == 3
    client._send(client._frame(42, lid, 0, "k"))
    status, _, errno = client._read_raw()
    assert (status, errno) == (sc.ST_BAD_FRAME, sc.ERR_UNKNOWN_OP)
    assert client.try_acquire(lid, "after-unknown-op") is True
    client.close()


def test_lease_ops_without_manager_answer_disabled(sidecar):
    server, _ = sidecar
    lid = server.register("tb", RateLimitConfig(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    client = _client(server)
    client._send(client._frame(sc.OP_LEASE, lid, 8, "k", ext=0))
    status, _, errno = client._read_raw()
    assert (status, errno) == (sc.ST_ERROR, sc.ERR_LEASE_DISABLED)
    client.close()


def test_lease_wire_round_trip_and_local_burn(sidecar):
    server, clock = sidecar
    cfg = RateLimitConfig(max_permits=500, window_ms=60_000,
                          refill_rate=100.0)
    lid = server.register("tb", cfg)
    mgr = leases.LeaseManager(server.storage, default_budget=16,
                              ttl_ms=10_000.0, clock_ms=lambda: clock.t)
    server.attach_leases(mgr)
    wire = _client(server)
    cli = leases.LeaseClient(wire, lid, budget=16, clock_ms=lambda: clock.t,
                             direct_fallback=False)
    allowed = sum(1 for _ in range(100) if cli.try_acquire("leased-key"))
    assert allowed == 100
    assert cli.wire_ops <= 100 // 10  # >= 10x frame reduction
    cli.release_all()
    assert mgr.table.outstanding() == 0
    st = mgr.status()
    assert st["local_decisions"] == 100
    assert st["over_admission"] == 0
    avail = int(server.storage.available_many("tb", lid,
                                              ["leased-key"])[0])
    assert avail == cfg.max_permits - 100
    wire.close()


def test_v1_client_interoperates_unchanged(sidecar):
    server, clock = sidecar
    lid = server.register("sw", RateLimitConfig(
        max_permits=3, window_ms=60_000, enable_local_cache=False))
    client = _client(server, protocol=1)
    assert client.server_version == 1  # never handshook
    assert client.ping()
    clock.t = (T0 // 60_000) * 60_000
    assert [client.try_acquire(lid, "v1user") for _ in range(5)] == \
        [True, True, True, False, False]
    assert client.available(lid, "v1user") == 0
    client.reset(lid, "v1user")
    assert client.try_acquire(lid, "v1user")
    with pytest.raises(RuntimeError):
        client.try_acquire(9999, "nobody")
    client.close()


def test_edge_frames_answered_in_protocol(sidecar):
    server, _ = sidecar
    lid = server.register("tb", RateLimitConfig(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    client = _client(server)
    assert client.try_acquire(lid, "") is True
    big = "k" * server.max_key_bytes
    assert client.try_acquire(lid, big) is True
    with pytest.raises(RuntimeError):
        client.try_acquire(lid, big + "k")
    assert client.try_acquire(lid, "zero", permits=0) is True
    with pytest.raises(RuntimeError):
        client.try_acquire(9999, "nobody")
    client._send(struct.pack("<I", 3) + b"abc")
    status, _, errno = client._read_raw()
    assert (status, errno) == (sc.ST_BAD_FRAME, sc.ERR_SHORT_FRAME)
    assert client.try_acquire(lid, "after-the-storm") is True
    client.close()


def test_oversized_declared_frame_stays_in_sync(sidecar):
    server, _ = sidecar
    lid = server.register("tb", RateLimitConfig(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    client = _client(server)
    declared = server.max_frame_bytes + 1000
    client._send(struct.pack("<I", declared) + b"\x00" * declared)
    status, _, errno = client._read_raw()
    assert (status, errno) == (sc.ST_BAD_FRAME, sc.ERR_FRAME_TOO_LONG)
    assert client.try_acquire(lid, "still-alive") is True
    assert server.malformed_total >= 1
    client.close()


def test_graceful_drain_on_stop():
    clock = FakeClock()
    storage = GpuBatchedStorage(num_slots=256, max_delay_ms=0.2,
                                clock_ms=clock, device="cpu")
    server = sc.SidecarServer(storage, host="127.0.0.1",
                              drain_timeout_ms=200.0).start()
    try:
        lid = server.register("tb", RateLimitConfig(
            max_permits=10, window_ms=60_000, refill_rate=5.0))
        client = _client(server)
        assert client.try_acquire(lid, "pre-drain") is True
        server._draining = True  # what stop() sets first
        got = client.acquire_batch(lid, ["a", "b"])
        assert all(s == sc.ST_SHUTTING_DOWN for s, _, _ in got)
        assert server.drained_total == 2
        client.close()
    finally:
        server.stop()
        storage.close()


def test_global_connection_limit():
    clock = FakeClock()
    storage = GpuBatchedStorage(num_slots=256, max_delay_ms=0.2,
                                clock_ms=clock, device="cpu")
    server = sc.SidecarServer(storage, host="127.0.0.1",
                              max_connections=2).start()
    try:
        a = _client(server)
        b = _client(server)
        with pytest.raises(ConnectionError):
            sc.SidecarClient("127.0.0.1", server.port, timeout=2.0)
        assert server.refused_total == 1
        assert a.ping() and b.ping()
        a.close()
        b.close()
    finally:
        server.stop()
        storage.close()


def test_v5_negotiation_and_v4_batch_rejected(sidecar):
    server, _ = sidecar
    lid = server.register("tb", RateLimitConfig(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    cli = _client(server)
    assert cli.server_version == sc.PROTOCOL_VERSION
    pinned = _client(server, protocol=4)
    assert pinned.server_version == 4
    pinned._send(pinned._frame(sc.OP_BATCH, lid, 2, "xx"))
    status, _, errno = pinned._read_raw()
    assert (status, errno) == (sc.ST_BAD_FRAME, sc.ERR_UNKNOWN_OP)
    assert pinned.try_acquire(lid, "v4-after-batch") is True
    pinned.close()
    cli.close()


def test_acquire_block_matches_per_request_decisions(sidecar):
    server, _ = sidecar
    cfg = RateLimitConfig(max_permits=7, window_ms=60_000, refill_rate=0.0)
    lid_blk = server.register("tb", cfg)
    lid_ref = server.register("tb", cfg)
    cli = _client(server)
    keys = [f"k{i % 5}" for i in range(40)]
    perms = [(i % 3) + 1 for i in range(40)]
    got = cli.acquire_block(lid_blk, keys, permits=perms)
    ref = [a for _, a, _ in cli.acquire_batch(lid_ref, keys, permits=perms)]
    assert got == ref
    assert True in got and False in got
    got = cli.acquire_block(lid_blk, keys)
    ref = [a for _, a, _ in cli.acquire_batch(lid_ref, keys)]
    assert got == ref
    cli.close()


def test_v5_malformed_columns_answered_in_protocol(sidecar):
    server, _ = sidecar
    lid = server.register("tb", RateLimitConfig(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    cli = _client(server)
    cap = server.max_pipeline
    bad = [
        _raw_batch(6, lid, 2, 4, b"abcd", [0, 2, 4], 1),
        _raw_batch(6, lid, 2, 4, b"abcd", [0, 2, 9], 0),
        _raw_batch(6, lid, 2, 4, b"abcd", [4, 2, 4], 0),
        _raw_batch(6, lid, cap + 1, 4, b"abcd", [0] * (cap + 2), 0),
        _raw_batch(6, lid, 2, 2, b"\xff\xfe", [0, 1, 2], 0),
    ]
    cli._send(b"".join(bad))
    got = cli._read_responses(len(bad))
    assert [s for s, _, _ in got] == [sc.ST_BAD_FRAME] * 5
    assert [e for _, _, e in got] == [
        sc.ERR_SHORT_FRAME, sc.ERR_BAD_COLUMN, sc.ERR_BAD_COLUMN,
        sc.ERR_FRAME_TOO_LONG, sc.ERR_BAD_KEY]
    assert cli.acquire_block(lid, ["ok-a", "ok-b"]) == [True, True]
    cli.close()


def test_v5_block_unknown_limiter_and_shed_raise(sidecar):
    server, _ = sidecar
    cli = _client(server)
    with pytest.raises(RuntimeError):
        cli.acquire_block(9999, ["a", "b"])
    lid = server.register("tb", RateLimitConfig(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    assert cli.acquire_block(lid, ["after-error"]) == [True]
    cli.close()


def test_lease_client_batched_submit(sidecar):
    server, _ = sidecar
    cfg = RateLimitConfig(max_permits=1 << 16, window_ms=60_000,
                          refill_rate=1e5)
    lid_a = server.register("tb", cfg)
    lid_b = server.register("tb", cfg)
    server.attach_leases(leases.LeaseManager(
        server.storage, default_budget=32, max_budget=32, ttl_ms=60_000.0))
    wire_a = _client(server)
    wire_b = _client(server)
    batched = leases.LeaseClient(wire_a, lid_a, budget=32, telemetry=False)
    serial = leases.LeaseClient(wire_b, lid_b, budget=32, telemetry=False)
    keys = [f"u{i % 6}" for i in range(192)]
    got = batched.try_acquire_many(keys)
    ref = [serial.try_acquire(k) for k in keys]
    assert got == ref
    assert batched.local_decisions > 0
    assert batched.wire_ops <= serial.wire_ops
    batched.release_all()
    serial.release_all()
    wire_a.close()
    wire_b.close()
