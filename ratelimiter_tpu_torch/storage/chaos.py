"""Fault-injecting storage wrapper (chaos testing), the TCP fault proxy,
and the ingress, sustained-outage and replicated-failover drills
(counterpart of ``ratelimiter_tpu/storage/chaos.py``: its
``FaultInjectingStorage``, ``FaultInjectingProxy``, ``ingress_drill``,
``outage_drill`` and ``failover_drill``; the other drills need the
sharded engine, the orchestrator, the cross-host topology and the fleet,
which the port does not have yet).

The reference has no fault injection at all (SURVEY.md §5.3 — its failure
handling is asserted, not exercised). This wrapper makes failure paths
first-class testable: it delegates to any ``RateLimitStorage`` and injects
``StorageException`` (and optional latency) on a configurable schedule, so
retry logic, fail-open policy, and metric accounting can be driven
deterministically in tests and chaos drills.

Determinism: failures come from a seeded RNG; ``fail_next(n)`` forces the
next n operations to fail regardless of probability — the tool for exact
retry-count assertions (the reference's retry wrapper does 3 attempts with
linear backoff; ``service/app.py`` implements the documented fail-open on
exhaustion).
"""

from __future__ import annotations

import collections
import random
import threading
import time

from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.storage.errors import StorageException

_DECISION_OPS = ("acquire", "acquire_many", "acquire_many_ids",
                 "acquire_stream_ids", "acquire_stream_strs",
                 "available_many", "reset_key")
_LEGACY_OPS = ("increment_and_expire", "get", "set", "compare_and_set",
               "delete", "z_add", "z_remove_range_by_score", "z_count",
               "eval_script")


class FaultInjectingStorage(RateLimitStorage):
    """Wraps a real backend; injects failures/latency on configured ops."""

    def __init__(
        self,
        inner: RateLimitStorage,
        failure_rate: float = 0.0,
        latency_ms: float = 0.0,
        seed: int = 0,
        ops: tuple = _DECISION_OPS + _LEGACY_OPS,
    ):
        self._inner = inner
        self.failure_rate = float(failure_rate)
        self.latency_ms = float(latency_ms)
        self._rng = random.Random(seed)
        self._ops = set(ops)
        self._lock = threading.Lock()
        self._forced = 0
        self.injected_failures = 0
        # Recent op names only — bounded so long-running drills can't leak.
        self.calls = collections.deque(maxlen=1024)

    # -- control surface ------------------------------------------------------
    def fail_next(self, n: int = 1) -> None:
        """Force the next ``n`` wrapped operations to fail."""
        with self._lock:
            self._forced += int(n)

    def heal(self) -> None:
        """Cancel any remaining forced failures (drills: end an outage)."""
        with self._lock:
            self._forced = 0

    def _maybe_fail(self, op: str) -> None:
        if op not in self._ops:
            return
        with self._lock:
            self.calls.append(op)
            if self._forced > 0:
                self._forced -= 1
                self.injected_failures += 1
                raise StorageException(f"injected failure in {op}")
            if self.failure_rate and self._rng.random() < self.failure_rate:
                self.injected_failures += 1
                raise StorageException(f"injected failure in {op}")
        if self.latency_ms:
            time.sleep(self.latency_ms / 1000.0)

    def __getattr__(self, name):
        # Everything not explicitly wrapped (register_limiter, flush,
        # checkpoints, attributes like engine/trace) passes straight through.
        return getattr(self._inner, name)

    # -- wrapped surface ------------------------------------------------------
    @property
    def supports_device_batching(self):  # type: ignore[override]
        return getattr(self._inner, "supports_device_batching", False)


def _wrap(op: str):
    def method(self, *args, **kwargs):
        self._maybe_fail(op)
        return getattr(self._inner, op)(*args, **kwargs)

    method.__name__ = op
    return method


for _op in _DECISION_OPS + _LEGACY_OPS + ("is_available", "close"):
    setattr(FaultInjectingStorage, _op, _wrap(_op))
# is_available/close are wrapped for delegation but never injected by
# default (they are the health/shutdown path; pass them in ``ops`` to
# chaos-test the health check itself).
#
# The abstract-method set was frozen before the loop above filled the
# contract in; clear it so the wrapper instantiates.
FaultInjectingStorage.__abstractmethods__ = frozenset()


class FaultInjectingProxy:
    """TCP man-in-the-middle for ingress chaos (service/sidecar.py).

    Listens on a local port and forwards each connection to a target
    server, injecting network faults into the CLIENT->SERVER direction on
    a configured schedule.  Fault classes (``set_fault``):

    - ``None``        — transparent passthrough (baseline),
    - ``"truncate"``  — forward only the first ``after`` bytes, then
      swallow everything else (the server holds a half-written frame
      until its read deadline fires — the slowloris shape),
    - ``"delay"``     — forward in 1-byte pieces with ``delay_ms`` sleeps
      (a slow writer that keeps the frame perpetually almost-done),
    - ``"garbage"``   — after ``after`` forwarded bytes, inject ``n``
      seeded-random bytes into the stream (framing corruption), then keep
      forwarding,
    - ``"kill"``      — abruptly close both sides after ``after``
      forwarded bytes (a client dying mid-pipeline),
    - ``"partition"`` — drop bytes without closing either socket (no
      RST, no FIN): the network-partition shape — the peer looks
      silently gone, exactly what an ack deadline/heartbeat must detect
      (``partition()`` / ``heal()`` are shorthands).  ``direction=``
      scopes the cut: ``"both"`` (default), ``"up"`` (client->server),
      or ``"down"`` (server->client only — the HALF-OPEN link where
      sends land but acks vanish),
    - ``"flap"``      — alternate partitioned and healthy every half
      ``period_s`` (a flaky link that heals before any single probe
      window closes — what the orchestrator's hysteresis must damp).

    ALL fault modes are evaluated LIVE, per chunk: a ``set_fault``/
    ``heal`` takes effect on in-flight connections at their next chunk
    boundary, not just on new accepts.  A long-lived connection (a
    replication link, a pinned sidecar session) must be degradable and
    healable mid-stream without reconnecting — the chaos conductor
    flips faults on links whose connections outlive every schedule
    step.  Per-connection byte counters (``after`` bookkeeping, the
    one-shot garbage injection) still start at accept time.
    Server->client bytes pass through untouched except under
    partition/flap — those attack the LINK, not just the ingress.
    """

    def __init__(self, target_port: int, target_host: str = "127.0.0.1",
                 host: str = "127.0.0.1", port: int = 0, seed: int = 0):
        import socket
        import socketserver

        self.target = (target_host, int(target_port))
        self._rng = random.Random(seed)
        self._fault: tuple = (None, {})
        self._flap_t0 = time.monotonic()
        self._lock = threading.Lock()
        self.connections = 0
        self.faults_injected = 0
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with outer._lock:
                    outer.connections += 1
                try:
                    up = socket.create_connection(outer.target, timeout=10.0)
                except OSError:
                    return
                down = threading.Thread(
                    target=outer._pump_down, args=(up, self.request),
                    daemon=True)
                down.start()
                try:
                    outer._pump_up(self.request, up)
                finally:
                    for s in (up, self.request):
                        try:
                            s.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                        try:
                            s.close()
                        except OSError:
                            pass
                    down.join(timeout=2.0)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="chaos-proxy",
            daemon=True)

    # -- control surface ------------------------------------------------------
    def set_fault(self, mode: str | None, **params) -> None:
        """Set the fault class, applied LIVE: in-flight connections see
        the new mode at their next chunk boundary, new connections from
        their first byte.

        ``after``: client bytes forwarded before the fault engages
        (default 0); ``n``: garbage byte count; ``delay_ms``: per-byte
        delay for ``"delay"``; ``period_s``: full flap cycle for
        ``"flap"`` (half up, half partitioned); ``direction``: which
        pump(s) a ``"partition"`` cuts — ``"both"`` (default), ``"up"``
        (client->server dropped, responses flow), or ``"down"``
        (server->client dropped: the HALF-OPEN link — sends land, acks
        vanish — that only an ack deadline can detect)."""
        if mode not in (None, "truncate", "delay", "garbage", "kill",
                        "partition", "flap"):
            raise ValueError(f"unknown fault mode: {mode!r}")
        direction = params.get("direction", "both")
        if direction not in ("both", "up", "down"):
            raise ValueError(f"unknown partition direction: {direction!r}")
        with self._lock:
            self._fault = (mode, dict(params))
            if mode == "flap":
                self._flap_t0 = time.monotonic()

    def partition(self, direction: str = "both") -> None:
        """Drop ``direction`` on every connection, live — no RST, no
        FIN: the silent network partition.  ``direction="down"`` makes
        the link HALF-OPEN (client bytes still arrive at the server,
        its acks/responses are swallowed) — the asymmetric-partition
        shape a one-byte-ack protocol can only catch via its ack
        deadline.  ``heal()`` restores."""
        self.set_fault("partition", direction=direction)

    def flap(self, period_s: float) -> None:
        """Alternate healthy/partitioned every ``period_s / 2``, live."""
        self.set_fault("flap", period_s=float(period_s))

    def heal(self) -> None:
        """Back to transparent passthrough (ends a partition/flap)."""
        self.set_fault(None)

    def _link_cut(self, direction: str = "both") -> bool:
        """Live verdict: are bytes currently being dropped in
        ``direction`` ("up" = client->server, "down" = server->client)?
        (Only the partition/flap modes cut the link wholesale; the
        ingress faults shape bytes in :meth:`_pump_up` instead.)"""
        with self._lock:
            mode, params = self._fault
            if mode == "partition":
                cut = params.get("direction", "both")
                return cut == "both" or cut == direction
            if mode == "flap":
                period = float(params.get("period_s", 0.2))
                phase = (time.monotonic() - self._flap_t0) % period
                return phase >= period / 2.0
            return False

    def start(self) -> "FaultInjectingProxy":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- pumps ----------------------------------------------------------------
    def _pump_down(self, up, client) -> None:
        """Server->client passthrough until either side dies (bytes are
        silently dropped while a live partition/flap cut is on)."""
        while True:
            try:
                chunk = up.recv(65536)
            except OSError:
                return
            if not chunk:
                try:
                    client.shutdown(1)  # SHUT_WR: flush EOF downstream
                except OSError:
                    pass
                return
            if self._link_cut("down"):
                with self._lock:
                    self.faults_injected += 1
                continue  # dropped: no RST, no FIN — silence
            try:
                client.sendall(chunk)
            except OSError:
                return

    def _pump_up(self, client, up) -> None:
        """Client->server with the CURRENT fault applied — the mode is
        re-read per chunk, so a mid-connection ``set_fault``/``heal``
        takes effect without a reconnect.  The ``forwarded`` byte
        counter and the garbage one-shot are per-connection state; the
        one-shot re-arms whenever the mode leaves ``"garbage"``, so a
        heal-then-reinject cycle corrupts the stream again."""
        forwarded = 0
        injected = False
        while True:
            try:
                chunk = client.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            if self._link_cut("up"):
                with self._lock:
                    self.faults_injected += 1
                continue  # partition/flap: dropped — silence, no close
            with self._lock:
                mode, params = self._fault
                garbage = b""
                if mode == "garbage" and not injected:
                    garbage = bytes(self._rng.randrange(256)
                                    for _ in range(params.get("n", 64)))
            after = int(params.get("after", 0))
            if mode != "garbage":
                injected = False
            if mode == "kill" and forwarded + len(chunk) >= after:
                cut = max(after - forwarded, 0)
                try:
                    if cut:
                        up.sendall(chunk[:cut])
                except OSError:
                    return
                with self._lock:
                    self.faults_injected += 1
                return  # handler's finally closes both sides abruptly
            if mode == "truncate":
                if forwarded >= after:
                    continue  # swallow: server waits on a half frame
                chunk = chunk[:max(after - forwarded, 0)]
                if forwarded + len(chunk) >= after:
                    with self._lock:
                        self.faults_injected += 1
            if mode == "garbage" and not injected \
                    and forwarded + len(chunk) >= after:
                cut = max(after - forwarded, 0)
                chunk = chunk[:cut] + garbage + chunk[cut:]
                injected = True
                with self._lock:
                    self.faults_injected += 1
            try:
                if mode == "delay":
                    delay_s = float(params.get("delay_ms", 20.0)) / 1000.0
                    for i in range(len(chunk)):
                        up.sendall(chunk[i:i + 1])
                        time.sleep(delay_s)
                else:
                    up.sendall(chunk)
            except OSError:
                return
            forwarded += len(chunk)


# ---------------------------------------------------------------------------
# Ingress drill (sidecar under network faults, differential vs the oracle)
# ---------------------------------------------------------------------------

def ingress_drill(
    num_slots: int = 1024,
    n_keys: int = 32,
    waves: int = 3,
    pipeline: int = 12,
    max_pipeline: int = 16,
    read_timeout_ms: float = 300.0,
    seed: int = 0,
    registry=None,
    device=None,
) -> dict:
    """Deterministic sidecar-ingress chaos drill.

    Runs the hardened sidecar (protocol v2, tight frame/pipeline/deadline
    bounds) over a controlled-clock ``GpuBatchedStorage`` on ``device``
    (None: the card) and attacks it
    with every fault class — malformed frames sent directly, plus
    truncate / garbage / kill-mid-pipeline through a
    :class:`FaultInjectingProxy` — while a healthy v2 client keeps making
    pipelined decisions that are checked BIT-IDENTICAL against
    ``semantics/oracle.py``.  It proves:

    - the server stays up under every fault class (PING works, later
      decisions still exact);
    - malformed frames are answered in-protocol with ``BAD_FRAME`` (the
      attacking connection survives and can still make valid decisions);
    - a slow/truncated frame trips the read deadline instead of pinning
      a handler thread;
    - a client killed mid-pipeline leaks nothing: batcher queue depth and
      the unresolved-waiter set return to baseline (abandoned futures are
      withdrawn or consumed), and handler threads are reaped;
    - pipeline overflow is shed with the typed retry-after status;
    - the health state machine's inputs transition: shedding is visible
      via ``last_shed_s`` within the health window.

    Returns a report dict; raises AssertionError on any violated claim.
    """
    import socket as socket_mod
    import struct

    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.service import sidecar as sc
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    rng = random.Random(seed)
    clock = {"t": 1_753_000_000_000}
    # max_inflight=1 pins the drain pool at one worker so the end-of-drill
    # thread-leak check compares like with like.
    storage = GpuBatchedStorage(num_slots=num_slots, max_delay_ms=0.2,
                                max_inflight=1,
                                clock_ms=lambda: clock["t"], device=device)
    server = sc.SidecarServer(
        storage, host="127.0.0.1", meter_registry=registry,
        max_frame_bytes=512, max_key_bytes=64,
        max_pipeline=max_pipeline, max_connections=64,
        idle_timeout_ms=5_000.0, read_timeout_ms=read_timeout_ms,
        drain_timeout_ms=500.0).start()
    report = {"decisions": 0, "mismatches": 0, "faults": [],
              "shed": 0, "malformed_answered": 0}
    proxy = FaultInjectingProxy(server.port, seed=seed).start()
    try:
        cfg_sw = RateLimitConfig(max_permits=10, window_ms=2000,
                                 enable_local_cache=False)
        cfg_tb = RateLimitConfig(max_permits=20, window_ms=2000,
                                 refill_rate=8.0)
        lid_sw = server.register("sw", cfg_sw)
        lid_tb = server.register("tb", cfg_tb)
        # The attacker gets its own limiter so its mutations never touch
        # the oracle-tracked keyspace.
        lid_atk = server.register("tb", RateLimitConfig(
            max_permits=1000, window_ms=60_000, refill_rate=100.0))
        oracle_sw = SlidingWindowOracle(cfg_sw)
        oracle_tb = TokenBucketOracle(cfg_tb)
        healthy = sc.SidecarClient("127.0.0.1", server.port)
        assert healthy.server_version >= 3, "handshake failed"

        def healthy_wave() -> None:
            """Pipelined decisions on the DIRECT path, oracle-checked."""
            clock["t"] += rng.choice([3, 17, 250, 999, 2000])
            now = clock["t"]
            keys = [f"u{rng.randrange(n_keys)}" for _ in range(pipeline)]
            perms = [rng.choice([1, 1, 2, 5]) for _ in range(pipeline)]
            for lid, oracle in ((lid_sw, oracle_sw), (lid_tb, oracle_tb)):
                got = healthy.acquire_batch(lid, keys, perms)
                for j, (status, allowed, rem) in enumerate(got):
                    assert status == sc.ST_OK, (lid, j, status)
                    d = oracle.try_acquire(keys[j], perms[j], now)
                    report["decisions"] += 1
                    if allowed != d.allowed or (
                            lid == lid_tb and int(rem) != d.remaining_hint):
                        report["mismatches"] += 1

        def frame(op, a, b, key_bytes=b""):
            body = struct.pack("<BII", op, a, b) + key_bytes
            return struct.pack("<I", len(body)) + body

        # Baselines: warm one wave, then record thread/queue levels.
        healthy_wave()
        base_threads = threading.active_count()
        batcher = storage._batcher
        assert batcher.queue_depth() == 0

        # -- fault 1: malformed frames, sent directly --------------------
        # Pinned to v3: the hand-built frames below use the headerless
        # pre-v4 layout, so the connection must negotiate it.
        atk = sc.SidecarClient("127.0.0.1", server.port, protocol=3)
        declared = 100_000  # far over max_frame_bytes=512
        bad = [
            frame(1, lid_atk, 1, b"x" * 128),             # key too long
            struct.pack("<I", 4) + b"abc\x00",            # short frame
            frame(42, lid_atk, 1, b"k"),                  # unknown op
            frame(1, lid_atk, 1, b"\xff\xfe\xff"),        # invalid UTF-8 key
            struct.pack("<I", declared) + b"\x00" * declared,  # oversized
        ]
        # The oversized frame's declared payload is discarded as it
        # streams (never buffered) and the stream stays in sync: a valid
        # frame directly behind it still decides.
        atk._send(b"".join(bad))
        got = atk._read_responses(len(bad))
        for status, _, errno in got:
            assert status == sc.ST_BAD_FRAME, got
            report["malformed_answered"] += 1
        assert [g[2] for g in got] == [
            sc.ERR_KEY_TOO_LONG, sc.ERR_SHORT_FRAME, sc.ERR_UNKNOWN_OP,
            sc.ERR_BAD_KEY, sc.ERR_FRAME_TOO_LONG], got
        assert atk.try_acquire(lid_atk, "atk-ok") is True
        atk.close()
        report["faults"].append("malformed")
        healthy_wave()

        # -- fault 1b: malformed v5 columnar frames ----------------------
        # A v5 attacker hand-builds BATCH frames whose columns lie about
        # themselves.  Every one must be answered in-protocol with
        # BAD_FRAME + the right errno, the stream must stay in sync, and
        # a well-formed batch directly after must still decide.
        import numpy as _np
        atk5 = sc.SidecarClient("127.0.0.1", server.port)
        assert atk5.server_version >= 5

        def batch_frame(rows, klen, key_col, offs, flags, permits=b""):
            payload = (struct.pack("<I", klen) + key_col
                       + _np.asarray(offs, dtype=_np.uint32).tobytes()
                       + bytes([flags]) + permits)
            body = struct.pack("<BIIQ", sc.OP_BATCH, lid_atk, rows,
                               0) + payload
            return struct.pack("<I", len(body)) + body

        bad5 = [
            # column length mismatch: flags declare a permits column the
            # frame does not carry.
            batch_frame(2, 4, b"abcd", [0, 2, 4], 1),
            # offsets out of bounds: offs[-1] walks past the key column.
            batch_frame(2, 4, b"abcd", [0, 2, 9], 0),
            # offsets not monotonic.
            batch_frame(2, 4, b"abcd", [0, 3, 2][:3], 0),
            # declared rows over the frame cap (max_pipeline).
            batch_frame(max_pipeline + 1, 4, b"abcd",
                        [0] * (max_pipeline + 2), 0),
        ]
        atk5._send(b"".join(bad5))
        got5 = atk5._read_responses(len(bad5))
        for status, _, errno in got5:
            assert status == sc.ST_BAD_FRAME, got5
            report["malformed_answered"] += 1
        assert [g[2] for g in got5] == [
            sc.ERR_SHORT_FRAME, sc.ERR_BAD_COLUMN, sc.ERR_BAD_COLUMN,
            sc.ERR_FRAME_TOO_LONG], got5
        # Stream in sync: a valid columnar batch right behind the attack
        # still decides (and the bitmask has exactly its rows).
        assert atk5.acquire_block(lid_atk, ["b5-a", "b5-b"]) == [True, True]
        atk5.close()
        report["faults"].append("malformed_v5_columns")
        healthy_wave()

        # -- fault 2: slowloris / truncated frame ------------------------
        idle_before = server.idle_closed_total
        slow = socket_mod.create_connection(("127.0.0.1", server.port),
                                            timeout=5.0)
        slow.sendall(frame(1, lid_atk, 1, b"half-frame")[:9])  # partial
        t0 = time.monotonic()
        got_eof = slow.recv(16)  # server must close within the deadline
        dt = time.monotonic() - t0
        assert got_eof == b"", "server answered a half frame?"
        assert dt < read_timeout_ms / 1000.0 + 2.0, (
            f"read deadline did not fire in time ({dt:.2f}s)")
        assert server.idle_closed_total > idle_before
        slow.close()
        report["faults"].append("slowloris")
        healthy_wave()

        # -- fault 3: garbage injection through the proxy ----------------
        proxy.set_fault("garbage", after=17, n=48)
        gbg = sc.SidecarClient("127.0.0.1", proxy.port, protocol=1)
        try:
            # The injected garbage corrupts this connection's framing;
            # the server answers in-protocol or the conn dies — either
            # way the SERVER survives and other clients are unaffected.
            gbg.acquire_batch(lid_atk, [f"g{i}" for i in range(8)])
        except (ConnectionError, RuntimeError, socket_mod.timeout):
            pass
        finally:
            gbg.close()
        report["faults"].append("garbage")
        healthy_wave()

        # -- fault 4: kill mid-pipeline ----------------------------------
        proxy.set_fault("kill", after=120)  # dies mid-burst
        kil = sc.SidecarClient("127.0.0.1", proxy.port, protocol=1)
        try:
            kil.acquire_batch(lid_atk, [f"k{i}" for i in range(24)])
        except (ConnectionError, socket_mod.timeout, OSError):
            pass
        finally:
            kil.close()
        report["faults"].append("kill_mid_pipeline")
        healthy_wave()

        # -- pipeline-cap shed: typed retry-after status -----------------
        # The cap engages when the burst lands in one read; loopback with
        # TCP_NODELAY delivers an ~800-byte burst in one segment, but a
        # kernel split would halve it — retry a couple of times before
        # calling the cap broken.
        burst = max_pipeline * 2
        n_ok = n_shed = 0
        for _ in range(3):
            got = healthy.acquire_batch(
                lid_tb, [f"shed-{i}" for i in range(burst)])
            # Shed frames never reach the device, so the oracle stream is
            # untouched; ok frames mutate only shed-* keys (not tracked).
            n_ok = sum(1 for s, _, _ in got if s == sc.ST_OK)
            n_shed = sum(1 for s, _, _ in got if s == sc.ST_SHED)
            assert n_ok + n_shed == burst, got
            if n_shed:
                break
        assert n_shed >= 1, "pipeline cap never engaged"
        for status, _, rem in got:
            if status == sc.ST_SHED:
                assert rem > 0, "shed without a retry-after hint"
        report["shed"] = n_shed
        # Health machine input: a recent shed reads as SHEDDING inside
        # the window.
        assert server.last_shed_s > 0
        assert (time.monotonic() - server.last_shed_s) <= 5.0
        healthy_wave()

        # -- convergence: no leaked threads, futures, or queue depth -----
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with batcher._cv:
                waiters = len(batcher._waiters)
            if (batcher.queue_depth() == 0 and waiters == 0
                    and threading.active_count() <= base_threads):
                break
            time.sleep(0.05)
        with batcher._cv:
            waiters = len(batcher._waiters)
        assert batcher.queue_depth() == 0, "queue depth did not drain"
        assert waiters == 0, f"{waiters} batcher future(s) leaked"
        assert threading.active_count() <= base_threads, (
            f"handler threads leaked: {threading.active_count()} > "
            f"baseline {base_threads}")
        assert storage.is_available(), "server/storage not healthy at end"
        assert healthy.ping(), "sidecar did not survive the fault classes"
        healthy.close()

        report["threads"] = threading.active_count()
        report["idle_closed"] = server.idle_closed_total
        report["malformed"] = server.malformed_total
        report["pipeline_shed"] = server.pipeline_shed_total
        report["futures_abandoned"] = server.futures_abandoned
        if report["mismatches"]:
            raise AssertionError(
                f"healthy decisions diverged from the oracle: {report}")
        return report
    finally:
        proxy.stop()
        server.stop()
        storage.close()


# ---------------------------------------------------------------------------
# Sustained-outage drill (breaker open -> degraded -> resync -> bit-identical)
# ---------------------------------------------------------------------------

def outage_drill(
    num_slots: int = 512,
    n_keys: int = 24,
    healthy_waves: int = 3,
    outage_waves: int = 4,
    post_waves: int = 3,
    batch: int = 24,
    seed: int = 0,
    failure_threshold: int = 4,
    max_retries: int = 2,
    open_ms: float = 5000.0,
    registry=None,
    storage_factory=None,
) -> dict:
    """Deterministic sustained-outage drill over the production composition
    ``retry(breaker(chaos(storage)))``, differential vs the oracle.

    Phases, all under a controlled clock:

    1. **Healthy** — mixed sw/tb waves through single ``acquire``; every
       decision checked bit-exact against ``semantics/oracle.py`` (and the
       breaker's healthy path snapshots each key's last counter into the
       degraded limiter's seed cache).
    2. **Outage** — every backend op is forced to fail.  The drill proves
       the breaker opens within ``ceil(threshold / attempts)`` requests
       (each retry attempt counts), then that decisions are served by the
       degraded host limiter — marked ``degraded``, ZERO backend calls
       (the short-circuit claim, checked against the injector's op log),
       and per-key-per-window admission never exceeds ``max_permits``
       (bounded over-admission: fail-*approximate*, not fail-open).
    3. **Recovery** — the fault is healed and the clock advanced past
       ``open_ms``; a half-open probe on a dedicated key closes the
       breaker, which resyncs: every key the degraded limiter mutated is
       reset on the device.  The drill mirrors those resets in the oracle.
    4. **Post-resync** — waves again, bit-identical vs the oracle.

    The storage is ``GpuBatchedStorage(num_slots=num_slots, clock_ms=...)``
    on the card, or what ``storage_factory(num_slots, clock_ms)`` returns
    (for example a ``device="cpu"`` storage, or one that counts its
    clears).

    Returns a report dict; raises AssertionError on any violated claim.
    """
    import math
    import random

    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.storage.breaker import (
        CLOSED,
        OPEN,
        CircuitBreakerStorage,
    )
    from ratelimiter_tpu_torch.storage.degraded import DegradedHostLimiter
    from ratelimiter_tpu_torch.storage.errors import (
        RetryPolicy,
        StorageException,
    )
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
    from ratelimiter_tpu_torch.storage.retry import RetryingStorage

    from ratelimiter_tpu_torch.observability import flight_recorder

    frec = flight_recorder()
    fmark = frec.mark()
    rng = random.Random(seed)
    clock = {"t": 1_753_000_000_000}
    if storage_factory is None:
        def storage_factory(n, clock_ms):
            return GpuBatchedStorage(num_slots=n, clock_ms=clock_ms)
    inner = storage_factory(num_slots, lambda: clock["t"])
    chaos = FaultInjectingStorage(inner)
    fallback = DegradedHostLimiter(clock_ms=lambda: clock["t"],
                                   registry=registry)
    breaker = CircuitBreakerStorage(
        chaos, failure_threshold=failure_threshold, open_ms=open_ms,
        half_open_probes=1, clock_ms=lambda: clock["t"], fallback=fallback,
        registry=registry)
    storage = RetryingStorage(breaker, RetryPolicy(
        max_retries=max_retries, retry_delay_ms=0.01))

    cfg_sw = RateLimitConfig(max_permits=12, window_ms=2000,
                             enable_local_cache=False)
    cfg_tb = RateLimitConfig(max_permits=20, window_ms=2000, refill_rate=8.0)
    lid_sw = storage.register_limiter("sw", cfg_sw)
    lid_tb = storage.register_limiter("tb", cfg_tb)
    oracle_sw = SlidingWindowOracle(cfg_sw)
    oracle_tb = TokenBucketOracle(cfg_tb)

    report = {"decisions": 0, "mismatches": 0, "requests_to_open": 0,
              "degraded_decisions": 0, "over_admissions": 0,
              "touched_keys": 0, "shorted_backend_calls": 0}

    def one(algo, lid, oracle, key, permits, check=True):
        now = clock["t"]
        out = storage.acquire(algo, lid, key, permits)
        if not check:
            return out
        d = oracle.try_acquire(key, permits, now)
        report["decisions"] += 1
        hint = out.get("cache_value", out.get("remaining"))
        if (bool(out["allowed"]) != d.allowed
                or int(out["observed"]) != d.observed
                or int(hint) != d.remaining_hint):
            report["mismatches"] += 1
        return out

    def wave(check=True):
        clock["t"] += rng.choice([3, 17, 250, 999, 2000])
        for _ in range(batch):
            key = f"u{rng.randrange(n_keys)}"
            permits = rng.choice([1, 1, 1, 2, 5])
            one("sw", lid_sw, oracle_sw, key, permits, check=check)
            one("tb", lid_tb, oracle_tb, key, permits, check=check)

    try:
        # Phase 1: healthy, bit-identical.
        for _ in range(healthy_waves):
            wave()
        assert report["mismatches"] == 0, (
            f"healthy phase diverged from the oracle: {report}")

        # Phase 2: sustained outage.
        chaos.fail_next(10_000_000)
        budget = math.ceil(failure_threshold / max(max_retries, 1)) + 1
        opened_after = None
        for i in range(budget):
            try:
                storage.acquire("sw", lid_sw, f"u{i % n_keys}", 1)
            except StorageException:
                pass
            if breaker.state == OPEN:
                opened_after = i + 1
                break
        assert opened_after is not None, (
            f"breaker failed to open within {budget} requests of a "
            f"sustained outage (threshold={failure_threshold}, "
            f"attempts/request={max_retries})")
        report["requests_to_open"] = opened_after

        # Degraded service: no exceptions, no backend traffic, admission
        # bounded per key per window by the policy ceiling.
        backend_calls_at_open = len(chaos.calls)
        admitted: dict = {}
        for _ in range(outage_waves):
            clock["t"] += rng.choice([3, 17, 250, 999])
            for _ in range(batch):
                key = f"u{rng.randrange(n_keys)}"
                permits = rng.choice([1, 1, 2, 5])
                out = storage.acquire("sw", lid_sw, key, permits)
                assert out.get("degraded"), (
                    "breaker open but the decision did not come from the "
                    f"degraded host limiter: {out}")
                report["degraded_decisions"] += 1
                if out["allowed"]:
                    # The sw bucket counts REQUESTS (one increment per
                    # acquire regardless of permits — reference quirk
                    # Q1/Q2), so the per-bucket admission ceiling is
                    # max_permits requests.
                    win = clock["t"] // cfg_sw.window_ms
                    admitted[key, win] = admitted.get((key, win), 0) + 1
        report["shorted_backend_calls"] = (
            len(chaos.calls) - backend_calls_at_open)
        assert report["shorted_backend_calls"] == 0, (
            "degraded decisions still reached the backend: "
            f"{report['shorted_backend_calls']} op(s) after open")
        report["over_admissions"] = sum(
            1 for count in admitted.values() if count > cfg_sw.max_permits)
        assert report["over_admissions"] == 0, (
            f"degraded mode over-admitted past the policy ceiling: {admitted}")

        # Phase 3: heal, half-open probe, close + resync.
        chaos.heal()
        clock["t"] += int(open_ms) + 1
        touched = fallback.touched()
        report["touched_keys"] = len(touched)
        assert report["touched_keys"] > 0, "outage phase mutated no keys?"
        probe = storage.acquire("sw", lid_sw, "__probe__", 1)
        assert not probe.get("degraded") and breaker.state == CLOSED, (
            f"half-open probe did not close the breaker: state="
            f"{breaker.state}")
        assert breaker.resyncs_total == 1
        # Mirror the resync in the oracle: reset exactly the touched keys.
        oracle_sw.try_acquire("__probe__", 1, clock["t"])
        for algo, _lid, key in touched:
            (oracle_sw if algo == "sw" else oracle_tb).reset(key, clock["t"])

        # Phase 4: post-resync, bit-identical again.
        for _ in range(post_waves):
            wave()
        assert report["mismatches"] == 0, (
            f"post-resync decisions diverged from the oracle: {report}")

        # Flight-recorder timeline (ARCHITECTURE §13): the outage must
        # read back as open -> half_open -> close -> resync, in order.
        kinds = [e["kind"] for e in frec.events(kind="breaker",
                                                since=fmark)]
        timeline = iter(kinds)
        assert all(k in timeline for k in (
            "breaker.open", "breaker.half_open", "breaker.close",
            "breaker.resync")), (
            f"flight recorder missed the outage timeline: {kinds}")
        report["flight_timeline"] = kinds
    finally:
        storage.close()
    return report


# ---------------------------------------------------------------------------
# Failover drill (replication/ — kill the primary mid-soak, promote)
# ---------------------------------------------------------------------------

def failover_drill(
    num_slots: int = 2048,
    n_keys: int = 64,
    waves: int = 6,
    kill_after_wave: int = 3,
    post_waves: int = 3,
    batch: int = 48,
    seed: int = 0,
    registry=None,
    background_interval_ms: float | None = None,
    storage_factory=None,
) -> dict:
    """Deterministic replicated-failover drill, differential vs the oracle.

    Builds a primary and a same-geometry standby storage under a
    controlled clock, replicates primary -> standby through the full frame
    pipeline (journal -> log -> encoded wire frames -> receiver), and
    drives mixed sliding-window + token-bucket waves with every decision
    checked against ``semantics/oracle.py``.  After ``kill_after_wave``
    waves the drill ships a final epoch, runs one more LOSS wave that is
    never replicated, kills the primary (``close()``), promotes the
    standby, and verifies that every post-failover decision equals an
    oracle rolled back to the promoted epoch — the availability contract:
    state at or before the last replicated epoch survives, the loss wave
    does not.

    ``background_interval_ms`` additionally runs the async replicator
    thread during the soak; the drill still cuts a deterministic final
    epoch before the kill so the differential stays exact.

    The storages are ``GpuBatchedStorage(num_slots=num_slots,
    clock_ms=...)`` on the card, or what ``storage_factory(num_slots,
    clock_ms)`` returns (for example ``device="cpu"`` storages).  Returns a
    report dict; raises AssertionError on any decision mismatch.
    """
    import copy
    import random

    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.replication import (
        InProcessSink,
        ReplicationLog,
        Replicator,
        StandbyReceiver,
    )
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )

    if storage_factory is None:
        from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

        def storage_factory(n, clock_ms):
            return GpuBatchedStorage(num_slots=n, clock_ms=clock_ms)

    rng = random.Random(seed)
    clock = {"t": 1_753_000_000_000}
    primary = storage_factory(num_slots, lambda: clock["t"])
    standby = storage_factory(num_slots, lambda: clock["t"])
    cfg_sw = RateLimitConfig(max_permits=20, window_ms=2000,
                             enable_local_cache=False)
    cfg_tb = RateLimitConfig(max_permits=30, window_ms=2000,
                             refill_rate=10.0)
    lid_sw = primary.register_limiter("sw", cfg_sw)
    lid_tb = primary.register_limiter("tb", cfg_tb)
    # The standby registers limiters from replicated frames, not here —
    # that path is part of what the drill proves.
    log = ReplicationLog(primary)
    receiver = StandbyReceiver(standby, registry=registry)
    repl = Replicator(log, InProcessSink(receiver), registry=registry,
                      interval_ms=background_interval_ms or 200.0)
    if background_interval_ms:
        repl.start()

    oracle_sw = SlidingWindowOracle(cfg_sw)
    oracle_tb = TokenBucketOracle(cfg_tb)
    report = {"decisions": 0, "mismatches": 0, "lag_ms_samples": [],
              "frames": 0, "loss_wave_decisions": 0}

    def run_wave(storage) -> None:
        clock["t"] += rng.choice([1, 7, 250, 999, 2000, 2001])
        now = clock["t"]
        keys = [f"u{rng.randrange(n_keys)}" for _ in range(batch)]
        perms = [rng.choice([1, 1, 1, 2, 5, 21]) for _ in range(batch)]
        out = storage.acquire_many("sw", [lid_sw] * batch, keys, perms)
        for j in range(batch):
            d = oracle_sw.try_acquire(keys[j], perms[j], now)
            report["decisions"] += 1
            if (bool(out["allowed"][j]) != d.allowed
                    or int(out["observed"][j]) != d.observed):
                report["mismatches"] += 1
        out = storage.acquire_many("tb", [lid_tb] * batch, keys, perms)
        for j in range(batch):
            d = oracle_tb.try_acquire(keys[j], perms[j], now)
            report["decisions"] += 1
            if (bool(out["allowed"][j]) != d.allowed
                    or int(out["remaining"][j]) != d.remaining_hint):
                report["mismatches"] += 1

    try:
        for _ in range(max(kill_after_wave, 1)):
            run_wave(primary)
            if not background_interval_ms:
                report["frames"] += repl.ship_now()
                report["lag_ms_samples"].append(log.last_cut_lag_ms)
        if background_interval_ms:
            repl.stop()
        # Final deterministic epoch: everything up to here survives.
        report["frames"] += repl.ship_now()
        report["lag_ms_samples"].append(log.last_cut_lag_ms)
        snap_sw = copy.deepcopy(oracle_sw)
        snap_tb = copy.deepcopy(oracle_tb)
        promoted_epoch = log.epoch

        # Loss wave: mutations after the last replicated epoch die with
        # the primary.  The oracle rolls back to the snapshot below.
        pre = report["decisions"]
        run_wave(primary)
        report["loss_wave_decisions"] = report["decisions"] - pre
    finally:
        repl.stop()
        primary.close()  # the "crash"

    # Roll the oracle back to the promoted epoch: the loss wave's
    # mutations died with the primary, by contract.
    oracle_sw = snap_sw
    oracle_tb = snap_tb
    promoted = receiver.promote()
    assert promoted is standby

    for _ in range(post_waves):
        run_wave(promoted)
    promoted.close()
    report["promoted_epoch"] = promoted_epoch
    report["frames_applied"] = receiver.frames_applied
    if report["mismatches"]:
        raise AssertionError(
            f"failover drill diverged from the oracle: {report}")
    return report
