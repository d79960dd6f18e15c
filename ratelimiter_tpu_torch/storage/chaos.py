"""Fault-injecting storage wrapper (chaos testing), the TCP fault proxy,
and the ingress, sustained-outage, replicated-failover, cross-host, lease,
fleet and overload drills (counterpart of ``ratelimiter_tpu/storage/chaos.py``:
its ``FaultInjectingStorage``, ``FaultInjectingProxy``, ``ingress_drill``,
``outage_drill``, ``failover_drill``, the sharded engine's
``shard_failover_drill``, ``orchestrated_failover_drill`` and
``orchestrator_flap_drill``, ``lease_failover_drill`` and
``aggregator_failover_drill`` over the same N+1 topology,
``cross_host_failover_drill``, the fleet tier's ``rolling_upgrade_drill``
and ``partitioned_controller_drill``, and ``overload_drill``).

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

import numpy as np

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


def _sharded_primary(n_shards: int, slots_per_shard: int, clock, device,
                     devices):
    """A sharded primary storage on ``devices`` (default: ``n_shards``
    shards on ``device``) under the drill's clock, and the factory of one
    flat standby of ``slots_per_shard`` slots on ``device`` (one C index:
    a shard's frames carry one index's fingerprints)."""
    from ratelimiter_tpu_torch.engine.state import LimiterTable
    from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    devs = list(devices) if devices is not None else [device] * n_shards
    engine = ShardedDeviceEngine(slots_per_shard,
                                 LimiterTable(device=devs[0]), devices=devs)
    primary = GpuBatchedStorage(engine=engine, clock_ms=lambda: clock["t"])

    def standby_factory():
        return GpuBatchedStorage(num_slots=slots_per_shard,
                                 clock_ms=lambda: clock["t"], device=device,
                                 host_parallel=0)

    return engine, primary, standby_factory


def _standbys_equal(engine, standby_set, shards) -> bool:
    """Whether each listed shard's standby rows are byte-equal to the
    primary's rows of that shard (both algorithms)."""
    from ratelimiter_tpu_torch.replication import engine_state_fingerprint

    sps = engine.slots_per_shard
    whole = {a: engine.packed_host(a) for a in ("sw", "tb")}
    for q in shards:
        fp = engine_state_fingerprint(standby_set.storages[q].engine)
        for algo in ("sw", "tb"):
            if not np.array_equal(whole[algo][q * sps:(q + 1) * sps],
                                  fp[algo]):
                return False
    return True


def shard_failover_drill(
    n_shards: int = 4,
    slots_per_shard: int = 512,
    n_keys: int = 96,
    waves: int = 5,
    kill_after_wave: int = 3,
    post_waves: int = 3,
    stream_n: int = 1536,
    batch: int = 32,
    kill_shard: int | None = None,
    seed: int = 0,
    registry=None,
    background_interval_ms: float | None = None,
    journal_kind: str = "auto",
    device: str = "cuda",
    devices=None,
) -> dict:
    """Deterministic ONE-shard-of-N failover drill, differential against
    the oracle: the per-shard HA contract of sharded replication
    (replication/sharded.py).

    Topology: a sharded primary (``n_shards`` shards on ``device``, the
    card by default; or on ``devices``) under a controlled clock, one flat
    standby of ``slots_per_shard`` slots a shard on ``device`` (the
    standby set), per-shard epoch streams through the whole frame
    pipeline.  Traffic is a Zipf int-key token-bucket stream (the
    headline shape, ``acquire_stream_ids``) plus string-key
    sliding-window batches, every decision checked bit-exact against
    ``semantics/oracle.py``.  Every standby's rows are held byte-equal to
    its shard's after each synchronous cut.

    After ``kill_after_wave`` waves the drill ships a final epoch for
    every shard, then runs one LOSS wave of victim-shard-only traffic
    that is never replicated, kills the victim shard
    (``ShardFailoverRouter.fail_shard``), and proves:

    - **survivors never stop**: a traffic wave runs DURING the promotion
      window on the surviving shards, equal to the oracle, while
      victim-shard requests are denied fail-closed (counted: bounded
      UNDER-admission, never unbounded over-admission);
    - **loss is bounded**: the loss wave's admissions a key never exceed
      the policy ceiling;
    - **single-shard promotion is exact**: after promoting ONLY the
      victim's standby, every later decision (victim keys on the promoted
      flat storage, survivor keys on the primary) equals the oracle;
    - the health surface reports the DEGRADED-shard state (the router's
      ``shard_health``), not DOWN.

    The report carries wall times beside the counts without judging them
    (the caller that knows its host holds them to a bound): ``cuts``, a
    list a synchronous ship cycle of each shard's newest cut (full or
    delta, rows, cut / row read / index dump ms), ``bootstrap_ms`` (the
    first cycle, every shard's full frame, shipped and applied),
    ``promote_ms`` (promotion and router hand-over) and
    ``kill_to_first_answer_ms`` (the kill to the return of the first
    post-failover wave's call, whose victim keys the promoted shard
    answers; the promotion window's survivor waves and their oracle
    checks come first).  Returns the report dict;
    raises AssertionError on any violated claim.
    """
    import copy
    import random

    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.engine.routing import (
        shard_of_int_keys,
        shard_of_key,
    )
    from ratelimiter_tpu_torch.observability import flight_recorder
    from ratelimiter_tpu_torch.replication import (
        ShardedReplicationLog,
        ShardedReplicator,
        ShardFailoverRouter,
        ShardStandbySet,
    )
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )

    t_start = time.perf_counter()
    frec = flight_recorder()
    fmark = frec.mark()
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    clock = {"t": 1_753_000_000_000}
    engine, primary, standby_factory = _sharded_primary(
        n_shards, slots_per_shard, clock, device, devices)
    n_shards = engine.n_shards
    router = ShardFailoverRouter(primary)
    cfg_tb = RateLimitConfig(max_permits=25, window_ms=2000,
                             refill_rate=8.0)
    cfg_sw = RateLimitConfig(max_permits=15, window_ms=2000,
                             enable_local_cache=False)
    lid_tb = primary.register_limiter("tb", cfg_tb)
    lid_sw = primary.register_limiter("sw", cfg_sw)
    standbys = ShardStandbySet(n_shards, standby_factory, registry=registry)
    log = ShardedReplicationLog(primary, journal_kind=journal_kind)
    repl = ShardedReplicator(log, standbys.in_process_sinks(),
                             registry=registry,
                             interval_ms=background_interval_ms or 200.0)
    if background_interval_ms:
        repl.start()

    oracle_tb = TokenBucketOracle(cfg_tb)
    oracle_sw = SlidingWindowOracle(cfg_sw)
    report = {"decisions": 0, "mismatches": 0, "frames": 0,
              "loss_wave_decisions": 0, "loss_wave_admitted": 0,
              "window_decisions": 0, "window_denied": 0,
              "journal_kind": log.journal_kind, "cuts": [],
              "standby_checks": 0}

    def ship() -> None:
        t0 = time.perf_counter()
        report["frames"] += repl.ship_now()
        ms = (time.perf_counter() - t0) * 1e3
        if "bootstrap_ms" not in report:
            report["bootstrap_ms"] = ms
        report["cuts"].append([dict(c or {}, shard=q) for q, c in
                               enumerate(log.last_cuts)])
        log.last_cuts = [None] * n_shards
        assert _standbys_equal(engine, standbys, range(n_shards)), (
            "a standby's rows differ from its shard's after a cut")
        report["standby_checks"] += 1

    # The key population and the victim: int keys route by the splitmix
    # hash; the victim is the shard owning the most keys (the worst
    # single-shard blast radius) unless the caller pinned one.
    key_shard = shard_of_int_keys(np.arange(n_keys, dtype=np.int64),
                                  n_shards)
    victim = (int(np.bincount(key_shard, minlength=n_shards).argmax())
              if kill_shard is None else int(kill_shard))
    sw_keys = [f"u{i}" for i in range(n_keys)]
    sw_shard = np.asarray([shard_of_key((lid_sw, k), n_shards)
                           for k in sw_keys])

    def zipf_keys(n):
        return (nrng.zipf(1.3, size=n) - 1) % n_keys

    answered = {}

    def tb_wave(backend, keys, check=True):
        clock["t"] += rng.choice([1, 7, 250, 999, 2000, 2001])
        now = clock["t"]
        out = backend.acquire_stream_ids("tb", lid_tb,
                                         np.asarray(keys, dtype=np.int64))
        answered["t"] = time.perf_counter()
        admitted = int(out.sum())
        if check:
            for k, got in zip(keys, out):
                d = oracle_tb.try_acquire(int(k), 1, now)
                report["decisions"] += 1
                if bool(got) != d.allowed:
                    report["mismatches"] += 1
        return admitted, len(out)

    def sw_wave(backend, idx_keys, check=True):
        clock["t"] += rng.choice([1, 7, 250, 999])
        now = clock["t"]
        keys = [sw_keys[i] for i in idx_keys]
        perms = [rng.choice([1, 1, 2, 5]) for _ in keys]
        out = backend.acquire_many("sw", [lid_sw] * len(keys), keys, perms)
        if check:
            for j, k in enumerate(keys):
                d = oracle_sw.try_acquire(k, perms[j], now)
                report["decisions"] += 1
                if (bool(out["allowed"][j]) != d.allowed
                        or int(out["observed"][j]) != d.observed):
                    report["mismatches"] += 1

    victim_tb_keys = np.nonzero(key_shard == victim)[0].astype(np.int64)
    survivor_tb_keys = np.nonzero(key_shard != victim)[0].astype(np.int64)
    survivor_sw_idx = np.nonzero(sw_shard != victim)[0]
    assert len(victim_tb_keys) and len(survivor_tb_keys), (
        "degenerate key split; raise n_keys")

    try:
        # Phase 1: a healthy sharded soak, replicated per shard.
        for _ in range(max(kill_after_wave, 1)):
            tb_wave(router, zipf_keys(stream_n))
            sw_wave(router, [rng.randrange(n_keys) for _ in range(batch)])
            if not background_interval_ms:
                ship()
        if background_interval_ms:
            repl.stop()
        # The final epoch of EVERY shard: everything up to here survives
        # the kill.
        ship()
        report["promoted_epoch"] = log.epochs[victim]

        # The loss wave: victim-shard-only mutations after the last
        # replicated epoch, which die with the shard.  Checked against a
        # throwaway oracle copy (the primary still decides right), never
        # applied to the main oracle: the promoted standby will not know
        # them, by contract.
        loss_oracle = copy.deepcopy(oracle_tb)
        clock["t"] += rng.choice([1, 7, 250])
        now = clock["t"]
        loss_keys = victim_tb_keys[
            nrng.integers(0, len(victim_tb_keys), size=min(stream_n, 512))]
        out = primary.acquire_stream_ids(
            "tb", lid_tb, np.asarray(loss_keys, dtype=np.int64))
        per_key_admitted: dict = {}
        for k, got in zip(loss_keys, out):
            d = loss_oracle.try_acquire(int(k), 1, now)
            report["loss_wave_decisions"] += 1
            if bool(got) != d.allowed:
                report["mismatches"] += 1
            if got:
                per_key_admitted[int(k)] = per_key_admitted.get(int(k),
                                                                0) + 1
        report["loss_wave_admitted"] = int(out.sum())
        # Bounded over-admission: what the dead shard admitted but never
        # replicated is capped a key by the policy ceiling.
        over = {k: c for k, c in per_key_admitted.items()
                if c > cfg_tb.max_permits}
        assert not over, f"loss-wave admissions exceeded the ceiling: {over}"
    finally:
        repl.stop()

    # The victim dies with work still on its stream: one per-shard relay
    # dispatch is enqueued on the victim's device and deliberately NOT
    # fetched before the kill, so promotion cannot depend on the dead
    # shard's pipeline being quiesced.  (Victim-only post-epoch traffic:
    # the loss wave's class, it dies with the shard.)
    undrained = None
    if engine.relay_usable():
        word = np.array([1 << (engine.rank_bits + 1)], dtype=np.uint32)
        undrained = engine.relay_shard_dispatch(
            "tb", victim, "bits", word, np.int32(lid_tb), clock["t"])
    report["undrained_at_kill"] = undrained is not None

    # The kill: shard `victim` is gone.  Its standby survives.
    t_kill = time.perf_counter()
    router.fail_shard(victim)
    health = router.shard_health()
    assert health[victim] == "failed" and all(
        v == "active" for q, v in health.items() if q != victim), health

    # The promotion window: survivors keep serving (equal to the oracle),
    # victim requests are denied fail-closed and counted.
    pre = report["decisions"]
    tb_wave(router, survivor_tb_keys[
        nrng.integers(0, len(survivor_tb_keys), size=min(stream_n, 512))])
    sw_wave(router, [int(survivor_sw_idx[rng.randrange(
        len(survivor_sw_idx))]) for _ in range(batch)])
    report["window_decisions"] = report["decisions"] - pre
    denied_before = router.unavailable_denies
    probe = victim_tb_keys[:8]
    got = router.acquire_stream_ids("tb", lid_tb, probe)
    assert not got.any(), "failed shard served during the window"
    report["window_denied"] = router.unavailable_denies - denied_before
    assert report["window_denied"] == len(probe)

    # Promote ONLY the victim's standby and route its keys there.
    t_promote = time.perf_counter()
    promoted = standbys.promote(victim)
    router.install_replacement(victim, promoted)
    report["promote_ms"] = (time.perf_counter() - t_promote) * 1e3
    health = router.shard_health()
    assert health[victim] == "promoted", health

    # After the failover: mixed traffic through the router (victim keys on
    # the promoted flat storage, survivors on the primary), all equal to
    # the oracle.
    for i in range(post_waves):
        tb_wave(router, zipf_keys(stream_n))
        if i == 0:
            report["kill_to_first_answer_ms"] = (
                answered["t"] - t_kill) * 1e3
        sw_wave(router, [rng.randrange(n_keys) for _ in range(batch)])

    # The flight recorder reads back kill -> promote -> serving
    # replacement, in order, all naming the victim shard.
    events = [e for e in frec.events(since=fmark)
              if e["kind"] in ("shard.failed", "replication.promote",
                               "shard.promoted")]
    kinds = [e["kind"] for e in events]
    timeline = iter(kinds)
    assert all(k in timeline for k in (
        "shard.failed", "replication.promote", "shard.promoted")), (
        f"flight recorder missed the failover timeline: {kinds}")
    for e in events:
        if "shard" in e:
            assert e["shard"] == victim, e
    report["flight_timeline"] = kinds

    if undrained is not None:
        # Promotion and the later serving all ran with the dead shard's
        # dispatch undrained; its handle must still resolve (the device
        # itself never died).
        assert engine.fetch(victim, undrained).shape[0] >= 1, (
            "undrained victim dispatch did not resolve after promotion")

    report["victim_shard"] = victim
    report["shard_health"] = router.shard_health()
    router.close()  # closes the primary and the promoted replacement
    standbys.close(except_shards=(victim,))
    report["wall_s"] = time.perf_counter() - t_start
    if report["mismatches"]:
        raise AssertionError(
            f"shard failover drill diverged from the oracle: {report}")
    return report


def orchestrated_failover_drill(
    n_shards: int = 4,
    slots_per_shard: int = 256,
    n_keys: int = 64,
    waves: int = 3,
    stream_n: int = 768,
    batch: int = 24,
    kill_shard: int | None = None,
    seed: int = 0,
    registry=None,
    probe_interval_ms: float = 50.0,
    suspect_threshold: int = 3,
    hysteresis_ms: float = 200.0,
    cycles: int = 1,
    device: str = "cuda",
    devices=None,
) -> dict:
    """Self-healing one-shard-of-N failover with ZERO manual actuator
    calls: the orchestrator (replication/orchestrator.py) must detect the
    kill, fence, promote, route and re-seed on its own.

    The ``shard_failover_drill`` topology (shards on ``device``, or on
    ``devices``) plus a ``FailoverOrchestrator`` driven by deterministic
    ``tick()`` calls against a SIMULATED monotonic clock: every probe,
    hysteresis window and transition lands at an exact simulated
    millisecond, so the timeline assertions are exact.  Proves:

    - **detection is bounded**: kill -> FENCING within the configured
      probe budget (``suspect_threshold`` probes + hysteresis + one
      interval of phase slack), in simulated time;
    - **survivors serve during detection**: survivor-shard waves run
      between probe ticks, equal to the oracle;
    - **the zombie is fenced**: after FENCING, the victim shard's keys
      dispatched DIRECTLY at the old backend (router bypassed) raise the
      typed ``FencedError`` and are counted, while survivor keys
      dispatched directly still serve;
    - **promotion is exact**: later mixed traffic through the router
      equals the oracle;
    - **the system returns to N+1**: the orchestrator re-seeds a FRESH
      standby for the promoted replica from a full frame; it is
      consistent, unpromoted and byte-equal to the promoted storage;
    - **the flight recorder reads back in order**: MONITORING -> SUSPECT
      -> FENCING -> PROMOTING -> RESTORED -> MONITORING for the victim
      shard, with ``shard.failed`` before ``replication.promote`` before
      ``shard.promoted``.

    ``cycles > 1`` repeats kill -> promote -> re-seed on the shard that
    now serves from a promoted flat replacement.  Each cycle's report
    carries its wall milliseconds from the kill to the promoted shard's
    MONITORING (``kill_to_restored_ms``), and the report the drill's
    ``wall_s``, unjudged.  Returns the report dict; raises AssertionError
    on any violated claim.
    """
    import copy
    import random

    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.engine.routing import (
        shard_of_int_keys,
        shard_of_key,
    )
    from ratelimiter_tpu_torch.observability import flight_recorder
    from ratelimiter_tpu_torch.replication import (
        FailoverOrchestrator,
        OrchestratorConfig,
        ShardedReplicationLog,
        ShardedReplicator,
        ShardFailoverRouter,
        ShardStandbySet,
        engine_state_fingerprint,
    )
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.storage.errors import FencedError

    t_start = time.perf_counter()
    frec = flight_recorder()
    fmark = frec.mark()
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    clock = {"t": 1_753_000_000_000}
    engine, primary, standby_factory = _sharded_primary(
        n_shards, slots_per_shard, clock, device, devices)
    n_shards = engine.n_shards
    router = ShardFailoverRouter(primary)
    cfg_tb = RateLimitConfig(max_permits=25, window_ms=2000,
                             refill_rate=8.0)
    cfg_sw = RateLimitConfig(max_permits=15, window_ms=2000,
                             enable_local_cache=False)
    lid_tb = primary.register_limiter("tb", cfg_tb)
    lid_sw = primary.register_limiter("sw", cfg_sw)

    standbys = ShardStandbySet(n_shards, standby_factory, registry=registry)
    log = ShardedReplicationLog(primary)
    repl = ShardedReplicator(log, standbys.in_process_sinks(),
                             registry=registry)

    # The simulated monotonic clock: one probe interval a tick, so the
    # orchestrator's hysteresis arithmetic runs on exact simulated time.
    sim = {"s": 0.0}
    dead = {"flag": False, "at_promotions": 0}
    probe_victim = [None]
    cfg = OrchestratorConfig(probe_interval_ms=probe_interval_ms,
                             suspect_threshold=suspect_threshold,
                             hysteresis_ms=hysteresis_ms,
                             promote_backoff_ms=1.0)

    def probe(q):
        # The victim's serving backend is dead from the kill until THIS
        # cycle's replacement is installed (an earlier cycle's
        # replacement does not clear a fresh kill); the rest answer.
        if dead["flag"] and q == probe_victim[0] \
                and orch.promotions == dead["at_promotions"]:
            return False
        return True
    orch = FailoverOrchestrator(
        router, standbys, repl, standby_factory=standby_factory,
        config=cfg, probe=probe, registry=registry,
        clock=lambda: sim["s"], sleep=lambda s: None)

    def tick(n=1):
        for _ in range(n):
            sim["s"] += cfg.probe_interval_ms / 1000.0
            orch.tick()

    oracle_tb = TokenBucketOracle(cfg_tb)
    oracle_sw = SlidingWindowOracle(cfg_sw)
    report = {"decisions": 0, "mismatches": 0, "frames": 0,
              "false_alarms": 0, "cycles": [], "manual_promotions": 0}

    key_shard = shard_of_int_keys(np.arange(n_keys, dtype=np.int64),
                                  n_shards)
    sw_keys = [f"u{i}" for i in range(n_keys)]
    sw_shard = np.asarray([shard_of_key((lid_sw, k), n_shards)
                           for k in sw_keys])

    def zipf_keys(n):
        return (nrng.zipf(1.3, size=n) - 1) % n_keys

    def tb_wave(backend, keys):
        clock["t"] += rng.choice([1, 7, 250, 999, 2000, 2001])
        now = clock["t"]
        out = backend.acquire_stream_ids("tb", lid_tb,
                                         np.asarray(keys, dtype=np.int64))
        for k, got in zip(keys, out):
            d = oracle_tb.try_acquire(int(k), 1, now)
            report["decisions"] += 1
            if bool(got) != d.allowed:
                report["mismatches"] += 1

    def sw_wave(backend, idx_keys):
        clock["t"] += rng.choice([1, 7, 250, 999])
        now = clock["t"]
        keys = [sw_keys[i] for i in idx_keys]
        perms = [rng.choice([1, 1, 2, 5]) for _ in keys]
        out = backend.acquire_many("sw", [lid_sw] * len(keys), keys, perms)
        for j, k in enumerate(keys):
            d = oracle_sw.try_acquire(k, perms[j], now)
            report["decisions"] += 1
            if (bool(out["allowed"][j]) != d.allowed
                    or int(out["observed"][j]) != d.observed):
                report["mismatches"] += 1

    try:
        for cycle in range(max(int(cycles), 1)):
            if cycle == 0:
                # The victim: the busiest shard (the worst blast radius)
                # unless pinned; later cycles RE-KILL the same shard, now
                # served by its promoted replacement, which proves the
                # re-seeded standby restored failover capacity.
                counts = np.bincount(key_shard, minlength=n_shards)
                victim = (int(kill_shard) if kill_shard is not None
                          else int(counts.argmax()))
            probe_victim[0] = victim
            victim_tb = np.nonzero(key_shard == victim)[0].astype(np.int64)
            survivor_tb = np.nonzero(key_shard != victim)[0].astype(np.int64)
            assert len(victim_tb) and len(survivor_tb), (
                "degenerate key split; raise n_keys")
            assert len(np.nonzero(sw_shard != victim)[0])

            # A healthy soak: traffic, ships and idle orchestrator ticks.
            for _ in range(max(waves, 1)):
                tb_wave(router, zipf_keys(stream_n))
                sw_wave(router, [rng.randrange(n_keys) for _ in range(batch)])
                report["frames"] += repl.ship_now()
                tick()
            assert orch.status()["shards"][victim]["state"] == "MONITORING"
            base_promotions = orch.promotions

            # The final epoch, then (first cycle only) the loss wave:
            # victim-only traffic never replicated, which dies with the
            # shard; checked against a throwaway oracle.  Later cycles
            # skip it: the promoted replacement's re-seed stream ships on
            # every tick, so its mutations before the fence survive.
            report["frames"] += repl.ship_now()
            if cycle == 0:
                loss_oracle = copy.deepcopy(oracle_tb)
                clock["t"] += rng.choice([1, 7, 250])
                now = clock["t"]
                loss_keys = victim_tb[nrng.integers(
                    0, len(victim_tb), size=min(stream_n, 256))]
                out = primary.acquire_stream_ids(
                    "tb", lid_tb, np.asarray(loss_keys, dtype=np.int64))
                for k, got in zip(loss_keys, out):
                    if bool(got) != loss_oracle.try_acquire(
                            int(k), 1, now).allowed:
                        report["mismatches"] += 1

            # THE KILL.  No actuator call follows: the orchestrator does
            # everything.
            t_kill = time.perf_counter()
            dead["flag"] = True
            dead["at_promotions"] = orch.promotions
            fence_before = orch.fence_epoch
            ticks_to_fence = 0
            while orch.fence_epoch == fence_before and ticks_to_fence < 64:
                tick()
                ticks_to_fence += 1
                # Survivors serve while detection is in progress.
                if ticks_to_fence == suspect_threshold:
                    tb_wave(router, survivor_tb[nrng.integers(
                        0, len(survivor_tb), size=min(stream_n, 256))])
            detection_ms = ticks_to_fence * cfg.probe_interval_ms
            assert orch.fence_epoch > fence_before, (
                "orchestrator never fenced the dead shard")
            assert detection_ms <= cfg.detection_budget_ms \
                + cfg.probe_interval_ms, (
                f"detection took {detection_ms} ms (simulated); budget "
                f"{cfg.detection_budget_ms} ms")

            # Promotion is same-tick; a few more ticks settle RESTORED ->
            # MONITORING (the re-seed's full frame ships on a tick).
            settle = 0
            while (orch.status()["shards"][victim]["state"] != "MONITORING"
                   and settle < 32):
                tick()
                settle += 1
            kill_to_restored_ms = (time.perf_counter() - t_kill) * 1e3
            assert orch.promotions == base_promotions + 1, (
                "orchestrator did not promote exactly once this cycle")
            assert router.shard_health()[victim] == "promoted"

            # The zombie: the fenced old backend refuses victim-shard keys
            # sent DIRECTLY (router bypassed) with the typed error, while
            # survivor keys sent directly still serve.
            zombie = primary if cycle == 0 else zombie_prev
            rejected_before = orch.total_fence_rejected()
            try:
                zombie.acquire_stream_ids(
                    "tb", lid_tb, np.asarray(victim_tb[:8], dtype=np.int64))
                raise AssertionError(
                    "fenced zombie served victim-shard dispatches")
            except FencedError:
                pass
            assert orch.total_fence_rejected() > rejected_before
            if cycle == 0:
                # A shard-scoped fence: survivors through the SAME storage
                # still serve (their shards are not fenced).
                probe_keys = survivor_tb[:8]
                clock["t"] += 3
                got = primary.acquire_stream_ids(
                    "tb", lid_tb, np.asarray(probe_keys, dtype=np.int64))
                # Those direct dispatches changed real state: keep the
                # oracle in step (one permit each, same stamp).
                for j, k in enumerate(probe_keys):
                    d = oracle_tb.try_acquire(int(k), 1, clock["t"])
                    report["decisions"] += 1
                    if bool(got[j]) != d.allowed:
                        report["mismatches"] += 1

            # Back to N+1: a FRESH standby was re-seeded for the promoted
            # replica and is byte-equal to it.
            fresh_rx = standbys.receivers[victim]
            assert fresh_rx.consistent and not fresh_rx.promoted, (
                "re-seeded standby not consistent")
            promoted_storage = router.replacements[victim]
            fp_p = engine_state_fingerprint(promoted_storage.engine)
            fp_s = engine_state_fingerprint(
                standbys.storages[victim].engine)
            for algo in ("sw", "tb"):
                np.testing.assert_array_equal(fp_p[algo], fp_s[algo])

            # After the failover: mixed traffic, equal via the router.
            dead["flag"] = False
            for _ in range(2):
                tb_wave(router, zipf_keys(stream_n))
                sw_wave(router, [rng.randrange(n_keys) for _ in range(batch)])
                tick()
            report["cycles"].append({
                "victim": victim, "detection_ms": detection_ms,
                "fence_epoch": orch.fence_epoch,
                "kill_to_restored_ms": kill_to_restored_ms})
            zombie_prev = promoted_storage

        # The flight recorder: the victim's state machine reads back in
        # order, and the failover triplet is ordered.
        victim0 = report["cycles"][0]["victim"]
        trans = [(e["from"], e["to"]) for e in frec.events(since=fmark)
                 if e["kind"] == "orchestrator.transition"
                 and e["shard"] == victim0]
        expect = [("MONITORING", "SUSPECT"), ("SUSPECT", "FENCING"),
                  ("FENCING", "PROMOTING"), ("PROMOTING", "RESTORED"),
                  ("RESTORED", "MONITORING")]
        it = iter(trans)
        assert all(step in it for step in expect), (
            f"orchestrator timeline out of order: {trans}")
        kinds = [e["kind"] for e in frec.events(since=fmark)
                 if e["kind"] in ("shard.failed", "replication.promote",
                                  "shard.promoted")]
        it = iter(kinds)
        assert all(k in it for k in ("shard.failed", "replication.promote",
                                     "shard.promoted")), (
            f"failover triplet out of order: {kinds}")
        report["flight_transitions"] = trans
        report["false_alarms"] = orch.false_alarms
        report["promotions"] = orch.promotions
        report["reseeds"] = orch.reseeds
        report["fence_rejected"] = orch.total_fence_rejected()
        assert orch.false_alarms == 0, "healthy probes raised false alarms"
        report["wall_s"] = time.perf_counter() - t_start
        if report["mismatches"]:
            raise AssertionError(
                f"orchestrated failover diverged from the oracle: {report}")
        return report
    finally:
        orch.close()
        repl.stop()
        router.close()
        standbys.close()


def orchestrator_flap_drill(
    n_shards: int = 2,
    slots_per_shard: int = 128,
    n_keys: int = 48,
    flap_cycles: int = 3,
    seed: int = 0,
    registry=None,
    probe_interval_ms: float = 50.0,
    suspect_threshold: int = 2,
    hysteresis_ms: float = 300.0,
    device: str = "cuda",
    devices=None,
) -> dict:
    """Flap damping: a fault that HEALS inside the hysteresis window must
    never promote, and fencing must be a clean, liftable refusal.

    The victim shard's liveness probe runs over a real TCP hop through a
    :class:`FaultInjectingProxy`; each flap cycle calls ``partition()``
    (bytes dropped both ways, no RST: a silent partition) long enough to
    enter SUSPECT, then ``heal()`` before the hysteresis window closes.
    The shards live on ``device`` (or ``devices``).  Proves:

    - every flap increments ``false_alarms`` and nothing else: zero
      promotions, zero fence epochs, every shard ``active``, the state
      machine back in MONITORING;
    - traffic before, during and after the flaps equals the oracle (no
      loss, because nothing was promoted);
    - a fence installed on the primary refuses the fenced shard's
      dispatches with the typed ``FencedError`` (counted) while the other
      shard's keys still serve, and ``lift_fence`` restores the fenced
      shard to exact service.

    The report carries ``flap_ms`` (each cycle's wall milliseconds, the
    TCP probes' timeouts included) and ``wall_s``, unjudged.  Returns the
    report dict; raises AssertionError on any violated claim.
    """
    import random
    import socket as socket_mod
    import socketserver

    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.engine.routing import shard_of_int_keys
    from ratelimiter_tpu_torch.replication import (
        FailoverOrchestrator,
        OrchestratorConfig,
        ShardedReplicationLog,
        ShardedReplicator,
        ShardFailoverRouter,
        ShardStandbySet,
    )
    from ratelimiter_tpu_torch.semantics.oracle import TokenBucketOracle
    from ratelimiter_tpu_torch.storage.errors import FencedError

    t_start = time.perf_counter()
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    clock = {"t": 1_753_000_000_000}
    engine, primary, standby_factory = _sharded_primary(
        n_shards, slots_per_shard, clock, device, devices)
    n_shards = engine.n_shards
    router = ShardFailoverRouter(primary)
    cfg_tb = RateLimitConfig(max_permits=20, window_ms=2000,
                             refill_rate=8.0)
    lid_tb = primary.register_limiter("tb", cfg_tb)

    standbys = ShardStandbySet(n_shards, standby_factory, registry=registry)
    log = ShardedReplicationLog(primary)
    repl = ShardedReplicator(log, standbys.in_process_sinks(),
                             registry=registry)

    # The victim's probe is a 1-byte echo over TCP THROUGH the fault
    # proxy: partition() makes it time out exactly like a silently dead
    # peer; heal() restores it.
    class _Echo(socketserver.BaseRequestHandler):
        def handle(self):
            try:
                if self.request.recv(1):
                    self.request.sendall(b"o")
            except OSError:
                pass

    class _EchoServer(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    echo = _EchoServer(("127.0.0.1", 0), _Echo)
    echo_thread = threading.Thread(target=echo.serve_forever, daemon=True)
    echo_thread.start()
    proxy = FaultInjectingProxy(echo.server_address[1], seed=seed).start()

    key_shard = shard_of_int_keys(np.arange(n_keys, dtype=np.int64),
                                  n_shards)
    victim = int(np.bincount(key_shard, minlength=n_shards).argmax())

    def tcp_probe_ok() -> bool:
        try:
            s = socket_mod.create_connection(("127.0.0.1", proxy.port),
                                             timeout=0.25)
            s.settimeout(0.25)
            s.sendall(b"p")
            ok = s.recv(1) == b"o"
            s.close()
            return ok
        except OSError:
            return False

    def probe(q):
        return tcp_probe_ok() if q == victim else True

    sim = {"s": 0.0}
    cfg = OrchestratorConfig(probe_interval_ms=probe_interval_ms,
                             suspect_threshold=suspect_threshold,
                             hysteresis_ms=hysteresis_ms)
    orch = FailoverOrchestrator(
        router, standbys, repl, standby_factory=standby_factory,
        config=cfg, probe=probe, registry=registry,
        clock=lambda: sim["s"], sleep=lambda s: None)

    def tick(n=1):
        for _ in range(n):
            sim["s"] += cfg.probe_interval_ms / 1000.0
            orch.tick()

    oracle_tb = TokenBucketOracle(cfg_tb)
    report = {"decisions": 0, "mismatches": 0, "false_alarms": 0,
              "fence_rejected": 0, "flap_ms": []}

    def wave():
        clock["t"] += rng.choice([1, 7, 250, 999, 2000])
        now = clock["t"]
        keys = (nrng.zipf(1.3, size=384) - 1) % n_keys
        out = router.acquire_stream_ids(
            "tb", lid_tb, np.asarray(keys, dtype=np.int64))
        for k, got in zip(keys, out):
            d = oracle_tb.try_acquire(int(k), 1, now)
            report["decisions"] += 1
            if bool(got) != d.allowed:
                report["mismatches"] += 1

    try:
        # A healthy baseline.
        for _ in range(2):
            wave()
            repl.ship_now()
            tick()
        assert orch.false_alarms == 0

        # Flap cycles: partition long enough to enter SUSPECT, heal
        # before the hysteresis window closes.  The suspect window in
        # simulated time stays strictly under hysteresis_ms.
        suspect_ticks = max(
            1, int(hysteresis_ms / probe_interval_ms) - suspect_threshold - 1)
        for cycle in range(flap_cycles):
            t_flap = time.perf_counter()
            proxy.partition()
            tick(suspect_threshold)          # consecutive failures: SUSPECT
            state = orch.status()["shards"][victim]["state"]
            assert state == "SUSPECT", (cycle, state)
            tick(suspect_ticks)              # inside the window, still bad
            assert orch.status()["shards"][victim]["state"] == "SUSPECT"
            proxy.heal()                     # the fault clears in time
            tick()
            assert orch.status()["shards"][victim]["state"] == "MONITORING"
            assert orch.false_alarms == cycle + 1
            report["flap_ms"].append((time.perf_counter() - t_flap) * 1e3)
            wave()                           # serving throughout, exact
            repl.ship_now()
        assert orch.promotions == 0, "a transient fault was promoted"
        assert orch.fence_epoch == 0, "a transient fault installed a fence"
        assert all(v == "active" for v in router.shard_health().values())

        # A fence round trip on the primary: the fenced shard's keys are
        # refused with the typed error (the zombie's shape), the other
        # shard's keys keep serving, and lift_fence restores exact
        # service.
        victim_keys = np.nonzero(key_shard == victim)[0].astype(np.int64)
        other_keys = np.nonzero(key_shard != victim)[0].astype(np.int64)
        primary.fence(1, shards=(victim,))
        try:
            primary.acquire_stream_ids("tb", lid_tb, victim_keys[:8])
            raise AssertionError("fenced shard served a direct dispatch")
        except FencedError:
            pass
        assert primary.fence_rejected >= 1
        report["fence_rejected"] = primary.fence_rejected
        clock["t"] += 7
        got = primary.acquire_stream_ids("tb", lid_tb, other_keys[:8])
        for k, g in zip(other_keys[:8], got):
            d = oracle_tb.try_acquire(int(k), 1, clock["t"])
            report["decisions"] += 1
            if bool(g) != d.allowed:
                report["mismatches"] += 1
        primary.lift_fence(1)
        wave()                               # victim keys serve, exact

        report["false_alarms"] = orch.false_alarms
        report["promotions"] = orch.promotions
        report["victim"] = victim
        report["wall_s"] = time.perf_counter() - t_start
        if report["mismatches"]:
            raise AssertionError(
                f"flap drill diverged from the oracle: {report}")
        return report
    finally:
        orch.close()
        repl.stop()
        proxy.stop()
        echo.shutdown()
        echo.server_close()
        router.close()
        standbys.close()


def _lease_drill_topology(n_shards, slots_per_shard, clock, device, devices,
                          registry, probe_interval_ms, suspect_threshold,
                          hysteresis_ms):
    """The lease drills' N+1 topology: a sharded primary under the drills'
    clock (``_sharded_primary``), the ``ShardFailoverRouter`` in front of
    it, a flat standby a shard fed by per-shard epoch streams, and a
    ``FailoverOrchestrator`` on a SIMULATED monotonic clock whose probe
    answers False for ``victim[0]`` while ``dead["flag"]`` is set.
    Returns ``(primary, router, standbys, repl, orch, tick, dead,
    victim)``;
    ``tick(n)`` advances the simulated clock one probe interval a tick."""
    from ratelimiter_tpu_torch.replication import (
        FailoverOrchestrator,
        OrchestratorConfig,
        ShardedReplicationLog,
        ShardedReplicator,
        ShardFailoverRouter,
        ShardStandbySet,
    )

    engine, primary, standby_factory = _sharded_primary(
        n_shards, slots_per_shard, clock, device, devices)
    router = ShardFailoverRouter(primary)
    standbys = ShardStandbySet(engine.n_shards, standby_factory,
                               registry=registry)
    repl = ShardedReplicator(ShardedReplicationLog(primary),
                             standbys.in_process_sinks(), registry=registry)
    sim = {"s": 0.0}
    dead = {"flag": False}
    victim = [None]
    cfg = OrchestratorConfig(probe_interval_ms=probe_interval_ms,
                             suspect_threshold=suspect_threshold,
                             hysteresis_ms=hysteresis_ms,
                             promote_backoff_ms=1.0)

    def probe(q):
        return not (dead["flag"] and q == victim[0])

    orch = FailoverOrchestrator(
        router, standbys, repl, standby_factory=standby_factory,
        config=cfg, probe=probe, registry=registry,
        clock=lambda: sim["s"], sleep=lambda s: None)

    def tick(n=1):
        for _ in range(n):
            sim["s"] += cfg.probe_interval_ms / 1000.0
            orch.tick()

    return primary, router, standbys, repl, orch, tick, dead, victim


def _kill_until_fenced(orch, dead: dict, tick) -> None:
    """Kill the victim shard (its probe fails) and tick the orchestrator
    until it fenced the shard; the caller then settles the promotion."""
    epoch_before = orch.fence_epoch
    dead["flag"] = True
    ticks = 0
    while orch.fence_epoch == epoch_before and ticks < 64:
        tick()
        ticks += 1
    assert orch.fence_epoch > epoch_before, "never fenced"


def _settle_promotion(orch, victim: int, tick) -> None:
    """Tick until the victim shard is MONITORING again: promoted."""
    settle = 0
    while (orch.status()["shards"][victim]["state"] != "MONITORING"
           and settle < 32):
        tick()
        settle += 1
    assert orch.promotions == 1


def _replay_lease_ops(ops, oracles: dict) -> int:
    """Replay a lease manager's recorded reserve / credit stream into the
    oracles (``{algo: oracle}``); every replayed reserve must grant what
    the device granted.  Returns the count of replayed operations."""
    for op in ops:
        if op[0] == "reserve":
            _, algo, _lid, key, req, granted, ws, stamp = op
            g, w = oracles[algo].reserve(key, req, stamp)
            assert (g, w) == (granted, ws), (
                f"replayed reserve diverged for {key!r}: oracle "
                f"({g}, {w}) vs device ({granted}, {ws})")
        else:
            _, algo, _lid, key, unused, ws, stamp = op
            oracles[algo].credit(key, unused, ws, stamp)
    return len(ops)


def lease_failover_drill(
    n_shards: int = 4,
    slots_per_shard: int = 256,
    n_keys: int = 16,
    burns: int = 600,
    budget: int = 16,
    seed: int = 0,
    registry=None,
    probe_interval_ms: float = 50.0,
    suspect_threshold: int = 3,
    hysteresis_ms: float = 200.0,
    device: str = "cuda",
    devices=None,
    lease_ttl_ms: float = 5_000.0,
) -> dict:
    """Token leases under failure: dead clients, a killed shard, and an
    orchestrated promotion — with the lease over-admission bound held
    and the reserve/credit stream reconciling bit-identically against
    ``semantics/oracle.py`` once renewals drain.  The sharded primary's
    shards run on ``device`` (or on ``devices``), the standbys on
    ``device``; every lease step is ``ops/lease.py`` on those tensors.
    Proves:

    - **wire collapse**: a leased client burning ``burns`` decisions
      spends <= burns/10 wire round trips;
    - **dead client is bounded by construction**: killing a client
      mid-burn strands only its outstanding budget, each per-key term
      <= the grant cap <= the policy's ``max_permits``, and the strand
      is reclaimed: after TTL expiry the key grants again;
    - **honor-or-revoke across failover**: the orchestrator kills one
      shard and promotes its standby with zero manual calls; burns made
      against outstanding leases during the failover window are honored
      locally (bounded by the outstanding budget at fence time), every
      renewal after the fence-epoch bump is REVOKED, re-grants land on
      the promoted replacement carrying the new epoch, survivor-shard
      leases renew without a revocation or an epoch bounce (the fence is
      scoped to the victim shard), and the manager's ``over_admission``
      counter accounts exactly the burns reported on revoked leases;
    - **bit-identical reconciliation**: after every lease is released
      and renewals drain, replaying the managers' recorded reserve /
      credit stream into the oracles reproduces the device counters for
      every key (grants included).

    Deterministic: controlled decision clock (one millisecond a burn),
    simulated orchestrator clock, in-process transports.  The leased
    clients' lease TTL is ``lease_ttl_ms`` (the reference's 5 s): a key's
    burns ``n_keys`` milliseconds apart must fall inside it for the wire
    collapse, so a wide key set needs a longer one.  The report carries
    the counts, the healthy frames per decision and the drill's
    ``wall_s`` (unjudged).
    Raises AssertionError on any violated claim; returns a report dict.
    """
    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.engine.routing import shard_of_key
    from ratelimiter_tpu_torch.leases import (
        DirectTransport,
        LeaseClient,
        LeaseManager,
    )
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )

    t_start = time.perf_counter()
    clock = {"t": 1_753_000_000_000}
    primary, router, standbys, repl, orch, tick, dead, victim_box = (
        _lease_drill_topology(n_shards, slots_per_shard, clock, device,
                              devices, registry, probe_interval_ms,
                              suspect_threshold, hysteresis_ms))
    n_shards = router.n_shards
    cfg_tb = RateLimitConfig(max_permits=1 << 14, window_ms=60_000,
                             refill_rate=1000.0)
    cfg_sw = RateLimitConfig(max_permits=1 << 14, window_ms=60_000,
                             enable_local_cache=False)
    lid_tb = primary.register_limiter("tb", cfg_tb)
    lid_sw = primary.register_limiter("sw", cfg_sw)

    mgr = LeaseManager(router, default_budget=budget, max_budget=budget,
                       ttl_ms=lease_ttl_ms, registry=registry,
                       record_ops=True, clock_ms=lambda: clock["t"])
    # Strict lease-only clients: every device mutation flows through the
    # replayable reserve/credit log (no per-decision fallback traffic).
    cli_tb = LeaseClient(DirectTransport(mgr), lid_tb, budget=budget,
                         clock_ms=lambda: clock["t"],
                         direct_fallback=False)
    cli_sw = LeaseClient(DirectTransport(mgr), lid_sw, budget=budget,
                         clock_ms=lambda: clock["t"],
                         direct_fallback=False)
    tb_keys = [f"lease-tb-{i}" for i in range(n_keys)]
    sw_keys = [f"lease-sw-{i}" for i in range(n_keys)]
    report = {"decisions": 0, "local_denies": 0}

    try:
        # -- Phase A: healthy leased burn (both algos) --------------------
        for i in range(burns):
            clock["t"] += 1
            assert cli_tb.try_acquire(tb_keys[i % n_keys]), "tb burn denied"
            assert cli_sw.try_acquire(sw_keys[i % n_keys]), "sw burn denied"
            report["decisions"] += 2
            if i % 100 == 0:
                repl.ship_now()
                tick()
        wire = cli_tb.wire_ops + cli_sw.wire_ops
        assert wire * 10 <= report["decisions"], (
            f"wire ops {wire} for {report['decisions']} decisions — "
            "the >=10x frame reduction failed in-process")
        report["wire_ops_healthy"] = wire
        report["frames_per_decision"] = wire / report["decisions"]

        # -- Phase B: dead client — bounded strand, reclaimed by TTL ------
        # A dedicated short-TTL manager so the expiry advance cannot
        # expire the main clients' leases ("dead-key" belongs only to it).
        mgr_dead = LeaseManager(router, default_budget=budget,
                                max_budget=budget, ttl_ms=5.0,
                                record_ops=True,
                                clock_ms=lambda: clock["t"])
        cli_dead = LeaseClient(DirectTransport(mgr_dead), lid_tb,
                               budget=budget,
                               clock_ms=lambda: clock["t"],
                               direct_fallback=False)
        for i in range(budget // 2):
            assert cli_dead.try_acquire("dead-key")
        stranded = cli_dead.drop()
        assert set(stranded) == {"dead-key"}
        assert 0 < stranded["dead-key"]["remaining"] <= budget \
            <= cfg_tb.max_permits, "strand exceeds the grant bound"
        expired_before = mgr_dead.expired_total
        clock["t"] += int(mgr_dead.ttl_ms) + 1  # past the lease TTL
        g = mgr_dead.grant(lid_tb, "dead-key", budget)
        assert g.granted > 0, "expired lease still blocks the key"
        assert mgr_dead.expired_total == expired_before + 1
        mgr_dead.release(lid_tb, "dead-key", 0)
        report["stranded_budget"] = stranded["dead-key"]["remaining"]

        # -- Phase C: orchestrated failover — honor-or-revoke -------------
        # Victim: the shard holding the most leased tb keys.
        shard_of = {k: int(shard_of_key((lid_tb, k), n_shards))
                    for k in tb_keys}
        counts = [0] * n_shards
        for k in tb_keys:
            counts[shard_of[k]] += 1
        victim = victim_box[0] = int(np.argmax(counts))
        victim_keys = [k for k in tb_keys if shard_of[k] == victim]
        assert victim_keys, "degenerate key split; raise n_keys"
        # Complete replication BEFORE the kill: every charge is on the
        # standby, so the reconciliation phase is exact.
        repl.ship_now()
        _kill_until_fenced(orch, dead, tick)
        # Burns against outstanding leases during the failover window
        # are honored LOCALLY — this is the bounded over-admission.
        burned_after_fence = 0
        outstanding_at_fence = {
            k: cli_tb._leases[k].remaining for k in victim_keys
            if k in cli_tb._leases}
        for k in victim_keys:
            lease = cli_tb._leases.get(k)
            while lease is not None and lease.remaining > 0:
                clock["t"] += 1
                assert cli_tb.try_acquire(k)
                burned_after_fence += 1
        assert burned_after_fence == sum(outstanding_at_fence.values())
        assert all(v <= budget <= cfg_tb.max_permits
                   for v in outstanding_at_fence.values()), (
            "outstanding budget exceeds the per-key bound")
        _settle_promotion(orch, victim, tick)
        assert router.shard_health()[victim] == "promoted"
        dead["flag"] = False
        # Every renewal now hits the fence-epoch check: REVOKED, then
        # the client re-grants against the promoted replacement.
        over_before = mgr.over_admission_total
        revoked_before = mgr.revoked_total
        used_unreported = {k: cli_tb._leases[k].used
                           for k in victim_keys if k in cli_tb._leases}
        post_burns = 0
        for k in victim_keys:
            clock["t"] += 1
            assert cli_tb.try_acquire(k), (
                "post-promotion re-grant failed to serve")
            post_burns += 1
        assert mgr.revoked_total > revoked_before, "no lease was revoked"
        assert cli_tb.revoked_seen >= 1
        # over_admission accounts exactly the burns reported on revoked
        # leases (every other burn was reported on a live renewal).
        assert mgr.over_admission_total - over_before == \
            sum(used_unreported.values()), (
            mgr.over_admission_total, over_before, used_unreported)
        for k in victim_keys:
            if k in cli_tb._leases:
                assert cli_tb._leases[k].epoch == orch.fence_epoch, (
                    "re-grant does not carry the bumped fence epoch")
        # SCOPED revocation: the fence named only the victim shard, so
        # survivor-shard leases renew WITHOUT a revocation or an epoch
        # bounce.
        survivor_keys = [k for k in tb_keys if shard_of[k] != victim]
        assert survivor_keys, "degenerate key split; raise n_keys"
        revoked_settled = mgr.revoked_total
        survivor_epochs = {k: cli_tb._leases[k].epoch
                           for k in survivor_keys if k in cli_tb._leases}
        assert survivor_epochs, "no survivor lease left to renew"
        survivor_burns = 0
        for k in survivor_keys:
            lease = cli_tb._leases.get(k)
            # Drain the slice, then one more burn to force a wire RENEW
            # through the fence-epoch check.
            while lease is not None and lease.remaining > 0:
                clock["t"] += 1
                assert cli_tb.try_acquire(k), "survivor burn denied"
                survivor_burns += 1
            clock["t"] += 1
            assert cli_tb.try_acquire(k), "survivor renewal denied"
            survivor_burns += 1
        assert mgr.revoked_total == revoked_settled, (
            "a survivor-shard lease was revoked by the scoped fence")
        for k, ep in survivor_epochs.items():
            if k in cli_tb._leases:
                assert cli_tb._leases[k].epoch == ep, (
                    f"survivor {k!r} epoch bounced across the scoped "
                    f"promotion: {ep} -> {cli_tb._leases[k].epoch}")
        report["survivor_renewals"] = len(survivor_epochs)
        report["decisions"] += (burned_after_fence + post_burns
                                + survivor_burns)
        report["burned_after_fence"] = burned_after_fence
        report["revoked"] = mgr.revoked_total
        report["over_admission"] = mgr.over_admission_total

        # -- Phase D: drain + bit-identical reconciliation ----------------
        cli_tb.release_all()
        cli_sw.release_all()
        router.flush()
        oracle_tb = TokenBucketOracle(cfg_tb)
        oracle_sw = SlidingWindowOracle(cfg_sw)
        # The two managers touch disjoint key sets, so appending the
        # dead-client log preserves per-key operation order.
        report["replayed_ops"] = _replay_lease_ops(
            mgr.ops + mgr_dead.ops, {"tb": oracle_tb, "sw": oracle_sw})
        now = clock["t"]
        for algo, lid, oracle, keys in (
                ("tb", lid_tb, oracle_tb, tb_keys + ["dead-key"]),
                ("sw", lid_sw, oracle_sw, sw_keys)):
            for k in keys:
                got = int(router.available_many(algo, lid, [k])[0])
                want = oracle.get_available_permits(k, now)
                assert got == want, (
                    f"{algo} availability diverged for {k!r}: device "
                    f"{got} vs oracle {want}")
        report["reconciled_keys"] = 2 * n_keys + 1
        report["local_denies"] = cli_tb.local_denies + cli_sw.local_denies
        report["status"] = mgr.status()
        report["promotions"] = orch.promotions
        report["fence_epoch"] = orch.fence_epoch
        report["victim"] = victim
        report["wall_s"] = time.perf_counter() - t_start
        return report
    finally:
        orch.close()
        repl.stop()
        router.close()
        standbys.close()


def aggregator_failover_drill(
    n_shards: int = 4,
    slots_per_shard: int = 256,
    n_keys: int = 12,
    burns: int = 500,
    bulk_budget: int = 192,
    slice_budget: int = 12,
    n_clients: int = 4,
    seed: int = 0,
    registry=None,
    probe_interval_ms: float = 50.0,
    suspect_threshold: int = 3,
    hysteresis_ms: float = 200.0,
    device: str = "cuda",
    devices=None,
) -> dict:
    """The edge aggregator tier under failure: an aggregator killed
    mid-Zipf, its replacement resuming, and a scoped shard promotion
    revoking only the bulk leases it names, on ``lease_failover_drill``'s
    topology (shards on ``device`` or ``devices``).  Proves:

    - **multiplicative wire collapse**: ``n_clients`` clients burning a
      Zipf-skewed key set through one aggregator spend <= decisions/5
      upstream frames;
    - **death is bounded by the bulk budgets**: killing the aggregator
      WITHOUT a final flush strands only the subleased permits already
      in clients' hands — every burn after the death is served from
      those slices, and their sum is <= the dropped bulk budgets;
    - **TTL reclaims the carcass**: the dead aggregator's bulk leases
      expire at the core like any dead client's, and a re-granted
      aggregator takes the keys over cleanly;
    - **scoped revocation**: a victim-shard promotion revokes exactly
      the bulk pools whose keys route to that shard (the storage's
      per-shard ``lease_scope_epoch``) — survivor pools renew without
      revocation or epoch bounce — and the burns clients fold onto the
      revoked pools land in the core's ``lease.over_admission``, equal
      tier-to-tier;
    - **bit-identical reconciliation**: replaying the core manager's
      reserve/credit stream into ``semantics/oracle.py`` reproduces the
      device counters for every key.

    Deterministic: controlled decision clock, simulated orchestrator
    clock, in-process transports.  The report carries the drill's
    ``wall_s`` (unjudged).  Raises AssertionError on any violated claim;
    returns a report dict.
    """
    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.edge import EdgeAggregator
    from ratelimiter_tpu_torch.engine.routing import shard_of_key
    from ratelimiter_tpu_torch.leases import (
        DirectTransport,
        LeaseClient,
        LeaseManager,
    )
    from ratelimiter_tpu_torch.semantics.oracle import TokenBucketOracle

    t_start = time.perf_counter()
    clock = {"t": 1_753_000_000_000}
    primary, router, standbys, repl, orch, tick, dead, victim_box = (
        _lease_drill_topology(n_shards, slots_per_shard, clock, device,
                              devices, registry, probe_interval_ms,
                              suspect_threshold, hysteresis_ms))
    n_shards = router.n_shards
    cfg_tb = RateLimitConfig(max_permits=1 << 14, window_ms=60_000,
                             refill_rate=1000.0)
    lid = primary.register_limiter("tb", cfg_tb)

    mgr = LeaseManager(router, default_budget=slice_budget,
                       max_budget=slice_budget, max_bulk_budget=bulk_budget,
                       ttl_ms=5_000.0, registry=registry, record_ops=True,
                       clock_ms=lambda: clock["t"])

    def make_aggregator():
        return EdgeAggregator(DirectTransport(mgr),
                              bulk_budget=bulk_budget,
                              slice_budget=slice_budget,
                              flush_ms=20.0, registry=registry,
                              clock_ms=lambda: clock["t"])

    agg = make_aggregator()
    clients = [LeaseClient(agg.session(), lid, budget=slice_budget,
                           clock_ms=lambda: clock["t"],
                           direct_fallback=False, telemetry=False)
               for _ in range(n_clients)]
    keys = [f"edge-{i}" for i in range(n_keys)]
    shard_of = {k: int(shard_of_key((lid, k), n_shards)) for k in keys}
    # Zipf-skewed draws: the hot keys every client hammers are exactly
    # where bulk leases multiply the collapse.
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_keys + 1) ** 1.1
    draws = rng.choice(n_keys, size=burns + 200, p=p / p.sum())
    report = {"decisions": 0}

    try:
        # -- Phase A: healthy Zipf burn through one aggregator ------------
        for i in range(burns):
            clock["t"] += 1
            assert clients[i % n_clients].try_acquire(keys[draws[i]]), (
                "healthy edge burn denied")
            report["decisions"] += 1
            if i % 100 == 0:
                repl.ship_now()
                tick()
        agg.flush()  # settle burn reports before the kill window
        assert agg.upstream_frames * 5 <= report["decisions"], (
            f"{agg.upstream_frames} upstream frames for "
            f"{report['decisions']} decisions — the aggregator collapse "
            "failed in-process")
        report["wire_frames_healthy"] = agg.upstream_frames
        report["frames_per_decision"] = (agg.upstream_frames
                                         / report["decisions"])

        # -- Phase B: kill mid-Zipf — burns bounded by bulk budgets -------
        repl.ship_now()
        exposure = agg.drop()
        assert exposure["pools"] > 0 and exposure["subleases"] > 0, (
            "the kill caught no live subleases; raise burns")
        burned_after_death = 0
        for lc in clients:
            for k in list(lc._leases):
                lease = lc._leases[k]
                while lease.remaining > 0:
                    clock["t"] += 1
                    assert lc.try_acquire(k), "sliced burn denied"
                    burned_after_death += 1
        assert burned_after_death <= exposure["sliced_out"] \
            <= exposure["bulk_budget"] <= bulk_budget * n_keys, (
            f"burns after death ({burned_after_death}) escaped the "
            f"dropped bulk budgets ({exposure})")
        report["burned_after_death"] = burned_after_death
        report["exposure"] = exposure

        # -- Phase C: TTL reclaim + re-granted aggregator -----------------
        expired_before = mgr.expired_total
        clock["t"] += int(mgr.ttl_ms) + 1  # past the bulk-lease TTL
        agg2 = make_aggregator()
        for lc in clients:
            # The fleet re-points at the replacement aggregator; stale
            # client-side leases renew into it, fold conservatively, and
            # re-grant from fresh bulk pools.
            lc._t = agg2.session()
        for i in range(200):
            clock["t"] += 1
            assert clients[i % n_clients].try_acquire(
                keys[draws[burns + i]]), "post-reclaim burn denied"
            report["decisions"] += 1
        assert mgr.expired_total > expired_before, (
            "the dead aggregator's bulk leases never expired")
        assert agg2._pools, "replacement aggregator took no pools"

        # -- Phase D: scoped promotion revokes only victim pools ----------
        agg2.flush()  # settle pending reports; pools now current
        pool_epochs = {key: p_.epoch
                       for (_l, key), p_ in agg2._pools.items()}
        counts = [0] * n_shards
        for key in pool_epochs:
            counts[shard_of[key]] += 1
        victim = victim_box[0] = int(np.argmax(counts))
        victim_pools = [k for k in pool_epochs if shard_of[k] == victim]
        survivor_pools = [k for k in pool_epochs if shard_of[k] != victim]
        assert victim_pools and survivor_pools, (
            "degenerate pool split; raise n_keys")
        victim_budget = sum(p_.budget for (_l, key), p_ in
                            agg2._pools.items() if key in victim_pools)
        repl.ship_now()
        _kill_until_fenced(orch, dead, tick)
        _settle_promotion(orch, victim, tick)
        dead["flag"] = False
        rev_before = agg2.scoped_revocations_total
        over_core_before = mgr.over_admission_total
        over_agg_before = agg2.over_admission_total
        agg2.flush()
        assert agg2.scoped_revocations_total - rev_before \
            == len(victim_pools), (
            f"scoped fence revoked "
            f"{agg2.scoped_revocations_total - rev_before} pools; "
            f"expected exactly the {len(victim_pools)} victim pools")
        for (_l, key), p_ in agg2._pools.items():
            assert shard_of[key] != victim, (
                f"victim-shard pool {key!r} survived the fence")
            assert p_.epoch == pool_epochs[key], (
                f"survivor pool {key!r} epoch bounced: "
                f"{pool_epochs[key]} -> {p_.epoch}")
        # Clients still hold slices cut from the revoked pools: burning
        # them is the bounded over-admission window, and the fold-and-
        # flush lands those burns in the core's lease.over_admission.
        post_burns = 0
        for lc in clients:
            for k in list(lc._leases):
                if shard_of[k] != victim:
                    continue
                lease = lc._leases[k]
                while lease.remaining > 0:
                    clock["t"] += 1
                    assert lc.try_acquire(k), "revoked-slice burn denied"
                    post_burns += 1
                clock["t"] += 1
                # Renew folds the burns onto the dead pool, the client
                # re-grants from a fresh pool at the NEW epoch.
                assert lc.try_acquire(k), "post-promotion re-grant failed"
                post_burns += 1
        agg2.flush()  # dead pools' final burn reports land upstream
        report["decisions"] += post_burns
        assert agg2.over_admission_total - over_agg_before <= victim_budget, (
            "aggregator-tier over-admission escaped the revoked budgets")
        assert mgr.over_admission_total - over_core_before \
            == agg2.over_admission_total - over_agg_before, (
            f"core over_admission delta "
            f"{mgr.over_admission_total - over_core_before} != aggregator "
            f"fold delta {agg2.over_admission_total - over_agg_before}")
        for (_l, key), p_ in agg2._pools.items():
            if key in victim_pools:
                assert p_.epoch == orch.fence_epoch, (
                    f"re-granted pool {key!r} does not carry the bumped "
                    f"fence epoch")
        report["scoped_revocations"] = agg2.scoped_revocations_total
        report["over_admission"] = mgr.over_admission_total
        report["burned_after_fence"] = post_burns

        # -- Phase E: drain + bit-identical reconciliation ----------------
        for lc in clients:
            lc.release_all()
        agg2.release_all()
        router.flush()
        oracle = TokenBucketOracle(cfg_tb)
        report["replayed_ops"] = _replay_lease_ops(mgr.ops, {"tb": oracle})
        now = clock["t"]
        for k in keys:
            got = int(router.available_many("tb", lid, [k])[0])
            want = oracle.get_available_permits(k, now)
            assert got == want, (
                f"availability diverged for {k!r}: device {got} vs "
                f"oracle {want}")
        report["reconciled_keys"] = n_keys
        report["status"] = mgr.status()
        report["edge_status"] = agg2.status()
        report["promotions"] = orch.promotions
        report["fence_epoch"] = orch.fence_epoch
        report["victim"] = victim
        report["wall_s"] = time.perf_counter() - t_start
        return report
    finally:
        orch.close()
        repl.stop()
        router.close()
        standbys.close()


def cross_host_failover_drill(
    num_slots: int = 512,
    n_keys: int = 24,
    waves: int = 3,
    pipeline: int = 16,
    seed: int = 0,
    probe_interval_ms: float = 100.0,
    suspect_threshold: int = 3,
    hysteresis_ms: float = 300.0,
    lease_ttl_ms: float = 1200.0,
    witness_fresh_ms: float = 500.0,
    lease_budget: int = 12,
    boot_timeout_s: float = 180.0,
    registry=None,
    device: str = "cuda",
    settle_s: float = 60.0,
) -> dict:
    """Cross-host failover with shard primary, standby, and orchestrator
    in SEPARATE OS PROCESSES — this process plays the orchestrator; the
    primary and standby are real subprocesses
    (``replication/hostproc.py``, on ``device``: the card by default,
    both on the one card) joined by TCP through
    :class:`FaultInjectingProxy` links, so a ``partition()`` is a real
    silent byte-drop between processes, not a mock.

    Proves:

    - **orchestrator-partitioned-from-healthy-shard -> nothing happens**:
      with only the orchestrator->primary control link cut, the standby
      witness (replication heartbeats still landing) VETOES fencing, the
      serving lease keeps renewing via the standby relay path (deposit
      -> mailbox -> primary's lease keeper), and after longer than a
      full lease TTL the primary is still serving exactly: zero
      promotions, zero fences, zero self-fences.
    - **a partitioned primary self-fences at its own lease deadline**:
      with the primary fully isolated (control + replication + relay
      links all cut) no grant reaches it after the cut (its lease epoch
      is the one read just before it, with at most one TTL remaining),
      the first decision past the deadline self-fences, and every later
      one is refused and counted by the primary's fence.  What it
      admitted before is the documented over-admission window: per key
      at most ``max_permits``, and a leased client's local burns at most
      its outstanding budget at the cut.
    - **promotion waits out the zombie's lease, then lands**: the fence
      RPC cannot be delivered, so the orchestrator holds FENCING until
      every grant it issued has provably expired, then drives the
      remote-promotion RPC; the promoted standby opens a sidecar and
      serves the SAME keyspace equal to ``semantics/oracle.py``.
    - **token leases are revoked-or-honored**: a renewal of the zombie-
      era lease against the promoted server is REVOKED (it carries a
      strictly higher fence epoch) and the re-grant lands with that
      higher epoch — never honored across the promotion boundary.

    The report carries the wall times (``self_fence_after_s``,
    ``promotion_after_s``, the nodes' ``ready_s``) without judging them:
    a loaded host stretches them, and the caller that knows its host
    holds them to a bound.  Every wait is a poll against a deadline of
    at most ``settle_s`` (``boot_timeout_s`` for a node's ready line).

    Equality across processes uses TIME-INSENSITIVE policies (token
    bucket with a refill rate whose fixed-point form is 0, sliding
    window with a multi-decade window) so wall-clock skew between the
    subprocesses and this process's oracle cannot change any decision.

    Returns a report dict (``launches``: the nodes' kernel launches,
    summed, when both exited cleanly); raises AssertionError on any
    violated claim.
    """
    import json as json_mod

    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.leases.client import LeaseClient
    from ratelimiter_tpu_torch.replication.control import ControlClient
    from ratelimiter_tpu_torch.replication.hostproc import NodeProcess
    from ratelimiter_tpu_torch.replication.orchestrator import (
        FailoverOrchestrator,
        OrchestratorConfig,
    )
    from ratelimiter_tpu_torch.replication.remote import (
        FanoutLeaseChannel,
        RemoteBackend,
        RemoteReceiver,
        RemoteShardDirectory,
        RemoteStandbySet,
        standby_witness,
    )
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.service import sidecar as sc

    rng = random.Random(seed)
    # Time-insensitive policies: decisions depend only on arrival ORDER.
    # 2^30 ms (~12.4 days, the config ceiling) keeps the drill inside one
    # never-rolling window with a fresh previous window.
    GIANT_WINDOW = 1 << 30
    cfg_tb = RateLimitConfig(max_permits=30, window_ms=GIANT_WINDOW,
                             refill_rate=1e-9)
    assert cfg_tb.refill_rate_fp == 0, "drill needs an order-only bucket"
    cfg_sw = RateLimitConfig(max_permits=18, window_ms=GIANT_WINDOW,
                             enable_local_cache=False)
    limiters_spec = json_mod.dumps([
        {"algo": "tb", "max_permits": cfg_tb.max_permits,
         "window_ms": cfg_tb.window_ms, "refill_rate": cfg_tb.refill_rate},
        {"algo": "sw", "max_permits": cfg_sw.max_permits,
         "window_ms": cfg_sw.window_ms},
    ])
    NOW = 1_753_000_000_000  # fixed oracle stamp (its window never rolls)
    POST_FENCE_TRIES = 8  # decisions sent to the zombie after its fence

    nodes: list = []
    proxies: list = []
    clients: list = []
    orch = None

    def spawn(args):
        node = NodeProcess(args, device=device,
                           boot_timeout_s=boot_timeout_s)
        nodes.append(node)
        return node

    def proxy_for(port):
        p = FaultInjectingProxy(port, seed=seed).start()
        proxies.append(p)
        return p

    def poll(pred, what, timeout_s=settle_s):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(0.02)
        raise AssertionError(f"timed out waiting for {what}")

    def keep(c):
        clients.append(c)
        return c

    def ctl(port, timeout=0.5):
        return keep(ControlClient("127.0.0.1", port, timeout=timeout))

    report = {"decisions": 0, "mismatches": 0, "zombie_allows": {}}
    try:
        # -- topology -----------------------------------------------------
        standby = spawn(["--role", "standby", "--num-slots", str(num_slots),
                         "--lease"])
        standby_info = standby.info
        # The primary's links to the standby: replication data, and the
        # lease keeper's relay fetches.
        p_repl = proxy_for(standby_info["repl_port"])
        p_relay = proxy_for(standby_info["control_port"])
        primary = spawn([
            "--role", "primary", "--num-slots", str(num_slots), "--lease",
            "--limiters", limiters_spec,
            "--repl-target", f"127.0.0.1:{p_repl.port}",
            "--standby-control", f"127.0.0.1:{p_relay.port}",
            "--repl-interval-ms", "100",
        ])
        primary_info = primary.info
        report["ready_s"] = {"standby": standby.ready_s,
                             "primary": primary.ready_s}
        lid_tb, lid_sw = primary_info["lids"]
        # The orchestrator's control link to the primary.
        p_ctl = proxy_for(primary_info["control_port"])

        # The orchestrator's view: primary through ITS (cuttable) link,
        # standby direct (that link is never the one partitioned here).
        primary_backend = RemoteBackend(ctl(p_ctl.port))
        directory = RemoteShardDirectory({0: primary_backend})
        rx = RemoteReceiver(ctl(standby_info["control_port"], timeout=2.0),
                            promote_timeout_s=60.0)
        standby_set = RemoteStandbySet([rx])
        witness = standby_witness({0: ctl(standby_info["control_port"])},
                                  fresh_ms=witness_fresh_ms)
        lease_channels = {0: FanoutLeaseChannel(
            primary_backend, ctl(standby_info["control_port"]))}
        # Drill-side DIRECT taps (assertions only, never partitioned).
        prim_direct = ctl(primary_info["control_port"], timeout=2.0)

        def probe(q):
            backend = directory.serving(q)
            return backend is not None and backend.is_available()

        orch = FailoverOrchestrator(
            directory, standby_set, None, standby_factory=None,
            config=OrchestratorConfig(
                probe_interval_ms=probe_interval_ms,
                suspect_threshold=suspect_threshold,
                hysteresis_ms=hysteresis_ms,
                promote_retries=2, promote_backoff_ms=100.0,
                reseed=False,
                fence_lease_ttl_ms=lease_ttl_ms,
                fence_wait_slack_ms=150.0),
            probe=probe, witness=witness, lease_channels=lease_channels,
            witness_fresh_ms=witness_fresh_ms,
            repl_heartbeat_ms=100.0,
            registry=registry).start()

        # -- healthy phase ------------------------------------------------
        oracle_tb = TokenBucketOracle(cfg_tb)
        oracle_sw = SlidingWindowOracle(cfg_sw)
        client = keep(sc.SidecarClient("127.0.0.1",
                                       primary_info["sidecar_port"]))
        assert client.server_version >= 3, "primary handshake failed"

        def wave(via, n=None):
            """One pipelined oracle-checked wave on the main keyspace."""
            keys = [f"k{rng.randrange(n_keys)}"
                    for _ in range(n or pipeline)]
            perms = [rng.choice([1, 1, 2, 3]) for _ in keys]
            for lid, oracle in ((lid_tb, oracle_tb), (lid_sw, oracle_sw)):
                got = via.acquire_batch(lid, keys, perms)
                for j, (status, allowed, rem) in enumerate(got):
                    assert status == sc.ST_OK, (lid, j, status, rem)
                    d = oracle.try_acquire(keys[j], perms[j], NOW)
                    report["decisions"] += 1
                    if allowed != d.allowed or (
                            lid == lid_tb and int(rem) != d.remaining_hint):
                        report["mismatches"] += 1

        for _ in range(max(waves, 1)):
            wave(client)
        poll(lambda: prim_direct.call_ok("probe")["lease"]["installed"],
             "the orchestrator's first serving-lease grant")
        assert not prim_direct.call_ok("probe")["lease"]["expired"]
        # Let replication settle (the standby's first frame apply may
        # build the row scatter) before any partition goes in — the
        # witness freshness signal must be steady from here on.
        poll(lambda: rx.consistent and rx.last_epoch >= 1,
             "standby consistency after the healthy phase")

        # -- scenario A: orchestrator partitioned from a HEALTHY shard ----
        fences_before = orch.fence_epoch
        p_ctl.partition()
        t_cut_a = time.monotonic()
        # Hold the partition past a full lease TTL (only the standby-
        # relayed renewals can then be keeping the primary leased) AND
        # until at least one veto — each failing probe blocks for the
        # control timeout, so a SUSPECT->veto round is several times the
        # nominal probe cadence.
        need_s = lease_ttl_ms / 1000.0 * 1.5
        while (time.monotonic() - t_cut_a < need_s
               or (orch.witness_vetoes < 1
                   and time.monotonic() - t_cut_a < settle_s)):
            time.sleep(0.1)
            wave(client, n=4)  # the healthy primary keeps serving, exact
        hold_s = time.monotonic() - t_cut_a
        st = orch.status()
        assert st["promotions"] == 0, (
            "orchestrator promoted against a healthy-but-unreachable "
            f"shard: {st}")
        assert orch.fence_epoch == fences_before, (
            "orchestrator fenced a healthy-but-unreachable shard")
        assert st["witness_vetoes"] >= 1, (
            f"no witness veto recorded during the control partition: {st}")
        lease_a = prim_direct.call_ok("probe")["lease"]
        assert lease_a["installed"] and not lease_a["expired"], (
            f"relay renewals did not keep the healthy primary leased: "
            f"{lease_a}")
        assert not lease_a["self_fenced"]
        report["scenario_a"] = {
            "held_s": round(hold_s, 2),
            "witness_vetoes": st["witness_vetoes"],
            "lease": lease_a,
        }
        p_ctl.heal()
        poll(lambda: orch.status()["shards"][0]["state"] == "MONITORING"
             and directory.shard_health()[0] == "active",
             "recovery after the control partition healed")
        wave(client)

        # -- scenario B: the primary is PARTITIONED (fully isolated) ------
        # Token lease: grant + local burns, THEN the pre-cut sync, so the
        # reserve charge is in the replica when the partition hits; the
        # cut follows immediately, well inside the lease's server TTL.
        lease_transport = keep(sc.SidecarClient(
            "127.0.0.1", primary_info["sidecar_port"]))
        burner = LeaseClient(lease_transport, lid_tb, budget=lease_budget,
                             direct_fallback=False, telemetry=False)
        for _ in range(3):
            assert burner.try_acquire("lz") is True
        old_epoch = burner._leases["lz"].epoch
        assert old_epoch >= 1, "grant carried no fence-generation epoch"
        prim_direct.call_ok("ship")  # pin the replica byte-exact
        poll(lambda: rx.consistent and rx.last_epoch >= 1,
             "standby consistency before the kill")
        outstanding = burner._leases["lz"].remaining
        p_ctl.partition()
        p_repl.partition()
        p_relay.partition()
        t_cut = time.monotonic()
        # The zombie's serving lease as it stands at the cut: no grant
        # can reach it from here on.
        lease_cut = prim_direct.call_ok("probe")["lease"]
        assert lease_cut["installed"] and not lease_cut["self_fenced"], (
            f"primary not leased at the cut: {lease_cut}")
        assert lease_cut["ttl_remaining_ms"] <= lease_ttl_ms, lease_cut

        # The zombie's own clients (this drill, on direct connections)
        # keep hitting it: fresh z-keys so the zombie's post-cut state
        # never touches the replicated keyspace the oracle tracks.
        zombie_allows: dict = {}
        burns_after_cut = 0
        while burner._leases.get("lz") is not None \
                and burner._leases["lz"].remaining > 0:
            assert burner.try_acquire("lz") is True
            burns_after_cut += 1
        assert burns_after_cut <= outstanding, (
            "a leased client burned past its outstanding budget")
        refused_errors = (RuntimeError, ConnectionError,
                          sc.SidecarShedError, sc.SidecarSendError)
        t_fence = None
        zi = 0
        # Allows the zombie answered to a request sent after the
        # replacement was already promoted: two primaries at once.
        allowed_after_promotion = 0
        while time.monotonic() - t_cut < lease_ttl_ms / 1000.0 + settle_s:
            zkey = f"z{zi % 8}"
            zi += 1
            promoted_before = orch.promotions
            try:
                if client.try_acquire(lid_tb, zkey):
                    zombie_allows[zkey] = zombie_allows.get(zkey, 0) + 1
                    allowed_after_promotion += promoted_before > 0
            except refused_errors:
                t_fence = time.monotonic()
                break
            time.sleep(0.02)
        assert all(node.alive() for node in nodes), (
            "a node process died during the partition — the refusal "
            "would be a crash, not a self-fence")
        assert t_fence is not None, (
            "the isolated primary never self-fenced (lease expiry did "
            "not bite)")
        fence_after_s = t_fence - t_cut
        assert all(n <= cfg_tb.max_permits
                   for n in zombie_allows.values()), (
            f"zombie over-admitted past the per-key bound: "
            f"{zombie_allows}")
        assert allowed_after_promotion == 0, (
            f"the zombie admitted {allowed_after_promotion} decisions "
            f"sent after its replacement was promoted")
        # The fence is sticky: every later decision is refused, and the
        # primary counts each refusal itself.
        refused_after = 0
        for i in range(POST_FENCE_TRIES):
            try:
                client.try_acquire(lid_tb, f"z{i % 8}")
            except refused_errors:
                refused_after += 1
        assert refused_after == POST_FENCE_TRIES, (
            f"the self-fenced zombie admitted or answered "
            f"{POST_FENCE_TRIES - refused_after} of {POST_FENCE_TRIES} "
            f"later decisions")
        probe_b = prim_direct.call_ok("probe")
        lease_b = probe_b["lease"]
        assert lease_b["self_fenced"], f"zombie not self-fenced: {lease_b}"
        assert lease_b["epoch"] == lease_cut["epoch"], (
            f"a grant reached the isolated primary after the cut: "
            f"{lease_cut} -> {lease_b}")
        assert probe_b["fence"]["rejected"] >= 1 + POST_FENCE_TRIES, (
            probe_b["fence"])
        report["zombie_allows"] = zombie_allows

        # The orchestrator: SUSPECT -> (witness dead, no veto) ->
        # FENCING (fence RPC undeliverable -> wait out the lease) ->
        # PROMOTING -> remote promotion.
        poll(lambda: orch.promotions >= 1
             and directory.shard_health()[0] == "promoted",
             "the remote promotion")
        t_promoted = time.monotonic()
        assert orch.fence_epoch == fences_before + 1
        serve_port = standby_set.receivers[0].serve_port
        assert serve_port, "promoted standby opened no serving port"

        # Post-promotion: same keyspace, same oracle, exact.
        promoted_client = keep(sc.SidecarClient("127.0.0.1", serve_port))
        for _ in range(max(waves, 1)):
            wave(promoted_client)

        # Token leases across the boundary: the zombie-era lease is
        # REVOKED by the promoted server (strictly higher epoch), and
        # the re-grant carries that higher epoch.
        lease_wire = keep(sc.SidecarClient("127.0.0.1", serve_port))
        revoked = lease_wire.lease_renew(lid_tb, "lz", used=0,
                                         requested=lease_budget)
        assert revoked is None, (
            "promoted server honored a zombie-era lease renewal")
        fresh = lease_wire.lease_grant(lid_tb, "lz",
                                       requested=lease_budget)
        assert fresh is not None and fresh.epoch > old_epoch, (
            f"re-grant epoch {fresh and fresh.epoch} not past the "
            f"zombie-era epoch {old_epoch}")
        promoted_lease = RemoteBackend(
            ctl(standby_info["control_port"])).serving_lease_info()
        assert promoted_lease["installed"] \
            and not promoted_lease["expired"], promoted_lease

        report["scenario_b"] = {
            "self_fence_after_s": round(fence_after_s, 3),
            "promotion_after_s": round(t_promoted - t_cut, 3),
            "lease_ttl_s": lease_ttl_ms / 1000.0,
            "lease_at_cut": lease_cut,
            "refused_after_fence": refused_after,
            "fence_rejected": probe_b["fence"]["rejected"],
            "burns_after_cut": burns_after_cut,
            "outstanding_at_cut": outstanding,
            "old_epoch": old_epoch,
            "new_epoch": fresh.epoch,
        }
        report["status"] = orch.status()
        if report["mismatches"]:
            raise AssertionError(
                f"cross-host drill diverged from the oracle: {report}")
    finally:
        if orch is not None:
            orch.close()
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for p in proxies:
            try:
                p.stop()
            except Exception:  # noqa: BLE001
                pass
        for node in nodes:
            try:
                node.proc.stdin.close()
            except Exception:  # noqa: BLE001
                pass
        for node in nodes:
            node.stop(timeout_s=30.0)
            node.close()
    counts = [node.launches() for node in nodes]
    if counts and all(c is not None for c in counts):
        report["launches"] = {k: sum(c[k] for c in counts)
                              for k in counts[0]}
    return report


# ---------------------------------------------------------------------------
# Rolling-upgrade drill (fleet autopilot under live traffic)
# ---------------------------------------------------------------------------

#: The fleet drills' pipelined frames a sidecar round trip: under the
#: sidecar's 1024-frame pipeline cap, so a full-width wave (thousands of
#: keys a shard) is answered, not shed.  The reference's drills send a
#: shard's whole wave in one round trip at their 12-40 key waves; the
#: decisions and their order are the same either way.
_WAVE_FRAMES = 512


def _acquire_frames(cli, lid: int, keys, permits) -> list:
    """``cli.acquire_batch`` over ``keys`` in round trips of at most
    ``_WAVE_FRAMES`` frames, in order, on the one connection."""
    out: list = []
    for i in range(0, len(keys), _WAVE_FRAMES):
        out.extend(cli.acquire_batch(lid, keys[i:i + _WAVE_FRAMES],
                                     permits[i:i + _WAVE_FRAMES]))
    return out

def rolling_upgrade_drill(
    num_slots: int = 256,
    n_keys: int = 24,
    waves: int = 2,
    pipeline: int = 12,
    seed: int = 0,
    zipf_s: float = 1.1,
    probe_interval_ms: float = 100.0,
    suspect_threshold: int = 3,
    hysteresis_ms: float = 300.0,
    lease_ttl_ms: float = 1200.0,
    witness_fresh_ms: float = 500.0,
    reseed_deadline_s: float = 90.0,
    boot_timeout_s: float = 180.0,
    full: bool = False,
    registry=None,
    device: str = "cuda",
) -> dict:
    """Zero-loss rolling upgrade of a LIVE 2-shard cross-host cell:
    every node is replaced one at a time while
    Zipf-distributed traffic keeps flowing, with a mid-upgrade hard
    kill of the serving node thrown in — and every decision the cell
    emits stays bit-identical to ``semantics/oracle.py``.

    Topology (``full=False``, the fast CI shape): one 2-shard primary
    node ``P`` and one 2-shard standby node ``S``, both at ``--version
    v1``, run as real ``hostproc`` subprocesses (on ``device``: the card
    by default, every node on the one card) under a
    :class:`~ratelimiter_tpu_torch.fleet.manager.NodeManager`; this process
    plays the orchestrator + FleetAutopilot.  ``full=True`` (the slow
    soak) splits the primaries onto two single-shard nodes — a 3-node
    cell, drained one node at a time.

    The ladder:

    1. **Graceful standby swap** — spawn ``S2`` at v2, RETARGET both
       shards' replication streams at it (control-RPC full re-baseline,
       no restart of the primary), hand the consistent v2 replicas to
       the orchestrator (StandbySet + witness + lease-relay rewire via
       ``FleetAutopilot.install_standby``), retire ``S``.  Traffic
       never pauses.
    2. **Drain the serving node(s)** — ``mark_draining`` flips the
       drain-aware probe/witness: the orchestrator fences (deliverable
       — the node is healthy, just scheduled out) and promotes each
       shard onto the v2 standby.  The autopilot notices each consumed
       standby and — with ZERO operator calls — spawns a fresh v2
       node, re-targets the new serving side's stream at it, and hands
       the consistent replica back: the cell is N+1 again, inside
       ``reseed_deadline_s`` (asserted per job).
    3. **Mid-upgrade primary kill** — SIGKILL the node that now serves
       both shards.  Fence undeliverable -> the orchestrator waits out
       the serving lease TTL, promotes the re-seeded standbys, and the
       autopilot re-seeds AGAIN.  Decisions pinned before the kill
       (explicit ``ship``) are all in the replicas: zero decision loss.

    End state: every live node is at v2, every shard is promoted with
    a consistent unpromoted standby (N+1), and the full decision
    stream — across two handovers per shard — matched the oracle
    bit-for-bit.  Raises AssertionError on any violated claim.

    The report also carries the wall times, without judging them: every
    node's boot (``boot_s``), each drain's promote-away, the kill to the
    promotion (``kill_promote_s``, held only to its lease-TTL floor) and
    each re-seed job's ``elapsed_s``; and ``launches``, each node's kernel
    launches from its clean exit (None for the SIGKILLed node).
    """
    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.fleet import (
        DRAINING as NODE_DRAINING,
        FleetAutopilot,
        LocalExecutor,
        NodeManager,
    )
    from ratelimiter_tpu_torch.replication.control import ControlClient
    from ratelimiter_tpu_torch.replication.orchestrator import (
        FailoverOrchestrator,
        OrchestratorConfig,
    )
    from ratelimiter_tpu_torch.replication.remote import (
        FanoutLeaseChannel,
        RemoteBackend,
        RemoteReceiver,
        RemoteShardDirectory,
        RemoteStandbySet,
        standby_witness,
    )
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.service import sidecar as sc

    rng = random.Random(seed)
    # Same order-only policies as cross_host_failover_drill: decisions
    # depend only on arrival ORDER, so subprocess clock skew cannot
    # move a single verdict.
    GIANT_WINDOW = 1 << 30
    cfg_tb = RateLimitConfig(max_permits=30, window_ms=GIANT_WINDOW,
                             refill_rate=1e-9)
    assert cfg_tb.refill_rate_fp == 0, "drill needs an order-only bucket"
    cfg_sw = RateLimitConfig(max_permits=18, window_ms=GIANT_WINDOW,
                             enable_local_cache=False)
    limiters = [
        {"algo": "tb", "max_permits": cfg_tb.max_permits,
         "window_ms": cfg_tb.window_ms, "refill_rate": cfg_tb.refill_rate},
        {"algo": "sw", "max_permits": cfg_sw.max_permits,
         "window_ms": cfg_sw.window_ms},
    ]
    NOW = 1_753_000_000_000  # fixed oracle stamp (its window never rolls)
    # Zipf(s) traffic over the keyspace; keys land on shards by parity.
    zipf_w = [1.0 / float(r + 1) ** zipf_s for r in range(n_keys)]

    clients: list = []
    mgr = None
    orch = None

    def ctl(port, timeout=0.5):
        c = ControlClient("127.0.0.1", port, timeout=timeout)
        clients.append(c)
        return c

    def poll(pred, timeout_s, what):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(0.02)
        raise AssertionError(f"timed out waiting for {what}")

    report = {"decisions": 0, "mismatches": 0,
              "mode": "full" if full else "fast"}
    try:
        # -- topology: the v1 cell under fleet management -----------------
        mgr = NodeManager(
            executor=LocalExecutor(boot_timeout_s=boot_timeout_s,
                                   device=device),
            probe_interval_ms=probe_interval_ms,
            probe_timeout_s=1.0, registry=registry)
        s_node = mgr.spawn("S", "standby", shards=2, version="v1",
                           num_slots=num_slots, repl_interval_ms=100.0,
                           boot_timeout_s=boot_timeout_s)
        placements = {}
        if full:
            for q in (0, 1):
                p_node = mgr.spawn(
                    f"P{q}", "primary", shards=1, version="v1",
                    num_slots=num_slots, limiters=limiters,
                    repl_targets=[f"127.0.0.1:{s_node.repl_ports()[q]}"],
                    repl_interval_ms=100.0, boot_timeout_s=boot_timeout_s)
                placements[q] = (p_node.name, 0)
                mgr.mark_serving(p_node.name)
        else:
            p_node = mgr.spawn(
                "P", "primary", shards=2, version="v1",
                num_slots=num_slots, limiters=limiters,
                repl_targets=[f"127.0.0.1:{pt}"
                              for pt in s_node.repl_ports()],
                repl_interval_ms=100.0, boot_timeout_s=boot_timeout_s)
            placements = {0: ("P", 0), 1: ("P", 1)}
            mgr.mark_serving("P")

        def lids_of(node, shard_on_node):
            v = node.ready["lids"]
            if v and isinstance(v[0], list):
                return list(v[shard_on_node])
            return list(v)

        lids, cli, backends = {}, {}, {}
        for q, (pname, pshard) in placements.items():
            node = mgr.node(pname)
            lids[q] = lids_of(node, pshard)
            cli[q] = sc.SidecarClient("127.0.0.1",
                                      node.sidecar_ports()[pshard])
            assert cli[q].server_version >= 3, "primary handshake failed"
            backends[q] = RemoteBackend(ctl(node.control_port),
                                        label=pname, shard=pshard)

        directory = RemoteShardDirectory(backends)
        rxs = [RemoteReceiver(ctl(s_node.control_port, timeout=2.0),
                              promote_timeout_s=60.0, shard=q)
               for q in (0, 1)]
        standby_set = RemoteStandbySet(rxs)
        witness_ctls = {q: (ctl(s_node.control_port), q) for q in (0, 1)}
        inner_witness = standby_witness(witness_ctls,
                                        fresh_ms=witness_fresh_ms)
        lease_channels = {
            q: FanoutLeaseChannel(backends[q],
                                  ctl(s_node.control_port), shard=q)
            for q in (0, 1)}

        pilot = FleetAutopilot(
            mgr, None, standby_set, witness_ctls,
            node_defaults=dict(host="127.0.0.1", num_slots=num_slots,
                               repl_interval_ms=100.0,
                               boot_timeout_s=boot_timeout_s),
            version="v2", reseed_deadline_s=reseed_deadline_s)
        witness = pilot.witness_wrap(inner_witness)

        def probe(q):
            # Drain-fold: a shard still on its ORIGINAL backend whose
            # serving node is DRAINING probes "down" so the
            # orchestrator promotes away.  Once a replacement is
            # installed the fold is bypassed — the autopilot's binding
            # swap may trail the promotion by a manager tick, and the
            # stale DRAINING read must not re-suspect a shard that
            # already moved.
            if directory.replacements.get(q) is None:
                entry = pilot.serving_placement(q)
                if entry is not None:
                    node = mgr.nodes.get(entry[0])
                    if node is not None and node.state == NODE_DRAINING:
                        return False
            backend = directory.serving(q)
            return backend is not None and backend.is_available()

        orch = FailoverOrchestrator(
            directory, standby_set, None, standby_factory=None,
            config=OrchestratorConfig(
                probe_interval_ms=probe_interval_ms,
                suspect_threshold=suspect_threshold,
                hysteresis_ms=hysteresis_ms,
                promote_retries=2, promote_backoff_ms=100.0,
                reseed=False,
                fence_lease_ttl_ms=lease_ttl_ms,
                fence_wait_slack_ms=150.0),
            probe=probe, witness=witness, lease_channels=lease_channels,
            witness_fresh_ms=witness_fresh_ms,
            repl_heartbeat_ms=100.0,
            registry=registry).start()
        pilot.orch = orch
        for q, placement in placements.items():
            pilot.bind(q, placement, ("S", q))
        mgr.attach(pilot)
        mgr.start()

        # -- oracle-checked Zipf traffic ----------------------------------
        oracles = {q: (TokenBucketOracle(cfg_tb),
                       SlidingWindowOracle(cfg_sw)) for q in (0, 1)}

        def wave(n=None):
            ids = rng.choices(range(n_keys), weights=zipf_w,
                              k=n or pipeline)
            perms = [rng.choice([1, 1, 2, 3]) for _ in ids]
            by_shard = {0: [], 1: []}
            for kid, pm in zip(ids, perms):
                by_shard[kid % 2].append((f"k{kid}", pm))
            for q, items in by_shard.items():
                if not items:
                    continue
                keys = [k for k, _ in items]
                ps = [pm for _, pm in items]
                for slot, oracle in enumerate(oracles[q]):
                    got = _acquire_frames(cli[q], lids[q][slot], keys,
                                          ps)
                    for j, (status, allowed, rem) in enumerate(got):
                        assert status == sc.ST_OK, (q, slot, j, status)
                        d = oracle.try_acquire(keys[j], ps[j], NOW)
                        report["decisions"] += 1
                        if allowed != d.allowed or (
                                slot == 0
                                and int(rem) != d.remaining_hint):
                            report["mismatches"] += 1

        def ship(q):
            """Pin shard q's replica byte-exact (the zero-loss cut
            protocol: pause -> ship -> cut)."""
            pname, pshard = pilot.serving_placement(q)
            node = mgr.node(pname)
            ctl(node.control_port, timeout=15.0).call_ok(
                "ship", shard=pshard, timeout=15.0)

        # -- healthy phase ------------------------------------------------
        for _ in range(max(waves, 1)):
            wave()
        poll(lambda: all(r.consistent and r.last_epoch >= 1 for r in rxs),
             60.0, "v1 standby consistency after the healthy phase")
        poll(lambda: all(
            directory.serving(q).serving_lease_info()["installed"]
            for q in (0, 1)), 10.0, "the first serving-lease grants")

        # -- step 1: graceful standby swap S -> S2 (v2) -------------------
        s2 = mgr.spawn("S2", "standby", shards=2, version="v2",
                       num_slots=num_slots, repl_interval_ms=100.0,
                       boot_timeout_s=boot_timeout_s)
        for q in (0, 1):
            backends[q].retarget("127.0.0.1", s2.repl_ports()[q],
                                 timeout_s=60.0)
            r = RemoteReceiver(ctl(s2.control_port, timeout=2.0),
                               promote_timeout_s=60.0, shard=q)
            poll(lambda r=r: r.consistent and not r.promoted, 30.0,
                 f"v2 standby consistency for shard {q}")
            pilot.install_standby(q, "S2", q, r,
                                  serving_backend=backends[q])
        mgr.retire("S")
        mgr.note_upgrade_step()
        for _ in range(max(waves, 1)):
            wave()

        # -- step 2: drain the serving node(s); autopilot re-seeds --------
        drain_list = ["P0", "P1"] if full else ["P"]
        for pname in drain_list:
            qs = [q for q in (0, 1)
                  if pilot.serving_placement(q)[0] == pname]
            for q in qs:
                ship(q)
            cur_rx = {q: standby_set.receivers[q] for q in qs}
            poll(lambda: all(cur_rx[q].consistent for q in qs), 10.0,
                 f"replicas pinned before draining {pname}")
            promos_before = orch.promotions
            reseeds_before = mgr.reseeds
            t_drain = time.monotonic()
            mgr.mark_draining(pname)
            poll(lambda: orch.promotions >= promos_before + len(qs)
                 and all(directory.shard_health()[q] == "promoted"
                         for q in qs),
                 30.0, f"graceful promote-away from {pname}")
            promote_s = time.monotonic() - t_drain
            for q in qs:
                poll(lambda q=q: cur_rx[q].serve_port, 10.0,
                     f"promoted serve port for shard {q}")
                cli[q] = sc.SidecarClient("127.0.0.1",
                                          cur_rx[q].serve_port)
            for _ in range(max(waves, 1)):
                wave()
            poll(lambda: mgr.reseeds >= reseeds_before + len(qs),
                 reseed_deadline_s + 60.0,
                 f"automated re-seed to N+1 after draining {pname}")
            for q in qs:
                r = standby_set.receivers[q]
                assert r.consistent and not r.promoted, (
                    f"shard {q} re-seed handed back an unusable standby")
            mgr.retire(pname)
            mgr.note_upgrade_step()
            report[f"drain_{pname}"] = {"promote_s": round(promote_s, 3)}
            for _ in range(max(waves, 1)):
                wave()

        # -- step 3: mid-upgrade hard kill of the serving node ------------
        victim = pilot.serving_placement(0)[0]
        assert victim == "S2" \
            and pilot.serving_placement(1)[0] == victim, (
                "upgrade ladder did not converge on the v2 node")
        for q in (0, 1):
            ship(q)
        cur_rx = {q: standby_set.receivers[q] for q in (0, 1)}
        poll(lambda: all(cur_rx[q].consistent for q in (0, 1)), 10.0,
             "fresh standbys pinned before the kill")
        promos_before = orch.promotions
        reseeds_before = mgr.reseeds
        t_kill = time.monotonic()
        mgr.kill(victim)
        poll(lambda: orch.promotions >= promos_before + 2
             and all(directory.shard_health()[q] == "promoted"
                     for q in (0, 1)),
             60.0, "promotion after the mid-upgrade primary kill")
        kill_promote_s = time.monotonic() - t_kill
        # The fence was undeliverable, so the promotion must have
        # waited out the serving lease the dead node still held.
        assert kill_promote_s >= lease_ttl_ms / 1000.0 * 0.5, (
            f"promotion after the kill landed in {kill_promote_s:.2f}s "
            f"— inside the {lease_ttl_ms / 1000.0:.2f}s lease TTL the "
            f"dead node could still have been serving under")
        for q in (0, 1):
            poll(lambda q=q: cur_rx[q].serve_port, 10.0,
                 f"post-kill serve port for shard {q}")
            cli[q] = sc.SidecarClient("127.0.0.1", cur_rx[q].serve_port)
        for _ in range(max(waves, 1)):
            wave()
        poll(lambda: mgr.reseeds >= reseeds_before + 2,
             reseed_deadline_s + 60.0,
             "automated re-seed to N+1 after the kill")
        for _ in range(max(waves, 1)):
            wave()

        # -- end state: v2 fleet, N+1 everywhere, zero divergence ---------
        for name in mgr.live_nodes():
            node = mgr.node(name)
            assert node.version == "v2", (
                f"live node {name} still at {node.version}")
        for q in (0, 1):
            r = standby_set.receivers[q]
            assert r.consistent and not r.promoted, (
                f"shard {q} ended without a consistent standby (N+0)")
            assert directory.shard_health()[q] == "promoted"
        assert not pilot.failed_jobs, pilot.failed_jobs
        assert pilot.completed and all(
            c["elapsed_s"] <= reseed_deadline_s
            for c in pilot.completed), (
            f"a re-seed job overran its deadline: {pilot.completed}")
        expected_steps = 3 if full else 2
        assert mgr.upgrade_steps == expected_steps, mgr.upgrade_steps
        assert orch.promotions == 4, orch.status()
        assert mgr.reseeds == 4 and mgr.respawns == 4, mgr.status()
        report.update(
            promotions=orch.promotions, respawns=mgr.respawns,
            reseeds=mgr.reseeds, upgrade_steps=mgr.upgrade_steps,
            kill_promote_s=round(kill_promote_s, 3),
            reseed_elapsed_s=[c["elapsed_s"] for c in pilot.completed],
            boot_s={name: n.boot_s for name, n in mgr.nodes.items()},
            fleet=mgr.status(), orchestrator=orch.status())
        if report["mismatches"]:
            raise AssertionError(
                f"rolling upgrade diverged from the oracle: {report}")
        return report
    finally:
        if orch is not None:
            orch.close()
        if mgr is not None:
            mgr.close()
            report["launches"] = {
                name: getattr(n.handle, "launch_counts", None)
                for name, n in mgr.nodes.items()}
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


# ---------------------------------------------------------------------------
# Partitioned-controller drill (epoch-fenced leadership under partition)
# ---------------------------------------------------------------------------

def partitioned_controller_drill(
    num_slots: int = 256,
    n_keys: int = 12,
    pipeline: int = 40,
    pre_waves: int = 3,
    storm_waves: int = 3,
    seed: int = 0,
    zipf_s: float = 1.1,
    ttl_ms: float = 900.0,
    tick_ms: float = 50.0,
    detection_budget_s: float = 10.0,
    goodput_floor: float = 0.8,
    boot_timeout_s: float = 180.0,
    registry=None,
    device: str = "cuda",
) -> dict:
    """Partition the controller LEADER mid-storm and prove the
    epoch-fence claims: two real ``hostproc`` cells (on ``device``: the
    card by default)
    under live Zipf traffic, an AIMD controller actuating over the
    epoch-fenced :class:`~ratelimiter_tpu_torch.control.FleetControlPlane`,
    and a :class:`FaultInjectingProxy` cutting the leader's every
    member link at the worst moment.

    Topology: two single-shard primary nodes ``N0``/``N1`` (same
    limiter registrations, so lids and policy rows line up) under a
    :class:`~ratelimiter_tpu_torch.fleet.manager.NodeManager`; controller
    candidate ``ctrl-a`` reaches the nodes THROUGH partitionable
    proxies, rival ``ctrl-b`` directly; a
    :class:`~ratelimiter_tpu_torch.control.ControllerElection` attached to
    the manager re-elects from the probe tick (driven manually here
    for a deterministic timeline).

    The ladder:

    1. **Healthy baseline** — ``ctrl-a`` wins epoch 1 with a majority
       of seats; well-tenant Zipf waves flow to BOTH nodes and every
       decision is checked bit-identical against a generation-aware
       oracle (rebuilt from ``policy_info`` rows, fresh keys per wave
       so order-only configs stay exact); per-wave goodput recorded.
    2. **Storm + fleet-true cut** — a storm tenant hammers its sliding
       window far past the limit on both nodes; the leader's AIMD tick
       observes the FLEET-SUMMED signals and broadcasts a
       generation-stamped cut that must land on every node (one
       generation cell-wide), visible in the next wave's decisions.
    3. **Partition mid-storm** — both of ``ctrl-a``'s member links are
       silently cut (no RST, no FIN).  Its renewals stop landing a
       majority, so the OWN-CLOCK lease rule demotes it within
       ``ttl_ms``; the election then seats ``ctrl-b`` at epoch 2 and
       converges every node to one generation — all inside
       ``detection_budget_s``.
    4. **Zombie writes die at the seats** — the demoted ``ctrl-a``
       refuses to actuate (:class:`~ratelimiter_tpu_torch.control.NotLeader`
       BEFORE any frame leaves it), and a forced ``set_policy`` frame
       carried at its stale epoch — after the partition heals — is
       refused by every seat (``stale_rejected``) with ZERO rows
       moved: policy generations and rows are byte-compared around
       the attempt.
    5. **Storm continues under the successor** — ``ctrl-b`` keeps
       cutting the storm tenant at monotone generations; the
       well tenant's storm-phase goodput stays >= ``goodput_floor`` x
       its pre-storm mean (the control-plane failover never dents the
       data plane).

    Raises AssertionError on any violated claim; returns the report,
    with the wall times beside the claims: the nodes' boots
    (``boot_s``), the partition to ``ctrl-a``'s demotion (``demote_s``)
    and to ``ctrl-b``'s seat (``detect_s``), and to every node serving
    one generation under the successor (``converge_s``); and each node's
    kernel launches from its clean exit (``launches``).
    """
    from ratelimiter_tpu_torch.control import (
        AdaptivePolicyController,
        ControlConfig,
        ControllerElection,
        FleetControlPlane,
        NotLeader,
    )
    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.fleet import LocalExecutor, NodeManager
    from ratelimiter_tpu_torch.replication.control import ControlClient
    from ratelimiter_tpu_torch.replication.remote import RemoteBackend
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.service import sidecar as sc

    rng = random.Random(seed)
    # Order-only policies (the cross-host drill idiom): decisions
    # depend only on arrival ORDER, so subprocess clock skew cannot
    # move a verdict — and a FRESH key under any policy row behaves
    # exactly like a fresh oracle built from that row.
    GIANT_WINDOW = 1 << 30
    cfg_well = RateLimitConfig(max_permits=30, window_ms=GIANT_WINDOW,
                               refill_rate=1e-9)
    assert cfg_well.refill_rate_fp == 0, "drill needs an order-only bucket"
    cfg_storm = RateLimitConfig(max_permits=18, window_ms=GIANT_WINDOW,
                                enable_local_cache=False)
    limiters = [
        {"algo": "tb", "max_permits": cfg_well.max_permits,
         "window_ms": cfg_well.window_ms,
         "refill_rate": cfg_well.refill_rate},
        {"algo": "sw", "max_permits": cfg_storm.max_permits,
         "window_ms": cfg_storm.window_ms},
    ]
    NOW = 1_753_000_000_000  # fixed oracle stamp (its window never rolls)
    zipf_w = [1.0 / float(r + 1) ** zipf_s for r in range(n_keys)]

    clients: list = []
    proxies: dict = {}
    controllers: dict = {}
    planes: list = []
    mgr = None
    election = None
    node_names = ("N0", "N1")

    def ctl(port, timeout=0.5):
        c = ControlClient("127.0.0.1", port, timeout=timeout)
        clients.append(c)
        return c

    def poll(pred, timeout_s, what):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if mgr is not None:
                # The probe/election heartbeat rides every wait: the
                # leader's own-clock lease must keep renewing or
                # self_check() would demote it for OUR idleness.
                mgr.tick()
            if pred():
                return
            time.sleep(0.02)
        raise AssertionError(f"timed out waiting for {what}")

    report = {"decisions": 0, "mismatches": 0, "waves": 0}
    wave_seq = [0]
    try:
        # -- topology: two single-shard cells under fleet management ------
        mgr = NodeManager(
            executor=LocalExecutor(boot_timeout_s=boot_timeout_s,
                                   device=device),
            probe_interval_ms=tick_ms, probe_timeout_s=1.0,
            registry=registry)
        nodes, cli = {}, {}
        for name in node_names:
            nodes[name] = mgr.spawn(
                name, "primary", shards=1, version="v1",
                num_slots=num_slots, limiters=limiters,
                boot_timeout_s=boot_timeout_s)
            mgr.mark_serving(name)
            cli[name] = sc.SidecarClient(
                "127.0.0.1", nodes[name].sidecar_ports()[0])
            clients.append(cli[name])
            assert cli[name].server_version >= 3, "node handshake failed"

        def lids_of(node):
            v = node.ready["lids"]
            return list(v[0]) if v and isinstance(v[0], list) else list(v)

        assert lids_of(nodes["N0"]) == lids_of(nodes["N1"]), (
            "cells must register identical lids for fleet-wide rows")
        lid_well, lid_storm = lids_of(nodes["N0"])

        # ctrl-a reaches every member THROUGH a partitionable proxy;
        # ctrl-b's links are direct — the partition cuts exactly one
        # controller's world.
        for name in node_names:
            proxies[name] = FaultInjectingProxy(
                nodes[name].control_port).start()
        # Short timeouts on the proxied links: during the partition the
        # leader's every call burns its full deadline (bytes vanish, no
        # RST), and detection latency stacks those timeouts.
        members_a = {
            name: RemoteBackend(ctl(proxies[name].port, timeout=0.3),
                                label=f"{name}-via-proxy", shard=0)
            for name in node_names}
        members_b = {
            name: RemoteBackend(ctl(nodes[name].control_port),
                                label=name, shard=0)
            for name in node_names}
        ceilings = {int(lid_well): ("tb", cfg_well),
                    int(lid_storm): ("sw", cfg_storm)}
        plane_a = FleetControlPlane("ctrl-a", members_a,
                                    limiters=ceilings, ttl_ms=ttl_ms)
        plane_b = FleetControlPlane("ctrl-b", members_b,
                                    limiters=ceilings, ttl_ms=ttl_ms)
        planes[:] = [plane_a, plane_b]
        election = ControllerElection([plane_a, plane_b],
                                      interval_ms=tick_ms,
                                      registry=registry)
        mgr.attach(election)
        ctrl_cfg = ControlConfig(
            interval_ms=tick_ms, window_ms=3000, target_excess=0.5,
            decrease_factor=0.5, floor_fraction=0.1)
        controllers["ctrl-a"] = AdaptivePolicyController(plane_a, ctrl_cfg)
        controllers["ctrl-b"] = AdaptivePolicyController(plane_b, ctrl_cfg)

        def node_info(name):
            return members_b[name].policy_info()

        def row_of(name, lid):
            return node_info(name)["lids"][str(lid)]

        def gens():
            return {name: int(node_info(name)["generation"])
                    for name in node_names}

        # -- step 1: ctrl-a wins the cell ---------------------------------
        mgr.tick()
        assert plane_a.is_leader and plane_a.epoch == 1, (
            plane_a.fleet_status())
        assert not plane_b.is_leader
        assert election.leader() is plane_a

        def wave(goodput_log=None):
            """One well-tenant Zipf wave against BOTH nodes, every
            decision checked against a fresh generation-aware oracle
            (rebuilt from the node's live policy row, fresh keys)."""
            mgr.tick()  # keep the leader lease + election heartbeat live
            wave_seq[0] += 1
            report["waves"] += 1
            ids = rng.choices(range(n_keys), weights=zipf_w, k=pipeline)
            perms = [rng.choice([1, 1, 2, 3]) for _ in ids]
            keys = [f"w{wave_seq[0]}:k{kid}" for kid in ids]
            admitted = offered = 0
            for name in node_names:
                row = row_of(name, lid_well)
                ocfg = RateLimitConfig(
                    max_permits=int(row["max_permits"]),
                    window_ms=int(row["window_ms"]),
                    refill_rate=float(row["refill_rate"]))
                oracle = TokenBucketOracle(ocfg)
                got = _acquire_frames(cli[name], lid_well, keys, perms)
                for j, (status, allowed, rem) in enumerate(got):
                    assert status == sc.ST_OK, (name, j, status)
                    d = oracle.try_acquire(keys[j], perms[j], NOW)
                    report["decisions"] += 1
                    offered += 1
                    admitted += 1 if allowed else 0
                    if allowed != d.allowed \
                            or int(rem) != d.remaining_hint:
                        report["mismatches"] += 1
            if goodput_log is not None:
                goodput_log.append(admitted / max(offered, 1))

        def storm_wave():
            """Hammer the storm tenant far past its window on both
            nodes (denied >> admitted: the AIMD overload verdict)."""
            mgr.tick()  # keep the leader lease + election heartbeat live
            wave_seq[0] += 1
            keys = [f"s{wave_seq[0]}:hot"] * 50
            perms = [1] * len(keys)
            for name in node_names:
                row = row_of(name, lid_storm)
                ocfg = RateLimitConfig(
                    max_permits=int(row["max_permits"]),
                    window_ms=int(row["window_ms"]),
                    enable_local_cache=False)
                oracle = SlidingWindowOracle(ocfg)
                got = _acquire_frames(cli[name], lid_storm, keys, perms)
                for j, (status, allowed, _rem) in enumerate(got):
                    assert status == sc.ST_OK, (name, j, status)
                    d = oracle.try_acquire(keys[j], perms[j], NOW)
                    report["decisions"] += 1
                    if allowed != d.allowed:
                        report["mismatches"] += 1

        pre_goodput: list = []
        storm_goodput: list = []
        for _ in range(max(pre_waves, 1)):
            wave(goodput_log=pre_goodput)

        # -- step 2: storm -> fleet-true AIMD cut at one generation -------
        for _ in range(max(storm_waves, 1)):
            storm_wave()
        mgr.tick()  # renew the lease right before actuation self_check
        controllers["ctrl-a"].tick()
        assert plane_a.last_broadcast_generation >= 1, (
            "the leader's AIMD tick observed a fleet-wide storm but "
            "broadcast nothing")
        cut_gen = plane_a.last_broadcast_generation
        poll(lambda: all(g == cut_gen for g in gens().values()), 5.0,
             "the storm cut to land on every node at one generation")
        for name in node_names:
            row = row_of(name, lid_storm)
            assert int(row["max_permits"]) < cfg_storm.max_permits, (
                f"{name} still serves the uncut storm policy: {row}")
            assert int(row["generation"]) == cut_gen
        wave(goodput_log=storm_goodput)  # the cut must not dent the well

        # -- step 3: partition the leader mid-storm -----------------------
        storm_wave()
        t_cut = time.monotonic()
        for proxy in proxies.values():
            proxy.partition()
        deadline = t_cut + detection_budget_s
        demote_s = None
        while time.monotonic() < deadline:
            mgr.tick()  # probe + election ride the SAME manager tick
            if demote_s is None and not plane_a.is_leader:
                demote_s = time.monotonic() - t_cut
            if plane_b.is_leader and not plane_a.is_leader:
                break
            time.sleep(tick_ms / 1000.0)
        detect_s = time.monotonic() - t_cut
        assert plane_b.is_leader and not plane_a.is_leader, (
            f"leadership not repaired within {detection_budget_s}s: "
            f"{election.status()}")
        assert detect_s <= detection_budget_s
        # Own-clock demotion: the partitioned leader could not tell a
        # rival from a dead network, so it had to assume the worst
        # within one TTL — before ctrl-b's epoch ever reached it.
        assert plane_a.demote_reason == "lease_expired", (
            plane_a.demote_reason)
        assert plane_b.epoch == plane_a.epoch + 1
        assert detect_s * 1000.0 >= ttl_ms * 0.5, (
            f"demotion landed in {detect_s * 1000:.0f}ms — inside half "
            f"the {ttl_ms:.0f}ms lease TTL, which smells like a rigged "
            f"clock, not an expiry")
        poll(lambda: len(set(gens().values())) == 1, 5.0,
             "generation convergence under the successor")
        converge_s = time.monotonic() - t_cut
        wave(goodput_log=storm_goodput)  # traffic never paused

        # -- step 4: zombie writes die at the seats -----------------------
        # (a) The demoted plane self-fences BEFORE any frame leaves it.
        try:
            plane_a.set_policy(int(lid_storm), cfg_storm)
            raise AssertionError(
                "a demoted controller actuated a policy write")
        except NotLeader:
            pass
        # (b) The partition heals and the zombie's frames arrive late,
        # carried at its superseded epoch: every seat must refuse them
        # with ZERO rows moved.
        for proxy in proxies.values():
            proxy.heal()
        before = {name: node_info(name) for name in node_names}
        zombie_row = {str(lid_storm): {
            "algo": "sw", "max_permits": 999,
            "window_ms": cfg_storm.window_ms, "refill_rate": 0.0,
            "gen": max(before[n]["generation"]
                       for n in node_names) + 5}}
        stale_refused = 0
        for name in node_names:
            resp = members_a[name].set_policy_rows(
                zombie_row, plane_a.epoch, "ctrl-a")
            assert resp.get("stale_epoch") and not resp.get("applied"), (
                f"{name} accepted a write at the superseded epoch "
                f"{plane_a.epoch}: {resp}")
            stale_refused += 1
        after = {name: node_info(name) for name in node_names}
        for name in node_names:
            assert after[name]["generation"] == \
                before[name]["generation"], name
            assert after[name]["lids"] == before[name]["lids"], (
                f"{name} rows moved under a stale-epoch write")
            seat = after[name]["controller"]
            assert int(seat["stale_rejected"]) >= 1, seat
            assert seat["node"] == "ctrl-b" \
                and int(seat["epoch"]) == plane_b.epoch, seat

        # -- step 5: the storm continues under the successor --------------
        for _ in range(max(storm_waves, 1)):
            storm_wave()
        mgr.tick()  # renew the lease right before actuation self_check
        controllers["ctrl-b"].tick()
        assert plane_b.last_broadcast_generation > cut_gen, (
            "the successor's AIMD tick did not advance the generation")
        final_gen = plane_b.last_broadcast_generation
        poll(lambda: all(g == final_gen for g in gens().values()), 5.0,
             "the successor's cut to land on every node")
        for _ in range(2):
            wave(goodput_log=storm_goodput)
        storm_wave()

        # -- end state ----------------------------------------------------
        pre_mean = sum(pre_goodput) / len(pre_goodput)
        storm_mean = sum(storm_goodput) / len(storm_goodput)
        ratio = storm_mean / max(pre_mean, 1e-9)
        report.update(
            detect_s=round(detect_s, 3),
            demote_s=(round(demote_s, 3) if demote_s is not None
                      else None),
            converge_s=round(converge_s, 3),
            boot_s={name: n.boot_s for name, n in mgr.nodes.items()},
            epochs={"ctrl-a": plane_a.epoch, "ctrl-b": plane_b.epoch},
            demote_reason=plane_a.demote_reason,
            cut_generation=cut_gen, final_generation=final_gen,
            stale_refused=stale_refused,
            stale_rejected_total=sum(
                int(node_info(n)["controller"]["stale_rejected"])
                for n in node_names),
            pre_goodput=round(pre_mean, 4),
            storm_goodput=round(storm_mean, 4),
            goodput_ratio=round(ratio, 4),
            elections=election.elections,
            fleet=plane_b.fleet_status())
        assert ratio >= goodput_floor, (
            f"well-tenant goodput fell to {ratio:.2f}x its pre-storm "
            f"mean (floor {goodput_floor}x): the controller failover "
            f"dented the data plane: {report}")
        assert election.elections == 2 and plane_a.elections == 1 \
            and plane_b.elections == 1, election.status()
        if report["mismatches"]:
            raise AssertionError(
                f"decisions diverged from the generation-aware oracle: "
                f"{report}")
        return report
    finally:
        for controller in controllers.values():
            controller.stop()
        if election is not None:
            election.close()
        for plane in planes:
            try:
                plane.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for proxy in proxies.values():
            try:
                proxy.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        if mgr is not None:
            mgr.close()
            report["launches"] = {
                name: getattr(n.handle, "launch_counts", None)
                for name, n in mgr.nodes.items()}
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass



# ---------------------------------------------------------------------------
# Overload drill (bounded queue depth, shed-not-hang, p99 under load)
# ---------------------------------------------------------------------------

def overload_drill(
    load_multipliers=(1.0, 2.0),
    max_pending: int = 256,
    deadline_ms: float = 1000.0,
    dispatch_ms: float = 5.0,
    max_batch: int = 32,
    bursts: int = 40,
    burst_interval_ms: float = 10.0,
    p99_slack_ms: float = 250.0,
) -> dict:
    """Drive a MicroBatcher over a fixed-rate synthetic device at 1x..Nx
    its capacity and prove the admission-control claims:

    - pending queue depth never exceeds ``max_pending`` (hard bound),
    - overload is SHED (typed ``OverloadedError`` with a positive
      Retry-After hint), never queued forever,
    - p99 latency of *admitted* requests stays within the queue-deadline
      budget plus a dispatch cycle (shedding protects the admitted).

    The synthetic device resolves a batch in ``dispatch_ms`` per
    ``max_batch``-sized step, so capacity = ``max_batch / dispatch_ms``
    requests/s and the offered load is ``multiplier * capacity``
    submitted in bursts.  It is host code only: no kernel runs.  The
    defaults are deliberately coarse (deep queue, 1 s deadline) so that
    scheduler stalls on a loaded host do not read as overload; tighten
    them when measuring, not when gating.
    Returns per-multiplier stats; raises AssertionError on any violation.
    """
    import statistics

    from ratelimiter_tpu_torch.engine.batcher import MicroBatcher
    from ratelimiter_tpu_torch.engine.errors import OverloadedError

    capacity_rps = max_batch / (dispatch_ms / 1000.0)
    report = {"capacity_rps": capacity_rps, "runs": []}

    def device_step(n: int) -> int:
        # Cost scales with the number of max_batch-sized device steps:
        # the flusher hands over whatever accumulated, and an elastic
        # single-sleep model would let a deep queue raise capacity.
        time.sleep(-(-n // max_batch) * dispatch_ms / 1000.0)
        return n

    for mult in load_multipliers:
        batcher = MicroBatcher(
            dispatch={"sw": lambda slots, lids, permits:
                      device_step(len(slots))},
            dispatch_staged={"sw": lambda buf, n: device_step(n)},
            drain={"sw": lambda handle, n: {
                "allowed": np.ones(n, dtype=bool)}},
            clear={"sw": lambda slots: None},
            max_batch=max_batch, max_delay_ms=0.0, max_inflight=1,
            max_pending=max_pending, deadline_ms=deadline_ms)
        done_ms: dict = {}  # future -> completion latency (done callback,
        shed = deadline = admitted = 0  # so collection order can't inflate)
        per_burst = max(int(capacity_rps * burst_interval_ms / 1000.0
                            * mult), 1)
        pending: list = []

        def stamp(fut, born):
            fut.add_done_callback(
                lambda f: done_ms.setdefault(
                    f, (time.monotonic() - born) * 1000.0))
            return fut

        try:
            start = time.monotonic()
            for k in range(bursts):
                # Absolute schedule: a late burst fires immediately rather
                # than sliding every later burst (which would quietly lower
                # the offered rate on a loaded host).
                delay = start + k * burst_interval_ms / 1000.0 \
                    - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                born = time.monotonic()
                for i in range(per_burst):
                    try:
                        pending.append(stamp(
                            batcher.submit("sw", i % 32, 0, 1), born))
                    except OverloadedError as exc:
                        assert exc.retry_after_ms > 0, (
                            "shed without a Retry-After hint")
                        shed += 1
            lat_ms = []
            for fut in pending:
                try:
                    fut.result(timeout=10.0)
                    lat_ms.append(done_ms[fut])
                    admitted += 1
                except OverloadedError:
                    deadline += 1
            depth_seen = batcher.max_depth_seen
        finally:
            batcher.close()

        offered = shed + len(pending)
        p99 = (statistics.quantiles(lat_ms, n=100)[98]
               if len(lat_ms) >= 100 else max(lat_ms, default=0.0))
        run = {"multiplier": mult, "offered": offered, "admitted": admitted,
               "shed": shed, "deadline_expired": deadline,
               "goodput_frac": admitted / max(offered, 1),
               "shed_frac": (shed + deadline) / max(offered, 1),
               "max_depth_seen": depth_seen, "p99_ms": p99}
        report["runs"].append(run)

        assert depth_seen <= max_pending, (
            f"queue depth {depth_seen} exceeded the configured bound "
            f"{max_pending} at {mult}x load")
        assert admitted + shed + deadline == offered  # nothing stranded
        budget = deadline_ms + 2 * dispatch_ms + p99_slack_ms
        assert p99 <= budget, (
            f"p99 of admitted requests {p99:.1f} ms blew the "
            f"{budget:.1f} ms budget at {mult}x load")
        if mult >= 2.0:
            assert run["shed_frac"] > 0, (
                f"{mult}x offered load shed nothing — the queue bound "
                "is not engaging")
    return report
