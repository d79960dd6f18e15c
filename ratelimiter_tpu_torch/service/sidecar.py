"""Decision sidecar: a binary TCP protocol replacing the Redis round-trip
(counterpart of ``ratelimiter_tpu/service/sidecar.py``, the same wire).

The reference's distributed story is "every app instance speaks RESP to one
Redis".  This framework's equivalent is the sidecar: non-Python services
(e.g. a JVM API gateway) connect over TCP and stream decision requests; the
server funnels every connection into the shared micro-batcher, so requests
from *all* clients coalesce into the same device batches — the many-clients
/one-authority topology of Redis, with the card's engine as the authority.

Wire format v2 (little-endian), deliberately RESP-simple so any language
can speak it in ~30 lines:

  request  :=  u32 len | u8 op | u32 a | u32 b | key bytes
  response :=  u32 len | u8 status | u8 allowed | i64 remaining

  op: 1 = TRY_ACQUIRE   (a=limiter id, b=permits; allowed + remaining hint)
      2 = AVAILABLE     (a=limiter id; remaining permits; allowed unused)
      3 = RESET         (a=limiter id; admin)
      4 = PING          (health; allowed=1 when storage is up)
      5 = HELLO         (handshake: a=client protocol version, b=flags;
                         response: allowed=negotiated version,
                         remaining=server max frame bytes)
      6 = LEASE         (v3: a=limiter id, b=requested budget)
      7 = RENEW         (v3: a=limiter id, b=used | requested << 16)
      8 = RELEASE       (v3: a=limiter id, b=used)
      9 = TELEMETRY     (v4: key bytes carry a client burn report;
                         RESPONSE-LESS — see below)
     10 = BATCH         (v5: columnar decision batch — see below)
     11 = BULK_RENEW    (v6: columnar lease-portfolio renewal — see below)
  status: 0 = OK
          1 = ERROR          (generic; remaining carries an errno — the only
                              error status v1 clients ever see)
          2 = SHED           (admission control refused the frame; remaining
                              carries a retry-after hint in ms)
          3 = SHUTTING_DOWN  (server is draining; reconnect elsewhere)
          4 = BAD_FRAME      (malformed frame, answered in-protocol;
                              remaining carries an errno)
          5 = LEASE_REVOKED  (v3 only: the lease predates the current fence
                              epoch or the backend is fenced; re-grant)

**Versioning.**  A v2+ client's first frame is HELLO; the server answers
with the negotiated version (``min(client, server)``) and its frame-size
cap, and from then on may use the typed statuses of that version.  A v1
client never sends HELLO — the server serves it unchanged, downgrading
every v2-only status to the generic ``ERROR`` (status 1) with a matching
errno, so old clients keep their "status != 0 means error" contract and
never desync.  The v3 LEASE/RENEW/RELEASE ops exist only on connections
negotiated at v3: a v2 connection sending them gets ``BAD_FRAME``
(unknown op) and NEVER sees a lease status — v2 ingress is served
byte-identically to a v2 server.

**Token leases (v3; leases/).**  LEASE charges a bounded per-key permit
budget atomically against the device counters and the client burns it
locally — one wire frame per budget instead of one per decision (the
10-100x ingress collapse).  The lease response packs three fields into
``remaining``: ``granted | ttl_ms << 16 | fence_epoch << 40`` (granted
<= 65535, ttl < 2^24 ms, epoch < 2^23).  RENEW reports burns and
re-charges in one frame; ``LEASE_REVOKED`` forces a re-grant after a
failover (the fence epoch advanced — leases/manager.py).  Budgets are
capped at 65535 by the wire format.

**Wire v4: trace ids + client telemetry (observability/telemetry.py).**
On a connection negotiated at v4, every request frame EXCEPT HELLO
carries a 64-bit trace id between the header and the key bytes::

  v4 request := u32 len | u8 op | u32 a | u32 b | u64 trace_id | key

``trace_id == 0`` means untraced (the server mints one when lineage
sampling is armed); a nonzero id is force-sampled — the caller asked
for this trace — and threads client -> sidecar -> batcher -> shard ->
resolve through the lineage ring.  v<=3 clients never send the extra
field and are served byte-identically to a v3 server.  The TELEMETRY
op (9) ships a ``LeaseClient``'s accumulated burn report; it is
**response-less** by design (drop-don't-block: telemetry must never
add a wire round trip), so clients pipeline it in front of RENEW
frames for free or fire it on a cadence without reading anything back.
The server folds reports into the fleet telemetry plane
(``storage.telemetry``); a report during drain or on a plane-less
server is silently dropped (still no response — op 9 never answers).

**Wire v5: columnar batch frames (op 10).**  One BATCH frame carries a
whole burst as packed columns instead of N per-request frames::

  v5 batch  := u32 len | u8 op=10 | u32 lid | u32 rows | u64 trace_id
             | u32 klen | key bytes[klen]          (interned UTF-8 buffer)
             | u32 offsets[rows + 1]               (key i = bytes[offsets[i]
                                                    : offsets[i+1]])
             | u8 flags                            (bit 0: permits column)
             | u32 permits[rows]                   (iff flags & 1; else all 1)
  response  := u32 len=10+ceil(rows/8) | u8 status=OK | u8 1 | i64 rows
             | allow bits (np.packbits order: row r = bit 7-r%8 of byte r//8)

The key column is EXACTLY the native index's input
(``rl_index_assign_bytes``: packed UTF-8 + offsets), so the server
assigns slots straight off the wire buffer and submits ONE
batcher block (``submit_block``) — zero per-request Python objects
between socket and device.  Column validation is answered in-protocol:
truncated columns are ``BAD_FRAME``/``ERR_SHORT_FRAME``, trailing-length
or offset violations (offsets[0] != 0, decreasing, offsets[rows] !=
klen) are ``BAD_FRAME``/``ERR_BAD_COLUMN``, ``rows`` above the pipeline
cap is ``BAD_FRAME``/``ERR_FRAME_TOO_LONG``, and a per-key length over
``max_key_bytes`` is ``BAD_FRAME``/``ERR_KEY_TOO_LONG`` — the length
prefix keeps the stream in sync through all of them.  Error statuses
keep the plain 14-byte response shape (the length field disambiguates).
The op exists only on connections negotiated at v5 (HELLO, exactly like
v2->v4): a v<=4 connection sending op 10 gets the same unknown-op
``BAD_FRAME`` a v4 server would give, and v<=4 ingress is served
byte-identically to a v4 server.

**Wire v6: wide lease budgets + bulk portfolio renewal (edge/).**
Bulk leases (one aggregate budget subleased to many clients by an edge
aggregator) routinely exceed the v3 packing's 65535 cap, so a v6
connection widens every lease budget field:

- v6 lease REQUESTS carry a u32 ``ext`` field between the (v4) trace
  id and the key bytes — LEASE: ``b`` = requested (full u32), ``ext``
  bit 0 = bulk flag; RENEW: ``b`` = used (u32), ``ext`` = requested
  (u32); RELEASE: ``b`` = used (u32), ``ext`` reserved;
- v6 OK lease RESPONSES append a trailing u64 full-width grant after
  the standard 14 bytes (the packed ``remaining`` keeps the clamped v3
  fields; the length field disambiguates, exactly like BATCH).

The BULK_RENEW op (11, v6 only) renews an aggregator's whole portfolio
for one lid in ONE columnar frame::

  v6 bulk  := u32 len | u8 op=11 | u32 lid | u32 rows | u64 trace_id
            | u32 klen | key bytes[klen] | u32 offsets[rows + 1]
            | u64 used[rows] | u64 requested[rows] | u32 epochs[rows]
  response := u32 len | u8 status=OK | u8 1 | i64 rows
            | u64 granted[rows] | u32 ttl_ms[rows] | u32 epoch[rows]
            | u8 flags[rows]            (bit 0: REVOKED — re-grant)

Each row is the exact equivalent of one RENEW frame (same manager
call, same revocation and over-admission accounting).  ``epochs[i]``
names the lease instance row i reports for (0xFFFFFFFF = no check):
burns flushed for a revoked bulk lease that raced a successor grant on
the same key are counted into ``over_admission`` instead of folding
into the successor's accounting.  v<=5
connections never see any of this and are served byte-identically to a
v5 server (op 11 below v6 is the same unknown-op ``BAD_FRAME`` a v5
server would give).  When the attached lease backend is
session-capable (an ``edge.EdgeAggregator`` fronting subleases), each
connection gets its own session — one client's subleases never alias
another's.

**Ingress hardening.**  Every byte on the wire is untrusted:

- frames are validated (max frame length, max key length, UTF-8 key,
  short-frame and unknown-op checks) and violations are answered with a
  typed ``BAD_FRAME`` status *in protocol* — the length prefix keeps the
  stream in sync, so one bad frame never kills the connection.  A frame
  DECLARING more than ``max_frame_bytes`` is rejected immediately and its
  payload is discarded as it streams (never buffered), so a hostile
  length prefix cannot balloon memory;
- per-connection deadlines: ``idle_timeout_ms`` between requests and the
  stricter ``read_timeout_ms`` once a frame has started (slowloris — a
  half-written frame must not pin a handler thread), enforced by socket
  timeouts on both reads and writes (a client that stops reading its
  responses hits the same bound);
- per-connection pipeline cap: at most ``max_pipeline`` decision frames
  in flight per connection; excess frames are shed with the typed
  ``SHED`` status + retry-after hint (mirroring the micro-batcher's
  ``queue_full`` admission control, which the sidecar also relays);
- a global ``max_connections`` bound (excess accepts are closed);
- graceful drain: ``stop()`` first marks the server draining — in-flight
  frames resolve, new decision frames answer ``SHUTTING_DOWN`` — and
  only then tears connections down.  A client that disconnects mid-burst
  never leaks a batcher future: still-queued frames are withdrawn from
  the batcher (``MicroBatcher.forget``) and dispatched ones are consumed
  via done-callbacks.

Requests may be pipelined: a client can write N frames before reading N
responses (the provided ``SidecarClient.acquire_batch`` does exactly this),
which amortizes syscalls the way Redis pipelining does.  The server honors
the pipelining on the decision path: every TRY_ACQUIRE frame of a read
burst is SUBMITTED to the micro-batcher before any is resolved
(``GpuBatchedStorage.acquire_async``), so a 64-deep pipeline coalesces
into one device flush instead of paying 64 sequential batcher round
trips — responses still return in request order.

Limiters are registered server-side by name -> (algo, config); clients
address them by the integer id returned at registration (distributed via
config, exactly like the reference's named Spring beans).
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.engine.errors import OverloadedError, ShutdownError
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from ratelimiter_tpu_torch.utils.logging import get_logger

log = get_logger("service.sidecar")

OP_TRY_ACQUIRE = 1
OP_AVAILABLE = 2
OP_RESET = 3
OP_PING = 4
OP_HELLO = 5
OP_LEASE = 6
OP_RENEW = 7
OP_RELEASE = 8
OP_TELEMETRY = 9
OP_BATCH = 10
OP_BULK_RENEW = 11

PROTOCOL_VERSION = 6

ST_OK = 0
ST_ERROR = 1
ST_SHED = 2
ST_SHUTTING_DOWN = 3
ST_BAD_FRAME = 4
ST_LEASE_REVOKED = 5

ERR_UNKNOWN_OP = 1
ERR_UNKNOWN_LIMITER = 2
ERR_INTERNAL = 3
ERR_SHORT_FRAME = 4
ERR_KEY_TOO_LONG = 5
ERR_FRAME_TOO_LONG = 6
ERR_OVERLOADED = 7
ERR_SHUTTING_DOWN = 8
ERR_BAD_KEY = 9
ERR_LEASE_DISABLED = 10
ERR_LEASE_REVOKED = 11
ERR_BAD_COLUMN = 12

# Lease-response field packing (remaining i64):
#   granted | ttl_ms << 16 | fence_epoch << 40
_LEASE_GRANT_MAX = 0xFFFF
_LEASE_TTL_MAX = 0xFFFFFF
_LEASE_EPOCH_MAX = 0x7FFFFF
# v6: budgets ride the wire full-width (bulk budgets are aggregate and
# routinely exceed the old 65535 cap).
_LEASE_GRANT_MAX_V6 = 0xFFFFFFFF
# v6 bulk-renew response columns, per row: u64 granted + u32 ttl_ms
# + u32 epoch + u8 flags (bit 0: REVOKED — re-grant at the new epoch).
_BULK_ROW_BYTES = 8 + 4 + 4 + 1
# Bulk-renew request epoch column sentinel: "no lease-instance check"
# (a plain client that does not track instance epochs).
_EPOCH_ANY = 0xFFFFFFFF


def _pack_lease(granted: int, ttl_ms: int, epoch: int) -> int:
    return (min(int(granted), _LEASE_GRANT_MAX)
            | min(max(int(ttl_ms), 0), _LEASE_TTL_MAX) << 16
            | min(max(int(epoch), 0), _LEASE_EPOCH_MAX) << 40)


def _unpack_lease(remaining: int):
    return (remaining & 0xFFFF, (remaining >> 16) & 0xFFFFFF,
            (remaining >> 40) & 0x7FFFFF)

_REQ_BODY = struct.Struct("<BII")    # op, a, b (after the u32 len)
_REQ_BODY4 = struct.Struct("<BIIQ")  # v4: op, a, b, trace_id
_RESP = struct.Struct("<IBBq")       # len, status, allowed, remaining

# v2-only statuses carry these errnos when downgraded for a v1 client.
_V1_ERRNO = {ST_SHED: ERR_OVERLOADED, ST_SHUTTING_DOWN: ERR_SHUTTING_DOWN}


def _mk_resp(status: int, allowed: int, remaining: int) -> bytes:
    return _RESP.pack(_RESP.size - 4, status, allowed, remaining)


def _consume_future(fut) -> None:
    """Retrieve an abandoned future's outcome so nothing stays orphaned
    (attached as a done-callback; fires immediately if already done)."""
    try:
        if not fut.cancelled():
            fut.exception()
    except (CancelledError, Exception):  # noqa: BLE001 — consumption only
        pass


class _ConnState:
    """Per-connection protocol state (owned by one handler thread)."""

    __slots__ = ("version", "buf", "skip", "pending", "leases")

    def __init__(self):
        self.version = 1       # until a HELLO negotiates up
        self.buf = b""         # unparsed wire bytes
        self.skip = 0          # bytes of an oversized frame left to discard
        self.pending: List = []  # burst: response bytes | futures | batches
        # Per-connection lease identity: when the attached lease backend
        # is session-capable (an EdgeAggregator), each connection gets
        # its own sublease bookkeeping (lazily created on first lease
        # op).  A plain LeaseManager is shared across connections.
        self.leases = None


class _BatchPending:
    """One submitted v5 BATCH frame awaiting resolution: either a single
    block future (columnar storage path — resolves to array slices) or a
    per-key future list (decoded-string fallback)."""

    __slots__ = ("fut", "futs", "rows")

    def __init__(self, fut_or_futs, rows: int):
        if isinstance(fut_or_futs, list):
            self.fut, self.futs = None, fut_or_futs
        else:
            self.fut, self.futs = fut_or_futs, None
        self.rows = int(rows)

    def futures(self) -> list:
        return self.futs if self.fut is None else [self.fut]


class SidecarServer:
    """Threaded TCP server over a GpuBatchedStorage.

    All hardening bounds accept 0/None to disable (the library default is
    hardened; ``service/props.py`` exposes them as ``ratelimiter.sidecar.*``).
    """

    def __init__(self, storage: GpuBatchedStorage, host: str = "0.0.0.0",
                 port: int = 0, *,
                 leases=None,
                 meter_registry=None,
                 max_frame_bytes: int = 4096,
                 max_key_bytes: int = 1024,
                 max_pipeline: int = 1024,
                 max_connections: int = 1024,
                 idle_timeout_ms: float = 60_000.0,
                 read_timeout_ms: float = 5_000.0,
                 resolve_timeout_ms: float = 30_000.0,
                 drain_timeout_ms: float = 1_000.0):
        self.storage = storage
        # Token-lease manager (leases/manager.py) behind the v3 LEASE/
        # RENEW/RELEASE ops; None answers them ERR_LEASE_DISABLED.
        self._leases = leases
        self.max_frame_bytes = int(max_frame_bytes or 0)
        self.max_key_bytes = int(max_key_bytes or 0)
        self.max_pipeline = int(max_pipeline or 0)
        self.max_connections = int(max_connections or 0)
        self.idle_timeout_s = float(idle_timeout_ms or 0.0) / 1000.0
        self.read_timeout_s = float(read_timeout_ms or 0.0) / 1000.0
        self.resolve_timeout_s = float(resolve_timeout_ms or 0.0) / 1000.0
        self.drain_timeout_s = float(drain_timeout_ms or 0.0) / 1000.0
        self._limiters: Dict[int, Tuple[str, RateLimitConfig]] = {}
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        self._stopped = False
        self._draining = False
        self._inflight = 0           # submitted-unresolved decision futures
        # Plain counters (always on — drills read them without a registry).
        self.malformed_total = 0
        self.idle_closed_total = 0
        self.pipeline_shed_total = 0
        self.drained_total = 0       # frames answered SHUTTING_DOWN
        self.refused_total = 0       # accepts over max_connections
        self.futures_abandoned = 0   # futures a dead client left behind
        self.telemetry_frames_total = 0   # TELEMETRY frames received
        self.telemetry_dropped_total = 0  # dropped (drain/no plane/bad)
        self.last_shed_s = 0.0       # monotonic stamp of the last shed
        reg = meter_registry
        self._m_conns = (reg.gauge(
            "ratelimiter.sidecar.connections",
            "Open sidecar connections") if reg is not None else None)
        self._m_malformed = (reg.counter(
            "ratelimiter.sidecar.malformed",
            "Malformed sidecar frames answered with BAD_FRAME")
            if reg is not None else None)
        self._m_idle = (reg.counter(
            "ratelimiter.sidecar.idle_closed",
            "Sidecar connections closed by idle/read deadline")
            if reg is not None else None)
        self._m_shed = (reg.counter(
            "ratelimiter.sidecar.pipeline_shed",
            "Sidecar frames shed by the per-connection pipeline cap")
            if reg is not None else None)
        self._m_drained = (reg.counter(
            "ratelimiter.sidecar.drained",
            "Sidecar frames answered SHUTTING_DOWN during drain")
            if reg is not None else None)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                self.accepted = False
                with outer._conn_lock:
                    over = (outer.max_connections
                            and len(outer._conns) >= outer.max_connections)
                    if outer._stopped or over:
                        if over and not outer._stopped:
                            outer.refused_total += 1
                        # Refused (limit) or accepted in the shutdown race
                        # window: close now rather than serving.
                        try:
                            self.request.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                        self.request.close()
                        return
                    outer._conns.add(self.request)
                    self.accepted = True
                    if outer._m_conns is not None:
                        outer._m_conns.set(len(outer._conns))

            def finish(self):
                with outer._conn_lock:
                    outer._conns.discard(self.request)
                    if outer._m_conns is not None:
                        outer._m_conns.set(len(outer._conns))

            def handle(self):
                if self.accepted:
                    outer._serve_conn(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="sidecar", daemon=True)

    @classmethod
    def from_props(cls, storage, props, meter_registry=None,
                   host: str = "0.0.0.0") -> "SidecarServer":
        """Build from ``ratelimiter.sidecar.*`` properties."""
        g_int, g_float = props.get_int, props.get_float
        return cls(
            storage, host=host,
            port=g_int("ratelimiter.sidecar.port", 7400),
            meter_registry=meter_registry,
            max_frame_bytes=g_int("ratelimiter.sidecar.max_frame_bytes", 4096),
            max_key_bytes=g_int("ratelimiter.sidecar.max_key_bytes", 1024),
            max_pipeline=g_int("ratelimiter.sidecar.max_pipeline", 1024),
            max_connections=g_int("ratelimiter.sidecar.max_connections", 1024),
            idle_timeout_ms=g_float(
                "ratelimiter.sidecar.idle_timeout_ms", 60_000.0),
            read_timeout_ms=g_float(
                "ratelimiter.sidecar.read_timeout_ms", 5_000.0),
            resolve_timeout_ms=g_float(
                "ratelimiter.sidecar.resolve_timeout_ms", 30_000.0),
            drain_timeout_ms=g_float(
                "ratelimiter.sidecar.drain_timeout_ms", 1_000.0),
        )

    # -- limiter registry -----------------------------------------------------
    def register(self, algo: str, config: RateLimitConfig) -> int:
        lid = self.storage.register_limiter(algo, config)
        self._limiters[lid] = (algo, config)
        return lid

    def expose(self, lid: int, algo: str, config: RateLimitConfig) -> int:
        """Expose an ALREADY-registered limiter (e.g. the HTTP tier's) to
        sidecar clients under its existing id — both front doors then
        decide against the same device counters."""
        self._limiters[int(lid)] = (algo, config)
        return int(lid)

    def attach_leases(self, manager) -> "SidecarServer":
        """Attach a LeaseManager serving the v3 LEASE/RENEW/RELEASE ops
        (wiring calls this when ``ratelimiter.lease.enabled``)."""
        self._leases = manager
        return self

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "SidecarServer":
        self._thread.start()
        return self

    def inflight(self) -> int:
        """Submitted-unresolved decision frames across all connections."""
        with self._conn_lock:
            return self._inflight

    def connections(self) -> int:
        with self._conn_lock:
            return len(self._conns)

    def stop(self, drain_timeout_s: float | None = None) -> None:
        """Graceful drain, then hard stop.

        Drain phase: new decision frames are answered ``SHUTTING_DOWN``
        while every already-submitted frame resolves normally — bounded
        by ``drain_timeout_s`` (default from the constructor).  Hard
        phase: the listener stops and every accepted connection is shut
        down, so no zombie handler thread answers clients from a closed
        storage."""
        self._draining = True
        budget = (self.drain_timeout_s if drain_timeout_s is None
                  else float(drain_timeout_s))
        deadline = time.monotonic() + max(budget, 0.0)
        while time.monotonic() < deadline:
            if self.inflight() == 0:
                break
            time.sleep(0.005)
        self._server.shutdown()
        self._server.server_close()
        with self._conn_lock:
            self._stopped = True
            conns = list(self._conns)
            self._conns.clear()
            if self._m_conns is not None:
                self._m_conns.set(0)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    # -- accounting helpers ---------------------------------------------------
    def _count_malformed(self) -> None:
        self.malformed_total += 1
        if self._m_malformed is not None:
            self._m_malformed.increment()

    def _count_idle_closed(self) -> None:
        self.idle_closed_total += 1
        if self._m_idle is not None:
            self._m_idle.increment()

    def _count_pipeline_shed(self) -> None:
        self.pipeline_shed_total += 1
        self.last_shed_s = time.monotonic()
        if self._m_shed is not None:
            self._m_shed.increment()
        from ratelimiter_tpu_torch.observability import flight_recorder

        flight_recorder().record("overload.shed", coalesce_ms=1000.0,
                                 reason="sidecar_pipeline")

    def _count_drained(self) -> None:
        self.drained_total += 1
        if self._m_drained is not None:
            self._m_drained.increment()

    def _track_submit(self, n: int) -> None:
        with self._conn_lock:
            self._inflight += n

    # -- connection loop ------------------------------------------------------
    def _serve_conn(self, sock: socket.socket) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        st = _ConnState()
        try:
            self._conn_loop(sock, st)
        finally:
            self._abandon_pending(st)

    def _conn_loop(self, sock: socket.socket, st: _ConnState) -> None:
        while True:
            # Idle deadline between requests; the stricter read deadline
            # once a frame has started (st.buf holds a partial frame, or
            # an oversized frame is still being discarded) — a half
            # frame must not pin this thread (slowloris).
            mid_frame = bool(st.buf) or st.skip > 0
            timeout = self.read_timeout_s if mid_frame else self.idle_timeout_s
            sock.settimeout(timeout if timeout > 0 else None)
            try:
                chunk = sock.recv(65536)
            except socket.timeout:
                self._count_idle_closed()
                return
            except OSError:
                return
            if not chunk:
                return
            if st.skip:
                # Discard an oversized frame's payload as it streams —
                # never buffered, already answered BAD_FRAME.
                n = min(st.skip, len(chunk))
                st.skip -= n
                chunk = chunk[n:]
                if not chunk:
                    continue
            st.buf += chunk
            # Two-phase pipelined burst: submit every decision frame of
            # this read burst (futures), THEN resolve in order — the
            # whole pipeline lands in one micro-batch flush.
            self._parse_burst(st)
            if st.pending:
                out = b"".join(
                    self._finish_frame(p, st) for p in st.pending)
                st.pending = []
                try:
                    sock.sendall(out)
                except (socket.timeout, OSError):
                    return

    def _parse_burst(self, st: _ConnState) -> None:
        while len(st.buf) >= 4:
            (length,) = struct.unpack_from("<I", st.buf)
            if self.max_frame_bytes and length > self.max_frame_bytes:
                # Hostile/corrupt length prefix: answer in-protocol and
                # discard exactly `length` bytes so the stream stays in
                # sync without ever buffering the oversized payload.
                self._count_malformed()
                st.pending.append(self._resp(
                    st, ST_BAD_FRAME, 0, ERR_FRAME_TOO_LONG))
                have = len(st.buf) - 4
                if have >= length:
                    st.buf = st.buf[4 + length:]
                else:
                    st.skip = length - have
                    st.buf = b""
                continue
            if len(st.buf) < 4 + length:
                break
            frame = st.buf[4:4 + length]
            st.buf = st.buf[4 + length:]
            st.pending.append(self._begin_frame(frame, st))

    # -- frame handling -------------------------------------------------------
    def _resp(self, st: _ConnState, status: int, allowed: int,
              remaining: int) -> bytes:
        """Version-aware response: statuses above a connection's
        negotiated version downgrade to the generic ERROR (status 1)
        with a matching errno, so older clients keep their
        status!=0-means-error contract.  (Lease statuses can only arise
        from v3-gated ops, so the v3 downgrade is pure defense.)"""
        if st.version < 3 and status == ST_LEASE_REVOKED:
            status, remaining = ST_ERROR, ERR_LEASE_REVOKED
        if st.version < 2 and status > ST_ERROR:
            if status in _V1_ERRNO:
                remaining = _V1_ERRNO[status]
            status = ST_ERROR
        return _mk_resp(status, allowed, remaining)

    def _begin_frame(self, frame: bytes, st: _ConnState):
        """Phase 1 of a pipelined burst: TRY_ACQUIRE frames are submitted
        to the micro-batcher and return their FUTURE; everything else
        (and every validation failure) resolves immediately to bytes.
        TELEMETRY frames are response-less and return b''."""
        resp = self._resp
        if len(frame) < _REQ_BODY.size:
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_SHORT_FRAME)
        try:
            tid = 0
            if st.version >= 4 and frame[0] != OP_HELLO:
                # v4 frame extension: a u64 trace id rides between the
                # header and the key bytes (HELLO keeps the v1 shape —
                # it IS the negotiation frame).
                if len(frame) < _REQ_BODY4.size:
                    self._count_malformed()
                    return resp(st, ST_BAD_FRAME, 0, ERR_SHORT_FRAME)
                op, a, b, tid = _REQ_BODY4.unpack_from(frame)
                key_bytes = frame[_REQ_BODY4.size:]
            else:
                op, a, b = _REQ_BODY.unpack_from(frame)
                key_bytes = frame[_REQ_BODY.size:]
            ext = 0
            if st.version >= 6 and op in (OP_LEASE, OP_RENEW, OP_RELEASE):
                # v6 lease-frame extension: a u32 ``ext`` field rides
                # between the (v4) trace id and the key bytes, widening
                # lease budgets past the old 16-bit packing — LEASE:
                # b = requested (u32), ext bit 0 = bulk flag; RENEW:
                # b = used (u32), ext = requested (u32); RELEASE:
                # b = used (u32), ext reserved.  v<=5 connections never
                # send it and are served byte-identically to a v5
                # server.
                if len(key_bytes) < 4:
                    self._count_malformed()
                    return resp(st, ST_BAD_FRAME, 0, ERR_SHORT_FRAME)
                (ext,) = struct.unpack_from("<I", key_bytes)
                key_bytes = key_bytes[4:]
            # BATCH payloads are columns, not one key — their per-key
            # lengths are checked in the column validation.  The v5 gate
            # is inside the condition so a v<=4 connection sending op 10
            # stays byte-identical to a v4 server (key check first).
            batch_op = (op == OP_BATCH and st.version >= 5) or (
                op == OP_BULK_RENEW and st.version >= 6)
            if op != OP_TELEMETRY and not batch_op and self.max_key_bytes \
                    and len(key_bytes) > self.max_key_bytes:
                self._count_malformed()
                return resp(st, ST_BAD_FRAME, 0, ERR_KEY_TOO_LONG)
            if op == OP_HELLO:
                # min(client, server): a v2 client stays on v2 — it
                # never sees the v3 ops or statuses (nor the v4 frame
                # extension).
                st.version = min(int(a), PROTOCOL_VERSION) if a >= 2 else 1
                return _mk_resp(ST_OK, st.version, self.max_frame_bytes)
            if op == OP_PING:
                if self._draining:
                    return resp(st, ST_OK, 0, 0)
                return resp(st, ST_OK,
                            1 if self.storage.is_available() else 0, 0)
            if op == OP_TELEMETRY:
                if st.version < 4:
                    self._count_malformed()
                    return resp(st, ST_BAD_FRAME, 0, ERR_UNKNOWN_OP)
                # Response-less by contract: fold (or drop) and emit
                # nothing — a report must never cost a round trip.
                self._fold_telemetry(key_bytes)
                return b""
            if op == OP_BATCH:
                if st.version < 5:
                    # The batch op does not exist below v5: same
                    # unknown-op answer a v4 server would give.
                    self._count_malformed()
                    return resp(st, ST_BAD_FRAME, 0, ERR_UNKNOWN_OP)
                if self._draining:
                    self._count_drained()
                    return resp(st, ST_SHUTTING_DOWN, 0, 0)
                return self._begin_batch(st, a, b, tid, key_bytes)
            if op == OP_BULK_RENEW:
                if st.version < 6:
                    # The bulk-renew op does not exist below v6: same
                    # unknown-op answer a v5 server would give.
                    self._count_malformed()
                    return resp(st, ST_BAD_FRAME, 0, ERR_UNKNOWN_OP)
                if self._draining:
                    self._count_drained()
                    return resp(st, ST_SHUTTING_DOWN, 0, 0)
                return self._bulk_renew_frame(st, a, b, tid, key_bytes)
            lease_op = op in (OP_LEASE, OP_RENEW, OP_RELEASE)
            if lease_op and st.version < 3:
                # The lease ops do not exist below v3: a v2 (or v1)
                # connection sending one gets the same unknown-op
                # answer a v2 server would give — and never a lease
                # status.
                self._count_malformed()
                return resp(st, ST_BAD_FRAME, 0, ERR_UNKNOWN_OP)
            if not lease_op and op not in (OP_TRY_ACQUIRE, OP_AVAILABLE,
                                           OP_RESET):
                self._count_malformed()
                return resp(st, ST_BAD_FRAME, 0, ERR_UNKNOWN_OP)
            if self._draining:
                self._count_drained()
                return resp(st, ST_SHUTTING_DOWN, 0, 0)
            try:
                key = key_bytes.decode()
            except UnicodeDecodeError:
                self._count_malformed()
                return resp(st, ST_BAD_FRAME, 0, ERR_BAD_KEY)
            entry = self._limiters.get(a)
            if entry is None:
                return resp(st, ST_ERROR, 0, ERR_UNKNOWN_LIMITER)
            algo, _cfg = entry
            if tid:
                # An explicit wire trace id: the client asked for this
                # trace — force-sample it and stamp the ingress hop.
                lineage = getattr(self.storage, "lineage", None)
                if lineage is not None:
                    lineage.force(tid)
                    lineage.record(tid, "sidecar", op=op, lid=int(a),
                                   version=st.version)
            if lease_op:
                return self._lease_frame(st, op, a, b, key, tid, ext)
            if op == OP_TRY_ACQUIRE:
                return self._begin_acquire(st, algo, a, key,
                                           max(int(b), 1), tid)
            if op == OP_AVAILABLE:
                avail = int(self.storage.available_many(algo, a, [key])[0])
                return resp(st, ST_OK, 0, avail)
            # OP_RESET
            self.storage.reset_key(algo, a, key)
            return resp(st, ST_OK, 1, 0)
        except Exception:  # noqa: BLE001 — protocol errors must not kill the conn
            return resp(st, ST_ERROR, 0, ERR_INTERNAL)

    def _fold_telemetry(self, blob: bytes) -> None:
        """Fold one TELEMETRY frame into the fleet plane (best-effort:
        drained, plane-less, or malformed reports are dropped+counted,
        and the op never answers either way)."""
        self.telemetry_frames_total += 1
        plane = getattr(self.storage, "telemetry", None)
        if plane is None or self._draining:
            self.telemetry_dropped_total += 1
            return
        if plane.fold(blob) < 0:
            self.telemetry_dropped_total += 1

    def _conn_leases(self, st: _ConnState):
        """The lease backend for THIS connection: a session-capable
        backend (an ``edge.EdgeAggregator``) gets one session per
        connection — each client's subleases are its own — while a
        plain ``LeaseManager`` is shared.  Lazily resolved so
        ``attach_leases`` may run after connections are open."""
        if st.leases is not None:
            return st.leases
        backend = self._leases
        if backend is None:
            return None
        sess = getattr(backend, "session", None)
        st.leases = sess() if callable(sess) else backend
        return st.leases

    @staticmethod
    def _lease_ok_resp(st: _ConnState, allowed: int, granted: int,
                       ttl_ms: int, epoch: int) -> bytes:
        """OK lease response.  v6 appends the full-width u64 grant
        after the standard 14 bytes (the packed ``remaining`` keeps the
        old clamped fields, so the layout degrades readably); the
        length field disambiguates, exactly like BATCH responses.
        v<=5 stays the plain 14-byte shape, clamps intact."""
        packed = _pack_lease(granted, ttl_ms, epoch)
        if st.version >= 6:
            return _RESP.pack(_RESP.size - 4 + 8, ST_OK, allowed,
                              packed) + struct.pack("<Q", max(int(granted),
                                                              0))
        return _mk_resp(ST_OK, allowed, packed)

    def _lease_frame(self, st: _ConnState, op: int, lid: int, b: int,
                     key: str, trace_id: int = 0, ext: int = 0) -> bytes:
        """One v3+ lease op against the attached lease backend.
        Resolves synchronously (a lease frame amortizes over a whole
        budget, so it does not ride the pipelined decision path).  On a
        v6 connection the budget fields are full u32s (``ext`` carries
        RENEW's requested budget and LEASE's bulk flag); below v6 the
        v3 16-bit packing applies unchanged."""
        mgr = self._conn_leases(st)
        if mgr is None:
            return self._resp(st, ST_ERROR, 0, ERR_LEASE_DISABLED)
        v6 = st.version >= 6
        try:
            if op == OP_LEASE:
                if v6:
                    g = mgr.grant(lid, key, requested=int(b),
                                  trace_id=trace_id,
                                  bulk=bool(ext & 1))
                else:
                    g = mgr.grant(lid, key, requested=int(b) & 0xFFFF,
                                  trace_id=trace_id)
            elif op == OP_RENEW:
                if v6:
                    g = mgr.renew(lid, key, used=int(b),
                                  requested=int(ext), trace_id=trace_id)
                else:
                    g = mgr.renew(lid, key, used=int(b) & 0xFFFF,
                                  requested=(int(b) >> 16) & 0xFFFF,
                                  trace_id=trace_id)
                if g is None:
                    return self._resp(st, ST_LEASE_REVOKED, 0,
                                      _pack_lease(0, 0, 0))
            else:  # OP_RELEASE
                used = int(b) if v6 else int(b) & 0xFFFF
                mgr.release(lid, key, used=used, trace_id=trace_id)
                return self._resp(st, ST_OK, 1, 0)
            return self._lease_ok_resp(st, 1 if g.granted > 0 else 0,
                                       g.granted, g.ttl_ms, g.epoch)
        except KeyError:
            return self._resp(st, ST_ERROR, 0, ERR_UNKNOWN_LIMITER)
        except Exception:  # noqa: BLE001 — per-frame errors stay per-frame
            return self._resp(st, ST_ERROR, 0, ERR_INTERNAL)

    def _bulk_renew_frame(self, st: _ConnState, lid: int, rows: int,
                          trace_id: int, payload: bytes) -> bytes:
        """One v6 OP_BULK_RENEW frame: an edge aggregator renews its
        whole bulk portfolio for one lid in ONE columnar round trip.

        request payload (after the v4/v6 header fields)::

          u32 klen | key bytes[klen] | u32 offsets[rows + 1]
          | u64 used[rows] | u64 requested[rows] | u32 epochs[rows]

        ``epochs[i]`` names the lease instance row ``i`` reports for
        (0xFFFFFFFF = no instance check): a burn report for a revoked
        bulk lease must never fold into a successor grant on the same
        key, so the manager counts an epoch-mismatched row straight
        into ``over_admission`` and leaves the live lease untouched.

        response::

          u32 len | u8 status=OK | u8 1 | i64 rows
          | u64 granted[rows] | u32 ttl_ms[rows] | u32 epoch[rows]
          | u8 flags[rows]                  (bit 0: REVOKED — re-grant)

        Each row is the exact equivalent of one RENEW frame (same
        manager call, same revocation/over-admission accounting);
        column validation mirrors OP_BATCH and every violation is
        answered in-protocol with the stream left in sync."""
        resp = self._resp
        mgr = self._conn_leases(st)
        if mgr is None:
            return resp(st, ST_ERROR, 0, ERR_LEASE_DISABLED)
        rows = int(rows)
        if rows < 1 or (self.max_pipeline and rows > self.max_pipeline):
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_FRAME_TOO_LONG)
        if len(payload) < 4:
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_SHORT_FRAME)
        (klen,) = struct.unpack_from("<I", payload)
        off_pos = 4 + klen
        used_pos = off_pos + 4 * (rows + 1)
        req_pos = used_pos + 8 * rows
        ep_pos = req_pos + 8 * rows
        expect = ep_pos + 4 * rows
        if len(payload) != expect:
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0,
                        ERR_SHORT_FRAME if len(payload) < expect
                        else ERR_BAD_COLUMN)
        offsets = np.frombuffer(payload, np.uint32, rows + 1,
                                offset=off_pos).astype(np.int64)
        if (offsets[0] != 0 or offsets[-1] != klen
                or bool(np.any(np.diff(offsets) < 0))):
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_BAD_COLUMN)
        if self.max_key_bytes and rows and \
                int(np.diff(offsets).max()) > self.max_key_bytes:
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_KEY_TOO_LONG)
        try:
            payload[4:off_pos].decode()
        except UnicodeDecodeError:
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_BAD_KEY)
        if self._limiters.get(lid) is None:
            return resp(st, ST_ERROR, 0, ERR_UNKNOWN_LIMITER)
        used = np.frombuffer(payload, np.uint64, rows, offset=used_pos)
        req = np.frombuffer(payload, np.uint64, rows, offset=req_pos)
        eps = np.frombuffer(payload, np.uint32, rows, offset=ep_pos)
        if trace_id:
            lineage = getattr(self.storage, "lineage", None)
            if lineage is not None:
                lineage.force(trace_id)
                lineage.record(trace_id, "sidecar", op=OP_BULK_RENEW,
                               lid=int(lid), version=st.version,
                               rows=rows)
        granted = np.zeros(rows, dtype=np.uint64)
        ttls = np.zeros(rows, dtype=np.uint32)
        epochs = np.zeros(rows, dtype=np.uint32)
        flags = np.zeros(rows, dtype=np.uint8)
        try:
            for i in range(rows):
                key = payload[4 + offsets[i]:4 + offsets[i + 1]].decode()
                ep = int(eps[i])
                g = mgr.renew(lid, key, used=int(used[i]),
                              requested=int(req[i]), trace_id=trace_id,
                              epoch=None if ep == _EPOCH_ANY else ep)
                if g is None:
                    flags[i] = 1
                else:
                    granted[i] = max(int(g.granted), 0)
                    ttls[i] = min(max(int(g.ttl_ms), 0), 0xFFFFFFFF)
                    epochs[i] = min(max(int(g.epoch), 0), 0xFFFFFFFF)
        except UnicodeDecodeError:
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_BAD_KEY)
        except KeyError:
            return resp(st, ST_ERROR, 0, ERR_UNKNOWN_LIMITER)
        except Exception:  # noqa: BLE001 — per-frame errors stay per-frame
            return resp(st, ST_ERROR, 0, ERR_INTERNAL)
        cols = (granted.tobytes() + ttls.tobytes() + epochs.tobytes()
                + flags.tobytes())
        return _RESP.pack(_RESP.size - 4 + len(cols), ST_OK, 1,
                          rows) + cols

    def _begin_acquire(self, st: _ConnState, algo: str, lid: int, key: str,
                       permits: int, trace_id: int = 0):
        """Submit one decision frame, enforcing the pipeline cap and
        relaying the batcher's own admission control in-protocol."""
        n_inflight = self._pending_rows(st)
        if self.max_pipeline and n_inflight >= self.max_pipeline:
            self._count_pipeline_shed()
            plane = getattr(self.storage, "telemetry", None)
            if plane is not None:
                plane.note_shed(lid, 1)
            # The burst drains within roughly one micro-batch flush; the
            # hint mirrors the batcher's queue_full estimate.
            batcher = getattr(self.storage, "_batcher", None)
            hint = max(getattr(batcher, "max_delay_s", 0.001) * 1000.0, 1.0)
            return self._resp(st, ST_SHED, 0, int(hint))
        acquire_async = getattr(self.storage, "acquire_async", None)
        try:
            if acquire_async is not None:
                fut = acquire_async(algo, lid, key, permits,
                                    trace_id=trace_id)
                self._track_submit(1)
                return fut
            out = self.storage.acquire(algo, lid, key, permits)
            remaining = int(out.get("remaining", out.get("cache_value", 0)))
            return self._resp(st, ST_OK, 1 if out["allowed"] else 0,
                              remaining)
        except OverloadedError as exc:
            return self._resp(st, ST_SHED, 0,
                              max(int(exc.retry_after_ms), 1))
        except ShutdownError:
            return self._resp(st, ST_SHUTTING_DOWN, 0, 0)
        except Exception:  # noqa: BLE001 — per-frame errors stay per-frame
            return self._resp(st, ST_ERROR, 0, ERR_INTERNAL)

    @staticmethod
    def _pending_rows(st: _ConnState) -> int:
        """In-flight decision ROWS of the current burst (the pipeline
        cap's operand): a batch frame counts as its row count."""
        n = 0
        for p in st.pending:
            if isinstance(p, bytes):
                continue
            n += p.rows if isinstance(p, _BatchPending) else 1
        return n

    def _begin_batch(self, st: _ConnState, lid: int, rows: int,
                     trace_id: int, payload: bytes):
        """Validate one v5 columnar BATCH frame and submit it.

        Returns a _BatchPending (phase 2 packs the allow bitmask) or
        immediate response bytes for validation failures / shed.  The
        happy path touches no per-request Python objects: the key column
        feeds the native index verbatim and the whole frame rides ONE
        batcher block future."""
        resp = self._resp
        rows = int(rows)
        if rows < 1 or (self.max_pipeline and rows > self.max_pipeline):
            # Declared rows above the pipeline cap: reject before any
            # column math sized by the attacker's number.
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_FRAME_TOO_LONG)
        if self.max_pipeline and \
                self._pending_rows(st) + rows > self.max_pipeline:
            self._count_pipeline_shed()
            plane = getattr(self.storage, "telemetry", None)
            if plane is not None:
                plane.note_shed(lid, rows)
            batcher = getattr(self.storage, "_batcher", None)
            hint = max(getattr(batcher, "max_delay_s", 0.001) * 1000.0, 1.0)
            return resp(st, ST_SHED, 0, int(hint))
        if len(payload) < 4:
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_SHORT_FRAME)
        (klen,) = struct.unpack_from("<I", payload)
        off_pos = 4 + klen
        flag_pos = off_pos + 4 * (rows + 1)
        if len(payload) < flag_pos + 1:
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_SHORT_FRAME)
        flags = payload[flag_pos]
        expect = flag_pos + 1 + (4 * rows if flags & 1 else 0)
        if len(payload) != expect:
            # Column length mismatch: declared columns and frame length
            # disagree (short permits column, trailing garbage, ...).
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0,
                        ERR_SHORT_FRAME if len(payload) < expect
                        else ERR_BAD_COLUMN)
        offsets = np.frombuffer(payload, np.uint32, rows + 1,
                                offset=off_pos).astype(np.int64)
        if (offsets[0] != 0 or offsets[-1] != klen
                or bool(np.any(np.diff(offsets) < 0))):
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_BAD_COLUMN)
        if self.max_key_bytes and rows and \
                int(np.diff(offsets).max()) > self.max_key_bytes:
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_KEY_TOO_LONG)
        try:
            payload[4:off_pos].decode()  # one pass; no per-key objects
        except UnicodeDecodeError:
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_BAD_KEY)
        entry = self._limiters.get(lid)
        if entry is None:
            return resp(st, ST_ERROR, 0, ERR_UNKNOWN_LIMITER)
        algo, _cfg = entry
        permits = None
        if flags & 1:
            # Mirror the per-frame contract: permits floor at 1.
            permits = np.maximum(
                np.frombuffer(payload, np.uint32, rows,
                              offset=flag_pos + 1).astype(np.int64), 1)
        if trace_id:
            lineage = getattr(self.storage, "lineage", None)
            if lineage is not None:
                lineage.force(trace_id)
                lineage.record(trace_id, "sidecar", op=OP_BATCH,
                               lid=int(lid), version=st.version,
                               rows=rows)
        data = np.frombuffer(payload, np.uint8, klen, offset=4)
        try:
            block = getattr(self.storage, "acquire_async_block", None)
            fut = None
            if block is not None:
                fut = block(algo, lid, data, offsets, permits,
                            trace_id=trace_id)
            if fut is not None:
                self._track_submit(1)
                return _BatchPending(fut, rows)
            # Fallback (Python index / fenced shards): decode the keys
            # and ride the per-key async path — identical decisions.
            keys = [payload[4 + offsets[i]:4 + offsets[i + 1]].decode()
                    for i in range(rows)]
            many = getattr(self.storage, "acquire_async_many", None)
            if many is not None:
                futs = many(algo, lid, keys, permits)
                self._track_submit(len(futs))
                return _BatchPending(futs, rows)
            allowed = np.empty(rows, dtype=bool)
            perms = permits if permits is not None else np.ones(
                rows, dtype=np.int64)
            for i, k in enumerate(keys):
                allowed[i] = bool(
                    self.storage.acquire(algo, lid, k,
                                         int(perms[i]))["allowed"])
            return self._batch_resp(rows, allowed)
        except UnicodeDecodeError:
            # A multi-byte char split across key boundaries survives the
            # whole-buffer check but no per-key slice decodes.
            self._count_malformed()
            return resp(st, ST_BAD_FRAME, 0, ERR_BAD_KEY)
        except OverloadedError as exc:
            return resp(st, ST_SHED, 0, max(int(exc.retry_after_ms), 1))
        except ShutdownError:
            return resp(st, ST_SHUTTING_DOWN, 0, 0)
        except Exception:  # noqa: BLE001 — per-frame errors stay per-frame
            return resp(st, ST_ERROR, 0, ERR_INTERNAL)

    @staticmethod
    def _batch_resp(rows: int, allowed: np.ndarray) -> bytes:
        """OK batch response: standard header (remaining = rows) plus
        the packed allow bits; the length field disambiguates."""
        bits = np.packbits(np.asarray(allowed, dtype=bool)).tobytes()
        return _RESP.pack(_RESP.size - 4 + len(bits), ST_OK, 1,
                          rows) + bits

    def _finish_batch(self, item: _BatchPending, st: _ConnState) -> bytes:
        """Phase 2 for a BATCH frame: one bitmask response."""
        try:
            timeout = self.resolve_timeout_s or None
            if item.fut is not None:
                out = item.fut.result(timeout=timeout)
                allowed = np.asarray(out["allowed"], dtype=bool)
            else:
                allowed = np.empty(item.rows, dtype=bool)
                for i, f in enumerate(item.futs):
                    allowed[i] = bool(f.result(timeout=timeout)["allowed"])
            return self._batch_resp(item.rows, allowed)
        except OverloadedError as exc:
            return self._resp(st, ST_SHED, 0,
                              max(int(exc.retry_after_ms), 1))
        except ShutdownError:
            return self._resp(st, ST_SHUTTING_DOWN, 0, 0)
        except _FutureTimeout:
            for f in item.futures():
                f.add_done_callback(_consume_future)
            return self._resp(st, ST_ERROR, 0, ERR_INTERNAL)
        except Exception:  # noqa: BLE001 — per-frame errors stay per-frame
            return self._resp(st, ST_ERROR, 0, ERR_INTERNAL)
        finally:
            self._track_submit(-len(item.futures()))

    def _finish_frame(self, item, st: _ConnState) -> bytes:
        """Phase 2: resolve a submitted future (or pass bytes through)."""
        if isinstance(item, bytes):
            return item
        if isinstance(item, _BatchPending):
            return self._finish_batch(item, st)
        try:
            out = item.result(
                timeout=self.resolve_timeout_s or None)
            remaining = int(out.get("remaining", out.get("cache_value", 0)))
            return self._resp(st, ST_OK, 1 if out["allowed"] else 0,
                              remaining)
        except OverloadedError as exc:
            return self._resp(st, ST_SHED, 0,
                              max(int(exc.retry_after_ms), 1))
        except ShutdownError:
            return self._resp(st, ST_SHUTTING_DOWN, 0, 0)
        except _FutureTimeout:
            # The batch never resolved within the bound (wedged device):
            # answer in-protocol and make sure the future is consumed
            # whenever it does land — never leave this thread pinned.
            item.add_done_callback(_consume_future)
            return self._resp(st, ST_ERROR, 0, ERR_INTERNAL)
        except Exception:  # noqa: BLE001 — per-frame errors stay per-frame
            return self._resp(st, ST_ERROR, 0, ERR_INTERNAL)
        finally:
            self._track_submit(-1)

    def _abandon_pending(self, st: _ConnState) -> None:
        """The connection died mid-burst: no batcher future may leak.

        Still-queued frames are WITHDRAWN from the batcher (they stop
        consuming device capacity and their slots stop pinning eviction);
        frames already dispatched resolve normally and are consumed via a
        done-callback."""
        futs = []
        for p in st.pending:
            if isinstance(p, bytes):
                continue
            futs.extend(p.futures() if isinstance(p, _BatchPending) else [p])
        st.pending = []
        if not futs:
            return
        batcher = getattr(self.storage, "_batcher", None)
        withdrawn = 0
        if batcher is not None and hasattr(batcher, "forget"):
            try:
                withdrawn = batcher.forget(futs)
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
        for fut in futs:
            fut.add_done_callback(_consume_future)
        self.futures_abandoned += len(futs)
        self._track_submit(-len(futs))
        if withdrawn:
            log.debug("withdrew %d queued frame(s) of a dead connection",
                      withdrawn)


class SidecarSendError(ConnectionError):
    """Connection died while SENDING a request — the server cannot have
    processed it, so a caller may safely replay on a fresh connection.
    Read-phase failures stay plain ConnectionError: the server may have
    executed the request before dying, so replay risks double-charging."""


class SidecarShedError(RuntimeError):
    """The server shed the request (pipeline cap or batcher admission
    control); retry after ``retry_after_ms``."""

    def __init__(self, retry_after_ms: float = 0.0):
        super().__init__(
            f"sidecar shed the request; retry after {retry_after_ms} ms")
        self.retry_after_ms = float(retry_after_ms)


class LeaseWire(NamedTuple):
    """Unpacked lease response: (granted, ttl_ms, epoch)."""

    granted: int
    ttl_ms: int
    epoch: int


class SidecarClient:
    """Minimal pipelining client (reference for other-language ports).

    Speaks protocol v4 by default: sends HELLO at connect and records the
    negotiated version + the server's frame cap.  ``protocol=1`` skips
    the handshake (byte-compatible with the pre-v2 client); a v1 server
    answering HELLO with an error also downgrades the client to v1, and
    a v2/v3 server negotiates the connection down (no lease ops below
    v3; no trace ids / telemetry below v4).

    The lease methods (``lease_grant``/``lease_renew``/``lease_release``)
    plus :meth:`telemetry_report` make this a full
    ``leases/client.py:LeaseClient`` transport: burn decisions locally,
    renew one frame per budget, flush burn telemetry response-less.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 protocol: int = PROTOCOL_VERSION,
                 telemetry_send_timeout: float = 0.25):
        self._host = host
        self._port = int(port)
        self._timeout = float(timeout)
        self._protocol = int(protocol)
        # Drop-don't-block: one TELEMETRY send may stall at most this
        # long; a failed send marks telemetry down for this connection
        # (a partial write would desync the stream, so never retry).
        self._telemetry_send_timeout = float(telemetry_send_timeout)
        self._telemetry_down = False
        self._connect_and_hello()

    def _connect_and_hello(self) -> None:
        self._sock = socket.create_connection((self._host, self._port),
                                              timeout=self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rbuf = b""
        self.server_version = 1
        self.server_max_frame = 0
        if self._protocol >= 2:
            # The HELLO response carries the negotiated version in the
            # `allowed` byte — read it raw (no bool coercion).  Sends the
            # CALLER'S protocol (a v2-pinned client must negotiate v2,
            # not whatever this module's ceiling is).
            self._send(self._frame(OP_HELLO, self._protocol, 0, ""))
            status, version, max_frame = self._read_raw()
            if status == ST_OK and version:
                self.server_version = int(version)
                self.server_max_frame = int(max_frame)

    def reconnect(self) -> bool:
        """Tear the connection down and re-establish it (fresh socket +
        re-HELLO).  On success the telemetry latch is RE-ARMED: the
        latch exists because a PARTIAL telemetry write desyncs a shared
        stream, but a brand-new negotiated connection has no desynced
        history — one failed write no longer disables burn reporting for
        the life of the client.  Returns False (latch stays down) when
        the reconnect itself fails.

        Only call between pipelined bursts: any unread in-flight
        responses on the old connection are discarded."""
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            self._connect_and_hello()
        except (OSError, ConnectionError):
            self._telemetry_down = True
            return False
        self._telemetry_down = False
        return True

    def _send(self, payload: bytes) -> None:
        try:
            self._sock.sendall(payload)
        except OSError as exc:
            raise SidecarSendError(str(exc)) from exc

    def close(self) -> None:
        self._sock.close()

    # -- framing --------------------------------------------------------------
    def _frame(self, op: int, lid: int, permits: int, key: str,
               trace_id: int = 0,
               key_bytes: Optional[bytes] = None,
               ext: Optional[int] = None) -> bytes:
        """One request frame in the connection's negotiated format: the
        v4 shape carries a u64 trace id after the header (HELLO always
        keeps the v1 shape — it predates negotiation); ``ext`` is the
        v6 lease-frame u32 extension field (budget widening), inserted
        between the trace id and the key bytes on v6 connections."""
        raw = key.encode() if key_bytes is None else key_bytes
        if ext is not None and self.server_version >= 6:
            raw = struct.pack("<I", int(ext)) + raw
        if self.server_version >= 4 and op != OP_HELLO:
            body = _REQ_BODY4.pack(op, lid, permits,
                                   int(trace_id) & ((1 << 64) - 1)) + raw
        else:
            body = _REQ_BODY.pack(op, lid, permits) + raw
        return struct.pack("<I", len(body)) + body

    def _read_raw(self) -> Tuple[int, int, int]:
        """One response with raw integer fields (the HELLO reply packs
        the negotiated version into the `allowed` byte)."""
        while len(self._rbuf) < _RESP.size:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("sidecar closed connection")
            self._rbuf += chunk
        _, status, allowed, remaining = _RESP.unpack_from(self._rbuf)
        self._rbuf = self._rbuf[_RESP.size:]
        return status, allowed, remaining

    def _read_responses(self, n: int):
        out = []
        while len(out) < n:
            while len(self._rbuf) < _RESP.size:
                chunk = self._sock.recv(65536)
                if not chunk:
                    raise ConnectionError("sidecar closed connection")
                self._rbuf += chunk
            _, status, allowed, remaining = _RESP.unpack_from(self._rbuf)
            self._rbuf = self._rbuf[_RESP.size:]
            out.append((status, bool(allowed), remaining))
        return out

    @staticmethod
    def _check(status: int, remaining: int) -> None:
        if status == ST_OK:
            return
        if status == ST_SHED:
            raise SidecarShedError(retry_after_ms=remaining)
        if status == ST_SHUTTING_DOWN:
            raise SidecarShedError(retry_after_ms=1000.0)
        raise RuntimeError(f"sidecar error (status={status}, "
                           f"errno={remaining})")

    # -- API ------------------------------------------------------------------
    def try_acquire(self, lid: int, key: str, permits: int = 1,
                    trace_id: int = 0) -> bool:
        self._send(self._frame(OP_TRY_ACQUIRE, lid, permits, key,
                               trace_id=trace_id))
        status, allowed, remaining = self._read_responses(1)[0]
        self._check(status, remaining)
        return allowed

    def acquire_batch(
        self, lid: int, keys: Sequence[str],
        permits: Optional[Sequence[int]] = None,
    ):
        """Pipelined batch: N frames out, N responses in, one syscall each way."""
        permits = permits or [1] * len(keys)
        payload = b"".join(
            self._frame(OP_TRY_ACQUIRE, lid, p, k) for k, p in zip(keys, permits))
        self._send(payload)
        return self._read_responses(len(keys))

    # -- columnar batch (protocol v5) -----------------------------------------
    def _batch_frame(self, lid: int, keys: Sequence[str],
                     permits: Optional[Sequence[int]] = None,
                     trace_id: int = 0) -> bytes:
        """One v5 BATCH frame: interned key column + offsets (+ optional
        permits column).  One frame carries the whole chunk — the server
        answers with ONE packed allow bitmask."""
        kbufs = [k.encode() for k in keys]
        rows = len(kbufs)
        offs = np.zeros(rows + 1, dtype=np.uint32)
        np.cumsum(np.fromiter((len(b) for b in kbufs), dtype=np.uint32,
                              count=rows), out=offs[1:])
        key_col = b"".join(kbufs)
        parts = [struct.pack("<I", len(key_col)), key_col, offs.tobytes()]
        if permits is not None:
            parts.append(b"\x01")
            parts.append(np.asarray(permits, dtype=np.uint32).tobytes())
        else:
            parts.append(b"\x00")
        body = _REQ_BODY4.pack(OP_BATCH, lid, rows,
                               int(trace_id) & ((1 << 64) - 1)) + b"".join(parts)
        return struct.pack("<I", len(body)) + body

    def _read_block_response(self, rows: int) -> list:
        """One BATCH response: the standard 14-byte header plus
        ``length - 10`` bitmask bytes (error responses carry none and
        raise via :meth:`_check`, leaving the stream in sync)."""
        while len(self._rbuf) < _RESP.size:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("sidecar closed connection")
            self._rbuf += chunk
        length, status, _, remaining = _RESP.unpack_from(self._rbuf)
        self._rbuf = self._rbuf[_RESP.size:]
        if status != ST_OK:
            self._check(status, remaining)
        nbits = length - (_RESP.size - 4)
        while len(self._rbuf) < nbits:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("sidecar closed connection")
            self._rbuf += chunk
        bits = np.frombuffer(self._rbuf[:nbits], np.uint8)
        self._rbuf = self._rbuf[nbits:]
        return [bool(b) for b in np.unpackbits(bits)[:rows]]

    def acquire_block(self, lid: int, keys: Sequence[str],
                      permits: Optional[Sequence[int]] = None,
                      trace_id: int = 0, max_rows: int = 16) -> list:
        """Columnar batch acquire: ONE v5 frame per ``max_rows`` chunk
        (and one bitmask back), zero per-request frames on the wire.
        Falls back to :meth:`acquire_batch` below v5 with identical
        decisions.  Returns a list of per-row allow booleans; shed /
        shutdown / malformed answers raise like :meth:`_check`.

        ``max_rows`` defaults to the server's default pipeline cap — a
        frame declaring more rows than the cap is rejected whole."""
        rows_total = len(keys)
        if rows_total == 0:
            return []
        if self.server_version < 5:
            allowed = []
            for status, alw, remaining in self.acquire_batch(
                    lid, keys, permits):
                self._check(status, remaining)
                allowed.append(alw)
            return allowed
        allowed = []
        start = 0
        while start < rows_total:
            n = min(max_rows or rows_total, rows_total - start)
            while True:
                p = permits[start:start + n] if permits is not None else None
                frame = self._batch_frame(lid, keys[start:start + n], p,
                                          trace_id)
                if n == 1 or not self.server_max_frame or \
                        len(frame) - 4 <= self.server_max_frame:
                    break
                n = max(n // 2, 1)
            self._send(frame)
            allowed.extend(self._read_block_response(n))
            start += n
        return allowed

    # -- token leases (protocol v3; widened at v6) ----------------------------
    def _read_lease_response(self) -> Optional[LeaseWire]:
        """One lease response, honoring the length field: a v6 OK
        answer carries a trailing u64 full-width grant after the
        standard 14 bytes (authoritative — the packed ``remaining``
        clamps at the old 65535); revoked/error answers carry none."""
        while len(self._rbuf) < _RESP.size:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("sidecar closed connection")
            self._rbuf += chunk
        length, status, _, remaining = _RESP.unpack_from(self._rbuf)
        self._rbuf = self._rbuf[_RESP.size:]
        extra = max(length - (_RESP.size - 4), 0)
        while len(self._rbuf) < extra:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("sidecar closed connection")
            self._rbuf += chunk
        tail = self._rbuf[:extra]
        self._rbuf = self._rbuf[extra:]
        if status == ST_LEASE_REVOKED:
            return None
        self._check(status, remaining)
        granted, ttl_ms, epoch = _unpack_lease(remaining)
        if extra >= 8:
            (granted,) = struct.unpack_from("<Q", tail)
        return LeaseWire(int(granted), ttl_ms, epoch)

    def _lease_roundtrip(self, op: int, lid: int, b: int, key: str,
                         trace_id: int = 0,
                         ext: Optional[int] = None) -> Optional[LeaseWire]:
        if self.server_version < 3:
            raise RuntimeError(
                f"server negotiated protocol v{self.server_version}; "
                "lease ops need v3")
        self._send(self._frame(op, lid, b, key, trace_id=trace_id,
                               ext=ext))
        return self._read_lease_response()

    def lease_grant(self, lid: int, key: str, requested: int = 0,
                    trace_id: int = 0,
                    bulk: bool = False) -> Optional[LeaseWire]:
        """Charge a per-key budget; ``granted == 0`` means the key stays
        on the per-decision path for ``ttl_ms`` (retry hint).  ``bulk``
        (v6) marks an edge-aggregator portfolio lease — the budget is
        aggregate and may exceed the old 65535 wire cap."""
        if self.server_version >= 6:
            return self._lease_roundtrip(
                OP_LEASE, lid,
                min(int(requested), _LEASE_GRANT_MAX_V6), key,
                trace_id=trace_id, ext=1 if bulk else 0)
        return self._lease_roundtrip(OP_LEASE, lid,
                                     min(int(requested), 0xFFFF), key,
                                     trace_id=trace_id)

    def lease_renew(self, lid: int, key: str, used: int,
                    requested: int = 0,
                    trace_id: int = 0) -> Optional[LeaseWire]:
        """Report ``used`` burns + re-charge; None when REVOKED (the
        fence epoch advanced — re-grant via :meth:`lease_grant`)."""
        if self.server_version >= 6:
            return self._lease_roundtrip(
                OP_RENEW, lid, min(int(used), _LEASE_GRANT_MAX_V6), key,
                trace_id=trace_id,
                ext=min(int(requested), _LEASE_GRANT_MAX_V6))
        b = (min(int(used), 0xFFFF)
             | min(int(requested), 0xFFFF) << 16)
        return self._lease_roundtrip(OP_RENEW, lid, b, key,
                                     trace_id=trace_id)

    def lease_release(self, lid: int, key: str, used: int,
                      trace_id: int = 0) -> None:
        """Close a lease: final burn report, unused budget credited."""
        if self.server_version < 3:
            return
        if self.server_version >= 6:
            self._send(self._frame(OP_RELEASE, lid,
                                   min(int(used), _LEASE_GRANT_MAX_V6),
                                   key, trace_id=trace_id, ext=0))
        else:
            self._send(self._frame(OP_RELEASE, lid,
                                   min(int(used), 0xFFFF), key,
                                   trace_id=trace_id))
        try:
            self._read_lease_response()
        except (SidecarShedError, RuntimeError):
            pass  # release is best-effort, exactly as before

    def lease_bulk_renew(self, lid: int, keys: Sequence[str],
                         used: Sequence[int], requested: Sequence[int],
                         epochs: Optional[Sequence[int]] = None,
                         trace_id: int = 0) -> list:
        """Portfolio renewal (v6 OP_BULK_RENEW): one columnar frame
        renews every ``(key, used, requested)`` row — each row the
        exact equivalent of one :meth:`lease_renew` — and one columnar
        response comes back.  ``epochs`` (one per row, optional) names
        the lease instance each report belongs to; rows without one are
        sent with the ANY sentinel (no instance check).  Returns
        ``[(granted, ttl_ms, epoch, revoked), ...]`` in row order."""
        if self.server_version < 6:
            return [
                ((0, 0, 0, True) if r is None
                 else (int(r.granted), int(r.ttl_ms), int(r.epoch),
                       False))
                for r in (self.lease_renew(lid, k, int(u), int(q),
                                           trace_id=trace_id)
                          for k, u, q in zip(keys, used, requested))]
        rows = len(keys)
        if rows == 0:
            return []
        kbufs = [k.encode() for k in keys]
        offs = np.zeros(rows + 1, dtype=np.uint32)
        np.cumsum(np.fromiter((len(b) for b in kbufs), dtype=np.uint32,
                              count=rows), out=offs[1:])
        key_col = b"".join(kbufs)
        ep_col = (np.full(rows, _EPOCH_ANY, dtype=np.uint32)
                  if epochs is None
                  else np.asarray(epochs, dtype=np.uint32))
        payload = (struct.pack("<I", len(key_col)) + key_col
                   + offs.tobytes()
                   + np.asarray(used, dtype=np.uint64).tobytes()
                   + np.asarray(requested, dtype=np.uint64).tobytes()
                   + ep_col.tobytes())
        body = _REQ_BODY4.pack(OP_BULK_RENEW, lid, rows,
                               int(trace_id) & ((1 << 64) - 1)) + payload
        self._send(struct.pack("<I", len(body)) + body)
        while len(self._rbuf) < _RESP.size:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("sidecar closed connection")
            self._rbuf += chunk
        length, status, _, remaining = _RESP.unpack_from(self._rbuf)
        self._rbuf = self._rbuf[_RESP.size:]
        extra = max(length - (_RESP.size - 4), 0)
        while len(self._rbuf) < extra:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("sidecar closed connection")
            self._rbuf += chunk
        cols = self._rbuf[:extra]
        self._rbuf = self._rbuf[extra:]
        self._check(status, remaining)
        if extra != rows * _BULK_ROW_BYTES:
            raise RuntimeError(
                f"bulk-renew response carries {extra} column bytes; "
                f"expected {rows * _BULK_ROW_BYTES}")
        granted = np.frombuffer(cols, np.uint64, rows)
        ttls = np.frombuffer(cols, np.uint32, rows, offset=8 * rows)
        epochs = np.frombuffer(cols, np.uint32, rows, offset=12 * rows)
        flags = np.frombuffer(cols, np.uint8, rows, offset=16 * rows)
        return [(int(granted[i]), int(ttls[i]), int(epochs[i]),
                 bool(flags[i] & 1)) for i in range(rows)]

    # -- telemetry (protocol v4, response-less) -------------------------------
    def telemetry_supported(self) -> bool:
        return self.server_version >= 4 and not self._telemetry_down

    def telemetry_report(self, blob: bytes) -> bool:
        """Ship one burn report; NO response is read (the op is
        response-less by contract).  Drop-don't-block: a send that
        cannot complete within ``telemetry_send_timeout`` (or errors)
        returns False and marks telemetry down for this connection — a
        partial write would desync the stream, so it is never retried.
        Callers count False as a dropped flush and keep accumulating."""
        if not self.telemetry_supported():
            return False
        frame = self._frame(OP_TELEMETRY, 0, 0, "", key_bytes=bytes(blob))
        if self.server_max_frame and len(frame) - 4 > self.server_max_frame:
            return False
        prev = None
        try:
            prev = self._sock.gettimeout()
            self._sock.settimeout(self._telemetry_send_timeout)
            self._sock.sendall(frame)
            return True
        except OSError:
            self._telemetry_down = True
            return False
        finally:
            if prev is not None:
                try:
                    self._sock.settimeout(prev)
                except OSError:
                    pass

    def available(self, lid: int, key: str) -> int:
        self._send(self._frame(OP_AVAILABLE, lid, 0, key))
        status, _, remaining = self._read_responses(1)[0]
        self._check(status, remaining)
        return remaining

    def reset(self, lid: int, key: str) -> None:
        self._send(self._frame(OP_RESET, lid, 0, key))
        self._read_responses(1)

    def ping(self) -> bool:
        self._sock.sendall(self._frame(OP_PING, 0, 0, ""))
        _, allowed, _ = self._read_responses(1)[0]
        return allowed
