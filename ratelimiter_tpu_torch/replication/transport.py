"""Replication transports: in-process and sidecar-style TCP (counterpart
of ``ratelimiter_tpu/replication/transport.py``, the same wire).

The TCP framing deliberately mirrors the reference's decision sidecar
(``ratelimiter_tpu/service/sidecar.py``) — ``u32 length | payload``
little-endian, one ack byte back per frame — so any environment that
can deploy the sidecar can deploy a standby next to it.  The ack is what makes ship failures
*detectable*: a frame the standby could not apply (geometry mismatch,
decode error) acks nonzero, and the replicator's failure path re-marks
the delta and re-baselines with a full frame.

``InProcessSink`` round-trips frames through encode/decode even though
it could hand the dict over directly — the in-process path (tests, the
chaos drill) then exercises the exact bytes the TCP path ships.
"""

from __future__ import annotations

import random
import socket
import socketserver
import struct
import threading
import time

ACK_OK = 0
ACK_ERROR = 1

_LEN = struct.Struct("<I")

# Link states a sink reports (``link_state()``): UNKNOWN before first
# contact, UP after a successful send/heartbeat ack, DEAD after
# ``dead_after`` consecutive ack failures.  The distinction the
# orchestrator needs: a DEAD link means the standby behind it is STALE
# ("standby gone"), not merely behind ("standby slow") — promoting onto
# it loses every epoch since the link died.
LINK_UNKNOWN = "unknown"
LINK_UP = "up"
LINK_DEAD = "dead"


class InProcessSink:
    """Feeds a StandbyReceiver in the same process (tests, drills)."""

    def __init__(self, receiver):
        self.receiver = receiver

    def send(self, data: bytes) -> None:
        self.receiver.apply_bytes(data)

    def heartbeat(self) -> bool:
        return True

    def link_state(self) -> str:
        return LINK_UP

    def close(self) -> None:
        pass


class TeeSink:
    """Fan out frames to several sinks (e.g. a standby plus a frame
    archive in the checkpoint-catch-up tests).  All sinks get every
    frame; the first failure propagates after the fan-out completes."""

    def __init__(self, *sinks):
        self.sinks = list(sinks)

    def send(self, data: bytes) -> None:
        err = None
        for sink in self.sinks:
            try:
                sink.send(data)
            except Exception as exc:  # noqa: BLE001 — re-raised below
                err = err or exc
        if err is not None:
            raise err

    def close(self) -> None:
        for sink in self.sinks:
            if hasattr(sink, "close"):
                sink.close()


class FrameArchive:
    """A sink that just records encoded frames (replay / catch-up)."""

    def __init__(self):
        self.frames: list = []

    def send(self, data: bytes) -> None:
        self.frames.append(data)


class SocketSink:
    """Primary-side TCP sender with per-frame acks and bounded retry.

    Connects lazily.  A broken pipe (standby restart, flaky link) does
    NOT error the ship cycle immediately: ``send`` retries the frame up
    to ``max_retries`` times with capped exponential backoff + jitter,
    reconnecting each time — a blip never errors out of the replication
    thread, only a sustained outage does (and the replicator's existing
    failure path then re-marks + requests a full frame).  Frames are
    idempotent (absolute rows, monotonic epochs), so a retry after a
    lost ack can only re-apply what the standby already holds.

    Any reconnect raises :meth:`consume_reconnected` once: the standby
    behind the fresh connection may be a RESTARTED process with empty
    state, so the replicator re-baselines with a ``full`` frame on its
    next cycle instead of shipping deltas into a void (the receiver's
    gap detection would catch it anyway — the full frame makes recovery
    immediate rather than promoted-blocked).
    """

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 max_retries: int = 4, backoff_ms: float = 50.0,
                 backoff_cap_ms: float = 2000.0, seed: int = 0,
                 ack_timeout: float = 5.0, dead_after: int = 2):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self.max_retries = int(max_retries)
        self.backoff_ms = float(backoff_ms)
        self.backoff_cap_ms = float(backoff_cap_ms)
        # Ack deadline: a standby that accepted the TCP bytes but never
        # acks (process wedged, half-open connection after a silent
        # death) must fail the send within ``ack_timeout`` seconds — the
        # old behavior waited the full connect timeout per attempt, so a
        # silently-dead standby just grew the byte-bounded queue until
        # coalescing with nothing marking the link as gone.
        self.ack_timeout = float(ack_timeout)
        # Consecutive fully-failed sends/heartbeats before the link
        # reports DEAD (one blip must not flap the gauge).
        self.dead_after = max(int(dead_after), 1)
        self.reconnects = 0
        self._rng = random.Random(seed)
        self._sock: socket.socket | None = None
        self._ever_connected = False
        self._reconnected = False
        self._consec_failures = 0
        self._link = LINK_UNKNOWN
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Post-connect ops (sendall + ack recv) run under the tighter
        # ack deadline, not the connect timeout.
        sock.settimeout(self.ack_timeout)
        if self._ever_connected:
            self._reconnected = True
            self.reconnects += 1
        self._ever_connected = True
        return sock

    # -- link liveness --------------------------------------------------------
    def _note_outcome(self, ok: bool) -> None:
        """Caller holds the lock."""
        if ok:
            self._consec_failures = 0
            self._link = LINK_UP
        else:
            self._consec_failures += 1
            if self._consec_failures >= self.dead_after:
                self._link = LINK_DEAD

    def link_state(self) -> str:
        # Deliberately LOCK-FREE (one atomic attribute read): the send
        # path holds the main lock through its whole retry/backoff loop
        # — many seconds against a partitioned standby — and the control
        # plane (probe handlers, /actuator status, the orchestrator)
        # polls this as a liveness signal.  A liveness read that blocks
        # on the data plane would wedge exactly when it matters most.
        return self._link

    def heartbeat(self) -> bool:
        """One zero-length liveness frame; the standby acks it without
        applying anything.  Bounded by ``ack_timeout``.  The replicator
        sends one on every idle cycle so a standby that dies SILENTLY
        mid-stream (no RST — a network partition, a hard power cut) is
        detected even when no deltas are flowing."""
        with self._lock:
            try:
                if self._sock is None:
                    self._sock = self._connect()
                self._sock.sendall(_LEN.pack(0))
                ack = self._recv_exact(1)
                ok = ack[0] == ACK_OK
            except OSError:
                self._drop()
                ok = False
            self._note_outcome(ok)
            return ok

    def consume_reconnected(self) -> bool:
        """True once per reconnect since the last call — the replicator
        re-baselines with a full frame when it sees it."""
        with self._lock:
            seen = self._reconnected
            self._reconnected = False
            return seen

    def send(self, data: bytes) -> None:
        payload = _LEN.pack(len(data)) + data
        with self._lock:
            last_exc: OSError | None = None
            for attempt in range(self.max_retries + 1):
                if attempt:
                    delay_ms = min(self.backoff_cap_ms,
                                   self.backoff_ms * (2 ** (attempt - 1)))
                    # Jitter in [0.5x, 1.5x): reconnect stampedes from
                    # many primaries must not synchronize.
                    time.sleep(delay_ms * (0.5 + self._rng.random())
                               / 1000.0)
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    self._sock.sendall(payload)
                    ack = self._recv_exact(1)
                except OSError as exc:
                    self._drop()
                    last_exc = exc
                    continue
                if ack[0] != ACK_OK:
                    # The standby REJECTED the frame (geometry mismatch,
                    # decode error) — not a link fault; retrying the same
                    # bytes cannot help.  Let the replicator's failure
                    # path re-mark and re-baseline.
                    self._drop()
                    self._note_outcome(True)  # it answered: link is alive
                    raise ConnectionError(
                        f"standby rejected replication frame (ack={ack[0]})")
                self._note_outcome(True)
                return
            self._note_outcome(False)
            raise ConnectionError(
                f"replication link to {self.host}:{self.port} down after "
                f"{self.max_retries + 1} attempts") from last_exc

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("standby closed connection")
            buf += chunk
        return buf

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._drop()


class ReplicationServer:
    """Standby-side TCP listener feeding a StandbyReceiver."""

    def __init__(self, receiver, host: str = "0.0.0.0", port: int = 0):
        self.receiver = receiver
        # Monotonic stamp of the LAST complete frame OR heartbeat from
        # the primary — the standby-side witness signal: an orchestrator
        # that cannot reach the primary asks this standby "when did you
        # last hear from it?" to tell a dead primary from one merely
        # partitioned off the orchestrator's own link (control.py
        # standby_handlers reports it as ``repl_rx_age_ms``).
        self._last_rx_mono: float | None = None
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock: socket.socket = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                buf = b""
                while True:
                    try:
                        chunk = sock.recv(1 << 20)
                    except OSError:
                        return
                    if not chunk:
                        return
                    buf += chunk
                    out = b""
                    while len(buf) >= _LEN.size:
                        (length,) = _LEN.unpack_from(buf)
                        if len(buf) < _LEN.size + length:
                            break
                        frame = buf[_LEN.size:_LEN.size + length]
                        buf = buf[_LEN.size + length:]
                        outer._last_rx_mono = time.monotonic()
                        if length == 0:
                            # Heartbeat: liveness ack, nothing to apply.
                            out += bytes([ACK_OK])
                            continue
                        try:
                            outer.receiver.apply_bytes(frame)
                            out += bytes([ACK_OK])
                        except Exception:  # noqa: BLE001 — ack the failure
                            out += bytes([ACK_ERROR])
                    if out:
                        try:
                            sock.sendall(out)
                        except OSError:
                            return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="replication-rx",
            daemon=True)

    def rx_age_ms(self) -> float | None:
        """Milliseconds since the primary's last frame or heartbeat
        landed here (None before first contact)."""
        last = self._last_rx_mono
        if last is None:
            return None
        return (time.monotonic() - last) * 1000.0

    def start(self) -> "ReplicationServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
