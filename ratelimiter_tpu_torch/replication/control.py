"""Control-plane RPC, flat part (counterpart of
``ratelimiter_tpu/replication/control.py``, the same wire): the small
dedicated port that lets a failover orchestrator or an operator drive a
primary and a standby running in other processes.

The replication data plane (transport.py) ships state; this port ships
*authority*: PROBE (liveness + replica status), FENCE (install a fence
epoch on a zombie), LEASE (grant/renew the serving lease that bounds a
partitioned zombie's over-admission), LEASE_DEPOSIT / LEASE_FETCH (the
standby-relayed renewal path for a primary the orchestrator cannot
reach directly), PROMOTE (the remote-promotion RPC), RESTORE (operator
unfence), and SHIP (flush + one synchronous replication cycle — drills
use it to pin the replica byte-exact before a kill).  The fleet control
plane rides the same port: every role also serves CONTROLLER_CLAIM /
SET_POLICY / POLICY_INFO / SIGNALS — the epoch-fenced
controller-leadership ops (:class:`ControllerSeat`) — so a node of the
port answers the same op set as a reference node.

Wire format::

    u32 length (LE) | UTF-8 JSON payload

Request payloads are ``{"op": <name>, ...args}``; responses are
``{"ok": true, ...fields}`` or ``{"ok": false, "error": <detail>}``.
JSON over length-prefixed frames is deliberate: control traffic is a
few frames per second per shard (the decision path never touches this
port), so the spec optimizes for auditability — an operator can drive
every op with ``python -c`` and a socket — not for bytes.  An unknown
op answers ``ok=false`` in-protocol; a handler exception is caught and
answered the same way (the control port never wedges on a bad frame).

Roles install different handler sets (``primary_handlers`` /
``standby_handlers``); a node can expose extra ops by passing more
callables.  Every handler runs on the server's connection thread —
handlers must stay short (promote is the long pole and is bounded by
the client's per-call timeout).
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import time
from typing import Callable, Dict, Optional

from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("replication.control")

_LEN = struct.Struct("<I")

# A control frame is a few hundred bytes of JSON; anything bigger is a
# framing error or an attack, answered in-protocol and the conn closed.
MAX_CONTROL_FRAME = 1 << 20


class ControlError(ConnectionError):
    """Transport-level control failure (peer unreachable / link cut /
    timed out) — distinct from an in-protocol ``ok=false`` refusal."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("control peer closed connection")
        buf += chunk
    return buf


def _read_frame(sock: socket.socket) -> Optional[dict]:
    try:
        header = _recv_exact(sock, _LEN.size)
    except (ConnectionError, OSError):
        return None
    (length,) = _LEN.unpack(header)
    if length == 0 or length > MAX_CONTROL_FRAME:
        raise ValueError(f"control frame length {length} out of bounds")
    payload = _recv_exact(sock, length)
    return json.loads(payload.decode("utf-8"))


def _write_frame(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(_LEN.pack(len(data)) + data)


class ControlServer:
    """Framed-JSON control listener dispatching to a handler table.

    ``handlers`` maps op name -> callable; the callable receives the
    request's non-``op`` fields as keyword arguments and returns a dict
    merged into the ``{"ok": true}`` response (or raises — the error
    string is answered as ``ok=false``).
    """

    def __init__(self, handlers: Dict[str, Callable[..., dict]],
                 host: str = "127.0.0.1", port: int = 0):
        self.handlers = dict(handlers)
        self.requests_served = 0
        self.errors_answered = 0
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock: socket.socket = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                while True:
                    try:
                        req = _read_frame(sock)
                    except (ValueError, OSError):
                        return  # framing violation: drop the conn
                    if req is None:
                        return
                    op = req.pop("op", None)
                    fn = outer.handlers.get(op)
                    if fn is None:
                        resp = {"ok": False, "error": f"unknown op {op!r}"}
                        outer.errors_answered += 1
                    else:
                        try:
                            out = fn(**req) or {}
                            resp = {"ok": True, **out}
                        except Exception as exc:  # noqa: BLE001 — answered
                            resp = {"ok": False,
                                    "error": f"{type(exc).__name__}: {exc}"}
                            outer.errors_answered += 1
                    outer.requests_served += 1
                    try:
                        _write_frame(sock, resp)
                    except OSError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="control-rpc",
            daemon=True)

    def start(self) -> "ControlServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class ControlClient:
    """One control connection with per-call deadlines.

    Connects lazily and reconnects per failed call; a call that cannot
    complete within ``timeout`` raises :class:`ControlError` (the
    orchestrator treats that as a probe failure — exactly the signal a
    partition produces).  Thread-safe: one in-flight call at a time.
    """

    def __init__(self, host: str, port: int, timeout: float = 2.0):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def call(self, op: str, timeout: Optional[float] = None, **kw) -> dict:
        """One request/response round trip; raises ControlError on any
        transport fault (the in-protocol ``ok`` field is the caller's to
        check).

        A call that fails on a PREVIOUSLY-USED connection retries once
        on a fresh one: a persistent control link can go stale between
        calls (peer restart, idle reaper, half-closed proxy) and every
        control op is safe to re-ask — reads are pure, and the write ops
        are guarded server-side by monotonic epochs / single-winner
        promotion, so a duplicate is answered in-protocol, not
        double-applied."""
        deadline = float(timeout if timeout is not None else self.timeout)
        with self._lock:
            for attempt in range(2):
                reused = self._sock is not None
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    self._sock.settimeout(deadline)
                    _write_frame(self._sock, {"op": op, **kw})
                    resp = _read_frame(self._sock)
                except (OSError, ValueError, ConnectionError) as exc:
                    self._drop()
                    if reused and attempt == 0:
                        continue
                    raise ControlError(
                        f"control call {op!r} to {self.host}:{self.port} "
                        f"failed: {exc}") from exc
                if resp is None:
                    self._drop()
                    if reused and attempt == 0:
                        continue
                    raise ControlError(
                        f"control peer {self.host}:{self.port} closed "
                        f"during {op!r}")
                return resp
            raise ControlError(  # unreachable; loop always raised/returned
                f"control call {op!r} to {self.host}:{self.port} failed")

    def call_ok(self, op: str, timeout: Optional[float] = None,
                **kw) -> dict:
        """Like :meth:`call` but an in-protocol refusal raises too."""
        resp = self.call(op, timeout=timeout, **kw)
        if not resp.get("ok"):
            raise RuntimeError(
                f"control op {op!r} refused by {self.host}:{self.port}: "
                f"{resp.get('error')}")
        return resp

    def try_call(self, op: str, **kw) -> Optional[dict]:
        """``call`` that returns None instead of raising on transport
        faults (witness/status polls that must never throw)."""
        try:
            return self.call(op, **kw)
        except ControlError:
            return None

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


# ---------------------------------------------------------------------------
# Role handler tables (service/wiring.py installs these)
# ---------------------------------------------------------------------------


class LeaseMailbox:
    """The standby-relayed renewal path's mailbox: the orchestrator
    deposits serving-lease grants here (it can reach the standby), and
    the primary — when it has not heard from the orchestrator directly —
    fetches the newest deposit over the replication-side link it still
    has.  Age is stamped at deposit on the MAILBOX's clock and returned
    relative, so neither peer needs synchronized wall clocks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._grant: Optional[dict] = None
        self.deposits = 0
        self.fetches = 0

    def deposit(self, epoch: int, ttl_ms: float) -> dict:
        with self._lock:
            self._grant = {"epoch": int(epoch), "ttl_ms": float(ttl_ms),
                           "at_mono": time.monotonic()}
            self.deposits += 1
            return {"epoch": int(epoch)}

    def fetch(self) -> dict:
        with self._lock:
            self.fetches += 1
            if self._grant is None:
                return {"deposited": False}
            age_ms = (time.monotonic() - self._grant["at_mono"]) * 1000.0
            return {"deposited": True, "epoch": self._grant["epoch"],
                    "ttl_ms": self._grant["ttl_ms"],
                    "age_ms": round(age_ms, 3)}


class ControllerSeat:
    """Node-side acceptor for the fleet controller's authority claims.
    Mirrors the serving-lease fence-epoch rule on the CONTROL plane: the
    seat remembers the highest controller epoch it ever granted, a claim
    at a lower epoch is refused in-protocol (with the current epoch, so a
    zombie learns it was superseded), and every policy write carries the
    writer's epoch — a write below the seat's epoch is rejected and
    counted, never applied.  Epochs are granted per NODE; the electing
    side only considers itself leader with a MAJORITY of seats, so two
    controllers can never both hold a quorum at the same epoch."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self.node: Optional[str] = None
        self.epoch = 0
        self.ttl_ms = 0.0
        self.granted_at = 0.0
        self.stale_rejected = 0

    def claim(self, node: str, epoch: int, ttl_ms: float = 3000.0) -> dict:
        """Grant (or refuse) controller authority at ``epoch``.  A
        strictly higher epoch always wins — even over an unexpired
        grant, exactly like ``storage.fence`` — and the CURRENT holder
        renews at its own epoch to refresh the TTL."""
        epoch = int(epoch)
        with self._lock:
            now = self._clock()
            if epoch > self.epoch or (epoch == self.epoch
                                      and node == self.node):
                self.node = str(node)
                self.epoch = epoch
                self.ttl_ms = float(ttl_ms)
                self.granted_at = now
                return {"granted": True, "epoch": self.epoch,
                        "node": self.node}
            return {"granted": False, "epoch": self.epoch,
                    "node": self.node,
                    "expired": self._expired_locked(now)}

    def check(self, epoch: int) -> bool:
        """True iff a write stamped ``epoch`` is current; a stale epoch
        is counted (``stale_rejected``) and must not be applied."""
        with self._lock:
            if int(epoch) < self.epoch:
                self.stale_rejected += 1
                return False
            return True

    def _expired_locked(self, now: float) -> bool:
        return (self.node is not None
                and (now - self.granted_at) * 1000.0 > self.ttl_ms)

    def info(self) -> dict:
        with self._lock:
            now = self._clock()
            remaining = 0.0
            if self.node is not None:
                remaining = self.ttl_ms - (now - self.granted_at) * 1000.0
            return {"node": self.node, "epoch": self.epoch,
                    "ttl_remaining_ms": round(remaining, 3),
                    "expired": self._expired_locked(now),
                    "stale_rejected": self.stale_rejected}


def controller_handlers(storage, seat: Optional[ControllerSeat] = None,
                        ) -> Dict[str, Callable]:
    """The fleet-controller ops EVERY node role serves (merged into
    both ``primary_handlers`` and ``standby_handlers``):

    - ``controller_claim`` — grant/renew/refuse controller authority at
      a fence epoch (see :class:`ControllerSeat`).
    - ``set_policy``      — apply a batch of policy rows at the
      leader's monotone generation stamp.  Idempotent: a duplicate is
      a no-op, an older generation is refused (``stale_generation``),
      and a write below the seat's controller epoch is refused without
      touching the table (``stale_epoch``).
    - ``policy_info``     — the policy table (generation + per-lid
      rows) plus the controller seat, the leader's anti-entropy read.
    - ``signals``         — the node's local ``UsageSignals`` per lid
      (serialized as field lists) plus the plane's staleness, the
      leader's fleet-true observation read.
    """
    from ratelimiter_tpu_torch.engine.checkpoint import (
        apply_limiter_policies,
    )

    seat = seat if seat is not None else ControllerSeat()

    def _generation() -> int:
        table = getattr(storage, "table", None)
        return int(table.generation) if table is not None else 0

    def controller_claim(node: str, epoch: int,
                         ttl_ms: float = 3000.0) -> dict:
        out = seat.claim(node, epoch, ttl_ms)
        out["generation"] = _generation()
        return out

    def set_policy(rows: dict, epoch: int = 0, node: str = "") -> dict:
        if not seat.check(int(epoch)):
            return {"applied": False, "stale_epoch": True,
                    "epoch": seat.epoch, "generation": _generation()}
        try:
            apply_limiter_policies(storage, dict(rows))
        except ValueError as exc:
            # An older generation racing a newer one is EXPECTED under
            # retries and failover — answer in-protocol so the caller
            # converges instead of error-storming.
            return {"applied": False, "stale_generation": True,
                    "error": str(exc), "generation": _generation()}
        return {"applied": True, "generation": _generation()}

    def policy_info() -> dict:
        if hasattr(storage, "policy_info"):
            out = dict(storage.policy_info())
        else:
            out = {"generation": _generation(), "lids": {}}
        out["controller"] = seat.info()
        return out

    def signals(window_ms: int = 2000) -> dict:
        plane = getattr(storage, "telemetry", None)
        if plane is None:
            return {"signals": {}, "staleness_ms": 0.0}
        sigs = plane.all_signals(int(window_ms))
        return {"signals": {str(lid): list(s) for lid, s in sigs.items()},
                "staleness_ms": float(plane.staleness_ms())}

    return {"controller_claim": controller_claim, "set_policy": set_policy,
            "policy_info": policy_info, "signals": signals}


def mux_handlers(per_shard: Dict[int, Dict[str, Callable]],
                 extra: Optional[Dict[str, Callable]] = None) -> Dict:
    """Multiplex several shards' handler tables behind ONE control port.

    A multi-shard node (``hostproc --shards k``) runs k
    independent shard storages in one process but must not burn k
    listener ports and k orchestrator connections: every op gains an
    optional ``shard`` field (default 0, so single-shard callers and old
    drills keep working verbatim) and dispatches to that shard's table.  An unknown
    shard or an op the shard does not serve is answered in-protocol.

    ``probe_all`` answers EVERY shard's probe in one round trip —
    ``{"shards": {"0": {probe..., "ok": true}, ...}}`` — so a manager
    watching a k-shard node pays one RPC per NODE per tick, not one per
    shard (the per-RPC GIL cost is the orchestrator probe loop's long
    pole; see bench/orchestrator_overhead.py).
    """
    shards = {int(q): dict(table) for q, table in per_shard.items()}

    def _dispatch(op: str) -> Callable[..., dict]:
        def call(shard: int = 0, **kw) -> dict:
            table = shards.get(int(shard))
            if table is None:
                raise ValueError(f"unknown shard {shard}")
            fn = table.get(op)
            if fn is None:
                raise ValueError(f"op {op!r} not served by shard {shard}")
            return fn(**kw) or {}
        return call

    def probe_all() -> dict:
        out: Dict[str, dict] = {}
        for q in sorted(shards):
            fn = shards[q].get("probe")
            if fn is None:
                continue
            try:
                out[str(q)] = {"ok": True, **(fn() or {})}
            except Exception as exc:  # noqa: BLE001 — per-shard verdict
                out[str(q)] = {"ok": False,
                               "error": f"{type(exc).__name__}: {exc}"}
        return {"shards": out}

    ops: set = set()
    for table in shards.values():
        ops.update(table)
    handlers: Dict[str, Callable] = {op: _dispatch(op) for op in ops}
    handlers["probe_all"] = probe_all
    handlers.update(extra or {})
    return handlers


def primary_handlers(storage, replicator=None,
                     extra: Optional[Dict[str, Callable]] = None) -> Dict:
    """Control ops a shard-primary process exposes.

    - ``probe``   — liveness + fence/lease state (the orchestrator's
      remote probe; also the operator's ``status`` peek).
    - ``fence``   — install a whole-storage fence epoch (the storage
      behind this port IS one shard of the cross-host topology).
    - ``lease``   — grant/renew the serving lease (distributed fence).
    - ``restore`` — operator unfence: lift the fence at ``epoch``.
    - ``ship``    — flush + one synchronous replication cycle (drills
      pin the replica byte-exact before a kill).
    """

    def probe() -> dict:
        out = {"role": "primary", "available": False}
        try:
            out["available"] = bool(storage.is_available())
        except Exception:  # noqa: BLE001 — an erroring probe reads dead
            pass
        out["fence"] = storage.fence_info()
        out["lease"] = storage.serving_lease_info()
        if replicator is not None:
            out["replication"] = {
                "frames_shipped": replicator.frames_shipped,
                "errors": replicator.errors,
                "link": replicator.link_state(),
            }
        return out

    def fence(epoch: int) -> dict:
        return {"epoch": storage.fence(int(epoch))}

    def lease(epoch: int, ttl_ms: float) -> dict:
        return storage.grant_serving_lease(int(epoch), float(ttl_ms))

    def restore(epoch: int) -> dict:
        storage.lift_fence(int(epoch))
        return {"epoch": int(epoch), "lease": storage.serving_lease_info()}

    def ship() -> dict:
        storage.flush()
        shipped = replicator.ship_now() if replicator is not None else 0
        return {"frames": int(shipped)}

    handlers = {"probe": probe, "fence": fence, "lease": lease,
                "restore": restore, "ship": ship}
    handlers.update(controller_handlers(storage))
    handlers.update(extra or {})
    return handlers


def standby_handlers(storage, receiver, repl_server=None,
                     mailbox: Optional[LeaseMailbox] = None,
                     on_promote: Optional[Callable[[], dict]] = None,
                     extra: Optional[Dict[str, Callable]] = None) -> Dict:
    """Control ops a standby process exposes.

    - ``probe``         — replica status (consistent/promoted/epoch) plus
      ``repl_rx_age_ms``: milliseconds since the standby last heard ANY
      replication frame or heartbeat from its primary.  This is the
      orchestrator's second witness — a primary the orchestrator cannot
      reach but whose heartbeats still land here is PARTITIONED-FROM-THE-
      ORCHESTRATOR, not dead, and must not be fenced or replaced.
    - ``lease_deposit`` / ``lease_fetch`` — the relay mailbox (above).
    - ``promote``       — the remote-promotion RPC; ``on_promote`` runs
      after a successful promote (hostproc starts a serving sidecar) and
      its fields join the response.
    - ``fence`` / ``lease`` / ``restore`` — the promoted storage's
      authority surface (after promotion this node IS the shard).
    """
    box = mailbox if mailbox is not None else LeaseMailbox()

    def probe() -> dict:
        out = {
            "role": "standby",
            "promoted": bool(receiver.promoted),
            "consistent": bool(receiver.consistent),
            "last_epoch": int(receiver.last_epoch),
            "frames_applied": int(receiver.frames_applied),
            "available": True,
        }
        if receiver.promoted:
            try:
                out["available"] = bool(storage.is_available())
            except Exception:  # noqa: BLE001
                out["available"] = False
        if repl_server is not None:
            age = repl_server.rx_age_ms()
            if age is not None:
                out["repl_rx_age_ms"] = round(age, 3)
        out["fence"] = storage.fence_info()
        out["lease"] = storage.serving_lease_info()
        return out

    def promote(force: bool = False) -> dict:
        receiver.promote(force=bool(force))
        out = {"last_epoch": int(receiver.last_epoch)}
        if on_promote is not None:
            out.update(on_promote() or {})
        return out

    def fence(epoch: int) -> dict:
        return {"epoch": storage.fence(int(epoch))}

    def lease(epoch: int, ttl_ms: float) -> dict:
        return storage.grant_serving_lease(int(epoch), float(ttl_ms))

    def restore(epoch: int) -> dict:
        storage.lift_fence(int(epoch))
        return {"epoch": int(epoch)}

    handlers = {"probe": probe, "promote": promote,
                "lease_deposit": box.deposit, "lease_fetch": box.fetch,
                "fence": fence, "lease": lease, "restore": restore}
    handlers.update(controller_handlers(storage))
    handlers.update(extra or {})
    return handlers
