"""Cross-host topology adapters (counterpart of
``ratelimiter_tpu/replication/remote.py``): run the
``FailoverOrchestrator`` against shard primaries and standbys living in
OTHER processes.

The orchestrator's contracts are duck-typed — a "backend" fences and
grants leases, a "receiver" reports consistency and promotes, a
"router" books which backend serves each shard.  These classes satisfy
those contracts over :mod:`replication.control` RPC, so the same state
machine (hysteresis, witness veto, fence-or-wait, bounded promote
retry) drives a multi-process deployment unchanged:

- :class:`RemoteBackend` — a storage behind a control port.  ``fence``/
  ``grant_serving_lease``/``lift_fence`` forward over RPC; a transport
  fault raises (the orchestrator's fence path then falls back to the
  lease-expiry wait — an unreachable zombie cannot be fenced directly,
  so its lease TTL is the fence).
- :class:`RemoteReceiver` — a StandbyReceiver behind a control port.
  ``promoted``/``consistent``/``last_epoch`` are short-TTL cached probe
  reads; ``promote()`` is the remote-promotion RPC and returns a
  :class:`RemoteBackend` for the newly serving storage (plus
  ``serve_port``, the sidecar the promoted node opened — clients
  re-point there).
- :class:`RemoteShardDirectory` — the router-duck for the orchestrator
  process.  It does NOT route decisions (cross-host clients route
  themselves); it keeps the authoritative serving map the orchestrator
  mutates (fail/replace/repair) and operators read.
- :class:`FanoutLeaseChannel` — serving-lease channel with the relay
  leg: ``grant`` renews the serving backend directly, ``deposit`` parks
  the grant in the standby's :class:`~.control.LeaseMailbox` for the
  primary to fetch over the replication-side link it still has when the
  orchestrator's direct path is partitioned.
- :func:`standby_witness` — the second-witness verdict from the
  standby's vantage point: a primary whose replication frames or
  heartbeats landed within ``fresh_ms`` is "alive" no matter what the
  orchestrator's own probe link says.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ratelimiter_tpu_torch.replication.control import (
    ControlClient,
    ControlError,
)
from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("replication.remote")


def _wall_ms() -> int:
    return time.time_ns() // 1_000_000


def parse_ready(info: dict) -> dict:
    """Validate a hostproc ready line and normalize pre-fleet fields.

    The explicit ``lid_base`` field replaces the lids-start-at-1
    convention: when the line carries registered lids at all, the base
    must be present AND agree with ``min(lids)`` — a launcher that
    would have silently mis-addressed every limiter fails loudly here
    instead.  Lines from pre-fleet nodes (no ``shards``/``version``)
    normalize to one v0 shard.
    """
    if not isinstance(info, dict) or not info.get("ready"):
        raise ValueError(f"not a hostproc ready line: {info!r}")
    if "control_port" not in info:
        raise ValueError("ready line missing control_port")
    role = info.get("role")
    if role not in ("primary", "standby"):
        raise ValueError(f"ready line has unknown role {role!r}")
    lids = info.get("lids") or []
    flat = [lid for entry in lids
            for lid in (entry if isinstance(entry, list) else [entry])]
    if flat:
        base = info.get("lid_base")
        if base is None:
            raise ValueError(
                "ready line registered lids but carries no lid_base — "
                "refusing to assume the lids-start-at-1 convention")
        if min(flat) != int(base):
            raise ValueError(
                f"ready line lid_base {base} disagrees with min(lids) "
                f"{min(flat)}")
    info.setdefault("shards", 1)
    info.setdefault("version", "v0")
    return info


class RemoteBackend:
    """Duck-typed storage proxy over a control port.

    ``shard`` addresses one shard of a multi-shard node (hostproc
    ``--shards k`` multiplexes k shard storages behind one control
    port); None keeps the bare ops for single-shard nodes and raw
    handler tables."""

    def __init__(self, ctl: ControlClient, label: str = "",
                 shard: Optional[int] = None):
        self.ctl = ctl
        self.shard = shard
        self.label = label or f"{ctl.host}:{ctl.port}"
        if shard is not None:
            self.label += f"/s{int(shard)}"

    def _kw(self, **kw) -> dict:
        if self.shard is not None:
            kw["shard"] = int(self.shard)
        return kw

    def fence(self, epoch: int, shards=None) -> int:
        """Install a whole-storage fence.  ``shards`` is accepted for
        interface parity and ignored: the storage behind this proxy IS
        exactly one shard of the cross-host topology, so whole-storage
        and shard-scoped fencing coincide."""
        del shards
        self.ctl.call_ok("fence", **self._kw(epoch=int(epoch)))
        return int(epoch)

    def lift_fence(self, epoch: int, shards=None) -> None:
        del shards
        self.ctl.call_ok("restore", **self._kw(epoch=int(epoch)))

    def grant_serving_lease(self, epoch: int, ttl_ms: float) -> dict:
        return self.ctl.call_ok("lease", **self._kw(epoch=int(epoch),
                                                    ttl_ms=float(ttl_ms)))

    def retarget(self, host: str, port: int,
                 interval_ms: Optional[float] = None,
                 timeout_s: float = 30.0) -> dict:
        """Re-point this shard's replication stream at a new standby
        listener and synchronously ship a full re-baseline frame (the
        fleet's re-seed primitive).  Generous timeout: the receiving
        side may build its kernels at its first frame apply."""
        kw = self._kw(host=str(host), port=int(port))
        if interval_ms is not None:
            kw["interval_ms"] = float(interval_ms)
        return self.ctl.call_ok("retarget", timeout=float(timeout_s), **kw)

    def fence_info(self) -> dict:
        return self.ctl.call_ok("probe", **self._kw()).get("fence", {})

    def serving_lease_info(self) -> dict:
        return self.ctl.call_ok("probe", **self._kw()).get("lease", {})

    def is_available(self) -> bool:
        try:
            resp = self.ctl.call("probe", **self._kw())
        except ControlError:
            return False
        return bool(resp.get("ok")) and bool(resp.get("available"))

    def probe(self) -> Optional[dict]:
        """Raw probe payload, or None when unreachable."""
        return self.ctl.try_call("probe", **self._kw())

    # -- fleet control plane ---------------------------------------------------
    # Thin forwarders for the controller-leadership ops every node role
    # serves (replication/control.py:controller_handlers).

    def controller_claim(self, node: str, epoch: int,
                         ttl_ms: float = 3000.0) -> dict:
        """Claim/renew controller authority on this node's seat.  A
        refusal is IN-PROTOCOL (granted=False + the seat's epoch), so
        callers distinguish "outvoted" from "unreachable"."""
        return self.ctl.call_ok("controller_claim", **self._kw(
            node=str(node), epoch=int(epoch), ttl_ms=float(ttl_ms)))

    def set_policy_rows(self, rows: Dict, epoch: int,
                        node: str = "") -> dict:
        """Apply a batch of policy rows at the leader's generation
        stamps; stale-epoch and stale-generation refusals come back
        in-protocol (``applied=False``)."""
        return self.ctl.call_ok("set_policy", **self._kw(
            rows=dict(rows), epoch=int(epoch), node=str(node)))

    def policy_info(self) -> dict:
        """Policy table generation + rows + the controller seat."""
        return self.ctl.call_ok("policy_info", **self._kw())

    def signals(self, window_ms: int = 2000) -> dict:
        """The node's serialized per-lid UsageSignals + staleness."""
        return self.ctl.call_ok("signals",
                                **self._kw(window_ms=int(window_ms)))

    def close(self) -> None:
        self.ctl.close()


class RemoteReceiver:
    """Duck-typed StandbyReceiver proxy over a control port.

    Status attributes refresh over RPC with a short cache (one control
    round trip answers all three — ``standby_ok`` reads two attributes
    back to back and must not pay two probes).  While the standby is
    UNREACHABLE the cached status decays to not-promotable (consistent
    False), which is the safe verdict: promoting onto a standby we
    cannot even probe would be flying blind.
    """

    def __init__(self, ctl: ControlClient, cache_ttl_s: float = 0.05,
                 promote_timeout_s: float = 30.0,
                 shard: Optional[int] = None):
        self.ctl = ctl
        self.shard = shard
        self.cache_ttl_s = float(cache_ttl_s)
        self.promote_timeout_s = float(promote_timeout_s)
        self._status: dict = {}
        self._status_at = 0.0
        self._lock = threading.Lock()
        # Filled by promote(): the serving port the promoted node opened.
        self.serve_port: Optional[int] = None
        self.promote_info: dict = {}

    def _kw(self, **kw) -> dict:
        if self.shard is not None:
            kw["shard"] = int(self.shard)
        return kw

    def _refresh(self) -> dict:
        with self._lock:
            now = time.monotonic()
            if now - self._status_at >= self.cache_ttl_s:
                resp = self.ctl.try_call("probe", **self._kw())
                if resp is not None and resp.get("ok"):
                    self._status = resp
                else:
                    # Unreachable: decay to the fail-safe verdict.
                    self._status = dict(self._status,
                                        consistent=False, reachable=False)
                self._status_at = now
            return self._status

    @property
    def promoted(self) -> bool:
        return bool(self._refresh().get("promoted"))

    @property
    def consistent(self) -> bool:
        return bool(self._refresh().get("consistent"))

    @property
    def last_epoch(self) -> int:
        return int(self._refresh().get("last_epoch", 0))

    def rx_age_ms(self) -> Optional[float]:
        return self._refresh().get("repl_rx_age_ms")

    def promote(self, force: bool = False) -> RemoteBackend:
        """The remote-promotion RPC.  Raises on refusal (gapped stream,
        already promoted, promotion in flight — the orchestrator's
        bounded retry handles it) and returns a RemoteBackend for the
        storage that is now serving."""
        resp = self.ctl.call("promote", timeout=self.promote_timeout_s,
                             **self._kw(force=bool(force)))
        if not resp.get("ok"):
            raise RuntimeError(
                f"remote promote refused by {self.ctl.host}:"
                f"{self.ctl.port}: {resp.get('error')}")
        self.promote_info = resp
        self.serve_port = resp.get("serve_port")
        with self._lock:
            self._status = dict(self._status, promoted=True)
            self._status_at = time.monotonic()
        return RemoteBackend(self.ctl, label="promoted-standby",
                             shard=self.shard)

    def close(self) -> None:
        self.ctl.close()


class RemoteStandbySet:
    """Standby-mesh duck over remote receivers (``receivers[q]`` is all
    the orchestrator reads; re-seeding a NEW remote standby process is
    an operator/deployment action, so ``replace`` only swaps the
    in-memory entry)."""

    def __init__(self, receivers: List[RemoteReceiver]):
        self.n_shards = len(receivers)
        self.receivers = list(receivers)

    def replace(self, shard: int, storage, receiver) -> None:
        del storage
        self.receivers[int(shard)] = receiver

    def close(self, except_shards: tuple = ()) -> None:
        del except_shards
        for rx in self.receivers:
            try:
                rx.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


class RemoteShardDirectory:
    """The authoritative serving map for a cross-host cell.

    Satisfies the orchestrator's router contract (``shard_primary``,
    ``fail_shard``, ``install_replacement``, ``replacements``,
    ``shard_health``/``shard_status``, ``repair_shard``) without any
    decision routing: in a multi-process topology clients hold their own
    connections and re-point on promotion; this directory is what tells
    them (and /actuator/health) where each shard's keyspace lives."""

    def __init__(self, primaries: Dict[int, RemoteBackend]):
        self.n_shards = len(primaries)
        if sorted(primaries) != list(range(self.n_shards)):
            raise ValueError("primaries must be dense 0..n_shards-1")
        self.primaries = {int(q): b for q, b in primaries.items()}
        self.replacements: Dict[int, object] = {}
        self.failed: set = set()
        self._lock = threading.Lock()
        now_w, now_m = _wall_ms(), time.monotonic()
        self._since_wall = [now_w] * self.n_shards
        self._since_mono = [now_m] * self.n_shards

    # The orchestrator reads router.primary only through the
    # shard_primary hook when one exists; expose shard 0's for parity.
    @property
    def primary(self):
        return self.primaries[0]

    def shard_primary(self, q: int):
        return self.primaries[int(q)]

    def _mark(self, q: int) -> None:
        self._since_wall[q] = _wall_ms()
        self._since_mono[q] = time.monotonic()

    def fail_shard(self, shard: int) -> None:
        with self._lock:
            self.failed.add(int(shard))
            self._mark(int(shard))
        from ratelimiter_tpu_torch.observability import flight_recorder

        flight_recorder().record("shard.failed", shard=int(shard))

    def install_replacement(self, shard: int, backend) -> None:
        with self._lock:
            self.replacements[int(shard)] = backend
            self.failed.discard(int(shard))
            self._mark(int(shard))
        from ratelimiter_tpu_torch.observability import flight_recorder

        flight_recorder().record("shard.promoted", shard=int(shard))

    def repair_shard(self, shard: int) -> None:
        with self._lock:
            self.failed.discard(int(shard))
            self.replacements.pop(int(shard), None)
            self._mark(int(shard))
        from ratelimiter_tpu_torch.observability import flight_recorder

        flight_recorder().record("shard.repaired", shard=int(shard))

    def serving(self, q: int):
        """Where shard q's keyspace currently lives (None = fail-closed:
        failed, replacement not yet installed)."""
        return self._backend(int(q))

    def _backend(self, q: int):
        with self._lock:
            if q in self.failed:
                return None
            return self.replacements.get(q, self.primaries[q])

    def shard_health(self) -> Dict[int, str]:
        with self._lock:
            return {q: ("failed" if q in self.failed
                        else "promoted" if q in self.replacements
                        else "active")
                    for q in range(self.n_shards)}

    def shard_status(self) -> Dict[int, Dict]:
        now = time.monotonic()
        health = self.shard_health()
        with self._lock:
            return {q: {"state": health[q],
                        "since_ms": self._since_wall[q],
                        "in_state_ms": round(
                            (now - self._since_mono[q]) * 1000.0, 3)}
                    for q in range(self.n_shards)}

    def degraded_shards(self) -> List[int]:
        with self._lock:
            return sorted(self.failed | set(self.replacements))

    def is_available(self) -> bool:
        return all(self.primaries[q].is_available()
                   for q in range(self.n_shards))

    def close(self) -> None:
        for b in self.primaries.values():
            b.close()
        with self._lock:
            reps = list(self.replacements.values())
        for r in reps:
            try:
                r.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


class FanoutLeaseChannel:
    """Serving-lease channel with both legs: ``grant`` direct to the
    serving backend, ``deposit`` into the shard's standby mailbox (the
    relay the primary fetches from when the orchestrator cannot reach it
    directly — replication/control.py:LeaseMailbox)."""

    def __init__(self, backend, standby_ctl: ControlClient,
                 shard: Optional[int] = None):
        self.backend = backend
        self.standby_ctl = standby_ctl
        self.shard = shard

    def grant(self, epoch: int, ttl_ms: float) -> None:
        self.backend.grant_serving_lease(int(epoch), float(ttl_ms))

    def deposit(self, epoch: int, ttl_ms: float) -> None:
        kw = {} if self.shard is None else {"shard": int(self.shard)}
        self.standby_ctl.call_ok("lease_deposit", epoch=int(epoch),
                                 ttl_ms=float(ttl_ms), **kw)


def standby_witness(standby_ctls: Dict[int, object],
                    fresh_ms: float = 400.0) -> Callable[[int], str]:
    """Build the orchestrator's second-witness callable: shard q's
    verdict comes from its STANDBY's control port — "alive" when the
    primary's replication frames/heartbeats landed within ``fresh_ms``,
    "dead" when they stopped longer ago, "unknown" when the standby
    itself is unreachable or has never heard from the primary.  Only
    "alive" vetoes a fencing (an unknown vantage point proves nothing).

    Entries are a bare :class:`ControlClient` (single-shard standby) or
    a ``(ControlClient, shard)`` tuple addressing one shard of a multi-
    shard node.  The dict is read AT CALL TIME, so the fleet autopilot
    retargets a shard's witness by mutating the entry in place — no
    orchestrator rewiring.

    ``fresh_ms`` must comfortably exceed the primary's replication
    heartbeat interval (or idle gaps read as death) and sit below the
    orchestrator's detection budget (or a real death is vetoed once
    before the staleness shows)."""

    def witness(q: int) -> str:
        entry = standby_ctls.get(int(q))
        if entry is None:
            return "unknown"
        if isinstance(entry, tuple):
            ctl, shard = entry
            kw = {"shard": int(shard)}
        else:
            ctl, kw = entry, {}
        # One retry: an "unknown" verdict cannot veto, so a single
        # dropped poll against a live standby must not let a healthy-
        # but-unreachable primary slip through to FENCING.
        resp = ctl.try_call("probe", **kw)
        if resp is None or not resp.get("ok"):
            resp = ctl.try_call("probe", **kw)
        if resp is None or not resp.get("ok"):
            return "unknown"
        age = resp.get("repl_rx_age_ms")
        if age is None:
            return "unknown"
        return "alive" if float(age) <= float(fresh_ms) else "dead"

    return witness
