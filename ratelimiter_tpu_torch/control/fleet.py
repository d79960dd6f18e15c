"""Fleet-true control plane: epoch-fenced controller leadership and
cross-host policy broadcast (counterpart of
``ratelimiter_tpu/control/fleet.py``).

The adaptive controller alone actuates one process's storage and observes
one process's telemetry.  This module makes the SAME controller
fleet-true without changing a line of its loop: a
:class:`FleetControlPlane` quacks like the storage the controller
expects — ``_configs`` for ceilings, ``set_policy`` for actuation,
``table.generation`` / ``row_generation`` for stamps, ``telemetry`` for
observations — but every surface is backed by the cell's control RPC:

- **Observation**: ``telemetry.all_signals`` fans the ``signals`` op
  out to every member node and SUMS the per-lid UsageSignals, so the
  hierarchical global cap finally sees fleet load, not one host's
  slice.  ``staleness_ms`` is the worst member's staleness — and
  infinity for an unreachable member, which trips the controller's
  staleness freeze (stale signals must never justify a raise).
- **Actuation**: ``set_policy`` stamps a monotone generation and
  broadcasts the row to every member over the ``set_policy`` op.
  Per-node apply is idempotent (engine/checkpoint.py:
  ``apply_limiter_policies``) and rejects older generations, so
  retries and leader races converge instead of fighting.
- **Leadership**: the plane only actuates while it HOLDS the cell: a
  majority of member :class:`~ratelimiter_tpu_torch.replication.control.
  ControllerSeat` grants at its fence epoch, renewed within
  ``ttl_ms`` on its OWN clock.  A member answering with a higher
  epoch, or a renewal round that cannot reach a majority before the
  TTL runs out, demotes the plane immediately — it then REFUSES to
  actuate (:class:`NotLeader`), mirroring the serving-lease
  self-fence rule.  Two controllers can never both hold a majority at
  the same epoch, and a partitioned zombie's writes die at the seats
  (``stale_rejected``).

:class:`ControllerElection` is the re-election loop: elect at
``max(observed epoch) + 1``, then anti-entropy every member to one
generation (``converge``), measured as ``ratelimiter.control.
converge_ms``.  It runs on its own cadence thread (``start()``); the
reference also lets its fleet tier's NodeManager drive ``tick()`` from
the node probe cadence (``manager.attach(election)``), which the port
has not ported yet.  A freshly promoted or re-seeded standby joins
through ``note_join`` and is converged to the leader's generation
before it can serve a stale one.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.observability.usage import UsageSignals
from ratelimiter_tpu_torch.replication.control import ControlError
from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("control.fleet")

STALE_UNREACHABLE_MS = float("inf")


def _mono_ms() -> float:
    return time.monotonic() * 1000.0


class NotLeader(RuntimeError):
    """Raised by an actuation attempted while not holding the cell —
    the 'refuse to actuate' half of the self-demote rule."""


class _FleetTable:
    """The ``storage.table`` duck the controller reads stamps from."""

    def __init__(self, plane: "FleetControlPlane"):
        self._plane = plane

    @property
    def generation(self) -> int:
        return self._plane.generation

    def row_generation(self, lid: int) -> int:
        return self._plane.row_gens.get(int(lid), 0)


class _FleetSignals:
    """The ``storage.telemetry`` duck: fleet-summed UsageSignals.

    ``staleness_ms`` reports from the most recent observation round
    (one RPC fan-out per tick, not two): the worst member staleness,
    or infinity if any member was unreachable — which is exactly the
    verdict a partition deserves.
    """

    def __init__(self, plane: "FleetControlPlane"):
        self._plane = plane
        self._staleness = 0.0
        self._fetched = False

    def all_signals(self, window_ms: int = 10_000,
                    ) -> Dict[int, UsageSignals]:
        merged: Dict[int, List[float]] = {}
        worst = 0.0
        for name, member in self._plane.members_snapshot():
            try:
                resp = member.signals(int(window_ms))
            except (ControlError, RuntimeError, OSError):
                worst = STALE_UNREACHABLE_MS
                continue
            worst = max(worst, float(resp.get("staleness_ms", 0.0)))
            for lid_s, vals in resp.get("signals", {}).items():
                lid = int(lid_s)
                have = merged.get(lid)
                if have is None:
                    merged[lid] = list(vals)
                else:
                    # Sum counts and rates; keep the widest window.
                    have[1] = max(have[1], vals[1])
                    for i in range(2, len(vals)):
                        have[i] += vals[i]
        self._staleness = worst
        self._fetched = True
        return {lid: UsageSignals(lid, *vals[1:])
                for lid, vals in merged.items()}

    def staleness_ms(self) -> float:
        if not self._fetched:
            self.all_signals(1000)
        return self._staleness


class FleetControlPlane:
    """Storage-shaped facade the AdaptivePolicyController runs on,
    backed by a member set of control-RPC backends
    (:class:`~ratelimiter_tpu_torch.replication.control` op tables, usually
    via :class:`~ratelimiter_tpu_torch.replication.remote.RemoteBackend`).

    Parameters
    ----------
    node : this controller's identity (claims and writes carry it).
    members : ``{name: RemoteBackend-like}`` — the cell's nodes.
    limiters : optional ``{lid: (algo, RateLimitConfig)}`` operator
        ceilings.  Without it the plane adopts ceilings from the
        member rows it converges (a mid-flight successor then treats
        the CURRENT effective policies as ceilings — pass the
        registered specs when the provisioned ceilings matter).
    ttl_ms : controller-lease TTL; renewals must land a majority
        within it ON THIS PLANE'S OWN CLOCK or the plane self-demotes.
    """

    def __init__(self, node: str, members: Dict[str, object], *,
                 limiters: Optional[Dict[int, tuple]] = None,
                 ttl_ms: float = 3000.0,
                 clock_ms: Optional[Callable[[], float]] = None,
                 recorder=None):
        self.node = str(node)
        self._members: Dict[str, object] = dict(members)
        self.ttl_ms = float(ttl_ms)
        self._clock_ms = clock_ms or _mono_ms
        self._lock = threading.RLock()
        # -- leadership state --
        self.epoch = 0
        self.is_leader = False
        self.last_renew_ok_ms = 0.0
        self.elections = 0
        self.demotions = 0
        self.stale_refusals = 0
        self.demote_reason: Optional[str] = None
        # -- policy state (leader's view) --
        self.generation = 0
        self.last_broadcast_generation = 0
        self.row_gens: Dict[int, int] = {}
        self.rows: Dict[str, dict] = {}
        self.node_generations: Dict[str, int] = {}
        self._configs: Dict[int, tuple] = dict(limiters or {})
        self.table = _FleetTable(self)
        self.telemetry = _FleetSignals(self)
        if recorder is not None:
            self._recorder = recorder
        else:
            from ratelimiter_tpu_torch.observability import flight_recorder

            self._recorder = flight_recorder()

    # -- membership ------------------------------------------------------------
    def members_snapshot(self) -> List[tuple]:
        with self._lock:
            return sorted(self._members.items())

    def add_member(self, name: str, backend) -> None:
        with self._lock:
            self._members[str(name)] = backend

    def remove_member(self, name: str) -> None:
        with self._lock:
            self._members.pop(str(name), None)
            self.node_generations.pop(str(name), None)

    def _majority(self) -> int:
        with self._lock:
            return len(self._members) // 2 + 1

    # -- leadership ------------------------------------------------------------
    def observed_epoch(self) -> int:
        """The highest controller epoch any reachable seat holds."""
        best = self.epoch
        for _, member in self.members_snapshot():
            try:
                info = member.policy_info()
            except (ControlError, RuntimeError, OSError):
                continue
            best = max(best, int(info.get("controller", {})
                                 .get("epoch", 0)))
        return best

    def elect(self) -> bool:
        """Claim the cell at ``max(observed epoch) + 1``.  Leadership
        requires a MAJORITY of seats; on success the plane immediately
        anti-entropies every member to one generation (converge)."""
        epoch = self.observed_epoch() + 1
        granted, refused_higher = self._claim_round(epoch)
        if granted < self._majority():
            if refused_higher:
                self.stale_refusals += 1
            return False
        with self._lock:
            self.epoch = epoch
            self.is_leader = True
            self.demote_reason = None
            self.last_renew_ok_ms = self._clock_ms()
            self.elections += 1
        self._recorder.record("control.leader_elected", node=self.node,
                              epoch=epoch)
        self.converge()
        return True

    def _claim_round(self, epoch: int) -> tuple:
        granted = 0
        refused_higher = False
        for _, member in self.members_snapshot():
            try:
                resp = member.controller_claim(self.node, epoch,
                                               self.ttl_ms)
            except (ControlError, RuntimeError, OSError):
                continue
            if resp.get("granted"):
                granted += 1
            elif int(resp.get("epoch", 0)) > epoch:
                refused_higher = True
        return granted, refused_higher

    def renew(self) -> bool:
        """Refresh the majority lease at the held epoch.  A seat
        answering with a HIGHER epoch means we were superseded —
        demote on the spot, exactly like a fenced storage."""
        if not self.is_leader:
            return False
        granted, refused_higher = self._claim_round(self.epoch)
        if refused_higher:
            self.stale_refusals += 1
            self._demote("superseded")
            return False
        if granted >= self._majority():
            with self._lock:
                self.last_renew_ok_ms = self._clock_ms()
            return True
        return False

    def self_check(self) -> bool:
        """The own-clock lease rule: a leader that has not landed a
        majority renewal within ``ttl_ms`` must assume a rival already
        claimed its seats and demote itself — it cannot tell the
        difference, and guessing wrong actuates stale policy."""
        if not self.is_leader:
            return False
        with self._lock:
            expired = (self._clock_ms()
                       - self.last_renew_ok_ms) > self.ttl_ms
        if expired:
            self._demote("lease_expired")
            return False
        return True

    def maintain(self) -> bool:
        """One leadership heartbeat: renew, then self-check."""
        if not self.is_leader:
            return False
        self.renew()
        return self.self_check()

    def _demote(self, reason: str) -> None:
        with self._lock:
            if not self.is_leader:
                return
            self.is_leader = False
            self.demotions += 1
            self.demote_reason = reason
        self._recorder.record("control.leader_demoted", node=self.node,
                              epoch=self.epoch, reason=reason)
        _log.warning("controller %s demoted at epoch %d (%s)",
                     self.node, self.epoch, reason)

    # -- policy broadcast ------------------------------------------------------
    def set_policy(self, lid: int, config: RateLimitConfig) -> int:
        """The controller's actuation surface: stamp the next monotone
        generation and broadcast the row to every member.  Refuses
        (:class:`NotLeader`) unless the plane currently holds the cell
        AND its own-clock lease is fresh."""
        if not self.self_check():
            reason = self.demote_reason or "never elected"
            raise NotLeader(
                f"controller {self.node} does not hold the cell "
                f"(epoch {self.epoch}, {reason}) — refusing to actuate")
        lid = int(lid)
        with self._lock:
            entry = self._configs.get(lid)
            if entry is None:
                raise KeyError(
                    f"no limiter known under lid={lid} — converge() "
                    f"adopts member rows, or pass limiters= ceilings")
            algo = entry[0]
            gen = self.generation + 1
            row = {str(lid): {"algo": algo,
                              "max_permits": int(config.max_permits),
                              "window_ms": int(config.window_ms),
                              "refill_rate": float(config.refill_rate),
                              "gen": gen}}
        self._broadcast(row)
        with self._lock:
            self.generation = gen
            self.last_broadcast_generation = gen
            self.row_gens[lid] = gen
            self.rows.update(row)
        return gen

    def _broadcast(self, rows: Dict[str, dict]) -> None:
        for name, member in self.members_snapshot():
            try:
                resp = member.set_policy_rows(rows, self.epoch,
                                              self.node)
            except (ControlError, RuntimeError, OSError):
                continue  # unreachable: converge() repairs it on join
            if resp.get("stale_epoch"):
                self.stale_refusals += 1
                self._demote("superseded")
                raise NotLeader(
                    f"controller {self.node} epoch {self.epoch} was "
                    f"superseded by epoch {resp.get('epoch')} mid-"
                    f"broadcast — demoted")
            if resp.get("applied") or resp.get("stale_generation"):
                self.node_generations[name] = int(
                    resp.get("generation", 0))

    def converge(self, member_names: Optional[List[str]] = None) -> int:
        """Anti-entropy: adopt the newest member rows as the leader's
        view and push them to every member (or just ``member_names``),
        so the whole cell lands on ONE generation.  Returns it."""
        newest_gen = -1
        newest_lids: Dict = {}
        for name, member in self.members_snapshot():
            try:
                info = member.policy_info()
            except (ControlError, RuntimeError, OSError):
                continue
            self.node_generations[name] = int(info.get("generation", 0))
            if int(info.get("generation", 0)) > newest_gen:
                newest_gen = int(info.get("generation", 0))
                newest_lids = dict(info.get("lids", {}))
        if newest_gen < 0:
            return self.generation
        rows = {}
        for lid_s, row in newest_lids.items():
            rows[lid_s] = {"algo": row["algo"],
                           "max_permits": int(row["max_permits"]),
                           "window_ms": int(row["window_ms"]),
                           "refill_rate": float(row["refill_rate"]),
                           "gen": int(row.get("generation", 0))}
            self.row_gens[int(lid_s)] = int(row.get("generation", 0))
            if int(lid_s) not in self._configs:
                self._configs[int(lid_s)] = (row["algo"], RateLimitConfig(
                    max_permits=int(row["max_permits"]),
                    window_ms=int(row["window_ms"]),
                    refill_rate=float(row["refill_rate"])))
        with self._lock:
            self.generation = max(self.generation, newest_gen)
            self.rows = dict(rows)
        targets = self.members_snapshot()
        if member_names is not None:
            wanted = {str(n) for n in member_names}
            targets = [(n, m) for n, m in targets if n in wanted]
        for name, member in targets:
            try:
                resp = member.set_policy_rows(rows, self.epoch, self.node)
            except (ControlError, RuntimeError, OSError):
                continue
            if not resp.get("stale_epoch"):
                self.node_generations[name] = int(
                    resp.get("generation", 0))
        return self.generation

    # -- introspection ---------------------------------------------------------
    def fleet_status(self) -> Dict:
        """The actuator payload: who leads, at what epoch, the last
        broadcast generation, and every node's applied generation +
        seat (refreshed over RPC; unreachable nodes report null)."""
        nodes: Dict[str, Optional[dict]] = {}
        stale_rejected = 0
        for name, member in self.members_snapshot():
            try:
                info = member.policy_info()
            except (ControlError, RuntimeError, OSError):
                nodes[name] = None
                continue
            seat = info.get("controller", {})
            stale_rejected += int(seat.get("stale_rejected", 0))
            gen = int(info.get("generation", 0))
            self.node_generations[name] = gen
            nodes[name] = {"generation": gen,
                           "epoch": int(seat.get("epoch", 0)),
                           "holder": seat.get("node"),
                           "stale_rejected": int(
                               seat.get("stale_rejected", 0))}
        with self._lock:
            return {
                "node": self.node,
                "is_leader": self.is_leader,
                "epoch": self.epoch,
                "generation": self.generation,
                "last_broadcast_generation": self.last_broadcast_generation,
                "elections": self.elections,
                "demotions": self.demotions,
                "demote_reason": self.demote_reason,
                "stale_refusals": self.stale_refusals,
                "stale_rejected": stale_rejected,
                "nodes": nodes,
            }

    def converged(self) -> bool:
        gens = {g for g in self.node_generations.values()}
        return len(gens) <= 1

    def close(self) -> None:
        for _, member in self.members_snapshot():
            try:
                member.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


class ControllerElection:
    """Leader-death repair, driven by ``tick()``.

    ``candidates`` is an ordered list of :class:`FleetControlPlane`
    instances (usually one per would-be controller host).  Each tick:
    the sitting leader heartbeats (renew + own-clock self-check); if
    NO candidate holds the cell, candidates are tried in order — a
    candidate that cannot reach a majority of seats (it is the
    partitioned one) simply fails its claim round and the next is
    tried.  Election + convergence is timed as ``converge_ms``.

    Quacks like a fleet autopilot (``tick()`` + ``status()``), so a
    node manager's probe cadence can drive it with no extra thread;
    ``start()`` runs a standalone cadence for deployments without one.
    """

    def __init__(self, candidates: List[FleetControlPlane],
                 interval_ms: float = 500.0,
                 registry=None, recorder=None):
        self.candidates = list(candidates)
        self.interval_ms = float(interval_ms)
        self.elections = 0
        self.last_converge_ms: Optional[float] = None
        self._last_stale: Dict[int, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if recorder is not None:
            self._recorder = recorder
        else:
            from ratelimiter_tpu_torch.observability import flight_recorder

            self._recorder = flight_recorder()
        if registry is not None:
            self._m_leader = registry.gauge(
                "ratelimiter.control.leader",
                "1 while a locally managed controller candidate holds "
                "the cell's controller lease (0 = no local leader)")
            self._m_elections = registry.counter(
                "ratelimiter.control.elections",
                "Controller leader elections won by locally managed "
                "candidates (leader death/supersession repairs)")
            self._m_stale = registry.counter(
                "ratelimiter.control.stale_rejected",
                "Stale-epoch controller refusals observed by locally "
                "managed candidates (their claims or policy writes "
                "answered by a seat at a higher epoch)")
            self._m_converge = registry.gauge(
                "ratelimiter.control.converge_ms",
                "Duration of the last election + generation "
                "convergence round (leader death to one fleet-wide "
                "policy generation)")
        else:
            self._m_leader = self._m_elections = None
            self._m_stale = self._m_converge = None

    def leader(self) -> Optional[FleetControlPlane]:
        return next((c for c in self.candidates if c.is_leader), None)

    def tick(self) -> None:
        for cand in self.candidates:
            if cand.is_leader:
                cand.maintain()
        if self.leader() is None:
            for cand in self.candidates:
                t0 = time.monotonic()
                try:
                    won = cand.elect()
                except (ControlError, RuntimeError, OSError):
                    won = False
                if won:
                    self.elections += 1
                    self.last_converge_ms = round(
                        (time.monotonic() - t0) * 1000.0, 3)
                    if self._m_elections is not None:
                        self._m_elections.increment()
                        self._m_converge.set(self.last_converge_ms)
                    self._recorder.record(
                        "control.leader_repaired", node=cand.node,
                        epoch=cand.epoch,
                        converge_ms=self.last_converge_ms)
                    break
        for i, cand in enumerate(self.candidates):
            seen = cand.stale_refusals
            delta = seen - self._last_stale.get(i, 0)
            if delta > 0 and self._m_stale is not None:
                for _ in range(delta):
                    self._m_stale.increment()
            self._last_stale[i] = seen
        if self._m_leader is not None:
            self._m_leader.set(1.0 if self.leader() is not None else 0.0)

    def note_join(self, name: str, backend) -> None:
        """A node joined (fresh standby hand-back, re-seed, promote):
        add it to every candidate's member set and converge it to the
        leader's generation before it can serve a stale one."""
        for cand in self.candidates:
            cand.add_member(name, backend)
        lead = self.leader()
        if lead is not None:
            lead.converge(member_names=[str(name)])

    def status(self) -> dict:
        lead = self.leader()
        return {
            "kind": "controller_election",
            "leader": lead.node if lead is not None else None,
            "epoch": lead.epoch if lead is not None else 0,
            "elections": self.elections,
            "converge_ms": self.last_converge_ms,
            "candidates": [
                {"node": c.node, "is_leader": c.is_leader,
                 "epoch": c.epoch, "demote_reason": c.demote_reason}
                for c in self.candidates
            ],
        }

    # -- standalone cadence (no NodeManager to ride) ---------------------------
    def start(self) -> "ControllerElection":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="controller-election", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_ms / 1000.0):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the repair loop survives
                _log.exception("controller election tick failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self) -> None:
        self.stop()
