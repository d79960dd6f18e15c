"""Self-healing failover (counterpart of
``ratelimiter_tpu/replication/orchestrator.py``): the control-plane loop
that automates the one-shard-of-N promotion mechanism.

``shard_failover_drill`` proved the *mechanism* — kill one shard,
promote its standby, decisions bit-identical to the oracle — but a
human had to notice the failure and drive ``promote`` + the router
install.  At "millions of users" scale that window is an outage
("Designing Scalable Rate Limiting Systems" treats automated failover
as table stakes).  "When Two is Worse Than One" names exactly how the
naive automation fails: a false-positive health verdict promotes a
second primary next to a live one (uncoordinated over-admission), and a
flapping fault promotes/demotes in a loop.  So the orchestrator is an
explicit state machine with *fencing* and *hysteresis*, not a health
poll wired to promote():

    MONITORING ──consecutive probe failures──► SUSPECT
    SUSPECT ──probe heals──► MONITORING            (false_alarms += 1)
    SUSPECT ──still failing past hysteresis──► FENCING
    FENCING: bump the monotonic fencing epoch, install it on the
        storage being replaced (``GpuBatchedStorage.fence`` — its
        dispatch paths refuse with the typed ``FencedError``), fail the
        shard closed in the router, drop its replication stream
    FENCING ──► PROMOTING: drive ``StandbyReceiver.promote`` + router
        install with bounded retry/backoff; a failed promotion falls
        back to the next standby candidate or fails the shard closed
    PROMOTING ──promoted──► RESTORED: re-seed a FRESH standby for the
        promoted replica via a flat replication stream bootstrapped by
        a FULL frame — the system returns to N+1 standby coverage
    RESTORED ──fresh standby consistent──► MONITORING
    PROMOTING ──candidates exhausted──► FAILED (shard stays fail-closed
        until an operator intervenes; flight event records why)

Two safety rules fall out of the papers:

- **A transient blip never promotes.**  SUSPECT needs
  ``suspect_threshold`` *consecutive* probe failures to enter and must
  persist for ``hysteresis_ms`` before FENCING; a fault that heals
  inside the window increments ``false_alarms`` and nothing else.
- **A promotion never races the thing it replaces.**  The fence epoch
  is bumped and installed *before* ``promote`` runs, so a zombie
  primary's racing dispatches are refused with ``FencedError`` — and a
  promoted ``StandbyReceiver`` refuses late frames, closing the
  replication-side half of the same race.

The loop itself is single-threaded and tick-driven: ``tick()`` advances
every shard's state machine once (drills call it with a controlled
clock for deterministic timelines), ``start()`` runs it on a cadence
thread.  Re-seed replication streams are also driven from ``tick`` —
no hidden threads, so a drill's timeline is exact.

Metrics: ``ratelimiter.orchestrator.state`` (most-degraded shard state,
coded 0..5), ``.promotions``, ``.false_alarms``, ``.fence_rejected``
(decisions refused by fences this orchestrator installed), ``.reseeds``.
Flight events: one ``orchestrator.transition`` per state change (with
``shard``, ``from``/``to``), plus ``orchestrator.false_alarm``,
``orchestrator.standby_stale``, ``orchestrator.failed_closed``.
The in-process wiring (``ratelimiter.orchestrator.*``) needs the sharded
engine and stays refused (service/wiring.py: ``UNPORTED_TIERS``); the
cross-host topology drives this machine over
``replication/remote.py``'s directory (storage/chaos.py:
``cross_host_failover_drill``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("replication.orchestrator")

MONITORING = "MONITORING"
SUSPECT = "SUSPECT"
FENCING = "FENCING"
PROMOTING = "PROMOTING"
RESTORED = "RESTORED"
FAILED = "FAILED"

# Gauge encoding: higher = more degraded; the exported gauge is the max
# over shards so a dashboard threshold on >0 catches any activity.
STATE_CODE = {MONITORING: 0, SUSPECT: 1, FENCING: 2, PROMOTING: 3,
              RESTORED: 4, FAILED: 5}


@dataclasses.dataclass(frozen=True)
class OrchestratorConfig:
    """Knobs, mirrored 1:1 by the ``ratelimiter.orchestrator.*`` props."""

    probe_interval_ms: float = 100.0
    # Consecutive probe failures before a shard turns SUSPECT.
    suspect_threshold: int = 3
    # A SUSPECT shard must stay failing this long before FENCING — the
    # flap damper: heal inside the window and nothing was promoted.
    hysteresis_ms: float = 500.0
    # Bounded promote retry/backoff per standby candidate.
    promote_retries: int = 3
    promote_backoff_ms: float = 50.0
    # Re-seed a fresh standby after promotion (N+1 restoration).
    reseed: bool = True
    # Distributed fence lease (the cross-host topology, hostproc.py):
    # when > 0, the orchestrator grants each serving backend an epoch
    # lease of this TTL and renews it while probes answer — a primary
    # partitioned from the orchestrator (and from the standby-relayed
    # renewal path) SELF-FENCES within one TTL, which bounds the zombie's
    # over-admission without quorum machinery.  0 keeps process-local
    # fencing (single-host topologies never pay).  Pick a TTL at
    # or above detection_budget_ms: a shorter one can expire a healthy
    # primary's lease during an ordinary flap-damped hysteresis window.
    fence_lease_ttl_ms: float = 0.0
    # Slack added when waiting out an unreachable zombie's lease before
    # promoting (covers grant-delivery latency; clocks are not assumed
    # synchronized — the wait runs entirely on the orchestrator's clock
    # from its own last-grant timestamp).
    fence_wait_slack_ms: float = 100.0

    @property
    def detection_budget_ms(self) -> float:
        """Upper bound on kill -> FENCING under on-schedule probes: the
        suspect threshold's probes plus the hysteresis window plus one
        probe interval of phase slack.  The drill asserts against it."""
        return (self.suspect_threshold + 1) * self.probe_interval_ms \
            + self.hysteresis_ms


class BackendLeaseChannel:
    """Serving-lease channel over a backend object held in-process (a
    local storage, or a replication/remote.py:RemoteBackend proxying a
    control port).  No relay leg — pair with a FanoutLeaseChannel
    (replication/remote.py) when a standby mailbox exists."""

    def __init__(self, backend):
        self.backend = backend

    def grant(self, epoch: int, ttl_ms: float) -> None:
        self.backend.grant_serving_lease(int(epoch), float(ttl_ms))


class _ShardWatch:
    """Per-shard state-machine bookkeeping."""

    __slots__ = ("state", "since", "since_wall_ms", "consecutive",
                 "probe_failures", "suspect_since", "promote_attempts",
                 "candidate_idx", "last_error", "lease_granted_at",
                 "fence_wait_until")

    def __init__(self, now: float):
        self.state = MONITORING
        self.since = now
        self.since_wall_ms = time.time_ns() // 1_000_000
        self.consecutive = 0
        self.probe_failures = 0
        self.suspect_since = 0.0
        self.promote_attempts = 0
        self.candidate_idx = 0
        self.last_error: Optional[str] = None
        # Orchestrator-clock stamp of the newest serving-lease grant (or
        # relay deposit) this shard's backend may hold — the FENCING wait
        # for an unreachable zombie runs from here.
        self.lease_granted_at = now
        # FENCING holds until this orchestrator-clock time (0 = no wait:
        # the explicit fence landed, or leases are off).
        self.fence_wait_until = 0.0


class FailoverOrchestrator:
    """Watches per-shard liveness; fences, promotes, and re-seeds.

    Parameters
    ----------
    router : ShardFailoverRouter over the sharded primary.
    standby_set : ShardStandbySet (the mesh the replicator feeds).
    replicator : ShardedReplicator shipping the per-shard streams (the
        orchestrator drops a shard's stream before promoting it, and
        reads per-shard link state to tell "standby gone" from
        "standby slow").
    standby_factory : zero-arg callable building one fresh flat standby
        storage of ``slots_per_shard`` geometry (the re-seed source).
        ``None`` disables re-seeding regardless of config.
    probe : ``probe(shard) -> bool`` liveness verdict.  Defaults to
        router shard health + the serving backend's ``is_available``.
        Drills inject deterministic probes.
    spares : optional ``{shard: [StandbyReceiver, ...]}`` fallback
        candidates tried (in order) when the primary standby's
        promotion fails.
    clock : monotonic-seconds source (injectable for deterministic
        drills); ``sleep`` likewise (promote backoff).
    """

    def __init__(self, router, standby_set, replicator,
                 standby_factory: Optional[Callable[[], object]] = None,
                 config: Optional[OrchestratorConfig] = None,
                 probe: Optional[Callable[[int], bool]] = None,
                 spares: Optional[Dict[int, List[object]]] = None,
                 lease_channels: Optional[Dict[int, object]] = None,
                 witness: Optional[Callable[[int], str]] = None,
                 witness_fresh_ms: Optional[float] = None,
                 repl_heartbeat_ms: Optional[float] = None,
                 registry=None, recorder=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.router = router
        self.standby_set = standby_set
        self.replicator = replicator
        self.standby_factory = standby_factory
        self.cfg = config or OrchestratorConfig()
        self._probe = probe or self._default_probe
        self._spares = {int(q): list(v) for q, v in (spares or {}).items()}
        # Serving-lease channels (cfg.fence_lease_ttl_ms > 0): per-shard
        # objects with ``grant(epoch, ttl_ms)`` (direct to the serving
        # backend) and optionally ``deposit(epoch, ttl_ms)`` (park the
        # grant at the shard's standby for the primary to fetch over the
        # replication-side path — replication/control.py:LeaseMailbox).
        self._lease_channels = dict(lease_channels or {})
        # Second witness (cross-host): ``witness(q)`` answers "alive" /
        # "dead" / "unknown" from a vantage point OTHER than the
        # orchestrator's own probe link — in the reference topology, the
        # shard's standby reporting how recently the primary's
        # replication frames/heartbeats landed.  "alive" VETOES fencing:
        # a primary the orchestrator cannot reach but the standby can is
        # partitioned-from-the-orchestrator, not dead, and replacing it
        # is exactly the two-primaries trap.  None (default): the probe
        # verdict alone drives the state machine.
        self._witness = witness
        self._clock = clock
        self._sleep = sleep
        self.n_shards = int(router.n_shards)
        now = clock()
        self._watch = [_ShardWatch(now) for _ in range(self.n_shards)]
        self.fence_epoch = 0
        self.promotions = 0
        self.false_alarms = 0
        self.reseeds = 0
        self.failed_closed = 0
        self.witness_vetoes = 0
        self.leases_granted = 0
        # Storages this orchestrator fenced (their rejected counts roll
        # up into the fence_rejected gauge) and per-shard re-seed
        # replication streams (flat Replicator, driven from tick()).
        self._fenced_storages: List[object] = []
        self._reseed_repl: Dict[int, object] = {}
        self._last_ship_errors = [0] * self.n_shards
        self._tick_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if recorder is not None:
            self._recorder = recorder
        else:
            from ratelimiter_tpu_torch.observability import flight_recorder

            self._recorder = flight_recorder()
        if registry is not None:
            self._m_state = registry.gauge(
                "ratelimiter.orchestrator.state",
                "Most-degraded shard state (0 MONITORING, 1 SUSPECT, "
                "2 FENCING, 3 PROMOTING, 4 RESTORED, 5 FAILED)")
            self._m_promotions = registry.counter(
                "ratelimiter.orchestrator.promotions",
                "Automatic standby promotions executed")
            self._m_false = registry.counter(
                "ratelimiter.orchestrator.false_alarms",
                "SUSPECT shards that healed inside the hysteresis "
                "window (no promotion)")
            self._m_fence_rej = registry.gauge(
                "ratelimiter.orchestrator.fence_rejected",
                "Decisions refused (FencedError) by fences this "
                "orchestrator installed")
            self._m_reseeds = registry.counter(
                "ratelimiter.orchestrator.reseeds",
                "Fresh standbys re-seeded after a promotion (back to "
                "N+1)")
            self._m_vetoes = registry.counter(
                "ratelimiter.orchestrator.witness_vetoes",
                "Fencings vetoed by the standby witness (primary "
                "partitioned from the orchestrator, not dead)")
        else:
            self._m_state = self._m_promotions = None
            self._m_false = self._m_fence_rej = self._m_reseeds = None
            self._m_vetoes = None
        self._validate_timing(witness_fresh_ms, repl_heartbeat_ms)

    def _validate_timing(self, witness_fresh_ms: Optional[float],
                         repl_heartbeat_ms: Optional[float]) -> None:
        """Warn-at-construction for the two silent misconfigurations
        the cross-host drills keep tripping over:
        a ``witness_fresh_ms`` outside (replication heartbeat interval,
        detection budget) makes the second witness either read idle
        gaps as death or veto a real one, and a fence lease shorter
        than the detection budget can expire a HEALTHY primary's lease
        inside an ordinary flap-damped hysteresis window.  Both are
        tuning hazards, not contract violations — warn loudly (log +
        flight event), never raise."""
        budget = self.cfg.detection_budget_ms

        def _warn(problem: str, **fields) -> None:
            _log.warning("orchestrator misconfiguration: %s (%s)",
                         problem,
                         ", ".join(f"{k}={v}" for k, v in fields.items()))
            self._recorder.record("orchestrator.misconfigured",
                                  problem=problem, **fields)

        if witness_fresh_ms is not None:
            fresh = float(witness_fresh_ms)
            if repl_heartbeat_ms is not None \
                    and fresh <= float(repl_heartbeat_ms):
                _warn("witness_fresh_ms at or under the replication "
                      "heartbeat interval — idle replication gaps will "
                      "read as primary death and the witness can never "
                      "veto",
                      witness_fresh_ms=fresh,
                      repl_heartbeat_ms=float(repl_heartbeat_ms))
            if fresh >= budget:
                _warn("witness_fresh_ms at or past the detection "
                      "budget — a really-dead primary's last heartbeat "
                      "still reads fresh when FENCING is due, vetoing "
                      "the first fencing attempt",
                      witness_fresh_ms=fresh,
                      detection_budget_ms=budget)
        ttl = float(self.cfg.fence_lease_ttl_ms)
        if 0.0 < ttl < budget:
            _warn("fence_lease_ttl_ms under the detection budget — a "
                  "healthy primary's serving lease can expire during "
                  "an ordinary flap-damped hysteresis window",
                  fence_lease_ttl_ms=ttl, detection_budget_ms=budget)

    # -- probes ----------------------------------------------------------------
    def _default_probe(self, q: int) -> bool:
        """Non-blocking liveness verdict for one shard.

        The probe must never serialize with the decision pipeline — a
        device sync on a busy sharded primary waits out every in-flight
        dispatch, which turns "probing" into "stalling".  So the primary
        is judged by signals that are already being produced: router shard
        health, and the per-shard replication stream's ship errors
        (a dead shard's row gather fails the next cut).  A promoted
        FLAT replacement has no sharded stream, so it gets the direct
        availability round-trip — it is the serving device for those
        keys, and a probe against a healthy flat engine is cheap.
        Deployments with richer signals (breaker failure streaks, lag
        SLOs, external health checks) inject their own ``probe``.
        """
        if self.router.shard_health().get(q) == "failed":
            return False
        backend = self.router._backend(q)
        if backend is None:
            return False
        if backend is not self.router.primary:
            try:
                return bool(backend.is_available())
            except Exception:  # noqa: BLE001 — erroring probe = failure
                return False
        if self.replicator is not None:
            errs = int(self.replicator.shard_errors[q])
            grew = errs > self._last_ship_errors[q]
            self._last_ship_errors[q] = errs
            if grew:
                return False
        return True

    def standby_ok(self, q: int) -> bool:
        """Is shard q's standby promotable?  Folds the receiver's
        consistency with the replication link's liveness verdict — a
        DEAD link means the replica is STALE ("standby gone"), and
        promoting onto it silently loses every epoch since the link
        died, which is worse than staying fail-closed."""
        rx = self.standby_set.receivers[q]
        if rx.promoted or not rx.consistent:
            return False
        if self.replicator is not None \
                and self.replicator.shard_link_state(q) == "dead":
            return False
        return True

    # -- state machine ---------------------------------------------------------
    def _transition(self, q: int, to: str, **fields) -> None:
        w = self._watch[q]
        if w.state == to:
            return
        self._recorder.record("orchestrator.transition", shard=q,
                              **{"from": w.state, "to": to}, **fields)
        _log.info("orchestrator shard %d: %s -> %s %s", q, w.state, to,
                  fields or "")
        w.state = to
        w.since = self._clock()
        w.since_wall_ms = time.time_ns() // 1_000_000

    def tick(self) -> None:
        """Advance every shard's state machine once (one probe round)."""
        with self._tick_lock:
            now = self._clock()
            for q in range(self.n_shards):
                try:
                    self._tick_shard(q, now)
                except Exception as exc:  # noqa: BLE001 — loop survives
                    self._watch[q].last_error = str(exc)[:200]
                    _log.warning("orchestrator tick failed for shard %d: "
                                 "%s", q, exc)
            self._export_metrics()

    def _tick_shard(self, q: int, now: float) -> None:
        w = self._watch[q]
        if w.state == MONITORING:
            self._drive_reseed_stream(q)
            if self._probe(q):
                w.consecutive = 0
                self._lease_grant(q)
                return
            w.consecutive += 1
            w.probe_failures += 1
            self._lease_relay(q)
            if w.consecutive >= self.cfg.suspect_threshold:
                w.suspect_since = now
                self._transition(q, SUSPECT,
                                 consecutive=w.consecutive)
        elif w.state == SUSPECT:
            if self._probe(q):
                # Healed inside the window: flap damped, nothing
                # promoted, nothing fenced.
                w.consecutive = 0
                self.false_alarms += 1
                if self._m_false is not None:
                    self._m_false.increment()
                self._recorder.record("orchestrator.false_alarm", shard=q,
                                      suspect_ms=round(
                                          (now - w.suspect_since) * 1000, 1))
                self._lease_grant(q)
                self._transition(q, MONITORING)
                return
            w.consecutive += 1
            w.probe_failures += 1
            self._lease_relay(q)
            if (now - w.suspect_since) * 1000.0 >= self.cfg.hysteresis_ms:
                if self._witness_alive(q):
                    # Second witness overrules the probe: the primary's
                    # replication heartbeats still land at its standby,
                    # so it is partitioned FROM US, not dead.  Fencing
                    # or promoting now would raise a second primary next
                    # to a live one — hold, keep its lease relayed.
                    self.witness_vetoes += 1
                    if self._m_vetoes is not None:
                        self._m_vetoes.increment()
                    self._recorder.record("orchestrator.witness_veto",
                                          shard=q)
                    w.consecutive = 0
                    self._transition(q, MONITORING)
                    return
                self._transition(q, FENCING)
                self._fence(q)
                self._maybe_enter_promoting(q, now)
        elif w.state == FENCING:
            # Waiting out an unreachable zombie's serving lease before
            # installing its replacement (the explicit fence RPC could
            # not be delivered — the lease expiry IS the fence).
            self._maybe_enter_promoting(q, now)
        elif w.state == PROMOTING:
            self._try_promote(q)
        elif w.state == RESTORED:
            self._drive_reseed_stream(q)
            rx = self.standby_set.receivers[q]
            if rx.consistent and not rx.promoted:
                self.reseeds += 1
                if self._m_reseeds is not None:
                    self._m_reseeds.increment()
                self._recorder.record("orchestrator.reseeded", shard=q,
                                      epoch=rx.last_epoch)
                self._transition(q, MONITORING)
        # FAILED is terminal until an operator intervenes: auto-
        # unfencing a shard the machine already declared dead twice
        # is exactly the two-primaries trap.

    # -- serving leases (the distributed fence; cfg.fence_lease_ttl_ms) --------
    def _lease_grant(self, q: int, epoch: Optional[int] = None) -> None:
        """Renew shard q's serving lease: direct grant to the serving
        backend plus (when the channel supports it) a relay deposit at
        the shard's standby.  Epoch = current fence generation + 1, so a
        replacement promoted after any future fence always carries a
        strictly higher epoch than every lease granted before it."""
        ch = self._lease_channels.get(q)
        if ch is None or self.cfg.fence_lease_ttl_ms <= 0:
            return
        ttl = self.cfg.fence_lease_ttl_ms
        ep = int(self.fence_epoch + 1 if epoch is None else epoch)
        ok = False
        try:
            ch.grant(ep, ttl)
            ok = True
        except Exception as exc:  # noqa: BLE001 — a failed renewal is
            # exactly what the lease is for; the backend runs down.
            self._watch[q].last_error = str(exc)[:200]
        dep = getattr(ch, "deposit", None)
        if dep is not None:
            try:
                dep(ep, ttl)
                ok = True
            except Exception:  # noqa: BLE001 — relay is best-effort
                pass
        if ok:
            self._watch[q].lease_granted_at = self._clock()
            self.leases_granted += 1

    def _lease_relay(self, q: int) -> None:
        """Probe failed but the shard may still be alive (partition on
        OUR link): while the standby witness vouches for it, keep its
        lease renewed through the relay mailbox only — the primary
        fetches it over the replication-side path it still has.  Without
        a witness (or with a dead/unknown verdict) nothing is renewed
        and the lease runs down toward self-fence."""
        ch = self._lease_channels.get(q)
        if ch is None or self.cfg.fence_lease_ttl_ms <= 0:
            return
        dep = getattr(ch, "deposit", None)
        if dep is None or not self._witness_alive(q):
            return
        try:
            dep(int(self.fence_epoch + 1), self.cfg.fence_lease_ttl_ms)
            self._watch[q].lease_granted_at = self._clock()
            self.leases_granted += 1
        except Exception:  # noqa: BLE001 — relay is best-effort
            pass

    def _witness_alive(self, q: int) -> bool:
        if self._witness is None:
            return False
        try:
            return self._witness(q) == "alive"
        except Exception:  # noqa: BLE001 — an erroring witness proves
            # nothing; only a positive "alive" vetoes.
            return False

    def _maybe_enter_promoting(self, q: int, now: float) -> None:
        """Leave FENCING for PROMOTING once it is SAFE: immediately when
        the explicit fence landed, otherwise only after the zombie's
        last-granted serving lease has provably expired (orchestrator
        clock, from our own grant stamp, plus slack)."""
        w = self._watch[q]
        if now < w.fence_wait_until:
            return
        w.promote_attempts = 0
        w.candidate_idx = 0
        self._transition(q, PROMOTING)
        self._try_promote(q)

    # -- FENCING ---------------------------------------------------------------
    def _fence(self, q: int) -> None:
        """Bump the monotonic fencing epoch and install it on whatever
        currently serves shard q, THEN fail the shard closed in the
        router and drop its replication stream.  Order matters: once
        this returns, no path — routed or direct — admits traffic for
        q's keys on the old backend."""
        self.fence_epoch += 1
        old = self.router.replacements.get(q)
        installed = False
        try:
            if old is not None:
                # A previously-promoted flat replacement died: fence the
                # whole flat storage.
                old.fence(self.fence_epoch)
                self._fenced_storages.append(old)
            else:
                # First failover of this shard: scope the fence to q on
                # the shard's primary — survivors keep serving.  A
                # cross-host directory resolves per-shard backends via
                # ``shard_primary`` (each is wholly one shard, so the
                # scoping is a no-op there); the in-process router keeps
                # the single sharded primary.
                prim = (self.router.shard_primary(q)
                        if hasattr(self.router, "shard_primary")
                        else self.router.primary)
                prim.fence(self.fence_epoch, shards=(q,))
                if prim not in self._fenced_storages:
                    self._fenced_storages.append(prim)
            installed = True
        except Exception as exc:  # noqa: BLE001 — a dead or PARTITIONED
            # primary may refuse (or never receive) the fence call; the
            # router's fail-closed deny still bounds routed admission,
            # and with serving leases on, the zombie's own lease expiry
            # bounds its direct admission (the wait below).
            _log.warning("fence install on shard %d backend failed: %s",
                         q, exc)
        w = self._watch[q]
        w.fence_wait_until = 0.0
        if not installed and self.cfg.fence_lease_ttl_ms > 0:
            # The fence RPC could not be delivered: the zombie's serving
            # lease IS the fence.  Hold PROMOTING until every grant we
            # (or our relay deposits) issued has provably expired —
            # measured on OUR clock from OUR last-grant stamp, so no
            # cross-host clock agreement is assumed.
            w.fence_wait_until = w.lease_granted_at + (
                self.cfg.fence_lease_ttl_ms
                + self.cfg.fence_wait_slack_ms) / 1000.0
            self._recorder.record(
                "orchestrator.fence_wait", shard=q,
                wait_ms=round(max(
                    w.fence_wait_until - self._clock(), 0.0) * 1000.0, 1))
        self.router.fail_shard(q)
        if self.replicator is not None:
            # Stop shipping into the standby we are about to promote —
            # and quiesce q's re-seed stream if this is a re-kill.
            repl = self._reseed_repl.pop(q, None)
            if repl is not None:
                try:
                    repl.stop()
                    repl.log.detach()
                except Exception:  # noqa: BLE001 — best effort
                    pass
            self.replicator.drop_shard(q)
        self._recorder.record("orchestrator.fenced", shard=q,
                              epoch=self.fence_epoch)

    # -- PROMOTING -------------------------------------------------------------
    def _candidates(self, q: int):
        return [self.standby_set.receivers[q]] + self._spares.get(q, [])

    def _try_promote(self, q: int) -> None:
        w = self._watch[q]
        candidates = self._candidates(q)
        while w.candidate_idx < len(candidates):
            rx = candidates[w.candidate_idx]
            if w.candidate_idx == 0 and not self.standby_ok(q):
                # Primary standby is stale (gapped stream or dead link):
                # promoting onto it loses epochs — skip to spares.
                self._recorder.record("orchestrator.standby_stale",
                                      shard=q)
                w.candidate_idx += 1
                continue
            for attempt in range(self.cfg.promote_retries + 1):
                try:
                    promoted = rx.promote()
                except Exception as exc:  # noqa: BLE001 — bounded retry
                    w.last_error = str(exc)[:200]
                    from ratelimiter_tpu_torch.storage.errors import (
                        PromotionInProgressError,
                    )

                    if isinstance(exc, PromotionInProgressError):
                        # A manual promote is racing us and will win (or
                        # fail); retry next tick rather than burning the
                        # backoff budget against a held lock.
                        return
                    if getattr(rx, "promoted", False):
                        # A concurrent manual promote already won on this
                        # receiver: exactly one promotion ran — adopt its
                        # result and finish the install ourselves.
                        promoted = rx.storage
                    else:
                        if attempt < self.cfg.promote_retries:
                            self._sleep(self.cfg.promote_backoff_ms
                                        * (2 ** attempt) / 1000.0)
                        continue
                self.router.install_replacement(q, promoted)
                self.promotions += 1
                if self._m_promotions is not None:
                    self._m_promotions.increment()
                self._recorder.record("orchestrator.promoted", shard=q,
                                      epoch=rx.last_epoch,
                                      fence_epoch=self.fence_epoch)
                self._lease_adopt(q, promoted)
                if self.cfg.reseed and self.standby_factory is not None:
                    self._transition(q, RESTORED)
                    self._start_reseed(q, promoted)
                else:
                    self._transition(q, MONITORING)
                self._watch[q].consecutive = 0
                return
            w.candidate_idx += 1  # this candidate is exhausted
        # Every candidate failed: the shard fails closed (bounded
        # under-admission — router keeps denying) until an operator
        # intervenes.
        self.failed_closed += 1
        self._recorder.record("orchestrator.failed_closed", shard=q,
                              error=w.last_error)
        self._transition(q, FAILED)

    def _lease_adopt(self, q: int, backend) -> None:
        """A replacement now serves shard q: hand it a fresh serving
        lease at a STRICTLY higher epoch than every lease the zombie
        ever held (fence_epoch was bumped in _fence, so +1 is past the
        zombie's generation), and point q's lease channel at it so the
        MONITORING renewals flow to the right process."""
        if self.cfg.fence_lease_ttl_ms <= 0 \
                or q not in self._lease_channels:
            return
        grant = getattr(backend, "grant_serving_lease", None)
        if grant is None:
            return
        try:
            grant(self.fence_epoch + 1, self.cfg.fence_lease_ttl_ms)
            self._lease_channels[q] = BackendLeaseChannel(backend)
            self._watch[q].lease_granted_at = self._clock()
            self.leases_granted += 1
        except Exception as exc:  # noqa: BLE001 — the next MONITORING
            # tick retries through the (now swapped or original) channel
            _log.warning("serving-lease grant to shard %d replacement "
                         "failed: %s", q, exc)

    # -- RESTORED (re-seed) ----------------------------------------------------
    def _start_reseed(self, q: int, promoted_storage) -> None:
        """Attach a flat replication stream to the promoted storage and
        point it at a FRESH standby; the first cut ships a FULL frame
        (flat-log bootstrap), returning shard q to N+1 coverage.  The
        stream is driven from tick() — no hidden thread."""
        from ratelimiter_tpu_torch.replication.log import ReplicationLog
        from ratelimiter_tpu_torch.replication.replicator import Replicator
        from ratelimiter_tpu_torch.replication.standby import StandbyReceiver
        from ratelimiter_tpu_torch.replication.transport import InProcessSink

        fresh = self.standby_factory()
        rx = StandbyReceiver(fresh)
        repl = Replicator(ReplicationLog(promoted_storage),
                          InProcessSink(rx))
        self._reseed_repl[q] = repl
        self.standby_set.replace(q, fresh, rx)

    def _drive_reseed_stream(self, q: int) -> None:
        repl = self._reseed_repl.get(q)
        if repl is not None:
            try:
                repl.ship_now()
            except Exception as exc:  # noqa: BLE001 — stream survives
                _log.warning("re-seed ship for shard %d failed: %s", q, exc)

    # -- operator unfence (the exit from terminal FAILED) ----------------------
    def unfence(self, q: int) -> Dict:
        """Recover a terminal ``FAILED`` shard: the operator has verified
        the primary's shard is actually healthy (the kill was a false
        positive, or the fault was repaired in place), so lift the
        fence(s) covering shard ``q``, repair the router back to the
        primary, replace the shard's standby with a fresh one, resume
        its replication stream (FULL re-baseline), and reset the watch
        to MONITORING.  Exposed at ``POST /actuator/orchestrator/
        unfence`` — previously this state was only recoverable from a
        Python shell (``lift_fence`` + manual router surgery).

        Refused (``ValueError``) unless the shard is FAILED: auto-unlike
        paths out of any live state would reopen the two-primaries trap
        this machine exists to close."""
        q = int(q)
        with self._tick_lock:
            w = self._watch[q]
            if w.state != FAILED:
                raise ValueError(
                    f"shard {q} is {w.state}, not FAILED; unfence is the "
                    "operator exit from the terminal state only")
            for storage in self._fenced_storages:
                try:
                    info = storage.fence_info()
                    if info["all"]:
                        storage.lift_fence(info["epoch"])
                    elif q in set(info["shards"]):
                        storage.lift_fence(info["epoch"], shards=(q,))
                except Exception as exc:  # noqa: BLE001 — best effort:
                    # a truly-dead backend may refuse even the lift; the
                    # router repair below still restores routing.
                    _log.warning("unfence: lift on a fenced backend "
                                 "failed for shard %d: %s", q, exc)
            self.router.repair_shard(q)
            # Restore N+1 coverage: fresh standby + resumed stream
            # (the fence dropped this shard's stream; its old standby
            # may be promoted, stale, or mid-failed-promotion).
            if self.standby_factory is not None \
                    and self.replicator is not None:
                from ratelimiter_tpu_torch.replication.standby import (
                    StandbyReceiver,
                )
                from ratelimiter_tpu_torch.replication.transport import (
                    InProcessSink,
                )

                fresh = self.standby_factory()
                rx = StandbyReceiver(fresh)
                self.standby_set.replace(q, fresh, rx)
                self.replicator.restore_shard(q, sink=InProcessSink(rx))
            w.consecutive = 0
            w.candidate_idx = 0
            w.promote_attempts = 0
            w.last_error = None
            w.fence_wait_until = 0.0
            self._transition(q, MONITORING)
            # Re-arm the repaired primary's serving lease (its old one
            # is void — self-fenced or explicitly fenced — and lift_fence
            # above cleared the fence, so a fresh generation re-enables
            # the expiry bound before traffic routes back).
            prim = (self.router.shard_primary(q)
                    if hasattr(self.router, "shard_primary")
                    else self.router.primary)
            if self.cfg.fence_lease_ttl_ms > 0 \
                    and q in self._lease_channels:
                self._lease_channels[q] = BackendLeaseChannel(prim)
                self._lease_grant(q)
            self._recorder.record("orchestrator.unfenced", shard=q,
                                  epoch=self.fence_epoch)
            self._export_metrics()
            return {"shard": q, "state": MONITORING,
                    "fence_epoch": self.fence_epoch}

    def set_lease_channel(self, q: int, channel) -> None:
        """Swap shard ``q``'s serving-lease channel (the fleet
        autopilot re-points the relay leg at a freshly re-seeded
        standby's mailbox after an automated replacement)."""
        with self._tick_lock:
            self._lease_channels[int(q)] = channel

    # -- metrics / status ------------------------------------------------------
    def _export_metrics(self) -> None:
        if self._m_state is not None:
            self._m_state.set(float(max(
                STATE_CODE[w.state] for w in self._watch)))
        if self._m_fence_rej is not None:
            self._m_fence_rej.set(float(self.total_fence_rejected()))

    def total_fence_rejected(self) -> int:
        return sum(int(getattr(s, "fence_rejected", 0))
                   for s in self._fenced_storages)

    def status(self) -> Dict:
        now = self._clock()
        return {
            "fence_epoch": self.fence_epoch,
            "promotions": self.promotions,
            "false_alarms": self.false_alarms,
            "reseeds": self.reseeds,
            "failed_closed": self.failed_closed,
            "witness_vetoes": self.witness_vetoes,
            "leases_granted": self.leases_granted,
            "fence_rejected": self.total_fence_rejected(),
            "config": dataclasses.asdict(self.cfg),
            "shards": {
                q: {
                    "state": w.state,
                    "since_ms": w.since_wall_ms,
                    "in_state_ms": round((now - w.since) * 1000.0, 3),
                    "consecutive_failures": w.consecutive,
                    "probe_failures": w.probe_failures,
                    "last_error": w.last_error,
                }
                for q, w in enumerate(self._watch)
            },
        }

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "FailoverOrchestrator":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="failover-orchestrator", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.probe_interval_ms / 1000.0):
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — loop survives
                _log.warning("orchestrator tick failed: %s", exc)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._stop.clear()

    def close(self) -> None:
        self.stop()
        for repl in self._reseed_repl.values():
            try:
                repl.close()
            except Exception:  # noqa: BLE001 — best effort
                pass
        self._reseed_repl.clear()
