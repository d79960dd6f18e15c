"""Server side of token leases: grant / renew / release / revoke
(counterpart of ``ratelimiter_tpu/leases/manager.py``).

The manager bridges the host lease table (leases/table.py) and the
storage's atomic ``lease_reserve``/``lease_credit`` surface
(storage/gpu.py -> ops/lease.py), and owns every policy decision:

- **Grant**: charge up to ``budget`` permits for a key in one device
  reserve.  The kernel bounds the grant by the remaining-window budget
  (sliding window) / current tokens (token bucket), so over-admission
  when a leased client dies is bounded by construction — the same
  per-key "one extra max_permits per window, worst case" bound
  ``storage/degraded.py`` documents.  A key that is ALREADY leased is
  refused (granted 0): one burner per key keeps the bound per-key; the
  second client stays on the per-decision path (the device keeps
  arbitrating contended keys — the lease design goal).
- **TTL**: ``min(ttl_ms, remaining window)`` for the sliding window —
  the charge ages out when the window rolls, so the budget must not
  outlive it; plain ``ttl_ms`` for the token bucket (its charge never
  expires, only refills around it).
- **Renew**: the client reports ``used`` burns; the manager credits the
  unused remainder back to the device and reserves a fresh budget in
  the same call — renewals ride the normal decision path, one wire
  frame per budget instead of one per decision.
- **Fence epochs**: every lease is stamped with the storage's fence
  epoch at grant time.  A renewal whose lease predates the current
  epoch is REVOKED, not honored — a failover promoted a replacement in
  between, and crediting/charging across that boundary would corrupt
  whichever side survived.  The client re-grants against the (possibly
  new) serving backend.  ``FencedError`` from the storage forces the
  same revocation.  Burns reported on a revoked or expired lease are
  counted into ``ratelimiter.lease.over_admission`` — a conservative
  upper bound on permits admitted locally that the serving backend may
  never have seen charged.

Metrics (``ratelimiter.lease.*``): granted / renewed / revoked /
expired counters, ``local_decisions`` (client-reported burns —
decisions that cost ZERO wire frames at decision time), ``over_
admission`` (permits, see above), and an ``outstanding`` gauge.

``record_ops=True`` keeps a replayable log of every reserve/credit with
its device stamp; the chaos drill (storage/chaos.py:
lease_failover_drill) replays it into ``semantics/oracle.py`` and
asserts the device state is bit-identical once renewals drain.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

from ratelimiter_tpu_torch.leases.table import Lease, LeaseTable
from ratelimiter_tpu_torch.storage.errors import FencedError, StorageException
from ratelimiter_tpu_torch.utils.logging import get_logger

log = get_logger("leases.manager")


def _wall_ms() -> int:
    return time.time_ns() // 1_000_000


class LeaseGrant(NamedTuple):
    """What a grant/renew answers: ``granted == 0`` means the key stays
    on the per-decision path for ``ttl_ms`` (retry hint)."""

    granted: int
    ttl_ms: int
    epoch: int


class LeaseManager:
    """Grants, renews, and revokes per-key permit budgets."""

    def __init__(self, storage, *,
                 default_budget: int = 64,
                 max_budget: int = 1024,
                 ttl_ms: float = 2000.0,
                 deny_ttl_ms: float = 25.0,
                 max_leases: int = 65536,
                 clock_ms=None,
                 registry=None,
                 recorder=None,
                 record_ops: bool = False,
                 storm_threshold: int = 8,
                 storm_window_ms: float = 2000.0,
                 max_concurrent: int = 0,
                 max_bulk_budget: int = 0):
        self.storage = storage
        self.default_budget = max(int(default_budget), 1)
        self.max_budget = max(int(max_budget), 1)
        # Aggregate cap for BULK leases (edge aggregators, ARCHITECTURE
        # §14b) — bulk budgets cover many subleased clients, so they may
        # legitimately exceed the per-client max_budget (and the old
        # 65535 wire cap; wire v6 carries them full-width).  0 means
        # "no separate cap": bulk grants clamp like ordinary ones.
        self.max_bulk_budget = max(int(max_bulk_budget), 0)
        self.ttl_ms = float(ttl_ms)
        self.deny_ttl_ms = max(float(deny_ttl_ms), 1.0)
        # TTL accounting rides the table's forward-clamped expiry clock:
        # one observed wall step advances expiry time by at most a few
        # TTLs, so an injected forward clock jump (chaos ``clock_jump``,
        # a bad NTP slew) degrades into a handful of clamped ticks
        # instead of mass-expiring every live lease at once.
        self.table = LeaseTable(
            max_leases=max_leases,
            max_forward_jump_ms=max(10_000, 4 * int(self.ttl_ms)))
        self._clock_ms = (clock_ms
                          or getattr(storage, "_clock_ms", None)
                          or _wall_ms)
        self._lock = threading.RLock()
        self._sweep_tick = 0
        self.ops: List[Tuple] = []   # replay log (record_ops)
        self._record = bool(record_ops)
        # Revocation-storm coalescing: N fence-driven revocations inside
        # the window read as ONE flight event with a tally — after a
        # failover, every outstanding lease revokes at its next renewal,
        # and a post-mortem needs "storm of 412" not 412 ring entries.
        self.storm_threshold = max(int(storm_threshold), 1)
        self.storm_window_ms = float(storm_window_ms)
        self._revoke_times: collections.deque = collections.deque(
            maxlen=max(self.storm_threshold, 64))
        self.revocation_storms = 0
        # Trace lineage ring (observability/telemetry.py), discovered on
        # the serving storage (the router passes through to the primary).
        self._lineage = getattr(storage, "lineage", None)
        if recorder is not None:
            self._recorder = recorder
        else:
            from ratelimiter_tpu_torch.observability import flight_recorder

            self._recorder = flight_recorder()
        if registry is not None:
            mk = registry.counter
            self._m_granted = mk(
                "ratelimiter.lease.granted",
                "Leases granted (fresh per-key budgets charged on device)")
            self._m_renewed = mk(
                "ratelimiter.lease.renewed",
                "Lease renewals served (unused credited, budget re-charged)")
            self._m_revoked = mk(
                "ratelimiter.lease.revoked",
                "Leases revoked (fence-epoch advance, FencedError, or "
                "unknown lease at renewal)")
            self._m_expired = mk(
                "ratelimiter.lease.expired",
                "Leases dropped by TTL expiry")
            self._m_local = mk(
                "ratelimiter.lease.local_decisions",
                "Client-reported decisions burned locally against a lease "
                "(zero wire frames at decision time)")
            self._m_over = mk(
                "ratelimiter.lease.over_admission",
                "Permits burned against revoked/expired leases — "
                "conservative upper bound on admission the serving "
                "backend may not have seen charged")
            self._m_outstanding = registry.gauge(
                "ratelimiter.lease.outstanding",
                "Leases currently outstanding")
        else:
            self._m_granted = self._m_renewed = self._m_revoked = None
            self._m_expired = self._m_local = self._m_over = None
            self._m_outstanding = None
        # Plain counters (drills read them without a registry).
        self.granted_total = 0
        self.renewed_total = 0
        self.revoked_total = 0
        self.expired_total = 0
        self.local_decisions_total = 0
        self.over_admission_total = 0
        # Concurrency slots (control/, ARCHITECTURE §15): per-lid caps
        # on the tenant's aggregate outstanding lease budget — lease
        # grants ARE the slots, so max_concurrent is enforced by the
        # accounting this manager already keeps, no new device surface.
        self._concurrency: dict = {}
        # Fleet-wide default cap (ratelimiter.control.max_concurrent;
        # 0/None = unbounded); per-lid set_concurrency_cap overrides.
        self.default_concurrency = (int(max_concurrent)
                                    if max_concurrent else None)
        self.concurrency_refused_total = 0
        # Policy-generation rebases: renewals whose budget predated a
        # live policy update and was re-reserved under the new rate.
        self.policy_rebased_total = 0

    # -- small helpers ---------------------------------------------------------
    def _algo_cfg(self, lid: int):
        entry = self.storage._configs.get(int(lid))
        if entry is None:
            raise KeyError(f"no limiter registered under lid={lid}")
        return entry  # (algo, config)

    def _epoch(self) -> int:
        fn = getattr(self.storage, "fence_info", None)
        if fn is None:
            return 0
        try:
            return int(fn()["epoch"])
        except Exception:  # noqa: BLE001 — epoch is best-effort metadata
            return 0

    def _scope_epoch(self, lid: int, key: str) -> int:
        """The revocation epoch for THIS key (ARCHITECTURE §14b): a
        storage exposing ``lease_scope_epoch`` scopes fence bumps to the
        shard the key routes to, so a single-shard promotion revokes
        only that shard's leases.  Storages without the surface keep the
        old global-epoch semantics."""
        fn = getattr(self.storage, "lease_scope_epoch", None)
        if fn is None:
            return self._epoch()
        try:
            return int(fn(int(lid), key))
        except Exception:  # noqa: BLE001 — epoch is best-effort metadata
            return self._epoch()

    def _budget_cap(self, bulk: bool) -> int:
        if bulk and self.max_bulk_budget:
            return max(self.max_bulk_budget, self.max_budget)
        return self.max_budget

    def _policy_gen(self, lid: int) -> int:
        """The lid's current policy-row generation (0 when the storage
        has no policy table — e.g. a bare memory backend)."""
        table = getattr(self.storage, "table", None)
        if table is None or not hasattr(table, "row_generation"):
            return 0
        try:
            return int(table.row_generation(int(lid)))
        except Exception:  # noqa: BLE001 — generation is metadata
            return 0

    # -- concurrency slots (control/) ------------------------------------------
    def set_concurrency_cap(self, lid: int, max_concurrent) -> None:
        """Bound one tenant's aggregate outstanding lease budget (lease
        grants as concurrency slots).  ``None`` lifts the cap.  A cap
        cut below the current outstanding budget does not revoke
        anything immediately — each lease shrinks (or is refused) at
        its next renewal, the same lazy convergence policy updates
        use."""
        with self._lock:
            if max_concurrent is None:
                self._concurrency.pop(int(lid), None)
            else:
                self._concurrency[int(lid)] = max(int(max_concurrent), 0)

    def concurrency_caps(self) -> dict:
        with self._lock:
            return dict(self._concurrency)

    def _slot_clamp(self, algo: str, lid: int, req: int,
                    exclude_key=None) -> int:
        """Clamp a grant/renewal request to the tenant's free slots;
        <= 0 means refuse (the key stays on the per-decision path)."""
        cap = self._concurrency.get(int(lid), self.default_concurrency)
        if cap is None:
            return req
        free = cap - self.table.outstanding_budget_for(
            algo, lid, exclude_key=exclude_key)
        return min(req, free)

    def _bump(self, meter, attr: str, n: int = 1) -> None:
        if n <= 0:
            return
        setattr(self, attr, getattr(self, attr) + n)
        if meter is not None:
            meter.add(n)

    def _gauge(self) -> None:
        if self._m_outstanding is not None:
            self._m_outstanding.set(float(self.table.outstanding()))

    def _trace(self, trace_id: int, hop: str, **fields) -> None:
        """One lineage hop under a (forced-sampled) wire trace id."""
        lin = self._lineage
        if lin is not None and trace_id:
            lin.force(trace_id)
            lin.record(trace_id, hop, **fields)

    def _note_fence_revocation(self, now: int, key: str,
                               reason: str) -> None:
        """Record a fence-driven revocation and coalesce bursts: the
        Nth revocation inside the window lands ONE ``lease.
        revocation_storm`` flight event (itself coalesced), so the ring
        shows the fence-epoch bump's blast radius as a tally."""
        self._revoke_times.append(now)
        recent = sum(1 for t in self._revoke_times
                     if now - t <= self.storm_window_ms)
        if recent >= self.storm_threshold:
            self.revocation_storms += 1
            self._recorder.record(
                "lease.revocation_storm",
                coalesce_ms=self.storm_window_ms,
                n_revocations=recent, epoch=self._epoch(), key=key,
                reason=reason)

    def _maybe_sweep(self, now: int) -> None:
        self._sweep_tick += 1
        if self._sweep_tick % 256:
            return
        for lease in self.table.sweep_expired(now):
            self._bump(self._m_expired, "expired_total")
            self._recorder.record("lease.expired", coalesce_ms=1000.0,
                                  key=lease.key)

    def _credit(self, lease: Lease, unused: int) -> None:
        """Best-effort device credit of unused budget (kernel drops a
        rolled-window credit safely)."""
        if unused <= 0:
            return
        out = self.storage.lease_credit(
            lease.algo, lease.lid, lease.key, int(unused), lease.ws)
        # stamp == 0 marks a fail-closed router answer (no device op ran)
        # — recording it would corrupt an oracle replay.
        if self._record and out.get("stamp", 0) > 0:
            self.ops.append(("credit", lease.algo, lease.lid, lease.key,
                             int(unused), lease.ws, out["stamp"]))

    # -- the lease protocol ----------------------------------------------------
    def grant(self, lid: int, key: str, requested: int = 0,
              trace_id: int = 0, bulk: bool = False) -> LeaseGrant:
        """Grant a fresh per-key budget.  ``granted == 0`` (with a retry
        hint in ``ttl_ms``) when the key is already leased, the budget
        is exhausted, the table is full, or the storage is fenced.
        ``trace_id`` threads the grant into the lineage ring.  ``bulk``
        marks an edge-aggregator portfolio lease: the budget is an
        aggregate and clamps against ``max_bulk_budget``."""
        with self._lock:
            algo, cfg = self._algo_cfg(lid)
            now = self.table.clamp_forward(int(self._clock_ms()))
            self._maybe_sweep(now)
            self._trace(trace_id, "lease.grant", key=key,
                        requested=int(requested))
            scope_epoch = self._scope_epoch(lid, key)
            existing = self.table.get(algo, lid, key)
            if existing is not None:
                if existing.expired(now):
                    self.table.pop(algo, lid, key)
                    self._bump(self._m_expired, "expired_total")
                    self._recorder.record("lease.expired",
                                          coalesce_ms=1000.0, key=key)
                elif scope_epoch > existing.epoch:
                    # The holder's lease predates a fence bump on this
                    # key's shard: its charge lives (at best) on the
                    # replaced backend.  Revoke it NOW so a re-granted
                    # aggregator takes the key over immediately instead
                    # of waiting out the dead holder's TTL; the dead
                    # holder's eventual renewal lands "unknown_lease"
                    # and its burns count into over_admission as usual.
                    self.table.pop(algo, lid, key)
                    self._bump(self._m_revoked, "revoked_total")
                    self._recorder.record("lease.revoked", key=key,
                                          reason="fence_epoch_grant",
                                          coalesce_ms=200.0)
                    self._note_fence_revocation(now, key,
                                                "fence_epoch_grant")
                else:
                    # One burner per key: the second client stays on the
                    # per-decision path (the device arbitrates contended
                    # keys).
                    return LeaseGrant(0, int(self.deny_ttl_ms),
                                      existing.epoch)
            req = int(requested) or self.default_budget
            req = max(1, min(req, self._budget_cap(bulk),
                             cfg.max_permits))
            req = self._slot_clamp(algo, lid, req)
            if req <= 0:
                # Concurrency slots exhausted: the tenant's outstanding
                # lease budget is at max_concurrent — refuse, the key
                # stays on the per-decision path until slots free up.
                self.concurrency_refused_total += 1
                return LeaseGrant(0, int(self.deny_ttl_ms), self._epoch())
            self._trace(trace_id, "batcher", op="flush+reserve")
            try:
                out = self.storage.lease_reserve(algo, lid, key, req)
            except FencedError:
                self._bump(self._m_revoked, "revoked_total")
                return LeaseGrant(0, int(self.deny_ttl_ms), self._epoch())
            except StorageException:
                return LeaseGrant(0, int(self.deny_ttl_ms), self._epoch())
            if self._record and out.get("stamp", 0) > 0:
                self.ops.append(("reserve", algo, lid, key, req,
                                 out["granted"], out["ws"], out["stamp"]))
            granted = int(out["granted"])
            self._trace(trace_id, "shard", path="lease_reserve",
                        granted=granted, stamp=int(out.get("stamp", 0)))
            epoch = self._scope_epoch(lid, key)
            if granted <= 0:
                return LeaseGrant(0, int(self.deny_ttl_ms), epoch)
            ttl = self._ttl_for(algo, cfg, out["stamp"])
            lease = Lease(algo=algo, lid=int(lid), key=key, budget=granted,
                          ws=int(out["ws"]), epoch=epoch,
                          deadline_ms=now + ttl, granted_total=granted,
                          policy_gen=self._policy_gen(lid), bulk=bulk)
            if not self.table.put(lease):
                # Table full: undo the charge and refuse — bounded state.
                self._credit(lease, granted)
                return LeaseGrant(0, int(self.deny_ttl_ms), epoch)
            self._bump(self._m_granted, "granted_total")
            self._recorder.record("lease.granted", coalesce_ms=1000.0,
                                  key=key, granted=granted)
            self._trace(trace_id, "resolve", granted=granted, ttl_ms=ttl,
                        epoch=epoch)
            self._gauge()
            return LeaseGrant(granted, ttl, epoch)

    def renew(self, lid: int, key: str, used: int,
              requested: int = 0,
              trace_id: int = 0,
              epoch: Optional[int] = None) -> Optional[LeaseGrant]:
        """Renew: report ``used`` burns, credit the unused remainder,
        charge a fresh budget.  Returns ``None`` when the lease was
        REVOKED (fence epoch advanced, storage fenced, or unknown
        lease) — the client must re-grant before burning again.

        ``epoch`` (when given) names the lease INSTANCE the report
        belongs to: an edge aggregator flushing burns for a revoked
        bulk lease may race a successor grant on the same key, and
        without the check those burns would fold into the successor's
        accounting.  A report whose epoch predates the live lease's is
        counted straight into ``over_admission`` — the dead instance's
        burns — and the live lease is left untouched.  The check is
        exact for fence-driven revocations (the epoch always advanced);
        a TTL-expired instance whose successor carries the SAME epoch
        folds into the successor — conservative (the successor's next
        renewal credits less, never more)."""
        with self._lock:
            algo, cfg = self._algo_cfg(lid)
            now = self.table.clamp_forward(int(self._clock_ms()))
            used = max(int(used), 0)
            self._bump(self._m_local, "local_decisions_total", used)
            # The client leg of the lineage: burns since the last wire
            # op ran client-side with ZERO frames — this hop is where
            # they become visible server-side.
            self._trace(trace_id, "client", local_burns=used, key=key)
            self._trace(trace_id, "lease.renew", key=key)
            lease = self.table.get(algo, lid, key)
            if lease is None:
                # Swept/never granted: those burns ran against a lease
                # this table no longer vouches for.
                self._bump(self._m_over, "over_admission_total", used)
                self._bump(self._m_revoked, "revoked_total")
                self._recorder.record("lease.revoked", key=key,
                                      reason="unknown_lease",
                                      coalesce_ms=200.0)
                return None
            if epoch is not None and int(epoch) != lease.epoch:
                # Stale lease-instance report (ARCHITECTURE §14b): the
                # reporter's lease died and the key was already
                # re-granted.  The burns ran against the DEAD
                # instance's (unreclaimed) reservation, so they are
                # over-admission — never the successor's usage.
                self._bump(self._m_over, "over_admission_total", used)
                self._recorder.record("lease.revoked", key=key,
                                      reason="stale_epoch_report",
                                      coalesce_ms=200.0)
                return None
            lease.used_total += used
            cur_epoch = self._scope_epoch(lid, key)
            if cur_epoch > lease.epoch:
                # Failover promoted a replacement since the grant: the
                # charge lives (at best) on the old backend, so neither
                # credit nor honor — revoke, client re-grants against
                # whatever serves now.  Burns since the last report are
                # the (bounded) over-admission window.
                self.table.pop(algo, lid, key)
                self._bump(self._m_revoked, "revoked_total")
                self._bump(self._m_over, "over_admission_total", used)
                self._recorder.record("lease.revoked", key=key,
                                      reason="fence_epoch",
                                      coalesce_ms=200.0)
                self._note_fence_revocation(now, key, "fence_epoch")
                self._gauge()
                return None
            unused = max(lease.budget - used, 0)
            if lease.expired(now):
                self.table.pop(algo, lid, key)
                self._bump(self._m_expired, "expired_total")
                self._bump(self._m_over, "over_admission_total", used)
                self._recorder.record("lease.expired", coalesce_ms=1000.0,
                                      key=key)
                try:
                    self._credit(lease, unused)
                except (FencedError, StorageException):
                    pass
                self._gauge()
                return None
            req = int(requested) or lease.budget
            req = max(1, min(req, self._budget_cap(lease.bulk),
                             cfg.max_permits))
            cur_gen = self._policy_gen(lid)
            if cur_gen > lease.policy_gen:
                # A live policy update landed since the last charge: the
                # re-reserve below runs against the NEW device rate and
                # the clamp above already used the new config — count
                # the rebase so drills can assert the budget turnover.
                self.policy_rebased_total += 1
            req = self._slot_clamp(algo, lid, req, exclude_key=key)
            if req <= 0:
                # The tenant's concurrency cap shrank below this lease:
                # credit the unused budget back and revoke to the
                # per-decision path (the lazy convergence contract).
                self.concurrency_refused_total += 1
                self.table.pop(algo, lid, key)
                try:
                    self._credit(lease, unused)
                except (FencedError, StorageException):
                    pass
                self._gauge()
                return LeaseGrant(0, int(self.deny_ttl_ms), cur_epoch)
            self._trace(trace_id, "batcher", op="credit+reserve")
            try:
                self._credit(lease, unused)
                out = self.storage.lease_reserve(algo, lid, key, req)
            except FencedError:
                self.table.pop(algo, lid, key)
                self._bump(self._m_revoked, "revoked_total")
                self._recorder.record("lease.revoked", key=key,
                                      reason="fenced", coalesce_ms=200.0)
                self._note_fence_revocation(now, key, "fenced")
                self._gauge()
                return None
            except StorageException:
                self.table.pop(algo, lid, key)
                self._gauge()
                return LeaseGrant(0, int(self.deny_ttl_ms), cur_epoch)
            if self._record and out.get("stamp", 0) > 0:
                self.ops.append(("reserve", algo, lid, key, req,
                                 out["granted"], out["ws"], out["stamp"]))
            granted = int(out["granted"])
            self._trace(trace_id, "shard", path="lease_reserve",
                        granted=granted, stamp=int(out.get("stamp", 0)))
            if granted <= 0:
                self.table.pop(algo, lid, key)
                self._gauge()
                return LeaseGrant(0, int(self.deny_ttl_ms), cur_epoch)
            ttl = self._ttl_for(algo, cfg, out["stamp"])
            lease.budget = granted
            lease.ws = int(out["ws"])
            lease.policy_gen = cur_gen
            lease.epoch = self._scope_epoch(lid, key)
            lease.deadline_ms = now + ttl
            lease.granted_total += granted
            lease.renewals += 1
            self._bump(self._m_renewed, "renewed_total")
            self._trace(trace_id, "resolve", granted=granted, ttl_ms=ttl,
                        epoch=lease.epoch)
            return LeaseGrant(granted, ttl, lease.epoch)

    def release(self, lid: int, key: str, used: int,
                trace_id: int = 0) -> None:
        """Close a lease: report final burns and credit the remainder."""
        with self._lock:
            algo, _cfg = self._algo_cfg(lid)
            used = max(int(used), 0)
            self._bump(self._m_local, "local_decisions_total", used)
            self._trace(trace_id, "client", local_burns=used, key=key)
            self._trace(trace_id, "lease.release", key=key)
            lease = self.table.pop(algo, lid, key)
            if lease is None:
                return
            lease.used_total += used
            self._recorder.record("lease.released", coalesce_ms=1000.0,
                                  key=key)
            if self._scope_epoch(lid, key) > lease.epoch:
                self._bump(self._m_over, "over_admission_total", used)
                self._gauge()
                return
            try:
                self._credit(lease, max(lease.budget - used, 0))
            except (FencedError, StorageException):
                pass
            self._gauge()

    def telemetry_report(self, blob: bytes) -> int:
        """Fold one client burn report into the storage's fleet
        telemetry plane (the in-process leg of the TELEMETRY op —
        ``DirectTransport`` calls this).  Returns the record count, -1
        on a malformed blob, or -1 when the storage carries no plane."""
        plane = getattr(self.storage, "telemetry", None)
        if plane is None:
            return -1
        return plane.fold(blob)

    def _ttl_for(self, algo: str, cfg, stamp: int) -> int:
        """Sliding window: the charge ages out when the window rolls, so
        the lease must not outlive it.  Token bucket: plain ttl_ms."""
        if algo == "sw":
            remaining = cfg.window_ms - (int(stamp) % cfg.window_ms)
            return max(1, min(int(self.ttl_ms), int(remaining)))
        return max(1, int(self.ttl_ms))

    # -- introspection ---------------------------------------------------------
    def status(self) -> dict:
        return {
            "outstanding": self.table.outstanding(),
            "outstanding_budget": self.table.outstanding_budget(),
            "granted": self.granted_total,
            "renewed": self.renewed_total,
            "revoked": self.revoked_total,
            "expired": self.expired_total,
            "local_decisions": self.local_decisions_total,
            "over_admission": self.over_admission_total,
            "revocation_storms": self.revocation_storms,
            "concurrency_refused": self.concurrency_refused_total,
            "policy_rebased": self.policy_rebased_total,
            "concurrency_caps": self.concurrency_caps(),
        }
