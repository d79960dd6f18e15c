"""The edge aggregator: bulk leases in, subleases out (counterpart of
``ratelimiter_tpu/edge/aggregator.py``).

One :class:`EdgeAggregator` fronts many lease clients.  Per hot
``(lid, key)`` it holds ONE bulk lease from the core (a
:class:`~ratelimiter_tpu_torch.leases.sublease.BulkPool`) and slices it to
clients via per-client :class:`EdgeSession` objects — a sublease grant
or renewal is a dict lookup and two integer moves, zero wire frames.
The aggregator's only upstream traffic is:

- one bulk LEASE frame when a pool is first (re-)created, and
- one ``OP_BULK_RENEW`` columnar frame per lid per flush interval,
  renewing the whole portfolio (used counts reported, budgets
  re-charged) in a single round trip.

Nesting invariant (ARCHITECTURE §14b, asserted by tests/test_edge.py):
every pool conserves ``remaining + sliced_out + used_pending ==
budget + deficit``, so the aggregator can never admit more than its
bulk budgets between flushes, and the fleet over-admission when an
aggregator dies mid-burn is bounded by the sum of its bulk budgets —
the same shape of bound the core documents per client lease, one tier
up.

Revocation is scoped: when a flush answer marks a pool revoked (the
core's ``lease_scope_epoch`` advanced for that key's shard), only that
pool dies — its clients re-grant at the new epoch on their next renew,
and burns they report against the dead pool are folded into
``used_pending`` and flushed upstream once more, where the core counts
them into ``lease.over_admission`` exactly as a direct client's
post-fence burns.  Pools on surviving shards are untouched.

``EdgeSession`` is intentionally bilingual: it implements BOTH the
manager duck-type (``grant``/``renew``/``release`` returning
``LeaseGrant``/``None`` — what ``service/sidecar.py`` dispatches lease
frames to) and the transport duck-type (``lease_grant``/
``lease_renew``/``lease_release``/``try_acquire``/
``telemetry_report`` — what ``LeaseClient`` burns against), so the
aggregator drops in on either side of the wire.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ratelimiter_tpu_torch.leases.manager import LeaseGrant
from ratelimiter_tpu_torch.leases.sublease import BulkPool, PoolKey, Sublease
from ratelimiter_tpu_torch.utils.logging import get_logger

log = get_logger("edge.aggregator")


def _wall_ms() -> int:
    return time.time_ns() // 1_000_000


class EdgeAggregator:
    """Subleases bulk budgets to clients; renews them in bulk."""

    def __init__(self, upstream, *,
                 bulk_budget: int = 4096,
                 slice_budget: int = 64,
                 flush_ms: float = 50.0,
                 deny_ttl_ms: float = 25.0,
                 clock_ms=None,
                 registry=None,
                 name: str = "edge"):
        self.upstream = upstream
        self.bulk_budget = max(int(bulk_budget), 1)
        self.slice_budget = max(int(slice_budget), 1)
        self.flush_ms = float(flush_ms)
        self.deny_ttl_ms = max(float(deny_ttl_ms), 1.0)
        self.name = name
        self._clock_ms = clock_ms or _wall_ms
        self._lock = threading.RLock()
        self._pools: Dict[PoolKey, BulkPool] = {}
        # Revoked/expired pools still owed a flush (used_pending) or
        # holding client slices that have not folded back yet.
        self._dead: List[BulkPool] = []
        self._deny_until: Dict[PoolKey, int] = {}
        self._next_sid = 0
        self._last_flush = int(self._clock_ms())
        # Plain counters (drills and the bench read them directly).
        self.upstream_frames = 0       # wire frames sent upstream
        self.bulk_renewals_total = 0   # portfolio flush frames
        self.scoped_revocations_total = 0
        self.over_admission_total = 0  # burns folded on dead bulk leases
        self.slices_granted_total = 0
        self.local_renewals_total = 0  # sublease renewals, zero frames
        if registry is not None:
            self._m_aggs = registry.gauge(
                "ratelimiter.edge.aggregators",
                "Edge aggregators live in this process")
            self._m_subs = registry.gauge(
                "ratelimiter.edge.subleases",
                "Client subleases currently outstanding across pools")
            self._m_renewals = registry.counter(
                "ratelimiter.edge.bulk_renewals",
                "Bulk portfolio renewal frames sent upstream (one "
                "columnar OP_BULK_RENEW per lid per flush)")
            self._m_revoked = registry.counter(
                "ratelimiter.edge.scoped_revocations",
                "Bulk leases revoked by a scoped fence-epoch advance "
                "(only pools routing to the promoted shard)")
            self._m_over = registry.counter(
                "ratelimiter.edge.over_admission",
                "Permits burned against revoked bulk leases — the "
                "aggregator-tier over-admission, reported upstream and "
                "bounded by the revoked pools' bulk budgets")
            self._m_aggs.set(1.0)
        else:
            self._m_aggs = self._m_subs = None
            self._m_renewals = self._m_revoked = self._m_over = None

    # -- sessions --------------------------------------------------------------
    def session(self, session_id: Optional[int] = None) -> "EdgeSession":
        """A per-client identity: each connection/client gets its own
        sublease bookkeeping (one slice per (lid, key) per session)."""
        with self._lock:
            if session_id is None:
                self._next_sid += 1
                session_id = self._next_sid
            return EdgeSession(self, int(session_id))

    # -- pools -----------------------------------------------------------------
    def _gauge_subs(self) -> None:
        if self._m_subs is not None:
            n = sum(len(p.subs) for p in self._pools.values())
            n += sum(len(p.subs) for p in self._dead)
            self._m_subs.set(float(n))

    def _retire_pool(self, pool: BulkPool, *, revoked: bool) -> None:
        """Move a pool out of service: revoked pools count toward the
        scoped-revocation tally; either way the carcass stays on the
        dead list until its clients have folded back and its pending
        burns have flushed."""
        self._pools.pop((pool.lid, pool.key), None)
        pool.revoked = True
        if revoked:
            self.scoped_revocations_total += 1
            if self._m_revoked is not None:
                self._m_revoked.add(1)
        if pool.used_pending or pool.subs:
            self._dead.append(pool)

    def _ensure_pool(self, lid: int, key: str,
                     now: int) -> Optional[BulkPool]:
        """The live pool for (lid, key), taking a fresh bulk lease
        upstream (ONE frame, amortized over every sublease it will
        back) when none is held.  None while in deny cooldown or when
        the core refuses the bulk grant."""
        k = (int(lid), key)
        pool = self._pools.get(k)
        if pool is not None:
            if not pool.revoked and not pool.expired(now):
                return pool
            # TTL lapsed before a flush renewed it: the core may have
            # swept the lease, so nothing this pool vouches for is
            # trustworthy — retire it (not a scoped revocation) and
            # re-grant below.
            self._retire_pool(pool, revoked=False)
        if now < self._deny_until.get(k, 0):
            return None
        self.upstream_frames += 1
        resp = self.upstream.lease_grant(lid, key, self.bulk_budget,
                                         bulk=True)
        if resp is None or int(resp[0]) <= 0:
            ttl = int(resp[1]) if resp is not None else self.deny_ttl_ms
            self._deny_until[k] = now + max(int(ttl), 1)
            return None
        granted, ttl, epoch = int(resp[0]), int(resp[1]), int(resp[2])
        pool = BulkPool(lid=int(lid), key=key, budget=granted,
                        remaining=granted, epoch=epoch,
                        deadline_ms=now + max(ttl, 1),
                        granted_total=granted)
        self._pools[k] = pool
        self._deny_until.pop(k, None)
        return pool

    # -- the portfolio flush ---------------------------------------------------
    def maybe_flush(self, now: Optional[int] = None) -> None:
        now = int(self._clock_ms()) if now is None else int(now)
        if now - self._last_flush >= self.flush_ms:
            self.flush(now)

    def flush(self, now: Optional[int] = None) -> int:
        """Renew the whole bulk portfolio: ONE columnar frame per lid
        covering every live pool (used reported, budget re-charged,
        TTL re-armed) plus one last row for each dead pool still owed
        a burn report.  Returns the number of upstream frames sent."""
        with self._lock:
            now = int(self._clock_ms()) if now is None else int(now)
            self._last_flush = now
            by_lid: Dict[int, List[BulkPool]] = {}
            for pool in self._pools.values():
                by_lid.setdefault(pool.lid, []).append(pool)
            for pool in self._dead:
                if pool.used_pending > 0:
                    by_lid.setdefault(pool.lid, []).append(pool)
            frames = 0
            bulk_fn = getattr(self.upstream, "lease_bulk_renew", None)
            for lid, pools in sorted(by_lid.items()):
                keys = [p.key for p in pools]
                used = [int(p.used_pending) for p in pools]
                req = [0 if p.revoked else self.bulk_budget
                       for p in pools]
                # Each row names its lease INSTANCE: a dead pool's burn
                # report must land in over_admission even when a
                # successor bulk lease already lives on the same key.
                eps = [int(p.epoch) for p in pools]
                if bulk_fn is not None:
                    rows = bulk_fn(lid, keys, used, req, eps)
                    self.upstream_frames += 1
                    frames += 1
                else:
                    rows = []
                    for key, u, r in zip(keys, used, req):
                        resp = self.upstream.lease_renew(lid, key, u, r)
                        self.upstream_frames += 1
                        frames += 1
                        rows.append((0, 0, 0, True) if resp is None
                                    else (int(resp[0]), int(resp[1]),
                                          int(resp[2]), False))
                self.bulk_renewals_total += 1
                if self._m_renewals is not None:
                    self._m_renewals.add(1)
                for pool, sent, row in zip(pools, used, rows):
                    granted, ttl, epoch, revoked = row
                    if pool.revoked:
                        # Dead pool's final burn report landed (the
                        # core counted it into lease.over_admission).
                        pool.used_pending = max(
                            pool.used_pending - sent, 0)
                        continue
                    if revoked or int(granted) <= 0:
                        # Scoped fence advance (or the core closed the
                        # lease): the reported burns were already
                        # counted upstream; clients re-grant at the
                        # new epoch on their next renew.
                        pool.used_pending = max(
                            pool.used_pending - sent, 0)
                        self._retire_pool(pool, revoked=bool(revoked))
                        continue
                    pool.apply_renewal(int(granted), int(ttl),
                                       int(epoch), now, sent)
            self._dead = [p for p in self._dead
                          if p.used_pending > 0 or p.subs]
            self._gauge_subs()
            return frames

    # -- lifecycle -------------------------------------------------------------
    def drop(self) -> dict:
        """Simulate an aggregator crash (the chaos drill's kill):
        abandon every pool and sublease WITHOUT flushing.  Returns the
        outstanding exposure so the drill can assert the bound: burns
        after death stay within the sum of the dropped bulk budgets."""
        with self._lock:
            out = {
                "pools": len(self._pools),
                "bulk_budget": sum(p.budget
                                   for p in self._pools.values()),
                "sliced_out": sum(p.sliced_out
                                  for p in self._pools.values()),
                "used_pending": sum(p.used_pending
                                    for p in self._pools.values()),
                "subleases": sum(len(p.subs)
                                 for p in self._pools.values()),
            }
            self._pools.clear()
            self._dead = []
            self._deny_until.clear()
            self._gauge_subs()
            return out

    def release_all(self) -> None:
        """Graceful shutdown: flush the final burn report, then release
        every live bulk lease.  Unreturned client slices are counted as
        used (conservative — their burn status is unknowable), so the
        core's view stays an upper bound."""
        with self._lock:
            self.flush()
            for pool in list(self._pools.values()):
                used = min(pool.budget,
                           pool.used_pending + pool.sliced_out)
                self.upstream_frames += 1
                try:
                    self.upstream.lease_release(pool.lid, pool.key,
                                                int(used))
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
            self._pools.clear()
            self._dead = []
            self._gauge_subs()
            if self._m_aggs is not None:
                self._m_aggs.set(0.0)

    close = release_all

    # -- introspection ---------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "pools": len(self._pools),
                "dead_pools": len(self._dead),
                "subleases": sum(len(p.subs)
                                 for p in self._pools.values()),
                "bulk_budget": sum(p.budget
                                   for p in self._pools.values()),
                "sliced_out": sum(p.sliced_out
                                  for p in self._pools.values()),
                "used_pending": sum(p.used_pending
                                    for p in self._pools.values()),
                "upstream_frames": self.upstream_frames,
                "bulk_renewals": self.bulk_renewals_total,
                "scoped_revocations": self.scoped_revocations_total,
                "over_admission": self.over_admission_total,
                "slices_granted": self.slices_granted_total,
                "local_renewals": self.local_renewals_total,
            }


class EdgeSession:
    """One client's identity at the aggregator (see module docstring
    for the dual duck-type contract)."""

    def __init__(self, agg: EdgeAggregator, sid: int):
        self._agg = agg
        self.sid = int(sid)
        # key -> the pool this session's slice was cut from (may be a
        # retired pool the client has not re-granted past yet).
        self._subs: Dict[PoolKey, BulkPool] = {}

    # -- manager duck-type (sidecar dispatch) ----------------------------------
    def grant(self, lid: int, key: str, requested: int = 0,
              trace_id: int = 0, bulk: bool = False) -> LeaseGrant:
        agg = self._agg
        with agg._lock:
            now = int(agg._clock_ms())
            agg.maybe_flush(now)
            k = (int(lid), key)
            old = self._subs.get(k)
            pool = agg._ensure_pool(lid, key, now)
            if old is not None and old is not pool:
                # The session's previous slice came from a pool that
                # has since been retired: the client lost track of it,
                # so fold it conservatively (counts as burned).
                sub = old.drop_sub(self.sid)
                if sub is not None:
                    old.fold_lost(sub)
                del self._subs[k]
            if pool is None:
                return LeaseGrant(0, int(agg.deny_ttl_ms), 0)
            req = int(requested) or agg.slice_budget
            req = max(1, min(req, agg.slice_budget))
            sub = pool.slice(self.sid, req)
            if sub.amount <= 0:
                # Pool dry: one portfolio flush may refill it (the
                # core credits+re-charges in the same call).
                agg.flush(now)
                if not pool.revoked:
                    pool.top_up(sub, req)
            if sub.amount <= 0:
                pool.drop_sub(self.sid)
                return LeaseGrant(0, int(agg.deny_ttl_ms), pool.epoch)
            self._subs[k] = pool
            agg.slices_granted_total += 1
            agg._gauge_subs()
            ttl = max(1, pool.deadline_ms - now)
            return LeaseGrant(sub.amount, ttl, pool.epoch)

    def renew(self, lid: int, key: str, used: int, requested: int = 0,
              trace_id: int = 0) -> Optional[LeaseGrant]:
        agg = self._agg
        with agg._lock:
            now = int(agg._clock_ms())
            agg.maybe_flush(now)
            k = (int(lid), key)
            used = max(int(used), 0)
            pool = self._subs.get(k)
            if pool is None:
                # Burns against a sublease this aggregator never saw
                # (restart, session churn): conserve them — fold into
                # the live pool's pending report if one exists.
                live = agg._pools.get(k)
                if used and live is not None:
                    live.fold_over_report(used)
                return None
            sub = pool.subs.get(self.sid)
            if sub is None:
                del self._subs[k]
                return None
            if pool.revoked or pool.expired(now):
                # The bulk lease died under this slice: fold the burns
                # (they flush upstream once more, where the core counts
                # them into lease.over_admission) and send the client
                # back to re-grant at the new epoch.
                pool.fold_used(sub, used)
                pool.drop_sub(self.sid)
                del self._subs[k]
                agg.over_admission_total += used
                if agg._m_over is not None:
                    agg._m_over.add(used)
                if not pool.revoked:
                    agg._retire_pool(pool, revoked=False)
                agg._gauge_subs()
                return None
            pool.fold_used(sub, used)
            pool.return_unused(sub)
            req = int(requested) or agg.slice_budget
            req = max(1, min(req, agg.slice_budget))
            amt = pool.top_up(sub, req)
            if amt <= 0:
                agg.flush(now)
                if pool.revoked:
                    pool.drop_sub(self.sid)
                    del self._subs[k]
                    agg._gauge_subs()
                    return None
                amt = pool.top_up(sub, req)
            agg.local_renewals_total += 1
            if amt <= 0:
                return LeaseGrant(0, int(agg.deny_ttl_ms), pool.epoch)
            ttl = max(1, pool.deadline_ms - now)
            return LeaseGrant(amt, ttl, pool.epoch)

    def release(self, lid: int, key: str, used: int,
                trace_id: int = 0) -> None:
        agg = self._agg
        with agg._lock:
            k = (int(lid), key)
            used = max(int(used), 0)
            pool = self._subs.pop(k, None)
            if pool is None:
                return
            sub = pool.drop_sub(self.sid)
            if sub is None:
                return
            pool.fold_used(sub, used)
            if pool.revoked:
                agg.over_admission_total += used
                if agg._m_over is not None:
                    agg._m_over.add(used)
            else:
                pool.return_unused(sub)
            agg._gauge_subs()

    # -- transport duck-type (LeaseClient-facing) ------------------------------
    def lease_grant(self, lid: int, key: str, requested: int,
                    trace_id: int = 0, bulk: bool = False):
        return self.grant(lid, key, requested, trace_id=trace_id)

    def lease_renew(self, lid: int, key: str, used: int,
                    requested: int = 0, trace_id: int = 0):
        return self.renew(lid, key, used, requested, trace_id=trace_id)

    def lease_release(self, lid: int, key: str, used: int,
                      trace_id: int = 0) -> None:
        self.release(lid, key, used, trace_id=trace_id)

    def try_acquire(self, lid: int, key: str, permits: int = 1,
                    trace_id: int = 0) -> bool:
        """Per-decision fallback: forwarded upstream (one frame) — the
        core's device keeps arbitrating keys the aggregator holds no
        budget for."""
        agg = self._agg
        agg.upstream_frames += 1
        return bool(agg.upstream.try_acquire(lid, key, permits))

    def telemetry_report(self, blob: bytes) -> bool:
        fn = getattr(self._agg.upstream, "telemetry_report", None)
        if fn is None:
            return False
        out = fn(blob)
        return bool(out) if not isinstance(out, int) else out >= 0
