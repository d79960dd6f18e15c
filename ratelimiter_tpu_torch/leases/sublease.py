"""Sublease accounting: how an edge aggregator nests client slices
inside one bulk lease (ARCHITECTURE §14b; counterpart of
``ratelimiter_tpu/leases/sublease.py``).

A :class:`BulkPool` is the aggregator-side mirror of ONE bulk lease on
``(lid, key)``: the core granted it an aggregate ``budget`` (leases/
manager.py, ``bulk=True``), and the pool hands out :class:`Sublease`
slices to clients at memory speed.  Permits are conserved — every
permit in the pool is in exactly one of three places::

    remaining + sliced_out + used_pending == budget + deficit

- ``remaining``     unsliced permits the pool can still hand out
- ``sliced_out``    permits in clients' hands, burns not yet reported
- ``used_pending``  burns reported by clients, not yet flushed upstream
- ``deficit``       transient over-hang after a SHRINKING renewal
                    (the core re-granted less than what is already
                    sliced out); returns from clients pay it down
                    before anything re-enters ``remaining``

The nesting invariant the property tests assert (tests/test_edge.py):
``sliced_out + remaining <= budget + deficit`` with ``deficit == 0``
whenever renewals are not shrinking — so the aggregator can never admit
more than its bulk budget between flushes, and fleet over-admission
when an aggregator dies is bounded by the sum of its bulk budgets,
exactly the per-key bound the core already documents.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class Sublease:
    """One client's slice of a bulk pool."""

    session_id: int
    amount: int          # unreported permits this client may still burn
    granted_total: int = 0
    used_total: int = 0


@dataclasses.dataclass
class BulkPool:
    """Aggregator-side state of one bulk lease on ``(lid, key)``."""

    lid: int
    key: str
    budget: int          # aggregate granted by the core's LAST renewal
    remaining: int       # unsliced permits
    epoch: int           # scoped fence epoch stamped by the core
    deadline_ms: int     # bulk-lease TTL deadline (aggregator clock)
    sliced_out: int = 0
    used_pending: int = 0
    deficit: int = 0
    revoked: bool = False
    granted_total: int = 0
    renewals: int = 0
    subs: Dict[int, Sublease] = dataclasses.field(default_factory=dict)

    def expired(self, now_ms: int) -> bool:
        return now_ms >= self.deadline_ms

    def outstanding(self) -> int:
        """Permits the aggregator can admit without another upstream
        frame — the quantity the nesting invariant bounds by the bulk
        budget (plus any transient shrink deficit)."""
        return self.remaining + self.sliced_out

    def check_conservation(self) -> None:
        assert (self.remaining + self.sliced_out + self.used_pending
                == self.budget + self.deficit), (
            f"pool ({self.lid},{self.key!r}) conservation broken: "
            f"rem={self.remaining} out={self.sliced_out} "
            f"pending={self.used_pending} budget={self.budget} "
            f"deficit={self.deficit}")

    # -- slice lifecycle -------------------------------------------------------
    def slice(self, session_id: int, requested: int) -> Sublease:
        """Hand ``requested`` permits (clamped to ``remaining``) to a
        session.  A session that already holds a slice gets it FOLDED
        conservatively first (see :meth:`fold_lost`) — a re-granting
        client lost track of its old slice, and unreported permits must
        count as burned, never silently returned."""
        old = self.subs.get(session_id)
        if old is not None:
            self.fold_lost(old)
        amt = max(0, min(int(requested), self.remaining))
        self.remaining -= amt
        self.sliced_out += amt
        sub = Sublease(session_id=session_id, amount=amt,
                       granted_total=amt)
        self.subs[session_id] = sub
        return sub

    def fold_used(self, sub: Sublease, used: int) -> int:
        """Fold a client's reported burns into ``used_pending``;
        returns the portion actually backed by the slice (over-reports
        beyond the slice are counted conservatively: they grow
        ``used_pending`` AND ``deficit`` together, so conservation
        holds and the burn is still reported upstream)."""
        u = max(int(used), 0)
        take = min(u, sub.amount)
        sub.amount -= take
        sub.used_total += u
        self.sliced_out -= take
        self.used_pending += take
        extra = u - take
        if extra > 0:
            self.used_pending += extra
            self.deficit += extra
        return take

    def return_unused(self, sub: Sublease) -> int:
        """Give a slice's unburned remainder back to the pool — paying
        down any shrink deficit before permits re-enter circulation."""
        rem = sub.amount
        sub.amount = 0
        self.sliced_out -= rem
        pay = min(rem, self.deficit)
        self.deficit -= pay
        self.remaining += rem - pay
        return rem

    def fold_lost(self, sub: Sublease) -> None:
        """A slice whose holder vanished (crash, re-grant after drop):
        its unreported permits may or may not have been burned, so the
        conservative fold counts them as USED — they flush upstream as
        burns, keeping the core's view an upper bound."""
        rem = sub.amount
        sub.amount = 0
        self.sliced_out -= rem
        self.used_pending += rem

    def top_up(self, sub: Sublease, requested: int) -> int:
        """Refill a (folded, emptied) slice to ``requested`` from
        ``remaining`` — the renewal path's re-slice.  Returns the new
        slice amount (0 when the pool is dry)."""
        amt = max(0, min(int(requested), self.remaining))
        self.remaining -= amt
        self.sliced_out += amt
        sub.amount = amt
        sub.granted_total += amt
        return amt

    def fold_over_report(self, used: int) -> None:
        """Burns reported with no slice backing them (a client whose
        sublease this pool never saw): conserve by growing
        ``used_pending`` and ``deficit`` together — the burn still
        flushes upstream, it just never consumes pool capacity."""
        u = max(int(used), 0)
        self.used_pending += u
        self.deficit += u

    def drop_sub(self, session_id: int) -> Optional[Sublease]:
        return self.subs.pop(session_id, None)

    # -- renewal bookkeeping ---------------------------------------------------
    def apply_renewal(self, granted: int, ttl_ms: int, epoch: int,
                      now_ms: int, reported_used: int) -> None:
        """Fold one upstream renewal answer in: ``reported_used`` burns
        left ``used_pending``, the pool's aggregate capacity becomes
        ``granted``, and a shrink below what is already sliced out
        becomes ``deficit`` (paid down by future returns)."""
        self.used_pending = max(self.used_pending - int(reported_used), 0)
        self.budget = int(granted)
        self.deficit = max(0, self.sliced_out + self.used_pending
                           - self.budget)
        self.remaining = max(0, self.budget - self.sliced_out
                             - self.used_pending)
        self.epoch = int(epoch)
        self.deadline_ms = int(now_ms) + max(int(ttl_ms), 1)
        self.granted_total += int(granted)
        self.renewals += 1
        self.check_conservation()


PoolKey = Tuple[int, str]
