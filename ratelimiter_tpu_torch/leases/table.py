"""Host-side lease accounting: who holds which per-key permit budget
(counterpart of ``ratelimiter_tpu/leases/table.py``).

One :class:`Lease` per ``(algo, lid, key)`` at a time — a leased key has
exactly one client burning it locally, which is what makes the
over-admission bound compose per key.  The table is pure bookkeeping
(budgets, TTL deadlines, fence epochs, usage counters); the device
charges/credits live in ``leases/manager.py`` via the storage's
``lease_reserve``/``lease_credit`` surface.

Bounded: ``max_leases`` caps the table; when full, expired leases are
swept first, then grants are refused (a refused grant just means the
client stays on the per-decision path — fail-closed, never unbounded
state).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, Optional, Tuple


@dataclasses.dataclass
class Lease:
    """One outstanding per-key permit budget."""

    algo: str
    lid: int
    key: str
    budget: int          # permits granted by the LAST reserve
    ws: int              # window the charge landed in (sw; 0 for tb)
    epoch: int           # fence epoch observed at grant time
    deadline_ms: int     # TTL deadline (manager clock)
    granted_total: int = 0   # permits charged over the lease's lifetime
    used_total: int = 0      # burns the client has reported back
    renewals: int = 0
    # Policy generation (control/, ARCHITECTURE §15) the budget was
    # charged under: a renewal at an older generation re-reserves under
    # the NEW rate (credit + fresh clamp against the updated config).
    policy_gen: int = 0
    # Bulk lease (edge/, ARCHITECTURE §14b): the holder is an edge
    # aggregator subleasing slices to its own clients, so the budget is
    # an AGGREGATE and clamps against ``max_bulk_budget`` instead of the
    # per-client ``max_budget``.  Over-admission nests: aggregator
    # outstanding <= this budget <= the core's outstanding bound.
    bulk: bool = False

    def expired(self, now_ms: int) -> bool:
        return now_ms >= self.deadline_ms


class LeaseTable:
    """Thread-safe bounded registry of outstanding leases."""

    def __init__(self, max_leases: int = 65536,
                 max_forward_jump_ms: int = 0,
                 forward_step_ms: int = 0):
        self._lock = threading.Lock()
        self._leases: Dict[Tuple[str, int, str], Lease] = {}
        self.max_leases = int(max_leases)
        # Forward clock-jump clamp (the TTL-side mirror of the storage
        # stamp's ``backward_clamps``): a wall-clock step LARGER than
        # ``max_forward_jump_ms`` is implausible (an injected jump, a
        # bad NTP slew), so :meth:`clamp_forward` refuses to replay it
        # into TTL accounting — the jump is ABSORBED into a standing
        # offset (counted once in ``forward_clamps``) and the expiry
        # clock resumes ``forward_step_ms`` past the last observation,
        # then keeps tracking subsequent wall progress at 1x.  Live
        # clients renewing at their normal cadence sail through
        # (nothing mass-expires in the poisoned tick, no matter how
        # many keys one sweep visits), while abandoned leases still
        # expire after their ordinary remaining TTL of rebased time.
        # Jumps at or under the threshold pass through untouched
        # (normal TTL expiry is exactly a legit forward step).
        # ``max_forward_jump_ms=0`` disables the clamp.
        self.max_forward_jump_ms = int(max_forward_jump_ms)
        self.forward_step_ms = int(forward_step_ms) or max(
            1, self.max_forward_jump_ms // 8)
        self.forward_clamps = 0
        self._expiry_clock: Optional[int] = None
        self._forward_offset = 0

    def clamp_forward(self, now_ms: int) -> int:
        """The table's view of ``now`` for TTL accounting: wall time
        minus the absorbed-jump offset.  A step beyond
        ``max_forward_jump_ms`` since the last observation grows the
        offset so TTL time lands ``forward_step_ms`` past that
        observation and continues at wall rate from there — every
        caller in the same sweep sees the SAME rebased now, so a
        poisoned jump can never expire more than a normal tick's worth
        of leases.  Backward steps pass through untouched (an earlier
        ``now`` only ever keeps a lease alive longer, which is the
        safe direction; the storage stamp clamp owns backward
        monotonicity)."""
        now = int(now_ms)
        if self.max_forward_jump_ms <= 0:
            return now
        with self._lock:
            eff = now - self._forward_offset
            if self._expiry_clock is None:
                self._expiry_clock = eff
                return eff
            if eff - self._expiry_clock > self.max_forward_jump_ms:
                target = self._expiry_clock + self.forward_step_ms
                self._forward_offset += eff - target
                eff = target
                self.forward_clamps += 1
            if eff > self._expiry_clock:
                self._expiry_clock = eff
            return eff

    @staticmethod
    def _k(algo: str, lid: int, key: str) -> Tuple[str, int, str]:
        return (algo, int(lid), key)

    def get(self, algo: str, lid: int, key: str) -> Optional[Lease]:
        with self._lock:
            return self._leases.get(self._k(algo, lid, key))

    def put(self, lease: Lease) -> bool:
        """Install a lease; False when the table is full (after sweeping
        nothing expired) — the caller refuses the grant."""
        with self._lock:
            k = self._k(lease.algo, lease.lid, lease.key)
            if k not in self._leases and len(self._leases) >= self.max_leases:
                return False
            self._leases[k] = lease
            return True

    def pop(self, algo: str, lid: int, key: str) -> Optional[Lease]:
        with self._lock:
            return self._leases.pop(self._k(algo, lid, key), None)

    def sweep_expired(self, now_ms: int) -> list:
        """Remove and return every TTL-expired lease."""
        with self._lock:
            dead = [k for k, v in self._leases.items()
                    if v.expired(now_ms)]
            return [self._leases.pop(k) for k in dead]

    def outstanding(self) -> int:
        with self._lock:
            return len(self._leases)

    def outstanding_budget(self) -> int:
        """Sum of unburned budget across live leases — the system-wide
        worst-case over-admission exposure if every leased client died
        right now AND every charge were lost (each per-key term is
        itself bounded by that key's remaining-window budget)."""
        with self._lock:
            return sum(v.budget for v in self._leases.values())

    def outstanding_budget_for(self, algo: str, lid: int,
                               exclude_key: Optional[str] = None) -> int:
        """One tenant's outstanding lease budget — the accounting behind
        concurrency slots (control/, ARCHITECTURE §15): with lease
        grants as slots, ``max_concurrent`` per tenant is enforced by
        bounding this sum.  ``exclude_key`` leaves one lease out (a
        renewal replaces its own budget, which must not count against
        itself).  O(outstanding leases) under the lock — grants are the
        cold path (decisions burn client-side)."""
        with self._lock:
            return sum(v.budget for (a, l, k), v in self._leases.items()
                       if a == algo and l == int(lid) and k != exclude_key)

    def __iter__(self) -> Iterator[Lease]:
        with self._lock:
            return iter(list(self._leases.values()))
