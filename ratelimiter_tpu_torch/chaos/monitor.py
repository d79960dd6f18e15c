"""The fleet-wide invariant monitor (counterpart of
``ratelimiter_tpu/chaos/monitor.py``).

One :class:`InvariantMonitor` watches a running
:class:`~ratelimiter_tpu_torch.chaos.harness.FleetHarness` and, after EVERY
conductor step, checks the whole invariant catalog — the union of what
the hand-scripted drills each assert in isolation:

========================  =====================================================
invariant                  claim
========================  =====================================================
``oracle-divergence``      healthy-path decisions are bit-identical to
                           ``semantics/oracle.py`` (and the final lease
                           reserve/credit replay reconciles exactly)
``admission-bound``        per-key over-admission stays within the documented
                           bound: every outstanding lease budget <= the
                           configured cap <= the policy's ``max_permits``, and
                           cumulative ``over_admission`` <= revocations x cap
``conservation``           every BulkPool conserves ``remaining + sliced_out +
                           used_pending == budget + deficit``
``epoch-monotonicity``     fence epochs, controller-seat epochs, and policy
                           generations NEVER regress
``liveness``               on fault-free steps the system keeps admitting:
                           a dedicated liveness probe per path (direct /
                           leased / edge) may not be denied for
                           ``liveness_window`` consecutive healthy steps
``zombie-serving``         a paused-then-resumed backend whose keyspace was
                           promoted away answers direct dispatch with
                           ``FencedError``, never with a decision
========================  =====================================================

A failed check raises :class:`InvariantViolation` — the harness stops
the run at that step and reports ``(invariant, step, detail)``, which
is exactly the tuple the minimizer (chaos/minimize.py) preserves while
shrinking the schedule and the artifact (chaos/replay.py) replays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class InvariantViolation(Exception):
    """One invariant broke at one step; carries the replay identity."""

    def __init__(self, invariant: str, step: int, detail: str):
        super().__init__(f"[{invariant}] step {step}: {detail}")
        self.invariant = str(invariant)
        self.step = int(step)
        self.detail = str(detail)

    def to_dict(self) -> Dict:
        return {"invariant": self.invariant, "step": self.step,
                "detail": self.detail}


class InvariantMonitor:
    """Per-step checker over the harness's live state."""

    def __init__(self, harness):
        self.h = harness
        self.checks_total = 0
        self.violations: List[Dict] = []
        # Watched epochs: watermark per (series, cell) — any regression
        # is a violation (the fence/authority/policy monotonicity the
        # whole design leans on).
        self._epochs: Dict[Tuple[str, int], int] = {}
        # Liveness: consecutive HEALTHY steps each probe path was
        # denied on (reset by a successful probe or a faulted step).
        self.unserved = {"direct": 0, "lease": 0, "edge": 0}

    # -- reporting -------------------------------------------------------------
    def violation(self, invariant: str, step: int, detail: str) -> None:
        v = InvariantViolation(invariant, step, detail)
        self.violations.append(v.to_dict())
        raise v

    # -- probe bookkeeping (harness calls these during traffic) ---------------
    def note_probe(self, path: str, step: int, served: bool,
                   healthy: bool) -> None:
        """One liveness probe outcome.  Only healthy (fault-free for
        that path) steps count toward the consecutive-denial window —
        a denial during an armed fault is the system being correctly
        unavailable, not a liveness bug."""
        if served:
            self.unserved[path] = 0
        elif healthy:
            self.unserved[path] += 1
        else:
            self.unserved[path] = 0

    # -- the per-step check ----------------------------------------------------
    def check(self, step: int) -> None:
        self.checks_total += 1
        self._check_oracle(step)
        self._check_conservation(step)
        self._check_admission_bound(step)
        self._check_epochs(step)
        self._check_liveness(step)

    def _check_oracle(self, step: int) -> None:
        n = self.h.step_mismatches
        if n:
            self.violation(
                "oracle-divergence", step,
                f"{n} direct decision(s) diverged from the oracle "
                f"this step (of {self.h.step_decisions})")

    def _check_conservation(self, step: int) -> None:
        agg = getattr(self.h, "agg", None)
        if agg is None:
            return
        with agg._lock:
            live = list(agg._pools.values())
            dead = list(agg._dead)
        for pool in live:
            try:
                pool.check_conservation()
            except AssertionError as e:
                self.violation("conservation", step, str(e))
        # Retired carcasses legitimately leak the identity's right-hand
        # side as their final burn report flushes (used_pending drains
        # upstream while the stale budget stays); what must still hold
        # is that nothing went NEGATIVE — a negative ledger is minted
        # permits, the one thing retirement can never do.
        for pool in dead:
            if (pool.remaining < 0 or pool.sliced_out < 0
                    or pool.used_pending < 0 or pool.deficit < 0):
                self.violation(
                    "conservation", step,
                    f"retired pool ({pool.lid},{pool.key!r}) went "
                    f"negative: rem={pool.remaining} "
                    f"out={pool.sliced_out} "
                    f"pending={pool.used_pending} "
                    f"deficit={pool.deficit}")

    def _check_admission_bound(self, step: int) -> None:
        mgr = getattr(self.h, "mgr", None)
        if mgr is None:
            return
        cap = max(mgr.max_budget,
                  getattr(mgr, "max_bulk_budget", 0) or 0)
        policy_cap = self.h.cells[0].cfg_lease.max_permits
        for lease in mgr.table:
            bound = (getattr(mgr, "max_bulk_budget", 0) or cap) \
                if lease.bulk else mgr.max_budget
            if lease.budget > bound or bound > policy_cap:
                self.violation(
                    "admission-bound", step,
                    f"lease ({lease.lid},{lease.key!r}) budget "
                    f"{lease.budget} exceeds cap {bound} "
                    f"(policy max_permits {policy_cap})")
        # Cumulative: every over-admitted permit traces to one revoked
        # or expired lease, each worth at most one full budget.
        events = mgr.revoked_total + mgr.expired_total
        if mgr.over_admission_total > events * cap:
            self.violation(
                "admission-bound", step,
                f"over_admission {mgr.over_admission_total} exceeds "
                f"{events} revocations/expiries x cap {cap}")

    def _watch(self, step: int, series: str, cell: int,
               value: Optional[int]) -> None:
        if value is None:
            return
        key = (series, int(cell))
        last = self._epochs.get(key)
        if last is not None and int(value) < last:
            self.violation(
                "epoch-monotonicity", step,
                f"{series} epoch regressed in cell {cell}: "
                f"{last} -> {value}")
        self._epochs[key] = int(value)

    def _check_epochs(self, step: int) -> None:
        for c in self.h.cells:
            self._watch(step, "orchestrator-fence", c.idx,
                        c.orch.fence_epoch)
            self._watch(step, "storage-fence", c.idx,
                        c.primary._fence_epoch)
            self._watch(step, "controller-seat", c.idx, c.seat.epoch)
            gen = c.policy_generation()
            self._watch(step, "policy-generation", c.idx, gen)

    def _check_liveness(self, step: int) -> None:
        window = int(self.h.topo["liveness_window"])
        for path, n in self.unserved.items():
            if n >= window:
                self.violation(
                    "liveness", step,
                    f"{path} liveness probe denied on {n} consecutive "
                    f"fault-free steps (window {window})")
