"""Degraded-mode host-side limiter: fail-*approximate*, not fail-open
(counterpart of ``ratelimiter_tpu/storage/degraded.py``).

When the circuit breaker (storage/breaker.py) is open — the device/storage
backend is persistently failing — decisions short-circuit here instead of
fail-opening blindly.  The approximation is a coarse in-memory restatement
of each registered limiter's policy (the oracle classes from
``semantics/oracle.py`` ARE the coarse host model: token bucket and
two-bucket sliding window, exact integer arithmetic, dict state), seeded
per key from the **last counter value the device reported** before the
outage (the breaker records those on the healthy path via
:meth:`note_seen`), so a key that was near its limit stays near its limit.

Over-admission is bounded: a key's degraded budget starts from its last
known remaining count (or full capacity if never seen), so the worst case
per key per window is one extra ``max_permits`` — the permits charged on
the device after the snapshot, which the host cannot see.  Compare
fail-open, whose over-admission is unbounded for the outage's duration.

On breaker close the keys *mutated* here are reset on the device (the
resync step in ``CircuitBreakerStorage``), so post-recovery decisions are
again bit-identical to ``semantics/oracle.py`` — a key either kept its
pre-outage device state untouched, or was reset on both sides.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.semantics.oracle import (
    SlidingWindowOracle,
    TokenBucketOracle,
)
from ratelimiter_tpu_torch.storage.errors import CircuitOpenError
from ratelimiter_tpu_torch.utils.logging import get_logger

log = get_logger("storage.degraded")


def _wall_clock_ms() -> int:
    return time.time_ns() // 1_000_000


class DegradedHostLimiter:
    """Host-side approximate decisions for the breaker's open state.

    Thread-safe (one lock — this path only runs while the device path is
    down, so a host dict under a lock is plenty).  State is per open
    episode: ``clear_state()`` (called by the breaker after resync) drops
    every oracle so the next episode re-seeds from fresh snapshots.
    """

    def __init__(self, clock_ms: Callable[[], int] = _wall_clock_ms,
                 registry=None, max_keys: int = 65536, telemetry=None):
        self._clock_ms = clock_ms
        self._lock = threading.RLock()
        # Fleet telemetry plane (observability/telemetry.py): degraded
        # decisions are decisions too — without this feed, every outage
        # would read as a drop in fleet load instead of degraded serving.
        self._telemetry = telemetry
        self._configs: Dict[int, Tuple[str, RateLimitConfig]] = {}
        self._oracles: Dict[int, object] = {}
        # Last device-reported counter per (algo, lid, key): sw -> raw
        # current-bucket count, tb -> whole tokens remaining.  Bounded
        # LRU — refreshed continuously on the healthy path.
        self._seen: "collections.OrderedDict" = collections.OrderedDict()
        self._seeded: set = set()   # keys whose oracle state was seeded
        self._touched: set = set()  # keys MUTATED here (resync must reset)
        self.max_keys = int(max_keys)
        self._decisions = (
            registry.counter(
                "ratelimiter.degraded.decisions",
                "Decisions served by the degraded host limiter "
                "(breaker open)")
            if registry is not None else None)

    # -- policy registry ------------------------------------------------------
    def register(self, lid: int, algo: str, config: RateLimitConfig) -> None:
        with self._lock:
            self._configs[int(lid)] = (algo, config)

    def update_policy(self, lid: int, algo: str, config: RateLimitConfig,
                      generation: int = 0) -> None:
        """Live policy update (control/, ARCHITECTURE §15): adopt the
        new rates so an outage DURING or AFTER a policy change seeds
        its approximation from the generation that is actually serving.
        A live oracle (mid-episode update) reconfigures in place — its
        seeded per-key state stays, exactly like the device's counters
        across the same boundary."""
        with self._lock:
            self._configs[int(lid)] = (algo, config)
            oracle = self._oracles.get(int(lid))
            if oracle is not None:
                oracle.reconfigure(config)

    def _oracle(self, algo: str, lid: int):
        entry = self._configs.get(int(lid))
        if entry is None or entry[0] != algo:
            raise CircuitOpenError(
                f"degraded limiter has no policy for ({algo!r}, lid={lid})")
        oracle = self._oracles.get(int(lid))
        if oracle is None:
            cfg = entry[1]
            oracle = (SlidingWindowOracle(cfg) if algo == "sw"
                      else TokenBucketOracle(cfg))
            self._oracles[int(lid)] = oracle
        return oracle

    # -- snapshot feed (healthy path, via the breaker) ------------------------
    def note_seen(self, algo: str, lid: int, key: str, value: int,
                  now_ms: int) -> None:
        with self._lock:
            k = (algo, int(lid), key)
            self._seen[k] = (int(value), int(now_ms))
            self._seen.move_to_end(k)
            while len(self._seen) > self.max_keys:
                self._seen.popitem(last=False)

    def _seed(self, algo: str, lid: int, key: str, oracle) -> None:
        k = (algo, int(lid), key)
        if k in self._seeded:
            return
        self._seeded.add(k)
        snap = self._seen.get(k)
        if snap is None:
            return  # never seen: lazy init to full capacity (oracle default)
        value, ts = snap
        if algo == "sw":
            oracle.seed_count(key, value, ts)
        else:
            oracle.seed_tokens(key, value, ts)

    # -- decision surface (breaker-open short circuit) ------------------------
    def acquire(self, algo: str, lid: int, key: str, permits: int) -> dict:
        """One approximate decision, in the exact dict shape the device
        path returns (plus ``degraded: True`` so callers/drills can tell)."""
        with self._lock:
            oracle = self._oracle(algo, lid)
            self._seed(algo, lid, key, oracle)
            d = oracle.try_acquire(key, int(permits), self._clock_ms())
            if d.mutated:
                self._touched.add((algo, int(lid), key))
        if self._decisions is not None:
            self._decisions.increment()
        if self._telemetry is not None:
            self._telemetry.note_degraded(int(lid), bool(d.allowed))
        if algo == "sw":
            return {"allowed": d.allowed, "mutated": d.mutated,
                    "observed": d.observed, "cache_value": d.remaining_hint,
                    "degraded": True}
        return {"allowed": d.allowed, "observed": d.observed,
                "remaining": d.remaining_hint, "degraded": True}

    def available(self, algo: str, lid: int,
                  keys: Sequence[str]) -> List[int]:
        with self._lock:
            oracle = self._oracle(algo, lid)
            now = self._clock_ms()
            out = []
            for key in keys:
                self._seed(algo, lid, key, oracle)
                out.append(int(oracle.get_available_permits(key, now)))
            return out

    def reset(self, algo: str, lid: int, key: str) -> None:
        with self._lock:
            oracle = self._oracle(algo, lid)
            oracle.reset(key, self._clock_ms())
            # An admin reset during the outage must reach the device at
            # resync too, or the device's stale pre-outage counters win.
            self._touched.add((algo, int(lid), key))

    # -- episode lifecycle ----------------------------------------------------
    def touched(self) -> List[Tuple[str, int, str]]:
        """Keys whose state diverged from the device during this episode
        (mutated or reset here) — the breaker's resync set."""
        with self._lock:
            return sorted(self._touched)

    def clear_state(self) -> None:
        """End the episode: drop every oracle and seed/touch record.  The
        ``note_seen`` snapshot cache persists — it belongs to the healthy
        path and will be fresher by the next outage anyway."""
        with self._lock:
            self._oracles.clear()
            self._seeded.clear()
            self._touched.clear()
