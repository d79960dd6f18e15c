"""Hybrid host-side serving tier — the Apt-Serve shape (counterpart of
``ratelimiter_tpu/cache/hybrid.py``; the storage hooks are in
``storage/gpu.py``).

The reference's TTL cache (``ttl_cache.py``) is a *negative* cache: it
short-circuits repeat rejections from a possibly-stale counter, trading
accuracy for round trips.  This tier is the grown-up version the
Apt-Serve paper sketches (PAPERS.md: adaptive request scheduling over a
hybrid cache that keeps the fast path off the expensive resource): it
answers **hot repeat-reject and safely-under-limit keys host-side from
EXACT per-key state**, with bounded staleness, and every host-side
mutation is **device-confirmed asynchronously**.

How exactness works
-------------------
The tier never guesses.  A key is *adopted* only when a device result
fully determines its semantic state:

- sliding window: a ``mutated`` decision whose weighted estimate carried
  zero previous-window contribution (``observed + 1 == cache_value``).
  Then the current bucket is exactly ``cache_value`` with deadline
  ``stamp + window`` (the increment's PEXPIRE), the previous bucket
  contributes zero for the remainder of this window (the floored weight
  is monotone non-increasing in-window), and across the boundary the
  tracked current bucket *becomes* the previous one — so the oracle
  snapshot is exact from adoption onward.
- token bucket: an allowed decision from a **full** bucket
  (``observed == max_permits`` — the floor equals the cap only when the
  fixed-point level is exactly the cap), leaving exactly
  ``(max_permits - permits) * TOKEN_FP_ONE`` with ``last_refill = stamp``.

From adoption on, the tier replays the key's traffic through the same
``semantics/oracle.py`` arithmetic every backend is proven against, so a
host-served decision is bit-identical to what the device would answer —
as long as every mutation of the key flows through this tier.  Paths
that can mutate state behind it (streams, direct batches, eviction,
reset, promotion) *invalidate* the entry at remap/clear time
(storage/tpu.py hooks), and every host-served **mutating** decision is
forwarded through the normal micro-batch path; its drain result is
compared field-for-field against the prediction.  Any mismatch counts
``ratelimiter.cache.hybrid.divergence`` and drops the entry — the tier
re-adopts from fresh device results.

Bounded over-admission
----------------------
Same bound ``storage/degraded.py`` proves for the breaker's open state:
the tier's oracle arithmetic admits at most ``max_permits`` per key per
window on its own, and the device independently admits at most
``max_permits`` — so even under worst-case divergence (a stale snapshot
racing hidden device traffic) the combined admission is bounded by **one
extra ``max_permits`` per key per window**, not unbounded fail-open.
Three additional brakes keep the divergence window small: entries serve
only within ``ttl_ms`` of their last device confirmation, at most
``unconfirmed_cap`` forwarded mutations may be awaiting confirmation
(past that the caller falls through to the device path, which refreshes
the entry), and sliding-window serves refuse the last ``guard_ms`` of a
window (a forwarded increment landing across the boundary would split
buckets between host and device).

Locking: ``lock`` is exposed and **held by the storage across
serve + confirmation submit**, so the device applies a key's forwarded
mutations in exactly the order the host decided them.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Tuple

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.semantics.oracle import (
    Decision,
    SlidingWindowOracle,
    TokenBucketOracle,
)
from ratelimiter_tpu_torch.utils.logging import get_logger

log = get_logger("cache.hybrid")


class _Entry:
    __slots__ = ("slot", "unconfirmed", "last_sync_ms", "gen")

    def __init__(self, slot: int, stamp_ms: int, gen: int):
        self.slot = int(slot)
        self.unconfirmed = 0
        self.last_sync_ms = int(stamp_ms)
        self.gen = gen


class HybridServingCache:
    """Exact host-side serving tier over adopted oracle snapshots."""

    def __init__(self, clock_ms, ttl_ms: float = 50.0,
                 max_keys: int = 65536, unconfirmed_cap: int = 64,
                 guard_ms: float = 5.0, registry=None):
        self._clock_ms = clock_ms
        self.ttl_ms = float(ttl_ms)
        self.max_keys = int(max_keys)
        self.unconfirmed_cap = int(unconfirmed_cap)
        self.guard_ms = float(guard_ms)
        self.lock = threading.RLock()
        self._configs: Dict[int, Tuple[str, RateLimitConfig]] = {}
        self._oracles: Dict[Tuple[str, int], object] = {}
        # (algo, lid, key) -> _Entry; LRU-bounded by max_keys.
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._by_slot: Dict[Tuple[str, int], Tuple[str, int, str]] = {}
        self._gen = 0
        self.served = 0       # decisions answered host-side
        self.rejects_served = 0  # of those: pure rejects (zero device work)
        self.adopted = 0
        self.invalidated = 0
        self.divergence = 0

        def _counter(name, desc):
            return (registry.counter(name, desc)
                    if registry is not None else None)

        self._served_c = _counter(
            "ratelimiter.cache.hybrid.served",
            "Decisions answered host-side by the hybrid serving tier")
        self._adopted_c = _counter(
            "ratelimiter.cache.hybrid.adopted",
            "Keys adopted into exact host-side tracking")
        self._invalidated_c = _counter(
            "ratelimiter.cache.hybrid.invalidated",
            "Hybrid-tier entries dropped (evict/reset/TTL/divergence)")
        self._divergence_c = _counter(
            "ratelimiter.cache.hybrid.divergence",
            "Device confirmations that mismatched the host prediction")

    # -- policy registry ------------------------------------------------------
    def register(self, lid: int, algo: str, config: RateLimitConfig) -> None:
        with self.lock:
            self._configs[int(lid)] = (algo, config)

    def update_policy(self, lid: int, algo: str,
                      config: RateLimitConfig) -> None:
        """Live policy update (storage.set_policy calls this BEFORE the
        device row moves): every entry tracking the lid is dropped — a
        host serve racing the update must not answer under the old rate
        — and the lid's oracle is rebuilt so re-adoption replays the
        NEW policy's arithmetic."""
        with self.lock:
            self._configs[int(lid)] = (algo, config)
            self._oracles.pop((algo, int(lid)), None)
            stale = [ek for ek in self._entries
                     if ek[0] == algo and ek[1] == int(lid)]
            for ek in stale:
                self._drop(ek)

    def _oracle(self, algo: str, lid: int):
        k = (algo, int(lid))
        oracle = self._oracles.get(k)
        if oracle is None:
            cfg = self._configs[int(lid)][1]
            oracle = (SlidingWindowOracle(cfg) if algo == "sw"
                      else TokenBucketOracle(cfg))
            self._oracles[k] = oracle
        return oracle

    # -- serve (storage.acquire_async fast path; lock held by caller) --------
    def serve(self, algo: str, lid: int, key: str, permits: int):
        """Host-side decision for a tracked key, or None (device path).

        Returns ``(out_dict, predicted)``; ``predicted`` is the oracle
        :class:`Decision` when the serve mutated host state (the caller
        forwards the identical request and registers it via
        :meth:`watch_confirm`), or None for a pure reject."""
        ek = (algo, int(lid), key)
        entry = self._entries.get(ek)
        if entry is None:
            return None
        now = self._clock_ms()
        cfg = self._configs[int(lid)][1]
        # Every decline DROPS the entry rather than bypassing it: a
        # bypassed request would mutate device state the snapshot never
        # sees until its drain callback, and a serve racing that replay
        # could answer from pre-op state.  Dropping keeps the invariant
        # "tracked => every mutation flowed through the tier"; the key
        # re-adopts from the next determining device result.
        if now - entry.last_sync_ms > self.ttl_ms:
            self._drop(ek)  # bounded staleness: re-adopt from the device
            return None
        if entry.unconfirmed >= self.unconfirmed_cap:
            self._drop(ek)  # backpressure: let the device path refresh it
            return None
        if algo == "sw":
            win = cfg.window_ms
            if win - (now % win) <= self.guard_ms:
                # Window edge: a forwarded increment could land in the
                # next bucket on the device.
                self._drop(ek)
                return None
        oracle = self._oracle(algo, int(lid))
        d: Decision = oracle.try_acquire(key, int(permits), now)
        self._entries.move_to_end(ek)
        self.served += 1
        if self._served_c is not None:
            self._served_c.increment()
        if algo == "sw":
            out = {"allowed": d.allowed, "mutated": d.mutated,
                   "observed": d.observed, "cache_value": d.remaining_hint,
                   "host_served": True}
        else:
            out = {"allowed": d.allowed, "observed": d.observed,
                   "remaining": d.remaining_hint, "host_served": True}
        if d.mutated:
            entry.unconfirmed += 1
            return out, d
        self.rejects_served += 1
        return out, None

    # -- device feedback ------------------------------------------------------
    def watch_confirm(self, algo: str, lid: int, key: str,
                      predicted: Decision, slot: int, fut) -> None:
        """Register a forwarded mutation's future (lock held): its drain
        result must match the host prediction field-for-field."""
        ek = (algo, int(lid), key)
        entry = self._entries.get(ek)
        if entry is None:
            return
        entry.slot = int(slot)
        self._by_slot[(algo, int(slot))] = ek
        gen = entry.gen
        fut.add_done_callback(
            lambda f: self._confirm(ek, gen, predicted, f))

    def _confirm(self, ek, gen: int, predicted: Decision, fut) -> None:
        try:
            out = fut.result()
        except Exception:  # noqa: BLE001 — device path failed; drop entry
            with self.lock:
                entry = self._entries.get(ek)
                if entry is not None and entry.gen == gen:
                    self._drop(ek)
            return
        algo = ek[0]
        ok = bool(out["allowed"]) == predicted.allowed and int(
            out["observed"]) == predicted.observed
        if algo == "sw":
            ok = ok and bool(out["mutated"]) == predicted.mutated and int(
                out["cache_value"]) == predicted.remaining_hint
        else:
            ok = ok and int(out["remaining"]) == predicted.remaining_hint
        with self.lock:
            entry = self._entries.get(ek)
            if entry is None or entry.gen != gen:
                return
            if not ok:
                self.divergence += 1
                if self._divergence_c is not None:
                    self._divergence_c.increment()
                log.warning(
                    "hybrid tier divergence on %s (predicted %s); "
                    "entry dropped", ek, predicted)
                self._drop(ek)
                return
            entry.unconfirmed -= 1
            stamp = out.get("stamp")
            if stamp is not None:
                entry.last_sync_ms = max(entry.last_sync_ms, int(stamp))

    def watch_miss(self, algo: str, lid: int, key: str, permits: int,
                   slot: int, fut) -> None:
        """Register a device-path miss (no lock held): its result either
        refreshes the tracked entry or — when it pins the key's full
        semantic state — adopts the key into host-side tracking."""
        fut.add_done_callback(
            lambda f: self._absorb(algo, int(lid), key, int(permits),
                                   int(slot), f))

    def _absorb(self, algo: str, lid: int, key: str, permits: int,
                slot: int, fut) -> None:
        try:
            out = fut.result()
        except Exception:  # noqa: BLE001 — failed dispatch teaches nothing
            return
        stamp = out.get("stamp")
        if stamp is None:
            return
        stamp = int(stamp)
        with self.lock:
            ek = (algo, lid, key)
            entry = self._entries.get(ek)
            if entry is not None:
                # A tracked key took the device path (unconfirmed cap,
                # window guard): the device mutated state the snapshot
                # didn't see — replay the same op through the oracle and
                # verify; mismatch means hidden divergence.
                oracle = self._oracle(algo, lid)
                d = oracle.try_acquire(key, permits, stamp)
                if (d.allowed != bool(out["allowed"])
                        or d.observed != int(out["observed"])):
                    self.divergence += 1
                    if self._divergence_c is not None:
                        self._divergence_c.increment()
                    self._drop(ek)
                else:
                    entry.last_sync_ms = max(entry.last_sync_ms, stamp)
                return
            cfg_entry = self._configs.get(lid)
            if cfg_entry is None or cfg_entry[0] != algo:
                return
            cfg = cfg_entry[1]
            if algo == "sw":
                if not (bool(out["mutated"])
                        and int(out["observed"]) + 1
                        == int(out["cache_value"])):
                    return  # previous-window contribution unknown
                self._adopt(ek, slot, stamp)
                self._oracle(algo, lid).seed_count(
                    key, int(out["cache_value"]), stamp)
            else:
                if not (bool(out["allowed"])
                        and int(out["observed"]) == cfg.max_permits):
                    return  # fractional fixed-point level unknown
                self._adopt(ek, slot, stamp)
                self._oracle(algo, lid).seed_tokens(
                    key, cfg.max_permits - permits, stamp)

    def _adopt(self, ek, slot: int, stamp: int) -> None:
        self._gen += 1
        self._entries[ek] = _Entry(slot, stamp, self._gen)
        self._by_slot[(ek[0], int(slot))] = ek
        self.adopted += 1
        if self._adopted_c is not None:
            self._adopted_c.increment()
        while len(self._entries) > self.max_keys:
            old_ek, old = self._entries.popitem(last=False)
            self._forget_state(old_ek, old)

    # -- invalidation (storage hooks) -----------------------------------------
    def _forget_state(self, ek, entry: Optional[_Entry]) -> None:
        algo, lid, key = ek
        if entry is not None:
            self._by_slot.pop((algo, entry.slot), None)
        oracle = self._oracles.get((algo, int(lid)))
        if oracle is not None:
            # Purge the key's semantic state so a later re-adoption
            # starts clean (the oracle dicts would otherwise leak).
            oracle.reset(key, self._clock_ms())

    def _drop(self, ek) -> None:
        entry = self._entries.pop(ek, None)
        if entry is None:
            return
        self._forget_state(ek, entry)
        self.invalidated += 1
        if self._invalidated_c is not None:
            self._invalidated_c.increment()

    def invalidate(self, algo: str, lid: int, key: str) -> None:
        with self.lock:
            self._drop((algo, int(lid), key))

    def invalidate_slots(self, algo: str, slots) -> None:
        """Slots being cleared/evicted: drop any entry tracking them."""
        with self.lock:
            for slot in slots:
                ek = self._by_slot.get((algo, int(slot)))
                if ek is not None:
                    self._drop(ek)

    def invalidate_all(self) -> None:
        with self.lock:
            n = len(self._entries)
            self._entries.clear()
            self._by_slot.clear()
            self._oracles.clear()
            self.invalidated += n
            if self._invalidated_c is not None and n:
                self._invalidated_c.add(n)

    # -- introspection --------------------------------------------------------
    def pending_confirms(self) -> int:
        """Forwarded mutations not yet device-confirmed, across tracked
        entries.  A host-served mutation is stamped at serve time but
        applied at dispatch time; callers that control the clock (tests,
        drills) quiesce this to zero before advancing it, so serve stamp
        == dispatch stamp and decisions stay bit-exact.  Under a live
        wall clock the skew is bounded by the flush deadline (sub-ms vs
        multi-second windows); a skewed op that does change a window or
        estimate is caught by its confirmation and the entry dropped."""
        with self.lock:
            return sum(e.unconfirmed for e in self._entries.values())

    def stats(self) -> Dict:
        with self.lock:
            return {
                "tracked": len(self._entries),
                "served": self.served,
                "rejects_served": self.rejects_served,
                "adopted": self.adopted,
                "invalidated": self.invalidated,
                "divergence": self.divergence,
            }

    def __len__(self) -> int:
        with self.lock:
            return len(self._entries)
