"""Client side of token leases: the local burner (counterpart of
``ratelimiter_tpu/leases/client.py``).

A :class:`LeaseClient` turns "one wire frame per decision" into "one
wire frame per budget": it holds a per-key lease (a permit budget the
server pre-charged on the device) and answers ``try_acquire`` from host
memory — a dict lookup and a decrement — renewing over the wire only
when the budget runs out, the TTL expires, or the server revokes.

Admission safety is the server's by construction: every locally-allowed
permit was already charged against the device counters at grant time,
so a crashing client can only UNDER-admit (charged-but-unburned budget,
reclaimed by TTL/window expiry).  The over-admission window exists only
across a failover (burns between a fence-epoch bump and the next
renewal), bounded by the outstanding budget — which the reserve kernel
bounded by the key's remaining-window budget.

Decision semantics seen by the caller:

- lease live and budget covers ``permits`` -> local ALLOW (zero wire);
- budget exhausted / TTL passed -> one RENEW (or LEASE) round trip,
  then the fresh budget answers;
- server granted 0 (key contended, already leased elsewhere, fenced,
  or over its remaining-window budget) -> the key stays on the
  per-decision path: with ``direct_fallback=True`` (default) each
  decision forwards to the server's ordinary TRY_ACQUIRE (the device
  arbitrates contended keys, exactly as without leases); with
  ``direct_fallback=False`` the client denies locally until the
  server's retry hint elapses (strict lease-only mode — the chaos
  drill uses it so every state mutation flows through the replayable
  reserve/credit log).

Transports are duck-typed: ``service/sidecar.py:SidecarClient`` (wire
protocol v3/v4) and :class:`DirectTransport` (in-process, over a
``LeaseManager``) both provide ``lease_grant`` / ``lease_renew`` /
``lease_release`` / ``try_acquire`` / ``telemetry_report``.

**Burn telemetry (observability/telemetry.py).**  With leases on, the
server no longer observes most decisions — it sees one coarse ``used``
count per renewal.  The client therefore accumulates per-(lid,
key-class) burn/deny counts plus a local-decision latency histogram
(the Timer log2-bucket scheme) and flushes them as one TELEMETRY
report: piggybacked in front of every renew/grant wire op (the op is
response-less, so this adds zero round trips) and on a bounded cadence
(``telemetry_flush_ms``) otherwise.  **Drop-don't-block**: a flush
that cannot be shipped is dropped and counted
(``telemetry_dropped``) — its counts are lost by design; telemetry is
an observability signal, never backpressure on the decision path.

**Trace lineage.**  With ``trace_lineage=True`` each lease mints one
64-bit trace id at grant and carries it on every wire op, so the
server's lineage ring shows grant -> local burns (the ``client`` hop
renew stamps) -> renew under one id (``trace_of(key)`` returns it).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional


def _wall_ms() -> int:
    return time.time_ns() // 1_000_000


class _Local:
    """One locally-held lease."""

    __slots__ = ("remaining", "used", "deadline", "epoch", "deny_until",
                 "trace")

    def __init__(self, remaining: int, deadline: int, epoch: int,
                 deny_until: int = 0, trace: int = 0):
        self.remaining = int(remaining)
        self.used = 0
        self.deadline = int(deadline)
        self.epoch = int(epoch)
        self.deny_until = int(deny_until)
        self.trace = int(trace)


class DirectTransport:
    """In-process transport: LeaseClient -> LeaseManager (drills,
    embedded deployments — no TCP in the loop)."""

    def __init__(self, manager):
        self.manager = manager

    def lease_grant(self, lid: int, key: str, requested: int,
                    trace_id: int = 0, bulk: bool = False):
        return self.manager.grant(lid, key, requested, trace_id=trace_id,
                                  bulk=bulk)

    def lease_renew(self, lid: int, key: str, used: int,
                    requested: int = 0, trace_id: int = 0):
        return self.manager.renew(lid, key, used, requested,
                                  trace_id=trace_id)

    def lease_bulk_renew(self, lid: int, keys, used, requested,
                         epochs=None, trace_id: int = 0):
        """Portfolio renewal (edge aggregators): one row per key, each
        the exact equivalent of :meth:`lease_renew`.  ``epochs`` (one
        per row, optional) names the lease instance each report belongs
        to, so burns flushed for a revoked bulk lease can never fold
        into a successor grant's accounting.  Returns one ``(granted,
        ttl_ms, epoch, revoked)`` tuple per row — the in-process mirror
        of wire v6 ``OP_BULK_RENEW``."""
        out = []
        eps = epochs if epochs is not None else [None] * len(keys)
        for key, u, req, ep in zip(keys, used, requested, eps):
            resp = self.manager.renew(lid, key, int(u), int(req),
                                      trace_id=trace_id,
                                      epoch=None if ep is None else int(ep))
            if resp is None:
                out.append((0, 0, 0, True))
            else:
                out.append((int(resp.granted), int(resp.ttl_ms),
                            int(resp.epoch), False))
        return out

    def lease_release(self, lid: int, key: str, used: int,
                      trace_id: int = 0) -> None:
        self.manager.release(lid, key, used, trace_id=trace_id)

    def try_acquire(self, lid: int, key: str, permits: int = 1,
                    trace_id: int = 0) -> bool:
        algo, _cfg = self.manager._algo_cfg(lid)
        out = self.manager.storage.acquire(algo, lid, key, permits)
        return bool(out["allowed"])

    def telemetry_report(self, blob: bytes) -> bool:
        return self.manager.telemetry_report(blob) >= 0


class LeaseClient:
    """Local lease burner over a lease-capable transport."""

    def __init__(self, transport, lid: int, *, budget: int = 64,
                 clock_ms=None, direct_fallback: bool = True,
                 telemetry: bool = True,
                 telemetry_flush_ms: float = 250.0,
                 telemetry_rearm_ms: float = 5000.0,
                 key_class=None,
                 trace_lineage: bool = False):
        self._t = transport
        self.lid = int(lid)
        self.budget = max(int(budget), 1)
        self._clock_ms = clock_ms or _wall_ms
        self.direct_fallback = bool(direct_fallback)
        self._leases: Dict[str, _Local] = {}
        # Accounting (the loopback bench computes its wire-frame ratio
        # from these; the chaos drill asserts per-key admission).
        self.local_decisions = 0   # allows answered with ZERO wire frames
        self.local_denies = 0
        self.wire_ops = 0          # lease + fallback frames sent
        self.revoked_seen = 0
        self.allowed_by_key: collections.Counter = collections.Counter()
        # Burn telemetry (module docstring): only armed when the
        # transport can ship a report.
        self._telem = None
        self.telemetry_flush_ms = float(telemetry_flush_ms)
        self.telemetry_flushes = 0    # reports shipped
        self.telemetry_dropped = 0    # reports dropped (never blocked on)
        # lease.telemetry_rearmed: latch recoveries — a transport whose
        # telemetry went down (one failed write latches it for that
        # CONNECTION) is reconnected + re-HELLO'd at a bounded cadence;
        # each success re-arms burn reporting instead of leaving it
        # silently dead for the life of the client.
        self.telemetry_rearmed = 0
        self.telemetry_rearm_ms = float(telemetry_rearm_ms)
        self._last_rearm = 0
        self._last_flush = int(self._clock_ms())
        if telemetry and hasattr(transport, "telemetry_report"):
            from ratelimiter_tpu_torch.observability.telemetry import (
                ClientTelemetry,
            )

            self._telem = ClientTelemetry(key_class=key_class)
        self._trace_lineage = bool(trace_lineage)

    def trace_of(self, key: str) -> int:
        """The lease's lineage trace id (0 when untraced/unknown)."""
        lease = self._leases.get(key)
        return lease.trace if lease is not None else 0

    # -- the decision surface --------------------------------------------------
    def try_acquire(self, key: str, permits: int = 1) -> bool:
        permits = max(int(permits), 1)
        telem = self._telem
        # Sampled stamping: the perf_counter pair costs ~1 µs per local
        # burn — the dominant telemetry overhead on a path whose whole
        # budget is a few µs.  Only the first record of each flush
        # interval pays it (ClientTelemetry.stamp_pending re-arms on
        # flush); every other burn records counts latency-free.
        stamp = telem is not None and telem.stamp_pending
        t0 = time.perf_counter() if stamp else 0.0
        now = int(self._clock_ms())
        lease = self._leases.get(key)
        if lease is not None and now < lease.deadline \
                and lease.remaining >= permits:
            lease.remaining -= permits
            lease.used += permits
            self.local_decisions += 1
            self.allowed_by_key[key] += permits
            if telem is not None:
                telem.record_burn(
                    self.lid, key, permits,
                    (time.perf_counter() - t0) * 1e6 if stamp else None)
                self._maybe_flush(now)
            return True
        lease = self._refresh(key, lease, now)
        if lease is not None and now < lease.deadline \
                and lease.remaining >= permits:
            lease.remaining -= permits
            lease.used += permits
            self.allowed_by_key[key] += permits
            if telem is not None:
                # The first burn of a fresh budget: local too (the wire
                # op charged the BUDGET, not this decision).
                telem.record_burn(
                    self.lid, key, permits,
                    (time.perf_counter() - t0) * 1e6 if stamp else None)
            return True
        if self.direct_fallback:
            self.wire_ops += 1
            allowed = bool(self._t.try_acquire(self.lid, key, permits))
            if allowed:
                self.allowed_by_key[key] += permits
            return allowed
        self.local_denies += 1
        if telem is not None:
            telem.record_deny(
                self.lid, key,
                (time.perf_counter() - t0) * 1e6 if stamp else None)
            self._maybe_flush(now)
        return False

    def try_acquire_many(self, keys, permits=None) -> list:
        """Batched decision surface: burn locally where live leases
        cover, then coalesce EVERY fallback decision of the flush into
        columnar batch frames (transport ``acquire_block``, wire v5 —
        one frame per chunk instead of one frame per request).
        Decisions are positionally identical to calling
        :meth:`try_acquire` per key; only the wire framing changes.
        Transports without ``acquire_block`` fall back per-request."""
        n = len(keys)
        perms = ([1] * n if permits is None
                 else [max(int(p), 1) for p in permits])
        out = [False] * n
        fb_i: list = []
        fb_k: list = []
        fb_p: list = []
        telem = self._telem
        now = int(self._clock_ms())
        for i, key in enumerate(keys):
            p = perms[i]
            lease = self._leases.get(key)
            hit = lease is not None and now < lease.deadline \
                and lease.remaining >= p
            if not hit:
                lease = self._refresh(key, lease, now)
            if lease is not None and now < lease.deadline \
                    and lease.remaining >= p:
                lease.remaining -= p
                lease.used += p
                if hit:
                    self.local_decisions += 1
                self.allowed_by_key[key] += p
                if telem is not None:
                    telem.record_burn(self.lid, key, p, None)
                out[i] = True
                continue
            if self.direct_fallback:
                fb_i.append(i)
                fb_k.append(key)
                fb_p.append(p)
            else:
                self.local_denies += 1
                if telem is not None:
                    telem.record_deny(self.lid, key, None)
        if telem is not None:
            self._maybe_flush(now)
        if fb_i:
            block = getattr(self._t, "acquire_block", None)
            if block is not None:
                # One columnar frame per 16-row chunk (the server's
                # default pipeline cap bounds declared rows per frame).
                self.wire_ops += -(-len(fb_k) // 16)
                allowed = block(self.lid, fb_k, permits=fb_p)
            else:
                allowed = []
                for k, p in zip(fb_k, fb_p):
                    self.wire_ops += 1
                    allowed.append(bool(self._t.try_acquire(self.lid, k, p)))
            for i, k, p, a in zip(fb_i, fb_k, fb_p, allowed):
                if a:
                    out[i] = True
                    self.allowed_by_key[k] += p
        return out

    # -- telemetry flushing ----------------------------------------------------
    def _maybe_flush(self, now: int) -> None:
        if self._telem is not None and self._telem.pending() \
                and now - self._last_flush >= self.telemetry_flush_ms:
            self._flush_telemetry(now)

    def _flush_telemetry(self, now: int) -> None:
        """Ship the accumulated report.  Drop-don't-block: a failed
        send loses that report's counts (counted in
        ``telemetry_dropped``) and never retries inline.  A transport
        whose telemetry latched down is re-armed here (reconnect +
        re-HELLO) at a bounded cadence — never more often than
        ``telemetry_rearm_ms`` — so one bad write costs at most one
        re-arm window of reports, not the client's lifetime."""
        telem = self._telem
        if telem is None or not telem.pending():
            return
        if getattr(self._t, "_telemetry_down", False) \
                and hasattr(self._t, "reconnect") \
                and now - self._last_rearm >= self.telemetry_rearm_ms:
            self._last_rearm = now
            try:
                rearmed = bool(self._t.reconnect())
            except Exception:  # noqa: BLE001 — telemetry never propagates
                rearmed = False
            if rearmed:
                self.telemetry_rearmed += 1
        self._last_flush = now
        blob = telem.encode_and_reset()
        try:
            ok = self._t.telemetry_report(blob)
        except Exception:  # noqa: BLE001 — telemetry must never propagate
            ok = False
        if ok:
            self.telemetry_flushes += 1
        else:
            self.telemetry_dropped += 1

    def _refresh(self, key: str, lease: Optional[_Local],
                 now: int) -> Optional[_Local]:
        """Renew/re-grant over the wire; None when no budget is usable
        (cooldown after a zero grant, or the server refused)."""
        if lease is not None and lease.remaining <= 0 \
                and now < lease.deny_until:
            return None  # zero-grant cooldown: no wire spam
        # Piggyback: the renew/grant below already pays a round trip;
        # a response-less TELEMETRY frame in front of it rides free.
        self._flush_telemetry(now)
        tid = lease.trace if lease is not None else 0
        if not tid and self._trace_lineage:
            from ratelimiter_tpu_torch.observability.telemetry import (
                mint_trace_id,
            )

            tid = mint_trace_id()
        if lease is not None and (lease.used or lease.remaining):
            self.wire_ops += 1
            resp = self._t.lease_renew(self.lid, key, lease.used,
                                       self.budget, trace_id=tid)
            lease.used = 0
            if resp is None:  # revoked: re-grant against whatever serves
                self.revoked_seen += 1
                self.wire_ops += 1
                resp = self._t.lease_grant(self.lid, key, self.budget,
                                           trace_id=tid)
        else:
            self.wire_ops += 1
            resp = self._t.lease_grant(self.lid, key, self.budget,
                                       trace_id=tid)
        if resp is None:
            self._leases.pop(key, None)
            return None
        granted, ttl_ms, epoch = resp[0], resp[1], resp[2]
        if granted <= 0:
            cool = _Local(0, now, epoch, deny_until=now + max(ttl_ms, 1),
                          trace=tid)
            self._leases[key] = cool
            return None
        fresh = _Local(granted, now + ttl_ms, epoch, trace=tid)
        self._leases[key] = fresh
        return fresh

    # -- lifecycle -------------------------------------------------------------
    def release_all(self) -> None:
        """Report final burns and hand every unused budget back (after
        a final telemetry flush, so the server's fleet counters
        reconcile exactly at release time)."""
        self._flush_telemetry(int(self._clock_ms()))
        for key, lease in list(self._leases.items()):
            if lease.used or lease.remaining:
                self.wire_ops += 1
                try:
                    self._t.lease_release(self.lid, key, lease.used,
                                          trace_id=lease.trace)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
        self._leases.clear()

    def drop(self) -> dict:
        """Simulate a client crash (the chaos drill's kill): abandon
        every lease WITHOUT releasing — returns what was outstanding so
        the drill can assert the over-admission bound."""
        out = {k: {"remaining": v.remaining, "used": v.used}
               for k, v in self._leases.items()}
        self._leases.clear()
        return out

    close = release_all
