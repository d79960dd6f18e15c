"""Adaptive per-tenant policy controller: AIMD + hierarchical global cap
(counterpart of ``ratelimiter_tpu/control/controller.py``).

This module closes the loop from observation to actuation:

- **Observation**: the fleet telemetry plane's per-tenant
  :class:`~ratelimiter_tpu_torch.observability.usage.UsageSignals`
  (``plane.all_signals(window_ms)``) — fleet-true under leases, within
  the documented staleness bound — plus the circuit breaker's
  state as the global overload signal.
- **Decision**: per-tenant AIMD over a *fraction* of the tenant's
  operator-set ceiling.  While the tenant's denied+shed share of its
  observed load stays under ``target_excess``, the fraction rises
  additively (``increase_fraction`` per tick) toward the ceiling; an
  overload verdict — the tenant hammering far past its limit, sheds
  landing on it, or the breaker open — cuts it multiplicatively
  (``decrease_factor``), clamped to the operator floor.  Hierarchical
  enforcement adds a **global aggregate cap**: when the fleet's RAW
  observed load exceeds ``global_cap_per_s``, every tenant's effective
  rate is scaled by ``cap / fleet_observed``.  Scaling by observed
  load (not admitted rate) is deliberate: in a shed-heavy storm the
  admitted rate can sit UNDER the cap while arrivals are far above it,
  and an admitted-rate trigger would never engage — under-throttling
  exactly when the aggregate needs protecting.  The scale is
  floor-protected per tenant (``max(fraction * scale, floor)``), so a
  hammering fleet cannot squeeze a well-behaved tenant below its
  operator floor while AIMD reallocates the cut onto whoever is
  storming.
- **Actuation**: ``storage.set_policy(lid, config)`` — three scalar
  device row updates stamped with a monotonic policy generation
  (``LimiterTable.set_policy``, on the card's policy tensors); the
  window/algo shape never moves.
  Only CHANGED effective policies actuate, so a converged controller
  ticks for free.

The loop is single-threaded and tick-driven (the failover
orchestrator's idiom): ``tick()`` advances everything once — tests drive it with a
simulated clock for exact timelines — and ``start()`` runs it on a
cadence thread.  Operators freeze a lid out of the loop entirely with
:meth:`pin` (``POST /actuator/policies/<lid>/pin``); a pinned lid keeps
whatever effective policy it had and ignores both AIMD and the global
scale until unpinned.

Metrics: ``ratelimiter.control.adjustments`` (set_policy actuations),
``.pinned`` (currently pinned lids), ``.generation`` (the table's
policy generation), ``.global_scale`` (1.0 = cap disengaged).  Flight
events: ``policy.adjusted`` — coalesced per lid with a tally, the
lease ``revocation_storm`` idiom, so a converging AIMD reads as one
ring entry per lid per window, not one per tick — and
``control.global_cap_engaged``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("control.controller")

# Per-lid controller verdicts (status() / GET /actuator/policies).
STEADY = "STEADY"      # at ceiling, healthy
RAISING = "RAISING"    # additive recovery toward the ceiling
CUTTING = "CUTTING"    # multiplicative cut this tick
PINNED = "PINNED"      # operator froze the lid out of the loop
IDLE = "IDLE"          # no observable load in the window


def _wall_ms() -> int:
    return time.time_ns() // 1_000_000


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Knobs, mirrored 1:1 by the ``ratelimiter.control.*`` props."""

    # Tick cadence (the start() thread; tests call tick() directly).
    interval_ms: float = 1000.0
    # Observation window handed to all_signals() — two ticks' worth by
    # default so one noisy bucket cannot flap a verdict.
    window_ms: int = 2000
    # Overload verdict: the tenant's (denied+shed)/observed share above
    # which its limit is cut multiplicatively.
    target_excess: float = 0.5
    # Additive raise per healthy tick, as a fraction of the ceiling.
    increase_fraction: float = 0.1
    # Multiplicative cut factor on an overload verdict.
    decrease_factor: float = 0.5
    # Default operator floor, as a fraction of the ceiling (per-lid
    # overrides via configure()).
    floor_fraction: float = 0.1
    # Hierarchical global cap on the fleet's aggregate load
    # (decisions/s); 0 disables.  Engages on RAW observed load — not
    # admitted rate, which a shed-heavy storm keeps under the cap
    # while arrivals are far above it.
    global_cap_per_s: float = 0.0
    # Telemetry staleness bound (ms); 0 disables.  When the plane's
    # ``staleness_ms`` exceeds it (a partitioned reporter, a dead
    # member link), the controller FREEZES raises — stale signals must
    # never justify giving a tenant more — while cuts stay allowed.
    staleness_bound_ms: float = 0.0
    # Tenants below this observed load get no verdict (their fraction
    # holds; raising an idle tenant would be guessing).
    min_load_per_s: float = 0.5
    # policy.adjusted events coalesce per lid within this window.
    event_coalesce_ms: float = 2000.0

    def validate(self) -> "ControlConfig":
        if not (0.0 < self.decrease_factor < 1.0):
            raise ValueError("decrease_factor must be in (0, 1)")
        if not (0.0 < self.increase_fraction <= 1.0):
            raise ValueError("increase_fraction must be in (0, 1]")
        if not (0.0 < self.floor_fraction <= 1.0):
            raise ValueError("floor_fraction must be in (0, 1]")
        if not (0.0 <= self.target_excess < 1.0):
            raise ValueError("target_excess must be in [0, 1)")
        if self.staleness_bound_ms < 0:
            raise ValueError("staleness_bound_ms must be >= 0")
        return self


class _LidState:
    """One controlled tenant: its ceiling (the registered policy), the
    operator floor, and the AIMD fraction between them."""

    __slots__ = ("algo", "ceiling", "floor_frac", "fraction", "pinned",
                 "applied", "verdict", "adjustments",
                 "last_event_ms", "coalesced")

    def __init__(self, algo: str, ceiling: RateLimitConfig,
                 floor_frac: float):
        self.algo = algo
        self.ceiling = ceiling
        self.floor_frac = floor_frac
        self.fraction = 1.0          # start at the provisioned ceiling
        self.pinned = False
        # (max_permits, refill_rate) last actuated; None = as registered.
        self.applied: Optional[tuple] = None
        self.verdict = STEADY
        self.adjustments = 0
        self.last_event_ms = 0
        self.coalesced = 0           # adjustments since the last event


class AdaptivePolicyController:
    """Tick-driven AIMD controller over a storage's policy table."""

    def __init__(self, storage, config: ControlConfig | None = None, *,
                 telemetry=None, breaker=None, clock_ms=None,
                 registry=None, recorder=None):
        self.storage = storage
        self.config = (config or ControlConfig()).validate()
        self._plane = (telemetry if telemetry is not None
                       else getattr(storage, "telemetry", None))
        if self._plane is None:
            raise ValueError(
                "the adaptive controller needs the fleet telemetry plane "
                "(storage built with observability=True) for its "
                "UsageSignals observations")
        self._breaker = breaker
        self._clock_ms = (clock_ms
                          or getattr(storage, "_clock_ms", None)
                          or _wall_ms)
        self._lock = threading.RLock()
        self._lids: Dict[int, _LidState] = {}
        self.ticks = 0
        self.adjustments_total = 0
        self.global_scale = 1.0
        self.global_cap_engagements = 0
        self._cap_event_ms = 0
        self.signals_stale_ticks = 0
        self._stale_event_ms = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if recorder is not None:
            self._recorder = recorder
        else:
            from ratelimiter_tpu_torch.observability import flight_recorder

            self._recorder = flight_recorder()
        if registry is not None:
            self._m_adjust = registry.counter(
                "ratelimiter.control.adjustments",
                "Live policy actuations (set_policy row updates) by the "
                "adaptive controller")
            self._m_pinned = registry.gauge(
                "ratelimiter.control.pinned",
                "Lids currently pinned out of the control loop by an "
                "operator")
            self._m_generation = registry.gauge(
                "ratelimiter.control.generation",
                "The policy table's monotonic generation (bumps on every "
                "live policy update)")
            self._m_scale = registry.gauge(
                "ratelimiter.control.global_scale",
                "Global-cap scale applied to every tenant's effective "
                "rate (1.0 = cap disengaged)")
            self._m_scale.set(1.0)
        else:
            self._m_adjust = self._m_pinned = None
            self._m_generation = self._m_scale = None

    # -- operator surface ------------------------------------------------------
    def configure(self, lid: int, *, floor: Optional[int] = None,
                  ceiling: Optional[RateLimitConfig] = None) -> None:
        """Set one lid's operator bounds: ``floor`` in permits (clamped
        to [1, ceiling]); ``ceiling`` replaces the registered policy as
        the AIMD upper bound (window immutable, like set_policy)."""
        with self._lock:
            st = self._ensure(int(lid))
            if st is None:
                raise KeyError(f"no limiter registered under lid={lid}")
            if ceiling is not None:
                ceiling.validate()
                if ceiling.window_ms != st.ceiling.window_ms:
                    raise ValueError("ceiling cannot change the window")
                st.ceiling = ceiling
            if floor is not None:
                floor = max(int(floor), 1)
                st.floor_frac = min(
                    max(floor / max(st.ceiling.max_permits, 1), 0.0), 1.0)

    def pin(self, lid: int, pinned: bool = True) -> Dict:
        """Freeze a lid out of the control loop (or release it).  The
        lid keeps its current effective policy while pinned."""
        with self._lock:
            st = self._ensure(int(lid))
            if st is None:
                raise KeyError(f"no limiter registered under lid={lid}")
            st.pinned = bool(pinned)
            if st.pinned:
                st.verdict = PINNED
            self._recorder.record("control.pinned" if pinned
                                  else "control.unpinned", lid=int(lid))
            if self._m_pinned is not None:
                self._m_pinned.set(float(sum(
                    1 for s in self._lids.values() if s.pinned)))
            return {"lid": int(lid), "pinned": st.pinned}

    def pinned_lids(self):
        with self._lock:
            return sorted(l for l, s in self._lids.items() if s.pinned)

    # -- the loop --------------------------------------------------------------
    def _ensure(self, lid: int) -> Optional[_LidState]:
        """Adopt a lid into the loop (its registered config becomes the
        ceiling).  Returns None for unregistered lids."""
        st = self._lids.get(lid)
        if st is not None:
            return st
        entry = getattr(self.storage, "_configs", {}).get(lid)
        if entry is None:
            return None
        algo, cfg = entry
        st = _LidState(algo, cfg, self.config.floor_fraction)
        self._lids[lid] = st
        return st

    def tick(self) -> None:
        """Advance the whole loop once: observe, decide, actuate.
        Single-threaded and clock-injected — drills and tests call it
        directly for deterministic timelines."""
        with self._lock:
            self.ticks += 1
            now = int(self._clock_ms())
            cfg = self.config
            for lid in list(getattr(self.storage, "_configs", {})):
                self._ensure(int(lid))
            signals = self._plane.all_signals(cfg.window_ms)
            breaker_open = False
            if self._breaker is not None:
                breaker_open = getattr(self._breaker, "state",
                                       "closed") != "closed"
            # -- staleness freeze -----------------------------------------
            # Stale observations must never justify RAISING a limit (a
            # partitioned reporter's last window could hide a storm);
            # cuts remain allowed — acting on overload evidence is safe
            # even if it is old.
            stale = False
            if cfg.staleness_bound_ms > 0:
                staleness = float(self._plane.staleness_ms())
                stale = staleness > cfg.staleness_bound_ms
                if stale:
                    self.signals_stale_ticks += 1
                    if now - self._stale_event_ms > cfg.event_coalesce_ms:
                        self._stale_event_ms = now
                        self._recorder.record(
                            "control.signals_stale",
                            staleness_ms=round(staleness, 1),
                            bound_ms=cfg.staleness_bound_ms)
            # -- hierarchical global cap ----------------------------------
            fleet_observed = sum(s.observed_load for s in signals.values())
            fleet_admitted = sum(s.goodput for s in signals.values())
            scale = 1.0
            if (cfg.global_cap_per_s > 0
                    and fleet_observed > cfg.global_cap_per_s):
                # Raw OBSERVED load is the trigger and the divisor: a
                # shed-heavy storm keeps the admitted rate under the
                # cap while arrivals are far above it, so admitted-rate
                # scaling would never engage.
                scale = cfg.global_cap_per_s / fleet_observed
                self.global_cap_engagements += 1
                if now - self._cap_event_ms > cfg.event_coalesce_ms:
                    self._cap_event_ms = now
                    self._recorder.record(
                        "control.global_cap_engaged",
                        observed_per_s=round(fleet_observed, 1),
                        admitted_per_s=round(fleet_admitted, 1),
                        scale=round(scale, 4))
            if stale and scale > self.global_scale:
                # A relaxing cap is a raise too: hold the tighter scale
                # until the plane reports fresh signals.
                scale = self.global_scale
            self.global_scale = scale
            if self._m_scale is not None:
                self._m_scale.set(scale)
            # -- per-tenant AIMD ------------------------------------------
            for lid, st in self._lids.items():
                if st.pinned:
                    st.verdict = PINNED
                    continue
                s = signals.get(lid)
                if s is None or s.observed_load < cfg.min_load_per_s:
                    if not breaker_open:
                        st.verdict = IDLE
                        continue
                    excess = 0.0
                else:
                    excess = ((s.denied_rate + s.shed_rate)
                              / max(s.observed_load, 1e-9))
                if breaker_open or excess > cfg.target_excess:
                    st.fraction = max(st.floor_frac,
                                      st.fraction * cfg.decrease_factor)
                    st.verdict = CUTTING
                elif st.fraction < 1.0 and not stale:
                    st.fraction = min(1.0,
                                      st.fraction + cfg.increase_fraction)
                    st.verdict = RAISING
                else:
                    st.verdict = STEADY
                self._actuate(lid, st, scale, now)
            if self._m_generation is not None:
                table = getattr(self.storage, "table", None)
                if table is not None:
                    self._m_generation.set(float(table.generation))

    def _actuate(self, lid: int, st: _LidState, scale: float,
                 now: int) -> None:
        """Apply the lid's effective policy iff it changed."""
        # Floor-protected: the global scale must not squeeze a tenant
        # below its operator floor (AIMD reallocates the cut instead).
        eff = max(st.fraction * scale, st.floor_frac)
        ceiling = st.ceiling
        permits = max(1, round(ceiling.max_permits * eff))
        refill = round(ceiling.refill_rate * eff, 6)
        if ceiling.refill_rate > 0:
            # A token bucket must keep refilling (a zero rate would
            # freeze the bucket, not limit it).
            refill = max(refill, 1e-6)
        if st.applied is None:
            # Never actuated: the registered row IS the ceiling.
            if (permits, refill) == (ceiling.max_permits,
                                     round(ceiling.refill_rate, 6)):
                return
        elif (permits, refill) == st.applied:
            return
        new_cfg = dataclasses.replace(ceiling, max_permits=permits,
                                      refill_rate=refill)
        gen = self.storage.set_policy(lid, new_cfg)
        st.applied = (permits, refill)
        st.adjustments += 1
        st.coalesced += 1
        self.adjustments_total += 1
        if self._m_adjust is not None:
            self._m_adjust.increment()
        # policy.adjusted coalesces PER LID (the revocation_storm idiom:
        # a converging AIMD emits one tallied event per window, the ring
        # shows the episode, not every step).
        if now - st.last_event_ms > self.config.event_coalesce_ms:
            self._recorder.record(
                "policy.adjusted", lid=int(lid), verdict=st.verdict,
                max_permits=permits, fraction=round(st.fraction, 4),
                global_scale=round(scale, 4), generation=int(gen),
                n_coalesced=st.coalesced)
            st.last_event_ms = now
            st.coalesced = 0

    # -- introspection ---------------------------------------------------------
    def status(self) -> Dict:
        with self._lock:
            table = getattr(self.storage, "table", None)
            lids = {}
            for lid, st in sorted(self._lids.items()):
                eff = (st.fraction if st.pinned
                       else max(st.fraction * self.global_scale,
                                st.floor_frac))
                applied = st.applied or (st.ceiling.max_permits,
                                         round(st.ceiling.refill_rate, 6))
                lids[str(lid)] = {
                    "algo": st.algo,
                    "state": st.verdict,
                    "pinned": st.pinned,
                    "fraction": round(st.fraction, 4),
                    "effective_max_permits": applied[0],
                    "effective_refill_rate": applied[1],
                    "ceiling_max_permits": st.ceiling.max_permits,
                    "floor_max_permits": max(
                        1, round(st.ceiling.max_permits * st.floor_frac)),
                    "generation": (table.row_generation(lid)
                                   if table is not None else 0),
                    "adjustments": st.adjustments,
                    "effective_fraction": round(eff, 4),
                }
            return {
                "ticks": self.ticks,
                "generation": (table.generation if table is not None
                               else 0),
                "global_scale": round(self.global_scale, 4),
                "global_cap_per_s": self.config.global_cap_per_s,
                "global_cap_engagements": self.global_cap_engagements,
                "signals_stale_ticks": self.signals_stale_ticks,
                "adjustments": self.adjustments_total,
                "pinned": [l for l, s in sorted(self._lids.items())
                           if s.pinned],
                "lids": lids,
            }

    # -- cadence thread (the failover orchestrator's idiom) --------------------
    def start(self) -> "AdaptivePolicyController":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="policy-controller")
        self._thread.start()
        return self

    def _run(self) -> None:
        interval_s = max(self.config.interval_ms, 1.0) / 1000.0
        while not self._stop.wait(interval_s):
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — the loop must survive
                if type(exc).__name__ == "NotLeader":
                    # Fleet mode while not holding the cell: the
                    # actuation refusal is the CORRECT behaviour, and
                    # the election loop repairs leadership — not an
                    # error worth a stack trace per tick.
                    _log.debug("controller tick deferred: %s", exc)
                else:
                    _log.exception("controller tick failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self) -> None:
        self.stop()
