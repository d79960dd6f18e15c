"""Adaptive flush control for the micro-batcher (r11).

The fixed size-or-deadline flush trigger (max_batch / max_delay_ms) makes
one latency promise for every load shape: a lightly-loaded deployment
waits the full deadline for batches the device could have served three
times over, and a saturated one flushes tiny batches faster than the
device absorbs them, paying per-dispatch assembly cost for no extra
throughput.  This controller trades the two against the **measured**
device-step time (the `device` stage the PR 7 lifecycle histograms
expose, fed here per drained batch):

- the applied flush deadline tracks ``step_ewma * headroom`` — there is
  no point flushing faster than the device can start the next step, and
  no reason to wait longer than one service interval;
- the size trigger tracks recent batch volume, so a burst flushes as
  soon as it reaches what one device step has been absorbing instead of
  waiting out the deadline.

Both outputs are **hard-clamped** to configured [floor, cap] bounds, and
samples are clamped to a multiple of the current estimate before they
enter the EWMA — a pathological reading (a first-use kernel build, a
wedged fetch) nudges the estimate instead of pinning the deadline at the
cap for thousands of batches.  Applied values only move after the
proposal has pointed the same direction for ``hysteresis_steps``
consecutive observations (the flap-damping idiom of
``replication/orchestrator.py``: consecutive evidence, then act —
a single noisy sample changes nothing), so the controller converges
instead of oscillating.

Deterministic by construction: no wall clock — ``observe()`` consumes
measurements, counters implement the hysteresis — so tests drive it with
a simulated ramp (tests/test_microbatch.py).
"""

from __future__ import annotations

import threading


def _clamp(x: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, x))


class AdaptiveFlushController:
    """Feeds the micro-batcher's flush deadline and size trigger from the
    measured device-step time.  Thread-safe: ``observe`` runs on drain
    threads, the getters on the flusher."""

    def __init__(
        self,
        base_delay_ms: float = 0.5,
        floor_ms: float = 0.05,
        cap_ms: float | None = None,
        size_floor: int = 32,
        size_cap: int = 8192,
        headroom: float = 1.0,
        alpha: float = 0.25,
        hysteresis_steps: int = 3,
        hysteresis_pct: float = 0.2,
        sample_clamp: float = 4.0,
        meter_registry=None,
    ):
        # cap defaults to the configured deadline: max_delay_ms is the
        # batcher's latency promise, so adaptation only ever SHRINKS the
        # wait below it, never extends it.
        cap_ms = base_delay_ms if cap_ms is None else cap_ms
        if floor_ms <= 0 or cap_ms < floor_ms:
            raise ValueError("need 0 < floor_ms <= cap_ms")
        if size_floor < 1 or size_cap < size_floor:
            raise ValueError("need 1 <= size_floor <= size_cap")
        self.floor_s = floor_ms / 1000.0
        self.cap_s = cap_ms / 1000.0
        self.size_floor = int(size_floor)
        self.size_cap = int(size_cap)
        self.headroom = float(headroom)
        self.alpha = float(alpha)
        self.hysteresis_steps = max(int(hysteresis_steps), 1)
        self.hysteresis_pct = float(hysteresis_pct)
        self.sample_clamp = float(sample_clamp)
        self._lock = threading.Lock()
        self._step_ewma: float | None = None
        self._batch_ewma: float | None = None
        self._applied_delay_s = _clamp(base_delay_ms / 1000.0,
                                       self.floor_s, self.cap_s)
        self._applied_size = self.size_cap
        self._delay_streak = 0   # signed consecutive-direction count
        self._size_streak = 0
        self.adjustments = 0     # applied-value changes (observability)
        self.clamped_samples = 0  # readings cut by sample_clamp
        self._delay_gauge = (
            meter_registry.gauge(
                "ratelimiter.microbatch.flush_delay_ms",
                "Adaptive flush controller: applied micro-batch flush "
                "deadline (ms)")
            if meter_registry is not None else None)
        self._size_gauge = (
            meter_registry.gauge(
                "ratelimiter.microbatch.size_trigger",
                "Adaptive flush controller: applied micro-batch size "
                "trigger (requests)")
            if meter_registry is not None else None)
        if self._delay_gauge is not None:
            self._delay_gauge.set(self._applied_delay_s * 1000.0)
        if self._size_gauge is not None:
            self._size_gauge.set(self._applied_size)

    # -- feedback (drain threads) ---------------------------------------------
    def observe(self, step_s: float, batch_n: int) -> None:
        """One drained batch: its device-stage seconds and lane count."""
        if step_s < 0:
            return
        with self._lock:
            if self._step_ewma is not None:
                ceil = self.sample_clamp * max(self._step_ewma, self.floor_s)
                if step_s > ceil:
                    step_s = ceil
                    self.clamped_samples += 1
                self._step_ewma += self.alpha * (step_s - self._step_ewma)
                self._batch_ewma += self.alpha * (batch_n - self._batch_ewma)
            else:
                self._step_ewma = min(step_s, self.cap_s * self.sample_clamp)
                self._batch_ewma = float(batch_n)
            self._update_delay()
            self._update_size()

    def _hysteresis(self, proposed: float, applied: float,
                    streak: int) -> tuple:
        """(new_streak, apply?): require hysteresis_steps consecutive
        same-direction proposals deviating > hysteresis_pct."""
        if applied <= 0:
            return 0, True
        dev = (proposed - applied) / applied
        if abs(dev) <= self.hysteresis_pct:
            return 0, False
        step = 1 if dev > 0 else -1
        streak = streak + step if streak * step > 0 else step
        return streak, abs(streak) >= self.hysteresis_steps

    def _update_delay(self) -> None:
        proposed = _clamp(self._step_ewma * self.headroom,
                          self.floor_s, self.cap_s)
        self._delay_streak, apply = self._hysteresis(
            proposed, self._applied_delay_s, self._delay_streak)
        if apply:
            self._applied_delay_s = proposed
            self._delay_streak = 0
            self.adjustments += 1
            if self._delay_gauge is not None:
                self._delay_gauge.set(proposed * 1000.0)

    def _update_size(self) -> None:
        # Flush a burst once it reaches ~2x what one device step has been
        # absorbing: past that point more coalescing buys bigger steps,
        # not fewer, and the oldest request is already paying for it.
        proposed = _clamp(self._batch_ewma * 2.0,
                          self.size_floor, self.size_cap)
        self._size_streak, apply = self._hysteresis(
            proposed, float(self._applied_size), self._size_streak)
        if apply:
            self._applied_size = int(round(proposed))
            self._size_streak = 0
            self.adjustments += 1
            if self._size_gauge is not None:
                self._size_gauge.set(self._applied_size)

    # -- applied values (flusher) ---------------------------------------------
    def delay_s(self) -> float:
        return self._applied_delay_s

    def size_trigger(self) -> int:
        return self._applied_size

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "delay_ms": self._applied_delay_s * 1000.0,
                "size_trigger": self._applied_size,
                "step_ewma_ms": (self._step_ewma or 0.0) * 1000.0,
                "batch_ewma": self._batch_ewma or 0.0,
                "adjustments": self.adjustments,
                "clamped_samples": self.clamped_samples,
            }
