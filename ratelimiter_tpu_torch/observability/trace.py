"""Request-lifecycle tracing: enqueue -> assembly -> device -> resolve
(counterpart of ``ratelimiter_tpu/observability/trace.py``).

The micro-batcher stamps each submitted request with a monotonic
timestamp; the dispatch/drain pipeline adds three more (batch taken,
dispatch enqueued, device results fetched, futures resolved).  This
module aggregates those stamps into the per-stage histograms the
latency-SLO work needs:

- ``ratelimiter.latency.queue_wait`` — submit until the flusher took the
  batch (per request; the adaptive-flush controller's feedback signal),
- ``ratelimiter.latency.assembly``   — take until the device dispatch
  call returned (host-side batch build, per batch),
- ``ratelimiter.latency.device``     — dispatch until the blocking fetch
  returned (per batch),
- ``ratelimiter.latency.resolve``    — fetch until every waiter's future
  was resolved (per batch),
- ``ratelimiter.latency.total``      — submit to resolve (per request).

The four stages telescope: queue_wait + assembly + device + resolve ==
total for the oldest request of a batch, by construction — the
trace-propagation test asserts it.

**Sampling.**  With ``sample_n > 0`` (config
``ratelimiter.obs.trace_sample``), one request per ~N is recorded as a
full per-request trace into the enriched ``DecisionTrace`` ring
(``utils/tracing.py``): stage breakdown, dispatch path, micro-batch
size — scraped at ``/actuator/trace``.

**Anomaly hook.**  A batch whose oldest request exceeded the flight
recorder's SLO threshold snapshots its stage breakdown plus recent ring
events (``FlightRecorder.note_dispatch``).

**Stream dispatch routes.**  The streaming loops bypass the batcher, so
their lifecycle lives in the ``ratelimiter.stream.*`` stage timers
(route/pack/index/layout/enqueue/fetch — per shard on the sharded path)
instead of the histograms above; every stream dispatch still records
its route into the same ``DecisionTrace`` ring (``relay|digest``,
``flat``, ``sharded|digest`` / ``sharded|words`` with its shard id, …)
and feeds the same slow-dispatch anomaly hook, so one
``/actuator/trace`` read shows which path — micro, flat, or a specific
shard's lane — a slow decision took (ARCHITECTURE §6c, §13).
"""

from __future__ import annotations

from typing import Optional, Sequence

STAGES = ("queue_wait", "assembly", "device", "resolve", "total")

#: Assembly sub-stages, mirroring the stream path's
#: pack/index/layout split: where inside the assembly stage a
#: micro-batch's microseconds go.  ``pack`` = host staging-buffer
#: finalize + eviction clears at take, ``index`` = per-request key->slot
#: assignment (recorded at submit, the only per-request piece),
#: ``layout`` = device placement + step enqueue.
ASSEMBLY_SUBSTAGES = ("pack", "index", "layout")


class LatencyTracer:
    """Aggregates batcher lifecycle timestamps into stage histograms."""

    def __init__(self, registry, trace=None, sample_n: int = 0,
                 recorder=None, lineage=None):
        self._h = {
            stage: registry.timer(
                f"ratelimiter.latency.{stage}",
                f"Request lifecycle: {stage} stage (us)")
            for stage in STAGES
        }
        self._sub = {
            stage: registry.timer(
                f"ratelimiter.latency.assembly.{stage}",
                f"Micro-batch assembly sub-stage: {stage} (us)")
            for stage in ASSEMBLY_SUBSTAGES
        }
        self._trace = trace
        self._sample_n = max(int(sample_n), 0)
        self._tick = 0          # requests since the last sampled trace
        self._recorder = recorder
        # Trace-id lineage ring (observability/telemetry.TraceLineage):
        # sampled ids get per-hop records (batcher/shard/resolve) so a
        # trace minted at ingress reads as an ordered path.
        self._lineage = lineage

    def record_sub(self, stage: str, us: float) -> None:
        """One assembly sub-stage sample (storage dispatch path)."""
        self._sub[stage].record_us(us)

    def observe_batch(self, algo: str, out: Optional[dict],
                      t_subs: Sequence[float], t_take: float,
                      t_disp: float, t_dev: float, t_res: float,
                      trace_ids: Optional[Sequence[int]] = None) -> None:
        """One dispatched-and-resolved batch's stamps.  Runs on the
        drain thread AFTER the waiters' futures resolved — nothing here
        is on a caller's critical path.  ``trace_ids`` (aligned with
        ``t_subs``; 0 = untraced) feed the lineage ring and enrich the
        sampled DecisionTrace with the trace the batch carried."""
        n = len(t_subs)
        if n == 0:
            return
        h = self._h
        h["assembly"].record_us((t_disp - t_take) * 1e6)
        h["device"].record_us((t_dev - t_disp) * 1e6)
        h["resolve"].record_us((t_res - t_dev) * 1e6)
        qh, th = h["queue_wait"], h["total"]
        for t0 in t_subs:
            qh.record_us((t_take - t0) * 1e6)
            th.record_us((t_res - t0) * 1e6)

        # Oldest request = the batch's worst case; it feeds both the
        # sampler and the SLO anomaly hook.
        t_oldest = min(t_subs)
        stages_us = {
            "queue_wait": (t_take - t_oldest) * 1e6,
            "assembly": (t_disp - t_take) * 1e6,
            "device": (t_dev - t_disp) * 1e6,
            "resolve": (t_res - t_dev) * 1e6,
        }
        total_us = (t_res - t_oldest) * 1e6

        sampled_tids = []
        lin = self._lineage
        if lin is not None and trace_ids:
            sampled_tids = [t for t in trace_ids if t and lin.sampled(t)]
            for i, tid in enumerate(trace_ids):
                if not tid or tid not in sampled_tids:
                    continue
                lin.record(tid, "batcher", algo=algo, batch=n,
                           queue_wait_us=round(
                               (t_take - t_subs[i]) * 1e6, 1),
                           assembly_us=round(
                               (t_disp - t_take) * 1e6, 1))
                lin.record(tid, "shard", path="micro", shard=0,
                           device_us=round((t_dev - t_disp) * 1e6, 1))
                lin.record(tid, "resolve",
                           total_us=round((t_res - t_subs[i]) * 1e6, 1))

        if self._sample_n and self._trace is not None:
            self._tick += n
            if self._tick >= self._sample_n:
                self._tick = 0
                allowed = -1
                if out is not None and "allowed" in out:
                    allowed = int(sum(1 for a in out["allowed"] if a))
                extra = {}
                if sampled_tids:
                    from ratelimiter_tpu_torch.observability.telemetry import (
                        trace_hex,
                    )

                    extra["trace"] = trace_hex(sampled_tids[0])
                self._trace.record(
                    algo, n, allowed, total_us, path="micro",
                    stages_us={k: round(v, 1)
                               for k, v in stages_us.items()},
                    **extra)

        if self._recorder is not None:
            self._recorder.note_dispatch(total_us, stages_us,
                                         algo=algo, batch=n, path="micro")
