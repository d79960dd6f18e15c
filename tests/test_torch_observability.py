"""The observability layer, port against the JAX package: the usage ring,
the client telemetry codec, the telemetry plane, the trace lineage, the
request-lifecycle tracer and the Prometheus exposition (the cases of
``tests/test_telemetry.py`` and ``tests/test_observability.py``), and the
storage's telemetry and lineage records after the same calls on
``GpuBatchedStorage(device="cpu")`` and ``TpuBatchedStorage`` with the
same manual clock and explicit ``host_parallel``.

The same seeded inputs go through both packages' classes; counts,
windows, encoded bytes, scrapes and rendered text must be equal.  Fields
that measure wall time (the tracer's microseconds, the trace ring's
``t_ms``) are compared by presence, not value.
"""

import random
import time

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.observability import (
    FlightRecorder as RefRecorder,
    LatencyTracer as RefTracer,
    prometheus as ref_prometheus,
    telemetry as ref_telemetry,
    usage as ref_usage,
)
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu.utils.tracing import DecisionTrace as RefTrace
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.observability import (
    FlightRecorder,
    LatencyTracer,
    prometheus,
    telemetry,
    usage,
)
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from ratelimiter_tpu_torch.utils.tracing import DecisionTrace
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_700_000_000_000

# (usage module, telemetry module, registry class, prometheus module)
PACKAGES = {
    "ref": (ref_usage, ref_telemetry, RefRegistry, ref_prometheus),
    "port": (usage, telemetry, MeterRegistry, prometheus),
}


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t


def both(fn):
    """``fn(package modules)`` for the reference and the port."""
    return [fn(*PACKAGES[name]) for name in ("ref", "port")]


def no_wall(x):
    """``x`` without its wall-clock stamps (``t_ms`` keys, at any depth)."""
    if isinstance(x, dict):
        return {k: no_wall(v) for k, v in x.items() if k != "t_ms"}
    if isinstance(x, (list, tuple)):
        return type(x)(no_wall(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# Usage ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1234, 99])
def test_usage_ring_windows_match_reference(seed):
    """The same event log (mixed cadence, ring wrap-arounds and one jump
    past the whole span) gives equal window sums at every checkpoint."""
    def run(usage_mod, *_):
        rnd = random.Random(seed)
        clock = FakeClock()
        ring = usage_mod.UsageRing(clock_ms=clock, max_tenants=8,
                                   resolutions=((100, 8), (1000, 8)))
        out = []
        for step in range(3000):
            clock.t += rnd.choice([0, 1, 7, 40, 140, 900, 5000]
                                  if step != 1500 else [50_000])
            field = rnd.choice(usage_mod.FIELDS)
            ring.record(rnd.randrange(3), **{field: rnd.randrange(1, 5)})
            if step % 157 == 0:
                for tenant in range(3):
                    for window_ms in (100, 250, 800, 3000, 8000):
                        out.append(ring.window_counts(tenant, window_ms))
        return out

    ref, port = both(run)
    assert port == ref


def test_usage_ring_tenant_cap_and_signals_match_reference():
    def run(usage_mod, *_):
        ring = usage_mod.UsageRing(clock_ms=FakeClock(), max_tenants=2)
        recorded = [ring.record(t, admitted=1) for t in (1, 2, 3)]
        clock = FakeClock()
        sig_ring = usage_mod.UsageRing(clock_ms=clock,
                                       resolutions=((1000, 64),))
        sig_ring.record(7, admitted=30, denied=10)
        sig_ring.record(7, shed=5, lease_local=20)
        return (recorded, ring.dropped_tenants, ring.tenants(),
                tuple(sig_ring.signals(7, window_ms=10_000)))

    ref, port = both(run)
    assert port == ref
    assert ref[0] == [True, True, False] and ref[1] == 1


# ---------------------------------------------------------------------------
# Client telemetry codec + plane folding
# ---------------------------------------------------------------------------

def _client_records(telem):
    telem.record_burn(1, "acme:u1", 2, 3.0)
    telem.record_burn(1, "acme:u2", 1, 900.0)
    telem.record_deny(1, "globex:u9", 10.0)
    telem.record_burn(1, 'evil"class\n:x', 1, 1.0)   # 3rd class: overflow


def test_client_telemetry_bytes_match_reference():
    """The same records encode to the same bytes, and each package
    decodes the other's report to the same fields."""
    def run(_u, tel, *_):
        telem = tel.ClientTelemetry(client_id=42, max_classes=2)
        _client_records(telem)
        blob = telem.encode_and_reset()
        return blob, telem.pending()

    (ref_blob, ref_pending), (port_blob, port_pending) = both(run)
    assert port_blob == ref_blob and port_pending == ref_pending is False
    ref_report = ref_telemetry.decode_report(port_blob)
    port_report = telemetry.decode_report(ref_blob)
    assert tuple(port_report) == tuple(ref_report)
    assert (ref_report.allowed, ref_report.denied) == (3, 1)


def test_client_telemetry_stamping_matches_reference():
    def run(_u, tel, *_):
        telem = tel.ClientTelemetry(client_id=7)
        seen = [telem.stamp_pending]
        telem.record_burn(1, "t:a", 1, 4.0)
        seen.append(telem.stamp_pending)
        telem.record_burn(1, "t:a", 1)
        telem.record_deny(1, "t:b")
        first = telem.encode_and_reset()
        seen.append(telem.stamp_pending)
        telem.record_deny(1, "t:b", 9.0)
        return seen, first, telem.encode_and_reset()

    ref, port = both(run)
    assert port == ref
    assert ref[0] == [True, False, True]


@pytest.mark.parametrize("key", ["tenant:user123", "plainkey", ":leading",
                                 "a:b:c"])
def test_default_key_class_matches_reference(key):
    assert telemetry.default_key_class(key) == \
        ref_telemetry.default_key_class(key)


def test_plane_fold_counters_and_staleness_match_reference():
    """Reports, a malformed blob, server, shed and degraded notes: equal
    scrapes, counts, windows and staleness."""
    def run(_u, tel, registry_cls, _p):
        clock = FakeClock()
        reg = registry_cls()
        plane = tel.TelemetryPlane(reg, clock_ms=clock)
        telem = tel.ClientTelemetry(client_id=9)
        telem.record_burn(3, "t:one", 1, 5.0)
        telem.record_burn(3, "t:one", 1, 5.0)
        telem.record_deny(3, "u:two", 5.0)
        folded = plane.fold(telem.encode_and_reset())
        clock.t += 750
        stale = plane.staleness_ms()
        rejected = plane.fold(b"\x01garbage")
        plane.note_server(3, 10, 7)
        plane.note_shed(3, 2)
        plane.note_degraded(3, True)
        plane.note_batch(np.array([3, 4, 4, 3, 5], dtype=np.int64),
                         np.array([True, False, True, True, False]))
        return (folded, stale, rejected, plane.reports_rejected,
                plane.allowed_total, plane.shed_total, reg.scrape(),
                plane.usage.window_counts(3, 10_000),
                plane.tenants_payload(),
                tuple(plane.signals(3)))

    ref, port = both(run)
    assert port == ref
    assert ref[0] == 2 and ref[2] == -1 and ref[1] == 750.0


def test_plane_prometheus_labeled_series_match_reference():
    def run(_u, tel, registry_cls, prom):
        reg = registry_cls()
        plane = tel.TelemetryPlane(reg, clock_ms=FakeClock())
        telem = tel.ClientTelemetry(client_id=1,
                                    key_class=lambda k: k.split("|")[0])
        telem.record_burn(5, 'bad\\cls"x\n|y', 1, 2.0)
        plane.fold(telem.encode_and_reset())
        plane.note_server(6, 4, 3)
        return prom.render(reg, collectors=(plane,))

    ref, port = both(run)
    assert port == ref
    assert 'ratelimiter_tenant_admitted_total{tenant="5"} 1' in ref


def test_lineage_sampling_and_bounds_match_reference():
    """Forced and head-sampled ids (fixed ids, no minting), the per-trace
    hop bound and the capacity LRU."""
    def run(_u, tel, *_):
        lin = tel.TraceLineage(capacity=4, sample_n=0, max_hops=3)
        out = [lin.sampled(12345), lin.record(12345, "sidecar")]
        lin.force(12345)
        out += [lin.sampled(12345)] + [
            lin.record(12345, hop, n=i)
            for i, hop in enumerate(("sidecar", "batcher", "resolve",
                                     "overflow"))]
        out += [lin.hops(12345), lin.dropped_hops]
        for t in range(1000, 1006):
            lin.force(t)
            lin.record(t, "hop")
        out += [lin.lineage(1005), lin.lineage(12345), lin.snapshot()]
        head = tel.TraceLineage(sample_n=4)
        out.append([head.sampled(t) for t in range(1, 40)])
        return out, tel.trace_hex(0xABCDEF), tel.trace_hex(-1)

    ref, port = both(run)
    assert no_wall(port) == no_wall(ref)


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------

def test_prometheus_render_matches_reference():
    """Counters with and without descriptions, a gauge, escaped HELP, a
    timer's bucket ladder and a labeled collector: equal text."""
    class Collector:
        @staticmethod
        def prometheus_samples():
            return [("ratelimiter.tenant.admitted", "counter", "Per-tenant",
                     [({"tenant": "3"}, 10),
                      ({"tenant": "7", "key_class": 'a"b\\c\nd'}, 2)]),
                    ("ratelimiter.x-y.gauge", "gauge", "", [({}, 1.25)])]

    def run(_u, _t, registry_cls, prom):
        reg = registry_cls()
        reg.counter("ratelimiter.requests.allowed", "Allowed").add(42)
        reg.counter("ratelimiter.cache.hits").add(7)
        reg.counter("ratelimiter.weird-name.v2", "d").add(1)
        reg.gauge("ratelimiter.replication.lag_ms", "Lag").set(1.5)
        t = reg.timer("ratelimiter.storage.latency",
                      "Dispatch latency\nsecond line \\ backslash")
        rnd = random.Random(7)
        for v in [1.0, 3.0, 100.0] + [rnd.uniform(0.1, 1e7)
                                      for _ in range(300)]:
            t.record_us(v)
        reg.timer("ratelimiter.latency.total", "empty")
        return (prom.render(reg, collectors=(Collector(),)),
                prom.CONTENT_TYPE, prom.render(registry_cls()))

    ref, port = both(run)
    assert port == ref
    assert ref[2] == ""


# ---------------------------------------------------------------------------
# Request-lifecycle tracer
# ---------------------------------------------------------------------------

def test_latency_tracer_matches_reference():
    """The same batch stamps (sampling 1 in 3, lineage with forced ids,
    an SLO-armed recorder) give equal histograms, trace records (less
    ``t_ms``), lineage hops and anomalies."""
    def run(ref: bool):
        reg = RefRegistry() if ref else MeterRegistry()
        trace = RefTrace() if ref else DecisionTrace()
        rec = (RefRecorder if ref else FlightRecorder)(slo_ms=0.5)
        tel = ref_telemetry if ref else telemetry
        lin = tel.TraceLineage(capacity=16, sample_n=0)
        for tid in (11, 22):
            lin.force(tid)
        tracer = (RefTracer if ref else LatencyTracer)(
            reg, trace=trace, sample_n=3, recorder=rec, lineage=lin)
        rnd = random.Random(5)
        for b in range(12):
            n = rnd.randrange(1, 5)
            t0 = 100.0 + b
            t_subs = [t0 + rnd.random() * 1e-3 for _ in range(n)]
            t_take = max(t_subs) + rnd.random() * 1e-3
            t_disp = t_take + rnd.random() * 1e-3
            t_dev = t_disp + rnd.random() * 1e-3
            t_res = t_dev + rnd.random() * 1e-3
            out = {"allowed": [rnd.random() < 0.5 for _ in range(n)]}
            tids = [rnd.choice([0, 11, 22, 33]) for _ in range(n)]
            tracer.observe_batch("sw" if b % 2 else "tb", out, t_subs,
                                 t_take, t_disp, t_dev, t_res,
                                 trace_ids=tids)
            tracer.record_sub("pack", 3.0 * b)
        recent = [{k: v for k, v in r.items() if k != "t_ms"}
                  for r in trace.snapshot()["recent"]]
        snap = rec.snapshot()
        anomalies = [{k: v for k, v in a.items() if k != "t_ms"}
                     for a in snap["anomalies"]]
        hops = [[{k: v for k, v in h.items() if k != "t_ms"}
                 for h in lin.lineage(tid)] for tid in (11, 22)]
        return (reg.scrape(), recent, hops, anomalies,
                snap["anomaly_total"])

    assert run(False) == run(True)


# ---------------------------------------------------------------------------
# The storage's telemetry and lineage records
# ---------------------------------------------------------------------------

def _storages(clock, host_parallel, **kw):
    now = lambda: clock["t"]  # noqa: E731
    ref = TpuBatchedStorage(num_slots=4096, clock_ms=now,
                            host_parallel=host_parallel,
                            recorder=RefRecorder(), **kw)
    port = GpuBatchedStorage(num_slots=4096, clock_ms=now, device="cpu",
                             host_parallel=host_parallel,
                             recorder=FlightRecorder(), **kw)
    return ref, port


def _quiesce(storage):
    """Wait until every submitted future resolved and its tracer ran."""
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        with storage._batcher._cv:
            if not storage._batcher._waiters:
                return
        time.sleep(0.002)
    pytest.fail("batcher did not settle within 30 s")


def _lineage_shape(storage):
    """Each recorded trace's hops with their untimed fields, in order."""
    lin = storage.lineage
    out = []
    with lin._lock:
        traces = list(lin._traces.values())
    for hops in traces:
        out.append([{k: v for k, v in h.items()
                     if not k.endswith("_us") and k != "t_ms"}
                    for h in hops])
    return out


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_storage_telemetry_and_lineage_match_reference(host_parallel):
    """Micro decisions of three tenants, a synchronous batch, stream
    calls of one limiter (relay, weighted) and of a lid array: equal
    per-tenant usage, fleet counters, trace ring paths and lineage hops
    (``trace_sample=1``: every minted id is sampled)."""
    require_reference_native()
    clock = {"t": T0}
    ref, port = _storages(clock, host_parallel, trace_sample=1,
                          lineage_capacity=4096)
    try:
        lids = {}
        for st, cfg_cls in ((ref, RefConfig), (port, RateLimitConfig)):
            lids[id(st)] = [
                st.register_limiter("sw", cfg_cls(max_permits=5,
                                                  window_ms=1_000)),
                st.register_limiter("tb", cfg_cls(max_permits=8,
                                                  window_ms=1_000,
                                                  refill_rate=4.0)),
                st.register_limiter("tb", cfg_cls(max_permits=3,
                                                  window_ms=2_000,
                                                  refill_rate=1.0))]
        rng = np.random.default_rng(7)
        algos = ("sw", "tb", "tb")
        results = {id(ref): [], id(port): []}
        for i in range(120):
            clock["t"] += int(rng.choice([0, 0, 5, 300]))
            which = int(rng.integers(0, 3))
            key = f"k{int(rng.integers(0, 12))}"
            permits = int(rng.integers(1, 3))
            for st in (ref, port):
                out = st.acquire(algos[which], lids[id(st)][which], key,
                                 permits)
                results[id(st)].append(bool(out["allowed"]))
                _quiesce(st)
        keys = [f"k{int(k)}" for k in rng.integers(0, 20, 64)]
        ids = rng.integers(0, 300, 3000).astype(np.int64)
        permits = rng.integers(1, 4, 3000).astype(np.int64)
        lid_arr = rng.integers(0, 2, 3000).astype(np.int64)
        for st in (ref, port):
            sw, tb, tb2 = lids[id(st)]
            clock["t"] += 1_000
            got = [st.acquire_many("tb", [tb] * len(keys), keys,
                                   [1] * len(keys))["allowed"],
                   st.acquire_stream_ids("tb", tb2, ids),
                   st.acquire_stream_ids("tb", tb, ids, permits),
                   st.acquire_stream_ids(
                       "tb", np.where(lid_arr == 0, tb, tb2), ids)]
            results[id(st)].extend(np.concatenate(got).tolist())
            _quiesce(st)
        assert results[id(port)] == results[id(ref)]
        assert port.telemetry.tenants_payload() == \
            ref.telemetry.tenants_payload()
        for attr in ("allowed_total", "denied_total", "shed_total"):
            assert getattr(port.telemetry, attr) == \
                getattr(ref.telemetry, attr), attr
        decisions = {n: v for n, v in port.registry.scrape().items()
                     if n.startswith("ratelimiter.decisions.")}
        assert decisions == {n: v for n, v in ref.registry.scrape().items()
                             if n.startswith("ratelimiter.decisions.")}
        assert decisions["ratelimiter.decisions.allowed"] > 0

        def paths(st):
            return [(r["algo"], r["batch"], r["allowed"], r.get("path"),
                     "stages_us" in r, "trace" in r)
                    for r in st.trace.snapshot(last=10_000)["recent"]]

        assert paths(port) == paths(ref)
        assert _lineage_shape(port) == _lineage_shape(ref)
        assert port.lineage.recorded_hops == ref.lineage.recorded_hops > 0
        for stage in ("queue_wait", "assembly", "device", "resolve",
                      "total", "assembly.pack", "assembly.index",
                      "assembly.layout"):
            name = f"ratelimiter.latency.{stage}"
            assert port.registry.timer(name).count() == \
                ref.registry.timer(name).count(), name
    finally:
        ref.close()
        port.close()
