"""The readers of the port's stream spans and chunk counters: the exposed
assign wait, the string hashing and the key packing from the chunk
records, and the share of the card's idle time under a program span
from a Chrome trace as the profiler exports it."""

import json

import pytest

from benchmark.lib import trace
from benchmark.tests.test_benchmark_readers import RECORDS, read, run_of


def test_assign_wait_hash_and_key_pack():
    """The port's own chunk fields: None where the records lack them (a
    parent commit's, or integer keys' for the hashing), else their sums
    over the requests."""
    run = run_of("stream", records=RECORDS)
    for name in ("assign_wait_ns_per_request.stream",
                 "hash_ns_per_request.stream",
                 "key_pack_ns_per_request.stream"):
        assert read(name, run) is None
        assert read(name, run_of("requests")) is None
    ints = [dict(r, assign_wait_s=0.0001) for r in RECORDS]
    run = run_of("stream", records=ints)
    assert read("assign_wait_ns_per_request.stream", run) == pytest.approx(
        0.0002 / 4000 * 1e9)
    assert read("hash_ns_per_request.stream", run) is None
    assert read("key_pack_ns_per_request.stream", run) is None
    strs = [dict(r, assign_wait_s=w, hash_s=h, key_pack_s=k)
            for r, w, h, k in zip(RECORDS, (0.0002, 0.00055),
                                  (0.0001, 0.0004), (0.00008, 0.0003))]
    run = run_of("stream", records=strs)
    assert read("assign_wait_ns_per_request.stream", run) == pytest.approx(
        0.00075 / 4000 * 1e9)
    assert read("hash_ns_per_request.stream", run) == pytest.approx(
        0.0005 / 4000 * 1e9)
    assert read("key_pack_ns_per_request.stream", run) == pytest.approx(
        0.00038 / 4000 * 1e9)


def spans_trace(path, spans=True):
    """A traced part of 1000 us on one card, busy 250 us in three
    kernels; its idle 750 us in four gaps: 100 us before any host event,
    300 us inside ``rl.stream.assign_wait``, 250 us inside an
    ``aten::copy_`` inside ``rl.stream.dispatch``, 100 us inside
    ``rl.limiter.try_acquire_many``.  Without ``spans`` the two spans
    are named as other host work."""
    def kernel(ts, dur):
        return {"ph": "X", "cat": "kernel", "name": "void k()", "ts": ts,
                "dur": dur, "args": {"device": 0}}

    def host(name, ts, dur, cat="user_annotation"):
        if not spans and name.startswith("rl."):
            name = "work"
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.MARK,
         "ts": 1000, "dur": 1000},
        kernel(1100, 100), kernel(1500, 50), kernel(1800, 100),
        host("rl.stream.assign_wait", 1200, 300),
        host("rl.stream.dispatch", 1540, 280),
        host("aten::copy_", 1600, 150, "cpu_op"),
        host("rl.limiter.try_acquire_many", 1890, 110),
    ]
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.summarize(str(path), 0.001)


def test_idle_in_spans_share(tmp_path):
    tr = spans_trace(tmp_path / "t.json")
    assert sum(x for _, x in tr["idle_gaps"]) == pytest.approx(750 / 1e6)
    run = run_of("stream", trace=tr)
    assert read("idle_in_spans_share.stream", run) == pytest.approx(
        100 * 400 / 750)
    plain = spans_trace(tmp_path / "p.json", spans=False)
    assert read("idle_in_spans_share.stream",
                run_of("stream", trace=plain)) == 0.0
    assert read("idle_in_spans_share.stream", run_of("stream")) is None
    assert read("idle_in_spans_share.stream",
                run_of("stream", trace=dict(tr, busy_us={}))) is None
    assert read("idle_in_spans_share.stream",
                run_of("requests", trace=tr)) is None
