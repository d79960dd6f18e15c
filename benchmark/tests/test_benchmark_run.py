"""Whole runs of every cell on the CPU at a cut size: the run is correct
as it stands, and comes out not correct with the timed path broken
underneath it, once for each fault the cell can have; the control fails
the comparison."""

import threading

import numpy as np
import pytest

from benchmark import control
from benchmark.tests.tiny import run_tiny, tiny_cell

CELLS = ["tb_1m_zipf.stream_strs", "sw_10m_uniform.stream_ids",
         "sw_10m_uniform.requests_20t", "sw_10m_uniform_x4.stream_ids"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = run_tiny(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) >= {"setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("name", ["tb_1m_zipf.stream_strs",
                                  "sw_10m_uniform.requests_20t"])
def test_a_traced_run_reads_its_host_metrics(name):
    r = run_tiny(name, traced=True)
    assert r["correct"]
    want = ({"walk_ns_per_request.stream", "host_ns_per_request.stream",
             "decisions_per_s.stream"}
            if "stream" in name else {"request_p99_ms.requests"})
    assert want <= set(r["metrics"])
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


# -- faults planted under the harness, at the entry the window drives ------

def state_unchanged(system, driver):
    """Every decision is made, but the step's state is put back."""
    eng = system.storage.engine
    lock = threading.Lock()

    def keep(fn):
        def wrapped(*a, **k):
            with lock:
                sw, tb = eng.sw_state, eng.tb_state
                out = fn(*a, **k)
                eng.sw_state, eng.tb_state = sw, tb
            return out
        return wrapped
    patch_entry(system, driver, keep)


def half_left_out(system, driver):
    """Half of each call never reaches the program; its answers are
    made up as allowed."""
    def half(fn):
        def wrapped(keys, *a, **k):
            if isinstance(keys, str):  # one request: every other one
                half.n = getattr(half, "n", 0) + 1
                return True if half.n % 2 else fn(keys, *a, **k)
            m = len(keys) // 2
            out = np.ones(len(keys), dtype=bool)
            out[:m] = fn(keys[:m], *a, **k)
            return out
        return wrapped
    patch_entry(system, driver, half)


def answer_altered(system, driver):
    """One answer a call, or one request in 50, turned round."""
    def alter(fn):
        def wrapped(keys, *a, **k):
            out = fn(keys, *a, **k)
            if isinstance(keys, str):
                alter.n = getattr(alter, "n", 0) + 1
                return (not out) if alter.n % 50 == 0 else out
            out = np.array(out, dtype=bool)
            out[len(out) // 3] = ~out[len(out) // 3]
            return out
        return wrapped
    patch_entry(system, driver, alter)


def exchange_left_out(system, driver):
    """The answers of the shards other than the first never come back:
    their requests read as allowed."""
    from ratelimiter_tpu_torch.engine.routing import shard_of_int_keys

    n = system.boot["shards"]

    def local(fn):
        def wrapped(keys, *a, **k):
            out = np.array(fn(keys, *a, **k), dtype=bool)
            out[shard_of_int_keys(np.asarray(keys), n) != 0] = True
            return out
        return wrapped
    patch_entry(system, driver, local)


ENTRIES = ("try_acquire", "try_acquire_many", "try_acquire_stream_ids")


def patch_entry(system, driver, wrap):
    """Every limiter the driver builds has its entries broken by
    ``wrap``."""
    make = system.limiter

    def broken(config):
        limiter = make(config)

        class Broken:
            def __getattr__(self, name):
                return getattr(limiter, name)
        b = Broken()
        for entry in ENTRIES:
            setattr(b, entry, wrap(getattr(limiter, entry)))
        return b
    system.limiter = broken


FAULTS = [(c, f) for c in CELLS
          for f in (state_unchanged, half_left_out, answer_altered)]
FAULTS.append(("sw_10m_uniform_x4.stream_ids", exchange_left_out))


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=lambda x: x if isinstance(x, str)
                         else x.__name__)
def test_a_broken_timed_path_is_not_correct(name, fault):
    r = run_tiny(name, hook=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_comparison(name):
    cell = tiny_cell(name)
    got = control.readings(cell, 2**31 + 3, calls=6, call_ms=300,
                           requests=200)
    assert not got["correct"], got
    assert got["decisions_wrong"] + got["peeks_wrong"] > 0, got
