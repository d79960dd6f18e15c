"""Whole calls, back to back, from one thread.

The traffic file's ``entry`` names the limiter's method
(``try_acquire_many`` for string keys, ``try_acquire_stream_ids`` for
integer ids), called as ``entry(keys, None, **entry_kwargs)``.  Each call
holds ``call_keys`` requests of one permit (string keys
``f"{key_prefix}{id}"`` or integer ids); ``pool_calls`` distinct calls are
drawn in set-up and sent in turn, each as a fresh list or array, so
nothing the program keys on an object's identity carries from one call to
the next; a call's string keys are objects of their own, one a request,
laid out in memory in the call's order.  Every call is stamped with one
time (the clock is frozen while it runs): the base time in set-up, the
base plus the milliseconds since the window opened in the window.  With
``fill`` (``"random"`` or ``"first_touch"``:
``drivers/__init__.py:fill_order``), set-up first sends every key once,
so the index holds every key as a running deployment's does; then the
plan-settling warm-up (``lib/warmup.py``).
"""

from __future__ import annotations

import time
from typing import Callable, List

import numpy as np

from benchmark.drivers import (Call, Window, fill_order, fill_slices,
                               key_names)
from benchmark.lib import generators, trace, warmup

# The plan-settling calls a run makes in set-up, as the control counts
# them (``warmup.settle`` makes 2 to 4).
PLAN_CALLS = 3


class Driver:
    kind = "stream"

    def __init__(self, system, config: dict, traffic: dict, rng, clock):
        self.system, self.config = system, config
        self.traffic, self.clock = traffic, clock
        self.num_keys = int(config["keys"])
        self.call_keys = int(traffic["call_keys"])
        pool = int(traffic["pool_calls"])
        self.strings = traffic["keys"] == "strings"
        self.prefix = traffic.get("key_prefix", "k")
        fill = traffic.get("fill")
        perm = rng.permutation(self.num_keys) if fill else None
        ids = generators.draw(rng, traffic["distribution"], self.num_keys,
                              pool * self.call_keys)
        self.pool_ids = ids.reshape(pool, self.call_keys)
        self.fill_order = fill_order(fill, perm, self.pool_ids[0])
        self.payload = None  # made in set-up (:meth:`setup`)
        self.kwargs = dict(traffic.get("entry_kwargs", {}))
        self.calls: List[Call] = []
        self.records_on = False
        self._next = 0
        self.limiter = None

    def _send(self, payload, ids, pool, stamp) -> Call:
        self.clock.set(stamp)
        storage = self.system.storage
        records = None
        if self.records_on:
            storage.stream_stats = records = []
        t0 = time.perf_counter()
        try:
            decisions = np.asarray(self.entry(payload, None, **self.kwargs),
                                   dtype=bool)
        finally:
            storage.stream_stats = None
        call = Call(ids, pool, stamp, decisions, records,
                    time.perf_counter() - t0)
        self.calls.append(call)
        return call

    def send_pool(self, stamp) -> Call:
        p = self._next % len(self.payload)
        self._next += 1
        payload = self.payload[p]
        fresh = list(payload) if self.strings else payload.copy()
        return self._send(fresh, None, p, stamp)

    def setup(self) -> None:
        # String keys: every request's key is a string object of its own,
        # made in the call's order, as a gateway decodes a batch off the
        # wire; no object is shared between requests of a call.
        self.payload = ([key_names(row, self.prefix) for row in self.pool_ids]
                        if self.strings else list(self.pool_ids))
        self.limiter = self.system.limiter(self.config)
        self.entry = getattr(self.limiter, self.traffic["entry"])
        base = self.clock.base_ms
        for ids in fill_slices(self.fill_order, self.call_keys):
            self._send(key_names(ids, self.prefix) if self.strings
                       else ids, ids, None, base)
        warmup.settle(self.system.storage, lambda: self.send_pool(base))

    def window(self, seconds: float, traced: bool,
               on_first: Callable[[], None]) -> Window:
        if traced:
            trace.prime(self.system.devices)
        w = Window(self.kind)
        self.records_on = traced
        first = len(self.calls)
        t_from = int(self.traffic.get("trace_from_call", 2))
        t_n = int(self.traffic.get("trace_calls", 2))
        session = None
        on_first()
        t0 = time.perf_counter()
        j = 0
        while True:
            if traced and j == t_from:
                session = trace.Session(self.system.devices)
                session.start()
            stamp = self.clock.base_ms + int(
                (time.perf_counter() - t0) * 1000.0)
            call = self.send_pool(stamp)
            w.completed += len(call.decisions)
            j += 1
            if session is not None and j == t_from + t_n:
                session.stop()
                w.traced_records = [r for c in self.calls[first + t_from:
                                                          first + j]
                                    for r in c.records]
            if time.perf_counter() - t0 >= seconds and (
                    not traced or j >= t_from + t_n):
                break
        w.seconds = time.perf_counter() - t0
        w.attempted = w.completed
        w.call_s = [c.wall_s for c in self.calls[first:]]
        if session is not None:
            w.trace = session.summary()
        if traced:
            w.records = [r for c in self.calls[first:] for r in c.records]
        self.records_on = False
        return w

    def last_stamp(self) -> int:
        return self.calls[-1].stamp

    def peek_keys(self, ids: np.ndarray) -> np.ndarray:
        return ids

    def peek(self, ids: np.ndarray) -> np.ndarray:
        names = (key_names(ids, self.prefix) if self.strings
                 else [int(i) for i in ids])
        return self.system.available(self.config["algorithm"],
                                     self.limiter, names)

    def replay(self):
        for c in self.calls:
            ids = c.ids if c.pool is None else self.pool_ids[c.pool]
            yield c.pool, ids, c.stamp, c.decisions, {}

    def planned(self, calls: int, call_ms: int) -> list:
        base = self.clock.base_ms
        out = [(None, ids, base, {})
               for ids in fill_slices(self.fill_order, self.call_keys)]
        pool = len(self.pool_ids)
        for j in range(PLAN_CALLS + calls):
            stamp = base + max(0, j - PLAN_CALLS) * call_ms
            out.append((j % pool, self.pool_ids[j % pool], stamp, {}))
        return out
