"""A closed loop of client threads, one request at a time.

``threads`` client threads each call the limiter's ``entry``
(``try_acquire``) with one string key ``f"{key_prefix}{id}"`` at a time;
thread ``t`` draws ``requests_per_thread`` ids from those congruent to
``t`` modulo ``threads``, so no two threads race on one key and each key's
decisions come in its thread's order.  With ``fill`` (``"random"``),
set-up first sends every key once, in a seeded order, through ``try_acquire_many`` in calls
of ``fill_call_keys``; then each thread sends ``warmup_requests``.  The
clock is frozen at the base time through set-up and runs live through the
window.

The replay decides the fill's calls at the base time and every request
after them as one call at the base time: exact for a sliding window while
every stamp the clock handed out lies in the fill's window bucket (no
bucket rolls and nothing expires), which :meth:`Driver.replay` checks.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List

import numpy as np

from benchmark.drivers import (Call, Window, fill_order, fill_slices,
                               key_names)
from benchmark.lib import generators, trace
from benchmark.lib.check import PEEK_AFTER_MS


class Driver:
    kind = "requests"

    def __init__(self, system, config: dict, traffic: dict, rng, clock):
        self.system, self.config = system, config
        self.traffic, self.clock = traffic, clock
        self.num_keys = int(config["keys"])
        self.threads = int(traffic["threads"])
        self.prefix = traffic.get("key_prefix", "k")
        self.call_keys = int(traffic["fill_call_keys"])
        fill = traffic.get("fill")
        self.fill_order = fill_order(
            fill, rng.permutation(self.num_keys) if fill else None)
        per = int(traffic["requests_per_thread"])
        T = self.threads
        self.ids = []
        for t, child in enumerate(np.random.SeedSequence(
                int(rng.integers(0, 2**63))).spawn(T)):
            span = (self.num_keys - t + T - 1) // T
            draw = generators.draw(np.random.default_rng(child),
                                   traffic["distribution"], span, per)
            self.ids.append(t + T * draw)
        self.thread_names = [key_names(ids, self.prefix) for ids in self.ids]
        self.fill_calls: List[Call] = []
        self.sent = [0] * T
        self.decisions = [np.zeros(per, dtype=bool) for _ in range(T)]
        self.errors: List[BaseException] = []
        self.limiter = None

    def setup(self) -> None:
        self.limiter = lim = self.system.limiter(self.config)
        self.clock.set(self.clock.base_ms)
        for ids in fill_slices(self.fill_order, self.call_keys):
            names = key_names(ids, self.prefix)
            dec = np.asarray(lim.try_acquire_many(names, None), dtype=bool)
            del names
            self.fill_calls.append(Call(ids, None, self.clock.base_ms, dec,
                                        None))
        warm = int(self.traffic["warmup_requests"])
        for th in self._run_threads(lambda t, i: i < warm, None):
            th.join()

    def _run_threads(self, keep_going, lat):
        """Each thread sends its next request while ``keep_going(t, i)``
        (``i`` its next request's index); with ``lat``, each request's
        start and end are kept there."""
        entry = getattr(self.limiter, self.traffic["entry"])

        def worker(t):
            names, dec = self.thread_names[t], self.decisions[t]
            i = self.sent[t]
            try:
                while i < len(names) and keep_going(t, i):
                    s = time.perf_counter()
                    dec[i] = entry(names[i])
                    if lat is not None:
                        lat[t].append((s, time.perf_counter()))
                    i += 1
            except BaseException as exc:  # reported, and fails the run
                self.errors.append(exc)
            finally:
                self.sent[t] = i

        threads = [threading.Thread(target=worker, args=(t,), daemon=True)
                   for t in range(self.threads)]
        for th in threads:
            th.start()
        return threads

    def window(self, seconds: float, traced: bool,
               on_first: Callable[[], None]) -> Window:
        if traced:
            trace.prime(self.system.devices)
        w = Window(self.kind)
        lat = [[] for _ in range(self.threads)]
        deadline = [float("inf")]
        go = threading.Event()

        def keep_going(t, i):
            go.wait()
            return time.perf_counter() < deadline[0]

        threads = self._run_threads(keep_going, lat)
        launches0 = self.system.launches()
        on_first()
        self.clock.go_live()
        t0 = time.perf_counter()
        deadline[0] = t0 + seconds
        go.set()
        if traced:
            t_from = float(self.traffic.get("trace_from_s", 2.0))
            t_len = float(self.traffic.get("trace_s", 1.0))
            time.sleep(max(0.0, t0 + t_from - time.perf_counter()))
            session = trace.Session(self.system.devices)
            session.start()
            time.sleep(t_len)
            session.stop()
        for th in threads:
            th.join()
        self.clock.freeze()
        end = t0 + seconds
        spans = np.array([x for per in lat for x in per], dtype=np.float64
                         ).reshape(-1, 2)
        w.seconds = seconds
        w.attempted = len(spans)
        w.completed = int((spans[:, 1] <= end).sum())
        w.latencies_s = spans[:, 1] - spans[:, 0]
        launches1 = self.system.launches()
        w.launches = {k: launches1[k] - launches0[k] for k in launches1}
        w.failed = len(self.errors)
        if traced:
            w.trace = session.summary()
        return w

    def last_stamp(self) -> int:
        return self.clock.freeze()

    def requests(self):
        """Every request sent, thread by thread in order: (ids,
        decisions)."""
        ids = np.concatenate([self.ids[t][:self.sent[t]]
                              for t in range(self.threads)])
        dec = np.concatenate([self.decisions[t][:self.sent[t]]
                              for t in range(self.threads)])
        return ids, dec

    def peek_keys(self, ids: np.ndarray) -> np.ndarray:
        """``ids`` and every key a request touched."""
        return np.union1d(ids, self.requests()[0])

    def peek(self, ids: np.ndarray) -> np.ndarray:
        return self.system.available(self.config["algorithm"],
                                     self.limiter,
                                     key_names(ids, self.prefix))

    def replay(self):
        clock, base = self.clock, self.clock.base_ms
        for c in self.fill_calls:
            yield None, c.ids, c.stamp, c.decisions, {}
        if self.config["algorithm"] != "sw" or (
                clock.live_max is not None
                and clock.live_max >= base + self.config["limiter"][
                    "window_ms"] - PEEK_AFTER_MS):
            raise RuntimeError("the request driver's replay needs a "
                               "sliding window whose stamps stay in one "
                               "bucket")
        ids, dec = self.requests()
        yield None, ids, base, dec, {}

    def planned(self, calls: int, call_ms: int) -> list:
        """The fill's calls and every drawn request as one call at the
        base time (``calls`` and ``call_ms`` do not apply: the traffic's
        ``requests_per_thread`` sets the size)."""
        base = self.clock.base_ms
        out = [(None, ids, base, {})
               for ids in fill_slices(self.fill_order, self.call_keys)]
        self.sent = [len(ids) for ids in self.ids]
        out.append((None, self.requests()[0], base, {}))
        return out
