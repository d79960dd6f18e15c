"""The plain references of the configurations: NumPy restatements of the
rate limiter's semantics, vectorised by key, that import nothing of the
program.

A configuration names its reference (``"reference"``), the module
``reference/<name>.py``, which defines ``Reference(limiter, num_keys)``
(``limiter``: the configuration's ``"limiter"``) with
``call(g, now, lost_updates=False, **extra)``, the decisions of one call
(``g`` from :func:`group`; ``extra``: what the driver's replay gives the
call, such as permits), and ``available(keys, now)``, the available
permits of each key.

A call is a batch of requests of one limiter, all stamped with one time,
each a key id and one permit.  Keys are independent, and one key's
requests are decided in arrival order, so a call reduces to its keys:
for each key, how many of its requests the state allows, the first ones
in arrival order.  :func:`group` computes what that needs once per call.

``lost_updates=True`` gives the control: every request of a call reads
the state as the call found it, and of the writes to one key one wins.
That is a batch step without the per-key segment solver, which breaks
the configurations' guarantee that each decision sees every earlier
decision of its key.
"""

from __future__ import annotations

import numpy as np


class Grouped:
    """One call's requests by key: ``keys`` (the unique ids, ascending),
    ``counts`` (requests per key), ``inv`` (each request's index into
    ``keys``) and, computed when first asked for, ``occ`` (each request's
    rank among its key's requests, in arrival order)."""

    def __init__(self, ids: np.ndarray):
        ids = np.asarray(ids, dtype=np.int64)
        counts = np.bincount(ids)
        self.keys = np.flatnonzero(counts)
        self.counts = counts[self.keys]
        where = np.zeros(len(counts), dtype=np.int64)
        where[self.keys] = np.arange(len(self.keys))
        self.inv = where[ids]
        self._occ = None

    @property
    def n(self) -> int:
        return len(self.inv)

    @property
    def occ(self) -> np.ndarray:
        if self._occ is None:
            order = np.argsort(self.inv, kind="stable")
            starts = np.r_[0, np.cumsum(self.counts)[:-1]]
            occ = np.empty(len(order), dtype=np.int64)
            occ[order] = np.arange(len(order)) - np.repeat(starts,
                                                           self.counts)
            self._occ = occ
        return self._occ


def group(ids: np.ndarray) -> Grouped:
    return Grouped(ids)


def decide(g: Grouped, allowed_per_key: np.ndarray,
           lost_updates: bool) -> np.ndarray:
    """Each request's decision: the first ``allowed_per_key`` requests of
    its key, or, for the control, every request of a key that allows
    one.  Where every key allows all its requests, no rank is needed."""
    if lost_updates:
        return (allowed_per_key > 0)[g.inv]
    if np.array_equal(allowed_per_key, g.counts):
        return np.ones(g.n, dtype=bool)
    return g.occ < allowed_per_key[g.inv]


def make(name: str, limiter: dict, num_keys: int):
    """The reference a configuration names (``"reference"``): the
    ``Reference`` of ``reference/<name>.py``."""
    from benchmark.lib import spec
    return spec.reference(name)(limiter, num_keys)
