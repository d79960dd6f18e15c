"""The drivers: the code that turns a traffic mix into calls of the
system.

A traffic file (``traffic/<mix>.json``) names its driver (``"driver"``),
which is ``drivers/<driver>.py``, found by that name; the rest of the file
is the driver's parameters: the entry it drives, how keys are drawn
(``"distribution"``, read by ``lib/generators.py``) and its sizes.  The
configuration says how many keys there are and which limiter serves them.
Every draw comes from the run's seed, so one seed gives the same requests
in the same order.

A driver module defines ``Driver(system, config, traffic, rng, clock)``
with:

- ``kind`` (``"stream"`` or ``"requests"``: which metrics find something to
  read) and ``num_keys``;
- ``setup()``: builds its limiters (``system.limiter(config)``), fills and
  warms the system;
- ``window(seconds, traced, on_first)``: drives the traffic for
  ``seconds``, calling ``on_first()`` just before the first timed
  request, and returns a :class:`Window`;
- ``last_stamp()``, ``peek_keys(ids)`` (the ids to read back: ``ids`` and
  any the driver adds), ``peek(ids)`` (the program's available permits of
  those keys at the clock's present value);
- ``replay()``: every call and request it sent, set-up and window alike, in
  the order the program saw them, as ``(group_key, ids, stamp, decisions,
  extra)`` for ``lib/check.py:replay`` (``extra``: keyword arguments of
  the reference's ``call``);
- ``planned(calls, call_ms)``: the same calls as ``(group_key, ids, stamp,
  extra)``, drawn without a system, as a run with ``calls`` window calls
  ``call_ms`` apart would send them (for ``control.py``).

The constructor draws the traffic and touches no system, so ``control.py``
can pass ``None`` for it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Call:
    """One logged call: its key ids (or the pool index that holds
    them), its stamp, its decisions and, with stream records on, its
    chunk records."""
    __slots__ = ("ids", "pool", "stamp", "decisions", "records", "wall_s")

    def __init__(self, ids, pool, stamp, decisions, records, wall_s=0.0):
        self.ids, self.pool, self.stamp = ids, pool, stamp
        self.decisions, self.records = decisions, records
        self.wall_s = wall_s


def key_names(ids: np.ndarray, prefix: str) -> List[str]:
    return [f"{prefix}{i}" for i in ids.tolist()]


def fill_order(fill, perm: Optional[np.ndarray], first_ids=None):
    """The order in which set-up sends every key once, or None without a
    fill (``fill`` false).  ``perm`` is a permutation of the keys drawn
    from the run's seed.  ``fill`` is ``"random"``: ``perm``; or
    ``"first_touch"``: the keys of ``first_ids`` in the order they first
    appear there, then the others in ``perm``'s order, as a deployment's
    index meets keys when its traffic first brings them."""
    if not fill:
        return None
    if fill == "random":
        return perm
    if fill != "first_touch":
        raise ValueError(f"unknown fill {fill!r}")
    seen, first = np.unique(np.asarray(first_ids), return_index=True)
    touched = seen[np.argsort(first, kind="stable")]
    rest = perm[~np.isin(perm, touched, assume_unique=True)]
    return np.concatenate([touched, rest])


def fill_slices(fill_order: Optional[np.ndarray], call_keys: int):
    """The fill's calls: every key once, in ``fill_order``, in calls of
    ``call_keys``."""
    if fill_order is None:
        return []
    return [fill_order[s:s + call_keys]
            for s in range(0, len(fill_order), call_keys)]


class Window:
    """What the window measured, for the metric readers."""

    def __init__(self, kind: str):
        self.kind = kind
        self.seconds = 0.0
        self.completed = 0
        self.attempted = 0
        self.failed = 0
        self.latencies_s: Optional[np.ndarray] = None
        self.records: Optional[list] = None       # the window's chunks
        self.traced_records: Optional[list] = None
        self.trace: Optional[dict] = None
        self.launches: Optional[dict] = None
        self.call_s: list = []  # each stream call's seconds
