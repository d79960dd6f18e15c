"""The comparison that decides ``correct``.

The reference (``benchmark/reference``) replays every call and request
that the run sent, set-up and window alike, with the stamps the run
gave them, and decides each request again.  Three numbers are
compared, each against its limit; all three comparisons are exact:

- ``decisions_wrong``: requests whose decision differs from the
  reference's (limit 0);
- ``peeks_wrong``: keys, of those read back after the window, whose
  available permits differ from the reference's (limit 0).  The read
  back shows what the decisions cannot where every request is allowed:
  whether each allowed request was counted once in its key's row;
- ``unanswered``: requests that raised or never returned (limit 0).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from benchmark import reference

LIMITS = {"decisions_wrong": 0, "peeks_wrong": 0, "unanswered": 0}
# The read back happens this long after the last stamp of the run.
PEEK_AFTER_MS = 1000


def peek_keys(rng, num_keys: int, peek: dict) -> np.ndarray:
    """The keys read back after the window: the ``hottest`` ids and
    ``random`` more drawn from ``rng``."""
    hot = np.arange(min(int(peek.get("hottest", 0)), num_keys))
    rand = rng.choice(num_keys, size=min(int(peek["random"]), num_keys),
                      replace=False)
    return np.unique(np.r_[hot, rand])


def replay(config: dict, calls: Iterable[Tuple[object, np.ndarray, int,
                                               np.ndarray, dict]],
           peek_ids: np.ndarray, peek_stamp: int, peeks: np.ndarray,
           lost_updates: bool = False) -> dict:
    """Decide ``calls`` again, in order, and compare: each call is
    ``(group_key, ids, stamp, decisions, extra)``, where calls with the
    same non-None ``group_key`` hold the same ids (their grouping is
    computed once) and ``extra`` goes to the reference's ``call``.  Then
    compare ``peeks``, the read back of ``peek_ids`` at ``peek_stamp``.
    With ``lost_updates`` the reference decides as the control (see
    ``benchmark/reference``)."""
    ref = reference.make(config["reference"], config["limiter"],
                         int(config["keys"]))
    groups = {}
    wrong = 0
    total = 0
    for key, ids, stamp, decisions, extra in calls:
        g = groups.get(key) if key is not None else None
        if g is None:
            g = reference.group(ids)
            if key is not None:
                groups[key] = g
        expect = ref.call(g, int(stamp), lost_updates=lost_updates, **extra)
        wrong += int(np.count_nonzero(expect != decisions))
        total += g.n
    expect_peeks = ref.available(peek_ids, int(peek_stamp))
    return {"decisions_wrong": wrong, "decisions": total,
            "peeks_wrong": int(np.count_nonzero(
                expect_peeks != np.asarray(peeks))),
            "peeks": int(len(peek_ids))}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
