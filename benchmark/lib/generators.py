"""Key-stream generators.

Frozen copies of ``uniform_stream`` and ``zipf_stream`` from
``ratelimiter_tpu_torch/bench/harness.py`` at commit 6150e04: the same
draws from the same ``numpy.random.Generator``, so one seed gives the
same ids in both.
"""

from __future__ import annotations

import numpy as np


def uniform_stream(rng, num_keys: int, n: int) -> np.ndarray:
    return rng.integers(0, num_keys, size=n)


def zipf_stream(rng, num_keys: int, n: int, a: float = 1.1) -> np.ndarray:
    """Bounded Zipf(a) keys in [0, num_keys): key k with probability
    proportional to (k + 1)^-a, by inverse CDF over ranks
    (``np.random.zipf`` is unbounded)."""
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    probs = ranks ** (-a)
    probs /= probs.sum()
    return rng.choice(num_keys, size=n, p=probs)


def draw(rng, distribution: dict, num_keys: int, n: int) -> np.ndarray:
    """``n`` ids in [0, num_keys) by the traffic file's ``distribution``
    (``{"kind": "zipf", "a": 1.1}`` or ``{"kind": "uniform"}``)."""
    kind = distribution["kind"]
    if kind == "zipf":
        ids = zipf_stream(rng, num_keys, n, float(distribution["a"]))
    elif kind == "uniform":
        ids = uniform_stream(rng, num_keys, n)
    else:
        raise ValueError(f"unknown key distribution {kind!r}")
    return ids.astype(np.int64, copy=False)
