"""The NumPy references against hand-worked cases and against the
port's sequential oracle (``semantics/oracle.py``), and the control
against the reference."""

import numpy as np
import pytest

from benchmark import reference
from benchmark.reference.sliding_window import SlidingWindow
from benchmark.reference.token_bucket import ONE, TokenBucket

TB = {"max_permits": 3, "window_ms": 1000, "refill_rate": 2.0}
SW = {"max_permits": 3, "window_ms": 1000}
T0 = 1_759_999_980_000


def call(ref, ids, now, lost=False):
    return ref.call(reference.group(np.asarray(ids)), now,
                    lost_updates=lost)


def test_group_ranks_each_key_in_arrival_order():
    g = reference.group(np.array([5, 2, 5, 5, 2, 9]))
    assert g.keys.tolist() == [2, 5, 9]
    assert g.counts.tolist() == [2, 3, 1]
    assert g.occ.tolist() == [0, 0, 1, 2, 1, 0]
    assert g.keys[g.inv].tolist() == [5, 2, 5, 5, 2, 9]


def test_token_bucket_by_hand():
    tb = TokenBucket(TB, 4)
    # A full bucket of 3: the first three of key 0 pass, the fourth not.
    assert call(tb, [0, 0, 1, 0, 0], T0).tolist() == [1, 1, 1, 1, 0]
    assert tb.available([0, 1, 2], T0).tolist() == [0, 2, 3]
    # 2 tokens a second: 499 ms refill 0.998 of a token, 500 ms one.
    assert call(tb, [0], T0 + 499).tolist() == [0]
    assert call(tb, [0, 0], T0 + 500).tolist() == [1, 0]
    # A deny writes nothing: the refill still counts from T0 + 500.
    assert tb.available([0], T0 + 1000).tolist() == [1]
    # The state expires two windows after the last allow: full again.
    assert tb.available([1], T0 + 2000).tolist() == [3]


def test_sliding_window_by_hand():
    sw = SlidingWindow(SW, 3)
    assert call(sw, [0, 0, 0, 0, 1], T0 + 100).tolist() == [1, 1, 1, 0, 1]
    assert sw.available([0, 1, 2], T0 + 100).tolist() == [0, 2, 3]
    # Next window, 50 ms in: the previous bucket weighs 3 * 950 // 1000
    # = 2, so one more passes.
    assert call(sw, [0, 0], T0 + 1050).tolist() == [1, 0]
    # The previous bucket expires 1000 ms after its last increment.
    assert sw.available([1], T0 + 1100).tolist() == [3]
    assert sw.available([0], T0 + 1099).tolist() == [0]
    assert sw.available([0], T0 + 1100).tolist() == [2]


def oracle_runs(algo, seed):
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.semantics import oracle

    rng = np.random.default_rng(seed)
    cfg = dict(TB if algo == "tb" else SW)
    ref = TokenBucket(cfg, 40) if algo == "tb" else SlidingWindow(cfg, 40)
    orc = (oracle.TokenBucketOracle if algo == "tb"
           else oracle.SlidingWindowOracle)(RateLimitConfig(**cfg))
    now = T0
    for _ in range(60):
        now += int(rng.choice([0, 1, 37, 250, 600, 1500, 2500]))
        ids = rng.integers(0, 40, size=int(rng.integers(1, 30)))
        got = call(ref, ids, now)
        want = [orc.try_acquire(str(i), 1, now).allowed for i in ids]
        assert got.tolist() == want
        keys = np.arange(40)
        assert ref.available(keys, now).tolist() == [
            orc.get_available_permits(str(i), now) for i in keys]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_token_bucket_equals_the_oracle(seed):
    oracle_runs("tb", seed)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sliding_window_equals_the_oracle(seed):
    oracle_runs("sw", seed)


@pytest.mark.parametrize("make", [lambda: TokenBucket(TB, 4),
                                  lambda: SlidingWindow(SW, 4)])
def test_the_control_loses_updates(make):
    sound, control = make(), make()
    ids = [0, 0, 0, 0, 1]
    assert call(sound, ids, T0).tolist() == [1, 1, 1, 0, 1]
    assert call(control, ids, T0, lost=True).tolist() == [1, 1, 1, 1, 1]
    assert sound.available([0], T0).tolist() == [0]
    assert control.available([0], T0).tolist() == [2]


def test_token_fixed_point():
    assert ONE == 1000 << 20
    assert TokenBucket(TB, 1).rate == 2 << 20
