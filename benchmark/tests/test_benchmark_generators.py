"""The frozen generators draw what the port's harness draws."""

import numpy as np
import pytest

from benchmark.lib import generators

harness = pytest.importorskip("ratelimiter_tpu_torch.bench.harness")


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 123456789012])
def test_zipf_equals_the_port_harness(seed):
    a = generators.zipf_stream(np.random.default_rng(seed), 50_000, 4096)
    b = harness.zipf_stream(np.random.default_rng(seed), 50_000, 4096)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 123456789012])
def test_uniform_equals_the_port_harness(seed):
    a = generators.uniform_stream(np.random.default_rng(seed), 10**7, 4096)
    b = harness.uniform_stream(np.random.default_rng(seed), 10**7, 4096)
    assert np.array_equal(a, b)


def test_draw_repeats_for_one_seed_and_differs_across_seeds():
    dist = {"kind": "zipf", "a": 1.1}
    a = generators.draw(np.random.default_rng(9), dist, 1000, 5000)
    b = generators.draw(np.random.default_rng(9), dist, 1000, 5000)
    c = generators.draw(np.random.default_rng(10), dist, 1000, 5000)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.dtype == np.int64 and a.min() >= 0 and a.max() < 1000
    # Zipf(1.1): the hottest key is the most drawn.
    assert np.bincount(a).argmax() == 0


def test_unknown_distribution_refused():
    with pytest.raises(ValueError):
        generators.draw(np.random.default_rng(1), {"kind": "normal"}, 10, 5)


def test_a_first_touch_fill_sends_every_key_once_hot_keys_first():
    from benchmark.drivers import fill_order

    perm = np.random.default_rng(7).permutation(10)
    order = fill_order("first_touch", perm, np.array([4, 4, 1, 9, 1, 4]))
    assert order[:3].tolist() == [4, 1, 9]
    assert sorted(order.tolist()) == list(range(10))
    assert order[3:].tolist() == [k for k in perm.tolist()
                                  if k not in (4, 1, 9)]
    assert fill_order("random", perm).tolist() == perm.tolist()
    assert fill_order(False, None) is None
