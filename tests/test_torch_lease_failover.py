"""The port's lease, aggregator and overload drills (``storage/chaos.py``)
against the JAX package's, on the CPU.

- ``lease_failover_drill`` and ``aggregator_failover_drill`` at the
  reference's fast-test arguments (``tests/test_leases.py:319``,
  ``tests/test_edge.py:573``), the port's shards and standbys on the CPU
  (``device="cpu"``), the reference's on ``make_mesh(n_devices=4)`` of the
  forced host devices: every count of the two reports equal (decisions,
  frames, strands, revocations, over-admission, promotions, the fence
  epoch, the lease manager's and the aggregator's status), the meters the
  reference's tests read equal, and each reconciliation replayed in full.
- ``overload_drill`` at ``tests/test_overload.py:163``'s arguments over the
  port's ``MicroBatcher``: the queue-depth bound, typed sheds with a
  positive Retry-After and the admitted p99 within the deadline plus a
  dispatch cycle (the drill's own assertion, its slack unchanged).
"""

import pytest
import torch

from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.storage import chaos as ref_chaos
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.storage import chaos
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

# Report keys only the port's drills add: wall time, frames per decision,
# the replayed operation and reconciled key counts, the victim shard.
_PORT_ONLY = {"wall_s", "frames_per_decision", "replayed_ops",
              "reconciled_keys", "victim"}


def _run_both(name: str):
    require_reference_native()
    regs = (RefRegistry(), MeterRegistry())
    want = getattr(ref_chaos, name)(registry=regs[0])
    got = getattr(chaos, name)(registry=regs[1], device="cpu")
    assert set(got) - set(want) == _PORT_ONLY
    for key in want:
        assert got[key] == want[key], key
    assert got["wall_s"] > 0
    return want, got, [reg.scrape() for reg in regs]


def test_lease_failover_drill_matches_reference():
    want, got, meters = _run_both("lease_failover_drill")
    assert got["promotions"] == 1 and got["fence_epoch"] == 1
    assert got["decisions"] > 1000
    assert got["wire_ops_healthy"] * 10 <= got["decisions"]
    assert got["frames_per_decision"] == got["wire_ops_healthy"] / 1200
    assert got["burned_after_fence"] <= \
        got["status"]["outstanding_budget"] + 16 * 16
    assert got["revoked"] >= 1 and got["over_admission"] > 0
    assert got["replayed_ops"] > 0 and got["reconciled_keys"] == 33
    for key in ("ratelimiter.lease.granted", "ratelimiter.lease.revoked",
                "ratelimiter.lease.local_decisions",
                "ratelimiter.lease.outstanding",
                "ratelimiter.lease.over_admission"):
        assert meters[1][key] == meters[0][key], key
    assert meters[1]["ratelimiter.lease.local_decisions"] > 1000.0
    assert meters[1]["ratelimiter.lease.outstanding"] == 0.0


def test_aggregator_failover_drill_matches_reference():
    want, got, meters = _run_both("aggregator_failover_drill")
    assert got["promotions"] == 1
    assert got["decisions"] > 500
    assert got["wire_frames_healthy"] * 5 <= got["decisions"]
    assert got["burned_after_death"] \
        <= got["exposure"]["sliced_out"] <= got["exposure"]["bulk_budget"]
    assert 0 < got["scoped_revocations"] < 12
    assert got["reconciled_keys"] == 12 and got["replayed_ops"] > 0
    for key in ("ratelimiter.edge.bulk_renewals",
                "ratelimiter.edge.scoped_revocations",
                "ratelimiter.lease.outstanding",
                "ratelimiter.lease.over_admission"):
        assert meters[1][key] == meters[0][key], key
    assert meters[1]["ratelimiter.edge.scoped_revocations"] \
        == float(got["scoped_revocations"])
    assert meters[1]["ratelimiter.lease.outstanding"] == 0.0


def test_overload_drill_fast():
    """``tests/test_overload.py:163`` over the port's batcher: queue depth
    bounded, overload shed not queued, the admitted p99 within the
    deadline budget (asserted inside the drill) at 2x offered load."""
    report = chaos.overload_drill(load_multipliers=(0.8, 2.0), bursts=25)
    under, two_x = report["runs"]
    assert under["goodput_frac"] > 0.9
    assert two_x["shed_frac"] > 0.2
    assert two_x["max_depth_seen"] <= 256
    for run in report["runs"]:
        assert run["admitted"] + run["shed"] + run["deadline_expired"] \
            == run["offered"]
        assert run["p99_ms"] <= 1000.0 + 2 * 5.0 + 250.0


@pytest.mark.parametrize("kwargs", [
    dict(n_keys=48, burns=1600, budget=32, seed=1),
    dict(n_shards=2, slots_per_shard=512, n_keys=20, burns=800, seed=2),
], ids=["wide", "two_shards"])
def test_lease_failover_drill_other_shapes_match_reference(kwargs):
    """Two more shapes of the lease drill: more keys and a larger budget
    (the victim shard holds more leases), and two shards."""
    require_reference_native()
    want = ref_chaos.lease_failover_drill(**kwargs)
    got = chaos.lease_failover_drill(device="cpu", **kwargs)
    for key in want:
        assert got[key] == want[key], key
