"""The chaos conductor of the port against the reference's, on the CPU.

- plan: determinism, the JSON form byte-equal to the reference's for the
  same generator arguments, generator hygiene (heals scheduled, defects
  gated), the traffic frame kept by ``with_actions``;
- clamp and sublease: the port's ``LeaseTable.clamp_forward`` and the
  manager-level forward-jump claim on a CPU storage, and ``BulkPool``
  conservation under a seeded-random interleaving of every verb;
- the fleet: the same ``FaultPlan`` through the reference's
  ``chaos.harness.run_plan`` and the port's ``run_plan(plan,
  device="cpu")`` gives reports equal key for key — fault-free, faulted,
  the planted pool leak, the planted epoch rollback (both minimizers
  keep exactly the planted action and report the same violation) — and
  an artifact either package dumps replays in the other to the same
  violation;
- slow: the TCP edge topology, and ``ProcActor`` over a CPU port node
  (SIGTERM is a graceful stop; SIGSTOP/SIGCONT keeps the process).
"""

import json
import random
import subprocess
import sys
import time

import pytest
import torch

from ratelimiter_tpu.chaos import harness as ref_harness
from ratelimiter_tpu.chaos import plan as ref_plan
from ratelimiter_tpu.chaos.minimize import minimize as ref_minimize
from ratelimiter_tpu.chaos.replay import dump_artifact as ref_dump
from ratelimiter_tpu.chaos.replay import load_artifact as ref_load
from ratelimiter_tpu.chaos.replay import replay as ref_replay
from ratelimiter_tpu_torch.chaos.plan import (
    DEFAULT_TOPOLOGY,
    DEFECT_OPS,
    FAULT_OPS,
    FaultAction,
    FaultPlan,
)
from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.leases.manager import LeaseManager
from ratelimiter_tpu_torch.leases.sublease import BulkPool
from ratelimiter_tpu_torch.leases.table import LeaseTable
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
)

torch.set_num_threads(1)


def _small_topology(**over):
    topo = {"n_direct_keys": 12, "n_lease_keys": 4, "n_edge_keys": 3}
    topo.update(over)
    return topo


def _port_run(plan):
    from ratelimiter_tpu_torch.chaos.harness import run_plan

    return run_plan(plan, device="cpu")


def _ref_plan(plan):
    """The same plan as the reference's object, read back from the port
    plan's JSON (the shared form)."""
    return ref_plan.FaultPlan.from_json(json.loads(plan.dumps()))


def _both(plan):
    port = _port_run(plan)
    ref = ref_harness.run_plan(_ref_plan(plan))
    return port, ref


# ---------------------------------------------------------------------------
# FaultPlan: determinism, serialization, generator hygiene
# ---------------------------------------------------------------------------

def test_plan_generation_is_deterministic():
    a = FaultPlan.generate(42, steps=32, fault_rate=0.6)
    b = FaultPlan.generate(42, steps=32, fault_rate=0.6)
    assert a.dumps() == b.dumps()
    c = FaultPlan.generate(43, steps=32, fault_rate=0.6)
    assert a.dumps() != c.dumps()


@pytest.mark.parametrize("seed,steps,rate,defects,topo", [
    (0, 14, 0.5, False, _small_topology()),
    (7, 24, 0.5, True, None),
    (11, 64, 0.9, False, None),
    (3, 64, 0.9, True, {"cells": 3, "edge": "tcp"}),
])
def test_plan_json_is_the_reference_form(seed, steps, rate, defects, topo):
    port = FaultPlan.generate(seed, topology=topo, steps=steps,
                              fault_rate=rate, include_defects=defects)
    ref = ref_plan.FaultPlan.generate(seed, topology=topo, steps=steps,
                                      fault_rate=rate,
                                      include_defects=defects)
    assert port.dumps() == ref.dumps()
    assert FaultPlan.from_json(ref.to_json()).dumps() == ref.dumps()
    assert ref_plan.FaultPlan.from_json(port.to_json()).dumps() == \
        port.dumps()
    assert (DEFAULT_TOPOLOGY, FAULT_OPS, DEFECT_OPS) == (
        ref_plan.DEFAULT_TOPOLOGY, ref_plan.FAULT_OPS, ref_plan.DEFECT_OPS)


def test_plan_json_roundtrip():
    plan = FaultPlan.generate(7, steps=24, include_defects=True)
    back = FaultPlan.from_json(json.loads(json.dumps(plan.to_json())))
    assert back.dumps() == plan.dumps()
    assert back.topology == plan.topology
    assert all(isinstance(a, FaultAction) for a in back.actions)


def test_generator_emits_only_known_ops_and_gates_defects():
    clean = FaultPlan.generate(3, steps=64, fault_rate=0.9)
    assert clean.actions, "a 0.9 fault rate over 64 steps emits faults"
    assert all(a.op in FAULT_OPS for a in clean.actions)
    dirty = FaultPlan.generate(3, steps=64, fault_rate=0.9,
                               include_defects=True)
    planted = [a for a in dirty.actions if a.op in DEFECT_OPS]
    assert len(planted) == 1


def test_generator_schedules_heals_and_resumes():
    plan = FaultPlan.generate(11, steps=64, fault_rate=0.9)
    ops = [a.op for a in plan.actions]
    if any(o.startswith("edge_") and o != "edge_heal" for o in ops):
        assert "edge_heal" in ops
    pauses = [a for a in plan.actions if a.op == "pause_shard"]
    resumes = {(a.params["cell"], a.params["shard"]): a.step
               for a in plan.actions if a.op == "resume_shard"}
    for p in pauses:
        key = (p.params["cell"], p.params["shard"])
        assert key in resumes and resumes[key] > p.step, (
            "every pause must schedule its resume (the zombie probe "
            "runs at resume time)")


def test_with_actions_preserves_the_traffic_frame():
    plan = FaultPlan.generate(5, steps=16)
    cut = plan.with_actions(plan.actions[:1])
    assert (cut.seed, cut.steps, cut.fault_rate) == (
        plan.seed, plan.steps, plan.fault_rate)
    assert cut.topology == plan.topology
    assert len(cut.actions) == min(1, len(plan.actions))


def test_lazy_package_exports_resolve_to_callables():
    # `minimize` and `replay` collide with submodule names: importing
    # the submodule sets the MODULE as a package attribute, which must
    # not shadow the exported callable on a from-import.
    from ratelimiter_tpu_torch.chaos import (
        FleetHarness, dump_artifact, load_artifact, minimize, replay,
        run_plan)
    for fn in (FleetHarness, dump_artifact, load_artifact, minimize,
               replay, run_plan):
        assert callable(fn), fn


# ---------------------------------------------------------------------------
# Forward clock-jump clamp (leases/table.py)
# ---------------------------------------------------------------------------

def test_clamp_forward_passes_normal_steps():
    t = LeaseTable(max_forward_jump_ms=10_000)
    assert t.clamp_forward(1_000) == 1_000
    assert t.clamp_forward(5_000) == 5_000       # within threshold
    assert t.clamp_forward(15_000) == 15_000     # exactly 10_000 ahead
    assert t.forward_clamps == 0


def test_clamp_forward_absorbs_a_jump():
    t = LeaseTable(max_forward_jump_ms=10_000, forward_step_ms=1_000)
    assert t.clamp_forward(0) == 0
    got = t.clamp_forward(1_000_000)             # a poisoned jump
    assert got == 1_000                          # one bounded step
    assert t.forward_clamps == 1
    # The jump is absorbed as an offset: the same wall reading maps to
    # the SAME rebased now, and wall progress resumes at 1x from there.
    assert t.clamp_forward(1_000_000) == 1_000
    assert t.clamp_forward(1_000_500) == 1_500
    assert t.forward_clamps == 1


def test_clamp_forward_backward_and_disabled():
    t = LeaseTable(max_forward_jump_ms=10_000)
    t.clamp_forward(50_000)
    assert t.clamp_forward(40_000) == 40_000     # backward: untouched
    off = LeaseTable()                           # clamp disabled
    off.clamp_forward(0)
    assert off.clamp_forward(10 ** 12) == 10 ** 12
    assert off.forward_clamps == 0


def _lease_storage(clock):
    storage = GpuBatchedStorage(num_slots=256, clock_ms=lambda: clock["t"],
                                device="cpu", host_parallel=0)
    cfg = RateLimitConfig(max_permits=1 << 12, window_ms=60_000,
                          refill_rate=500.0)
    return storage, storage.register_limiter("tb", cfg)


def test_forward_jump_does_not_mass_expire_leases():
    """A huge injected forward jump degrades into clamped ticks: live
    clients keep renewing through it instead of every lease expiring in
    one poisoned sweep."""
    clock = {"t": 1_000_000}
    storage, lid = _lease_storage(clock)
    mgr = LeaseManager(storage, default_budget=8, ttl_ms=2_000.0,
                       clock_ms=lambda: clock["t"])
    try:
        keys = [f"k{i}" for i in range(8)]
        for k in keys:
            assert mgr.grant(lid, k).granted > 0
        clock["t"] += 10 ** 9                    # the poisoned jump
        for k in keys:
            resp = mgr.renew(lid, k, used=1)
            assert resp is not None and resp.granted > 0, (
                f"lease {k} mass-expired through a clamped forward jump")
        assert mgr.table.forward_clamps >= 1
        assert mgr.expired_total == 0
    finally:
        storage.close()


def test_normal_ttl_expiry_still_works_with_the_clamp():
    clock = {"t": 1_000_000}
    storage, lid = _lease_storage(clock)
    mgr = LeaseManager(storage, default_budget=8, ttl_ms=2_000.0,
                       clock_ms=lambda: clock["t"])
    try:
        assert mgr.grant(lid, "k").granted > 0
        clock["t"] += 2_001                      # one ordinary TTL lapse
        assert mgr.renew(lid, "k", used=0) is None
        assert mgr.expired_total == 1
        assert mgr.table.forward_clamps == 0, (
            "an ordinary TTL-sized step must pass the clamp untouched")
    finally:
        storage.close()


# ---------------------------------------------------------------------------
# BulkPool conservation under seeded-random interleaving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bulk_pool_conserves_under_random_interleaving(seed):
    """Every interleaving of slice/fold/return/top_up/renewal/lost/
    over-report conserves ``remaining + sliced_out + used_pending ==
    budget + deficit`` — checked after EVERY verb, what the fleet
    monitor asserts per step."""
    rng = random.Random(seed)
    pool = BulkPool(lid=1, key="k", budget=256, remaining=256,
                    epoch=0, deadline_ms=10_000)
    sessions = list(range(6))
    for _ in range(400):
        sid = rng.choice(sessions)
        sub = pool.subs.get(sid)
        op = rng.randrange(7)
        if op == 0:
            pool.slice(sid, rng.randint(1, 64))
        elif op == 1 and sub is not None:
            pool.fold_used(sub, rng.randint(0, sub.amount + 8))
        elif op == 2 and sub is not None:
            pool.return_unused(sub)
        elif op == 3 and sub is not None:
            pool.top_up(sub, rng.randint(1, 64))
        elif op == 4 and sub is not None:
            pool.fold_lost(pool.drop_sub(sid))
        elif op == 5:
            pool.fold_over_report(rng.randint(0, 16))
        elif op == 6:
            # Renewal, sometimes shrinking below what's sliced out — the
            # deficit path.
            pool.apply_renewal(rng.randint(32, 256), 5_000, 0, 0,
                               rng.randint(0, pool.used_pending))
        pool.check_conservation()
        assert pool.remaining >= 0 and pool.sliced_out >= 0
        assert pool.used_pending >= 0 and pool.deficit >= 0


# ---------------------------------------------------------------------------
# FleetHarness: both packages, one plan, equal reports
# ---------------------------------------------------------------------------

def test_fault_free_plan_matches_reference():
    plan = FaultPlan.generate(0, steps=6, fault_rate=0.0,
                              topology=_small_topology())
    port, ref = _both(plan)
    assert port == ref
    assert port["violation"] is None
    assert port["steps_completed"] == 6
    assert port["decisions"] > 0
    assert port["invariant_checks"] == 6


def test_faulted_plan_matches_reference():
    """The acceptance shape: a seeded multi-fault schedule (a kill, a
    pause whose resume meets the fence, edge flaps) completes with zero
    violations, the final reserve/credit replay reconciles against the
    oracle, and every count equals the reference's."""
    plan = FaultPlan.generate(0, steps=14, fault_rate=0.5,
                              topology=_small_topology())
    assert plan.actions, "seed 0 must exercise real faults"
    port, ref = _both(plan)
    assert port == ref
    assert port["violation"] is None
    assert port["steps_completed"] == 14
    assert port["promotions"] == [1, 1] and port["zombies_fenced"] == 1


def test_planted_pool_leak_matches_reference():
    topo = dict(DEFAULT_TOPOLOGY)
    topo.update(_small_topology())
    plan = FaultPlan(seed=3, steps=8, topology=topo,
                     actions=[FaultAction(4, "pool_leak", {"cell": 0})])
    port, ref = _both(plan)
    assert port == ref
    v = port["violation"]
    assert v is not None and v["invariant"] == "conservation"


def test_planted_epoch_rollback_minimized_and_replayed_across(tmp_path):
    """The known-bad fixture end to end on both packages: each minimizer
    strips the schedule to the planted defect with the same violation,
    and an artifact dumped by either package replays in the other (and
    in itself) to that violation."""
    from ratelimiter_tpu_torch.chaos import (
        dump_artifact,
        load_artifact,
        minimize,
        replay,
    )

    base = FaultPlan.generate(5, steps=10, fault_rate=0.4,
                              topology=_small_topology())
    bad = base.with_actions(
        list(base.actions)
        + [FaultAction(5, "epoch_rollback", {"cell": 1})])

    res = minimize(bad, max_runs=16, device="cpu")
    ref_res = ref_minimize(_ref_plan(bad), max_runs=16)
    for r in (res, ref_res):
        assert r["reproduced"]
        assert [a.op for a in r["plan"].actions] == ["epoch_rollback"], (
            f"minimizer kept noise: {[a.to_dict() for a in r['plan'].actions]}")
    v = res["violation"]
    assert v["invariant"] == "epoch-monotonicity"
    assert v == ref_res["violation"]
    assert res["runs"] == ref_res["runs"]
    assert res["plan"].dumps() == ref_res["plan"].dumps()

    port_path = str(tmp_path / "port.json")
    ref_path = str(tmp_path / "ref.json")
    dump_artifact(port_path, res["plan"], v, minimized=True,
                  original_actions=len(bad.actions))
    ref_dump(ref_path, ref_res["plan"], ref_res["violation"],
             minimized=True, original_actions=len(bad.actions))
    with open(port_path) as a, open(ref_path) as b:
        assert a.read() == b.read()
    replays = [replay(load_artifact(ref_path), device="cpu"),
               ref_replay(ref_load(port_path)),
               replay(load_artifact(port_path), device="cpu")]
    for rep in replays:
        assert rep["reproduced"], rep.get("violation")
        assert rep["violation"] == v
    # And the clean base still passes on the port (the defect WAS it).
    assert _port_run(base)["violation"] is None


def test_replay_cli_reproduces_on_the_cpu(tmp_path):
    plan = FaultPlan(seed=3, steps=6, topology=dict(
        DEFAULT_TOPOLOGY, **_small_topology()),
        actions=[FaultAction(2, "epoch_rollback", {"cell": 0})])
    report = _port_run(plan)
    path = str(tmp_path / "a.json")
    ref_dump(path, _ref_plan(plan), report["violation"])
    out = subprocess.run(
        [sys.executable, "-m", "ratelimiter_tpu_torch.chaos.replay", path,
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "REPRODUCED [epoch-monotonicity] at step 2" in out.stdout


# ---------------------------------------------------------------------------
# Slow: the TCP edge topology, ProcActor over a CPU node
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_tcp_edge_topology_runs_clean():
    """The same schedule shape over a REAL wire: a sidecar server behind
    a FaultInjectingProxy, garbage/partition faults included."""
    plan = FaultPlan.generate(1, steps=12, fault_rate=0.5,
                              topology=_small_topology(edge="tcp"))
    report = _port_run(plan)
    assert report["violation"] is None
    assert report["steps_completed"] == 12


_NODE = ["ratelimiter_tpu_torch.replication.hostproc", "--device", "cpu",
         "--role", "standby", "--shards", "1", "--num-slots", "128"]


@pytest.mark.slow
def test_procactor_sigterm_is_a_graceful_stop():
    from ratelimiter_tpu_torch.chaos.actors import ProcActor

    actor = ProcActor(_NODE)
    try:
        ready = actor.spawn(timeout_s=180.0)
        assert ready.get("ready") and ready.get("role") == "standby"
        rc = actor.stop_graceful(timeout_s=30.0)
        assert rc == 0, (
            f"SIGTERM must drain and exit 0 (the graceful path), "
            f"got rc={rc}: {actor.stderr()}")
        assert '{"launches"' in actor.stderr()
    finally:
        actor.close()


@pytest.mark.slow
def test_procactor_sigstop_pause_preserves_the_process():
    """The zombie shape at the process level: SIGSTOP freezes the node
    (state intact, sockets open), SIGCONT revives it, and the revived
    process still honors the graceful stop."""
    from ratelimiter_tpu_torch.chaos.actors import ProcActor

    actor = ProcActor(_NODE)
    try:
        actor.spawn(timeout_s=180.0)
        actor.pause()
        time.sleep(0.2)
        assert actor.proc.poll() is None, "SIGSTOP killed the process"
        actor.resume()
        time.sleep(0.2)
        rc = actor.stop_graceful(timeout_s=30.0)
        assert rc == 0, f"revived process lost the drain path: rc={rc}"
    finally:
        actor.close()
