"""Seeded multi-fault schedules (counterpart of
``ratelimiter_tpu/chaos/plan.py``; the JSON form is the reference's, byte
for byte, so a plan or an artifact either package dumps replays in the
other).

A :class:`FaultPlan` is the chaos conductor's score: a list of timed
:class:`FaultAction` entries, generated deterministically from
``(seed, topology, steps, fault_rate)`` — the SAME inputs always yield
the SAME schedule, byte for byte, which is what makes every failure
replayable (chaos/replay.py) and minimizable (chaos/minimize.py).

The generator composes fault classes the hand-scripted drills
(storage/chaos.py) only ever exercised one at a time:

- **edge link** faults (``edge_partition`` / ``edge_flap`` /
  ``edge_delay`` / ``edge_garbage`` / ``edge_heal``) — applied to the
  aggregator's upstream link (a ``FaultInjectingProxy`` in the TCP
  topology, an in-process gate in the direct one);
- **shard lifecycle** faults (``kill_shard``, ``pause_shard`` /
  ``resume_shard``) — a kill is a crash the orchestrator must detect,
  fence, and promote around; a pause-then-resume is the classic zombie
  the fence must catch when the promotion happened mid-pause;
- **clock** faults (``clock_jump``) — step one cell's injected clock
  offset forward or backward (storage/gpu.py's now-source);
- **control/policy** churn (``storage_fault``, ``policy_bump``,
  ``controller_claim``) — benign-but-noisy traffic that the epoch-
  monotonicity invariant watches.

Every fault the generator emits auto-schedules its own heal a few steps
later (an unhealed schedule would only measure the outage, not the
recovery), and destructive actions respect per-target cooldowns so the
orchestrator's promote/re-seed cycle gets room to complete — chaos that
never lets the system heal proves nothing about convergence.

``include_defects=True`` (test fixtures only — never the CI gate)
plants a deliberately-broken action (``epoch_rollback``, ``pool_leak``)
so the invariant monitor, minimizer, and artifact replay can be proven
against a KNOWN violation.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional

# Ops whose only purpose is violating an invariant on purpose (fixture
# plans); the generator emits them only under include_defects=True.
DEFECT_OPS = ("epoch_rollback", "pool_leak")

FAULT_OPS = (
    "edge_partition", "edge_flap", "edge_delay", "edge_garbage",
    "edge_heal", "kill_shard", "pause_shard", "resume_shard",
    "clock_jump", "storage_fault", "policy_bump", "controller_claim",
)

DEFAULT_TOPOLOGY: Dict = {
    "cells": 2,
    "shards_per_cell": 2,
    "slots_per_shard": 128,
    "n_direct_keys": 24,
    "n_lease_keys": 6,
    "n_edge_keys": 4,
    "edge": "direct",          # "direct" (in-process) or "tcp" (proxy)
    "budget": 12,
    "bulk_budget": 64,
    "slice_budget": 8,
    "lease_ttl_ms": 5000.0,
    "probe_interval_ms": 50.0,
    "suspect_threshold": 3,
    "hysteresis_ms": 200.0,
    "liveness_window": 10,
}


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One timed conductor action: at schedule ``step``, apply ``op``
    with ``params`` (cell/shard targets, magnitudes)."""

    step: int
    op: str
    params: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"step": int(self.step), "op": self.op,
                "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultAction":
        return cls(step=int(d["step"]), op=str(d["op"]),
                   params=dict(d.get("params", {})))


@dataclasses.dataclass
class FaultPlan:
    """A deterministic, replayable chaos schedule."""

    seed: int
    steps: int
    topology: Dict
    actions: List[FaultAction]
    fault_rate: float = 0.5

    def by_step(self) -> Dict[int, List[FaultAction]]:
        out: Dict[int, List[FaultAction]] = {}
        for a in self.actions:
            out.setdefault(int(a.step), []).append(a)
        return out

    def with_actions(self, actions: List[FaultAction]) -> "FaultPlan":
        """Same schedule frame (seed/steps/topology — traffic is a pure
        function of those), different action list: the minimizer's
        reduction step."""
        return FaultPlan(seed=self.seed, steps=self.steps,
                         topology=dict(self.topology),
                         actions=list(actions),
                         fault_rate=self.fault_rate)

    # -- serialization ---------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "version": 1,
            "seed": int(self.seed),
            "steps": int(self.steps),
            "fault_rate": float(self.fault_rate),
            "topology": dict(self.topology),
            "actions": [a.to_dict() for a in self.actions],
        }

    @classmethod
    def from_json(cls, d: Dict) -> "FaultPlan":
        return cls(seed=int(d["seed"]), steps=int(d["steps"]),
                   topology=dict(d.get("topology", {})),
                   actions=[FaultAction.from_dict(a)
                            for a in d.get("actions", [])],
                   fault_rate=float(d.get("fault_rate", 0.5)))

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    # -- generation ------------------------------------------------------------
    @classmethod
    def generate(cls, seed: int, topology: Optional[Dict] = None,
                 steps: int = 24, fault_rate: float = 0.5,
                 include_defects: bool = False) -> "FaultPlan":
        """Deterministically generate a schedule.  Pure function of the
        arguments: ``generate(s, t, n, r)`` is the plan's identity —
        an artifact that records them reproduces the plan exactly.

        The generator keeps the schedule RUNNABLE, not just random:

        - the edge link carries at most one fault at a time, healed
          1–3 steps later;
        - at most one shard per cell is down at once, and a killed or
          paused shard gets a cooldown long enough for the orchestrator
          to promote and re-seed before the next hit;
        - pauses always schedule their resume (the conductor's zombie
          probe runs at resume time);
        - clock jumps are bounded (|jump| <= 4 s) so TTL accounting is
          stressed without making every lease trivially dead.
        """
        topo = dict(DEFAULT_TOPOLOGY)
        topo.update(topology or {})
        rng = random.Random(int(seed))
        steps = int(steps)
        cells = int(topo["cells"])
        shards = int(topo["shards_per_cell"])
        actions: List[FaultAction] = []

        edge_busy_until = -1
        # (cell, shard) -> first step the shard may be targeted again.
        shard_cooldown = {(c, q): 0 for c in range(cells)
                         for q in range(shards)}
        # Promotion settle budget: detect + hysteresis + re-seed ticks.
        settle = int(topo["suspect_threshold"]
                     + topo["hysteresis_ms"] / topo["probe_interval_ms"]
                     + 6)

        weighted = (
            ("edge_partition", 3), ("edge_flap", 1), ("edge_delay", 1),
            ("edge_garbage", 1), ("kill_shard", 3), ("pause_shard", 3),
            ("clock_jump", 3), ("storage_fault", 2), ("policy_bump", 2),
            ("controller_claim", 2),
        )
        ops = [op for op, w in weighted for _ in range(w)]

        def free_shard(step: int):
            cands = [(c, q) for (c, q), until in sorted(
                shard_cooldown.items()) if until <= step]
            return rng.choice(cands) if cands else None

        for step in range(steps):
            if rng.random() >= float(fault_rate):
                continue
            op = rng.choice(ops)
            if op.startswith("edge_"):
                if step <= edge_busy_until:
                    continue
                params: Dict = {}
                if op == "edge_partition":
                    params["direction"] = rng.choice(["both", "up", "down"])
                elif op == "edge_flap":
                    params["period_s"] = rng.choice([0.05, 0.1, 0.2])
                elif op == "edge_delay":
                    params["delay_ms"] = rng.choice([1.0, 2.0, 5.0])
                elif op == "edge_garbage":
                    params["n"] = rng.choice([8, 32, 64])
                heal_at = step + rng.randint(1, 3)
                actions.append(FaultAction(step, op, params))
                actions.append(FaultAction(heal_at, "edge_heal"))
                edge_busy_until = heal_at
            elif op == "kill_shard":
                target = free_shard(step)
                if target is None:
                    continue
                c, q = target
                actions.append(FaultAction(step, "kill_shard",
                                           {"cell": c, "shard": q}))
                shard_cooldown[(c, q)] = step + settle
            elif op == "pause_shard":
                target = free_shard(step)
                if target is None:
                    continue
                c, q = target
                resume_at = step + rng.randint(2, 5)
                actions.append(FaultAction(step, "pause_shard",
                                           {"cell": c, "shard": q}))
                actions.append(FaultAction(resume_at, "resume_shard",
                                           {"cell": c, "shard": q}))
                # A pause that outlived detection promoted a replacement;
                # give the re-seed the same settle room a kill gets.
                shard_cooldown[(c, q)] = resume_at + settle
            elif op == "clock_jump":
                actions.append(FaultAction(step, "clock_jump", {
                    "cell": rng.randrange(cells),
                    "ms": rng.choice([-250, -40, 60, 250, 1200, 4000]),
                }))
            elif op == "storage_fault":
                actions.append(FaultAction(step, "storage_fault",
                                           {"n": rng.randint(1, 3)}))
            elif op == "policy_bump":
                actions.append(FaultAction(step, "policy_bump"))
            elif op == "controller_claim":
                actions.append(FaultAction(step, "controller_claim",
                                           {"cell": rng.randrange(cells)}))

        if include_defects:
            at = rng.randint(2, max(2, steps - 2))
            actions.append(FaultAction(
                at, rng.choice(list(DEFECT_OPS)),
                {"cell": rng.randrange(cells)}))

        actions.sort(key=lambda a: (a.step, a.op))
        return cls(seed=int(seed), steps=steps, topology=topo,
                   actions=actions, fault_rate=float(fault_rate))
