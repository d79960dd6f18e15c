"""Failure minimization: shrink a failing FaultPlan to a minimal
reproducer (counterpart of ``ratelimiter_tpu/chaos/minimize.py``).

Two reductions, both sound because traffic at step ``s`` is a pure
function of ``(plan.seed, s)`` — dropping actions never shifts what
any surviving step does:

1. **prefix truncation** — a violation detected at step ``v`` cannot
   depend on anything after ``v``, so the plan is cut to ``v + 1``
   steps and actions at later steps dropped (one run to confirm);
2. **ddmin** — classic delta debugging over the remaining action list:
   remove chunks, keep any reduction that still reproduces a violation
   of the SAME invariant, refine the granularity, stop when single
   actions can't be removed (or the run budget is spent).

Each candidate costs one full fleet run, so the budget is explicit
(``max_runs``); the result records how many runs were spent and is
always a valid plan — worst case the original, failing one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ratelimiter_tpu_torch.chaos.plan import FaultPlan


def _run_fn(run_fn: Optional[Callable], device=None) -> Callable:
    if run_fn is not None:
        return run_fn
    from ratelimiter_tpu_torch.chaos.harness import run_plan

    return lambda plan: run_plan(plan, device=device)


def _same_failure(report: Dict, invariant: str) -> bool:
    v = report.get("violation")
    return v is not None and v.get("invariant") == invariant


def minimize(plan: FaultPlan, run_fn: Optional[Callable] = None,
             max_runs: int = 24, device=None) -> Dict:
    """Shrink ``plan`` to a minimal schedule still violating the same
    invariant.  Returns ``{"plan", "violation", "runs", "reduced_from",
    "reproduced"}`` — ``reproduced=False`` means the baseline run never
    failed and the plan comes back untouched.  Without ``run_fn`` each
    candidate runs through ``harness.run_plan`` on ``device`` (None: the
    card)."""
    run = _run_fn(run_fn, device)
    runs = 1
    base = run(plan)
    if base.get("violation") is None:
        return {"plan": plan, "violation": None, "runs": runs,
                "reduced_from": len(plan.actions), "reproduced": False}
    invariant = base["violation"]["invariant"]
    best = plan
    best_violation = base["violation"]

    # 1. Prefix truncation to the detection step.
    vstep = int(base["violation"]["step"])
    if vstep + 1 < int(plan.steps) and runs < max_runs:
        cand = FaultPlan(
            seed=plan.seed, steps=vstep + 1,
            topology=dict(plan.topology),
            actions=[a for a in plan.actions if a.step <= vstep],
            fault_rate=plan.fault_rate)
        rep = run(cand)
        runs += 1
        if _same_failure(rep, invariant):
            best = cand
            best_violation = rep["violation"]

    # 2. ddmin over the action list.
    actions = list(best.actions)
    n = 2
    while len(actions) >= 2 and n <= len(actions) and runs < max_runs:
        chunk = -(-len(actions) // n)  # ceil
        reduced = False
        for i in range(n):
            if runs >= max_runs:
                break
            subset = actions[:i * chunk] + actions[(i + 1) * chunk:]
            if len(subset) == len(actions):
                continue
            cand = best.with_actions(subset)
            rep = run(cand)
            runs += 1
            if _same_failure(rep, invariant):
                actions = subset
                best = cand
                best_violation = rep["violation"]
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(actions):
                break
            n = min(n * 2, len(actions))

    return {"plan": best, "violation": best_violation, "runs": runs,
            "reduced_from": len(plan.actions), "reproduced": True}
