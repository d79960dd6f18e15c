"""Replayable chaos artifacts (counterpart of
``ratelimiter_tpu/chaos/replay.py``; the artifact format is the
reference's, so an artifact either package dumps replays in the other).

When a conductor run violates an invariant, the failure is written as
a JSON artifact capturing the COMPLETE identity of the run — the plan
(seed, steps, topology, fault_rate, the exact action list) plus the
observed ``(invariant, step, detail)``.  Because traffic is a pure
function of ``(seed, step)`` and actions carry all their parameters,
re-running the artifact's plan reproduces the same trajectory and the
same violation deterministically, on the card or on the CPU:

    python -m ratelimiter_tpu_torch.chaos.replay failure.json [--device cpu]

The module is also the library surface the soak gate and tests use:
``dump_artifact`` / ``load_artifact`` / ``replay``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

from ratelimiter_tpu_torch.chaos.plan import FaultPlan

ARTIFACT_VERSION = 1


def dump_artifact(path: str, plan: FaultPlan, violation: Dict,
                  minimized: bool = False,
                  original_actions: Optional[int] = None) -> str:
    """Write a replayable failure artifact; returns ``path``."""
    doc = {
        "version": ARTIFACT_VERSION,
        "kind": "chaos-artifact",
        "plan": plan.to_json(),
        "violation": {
            "invariant": str(violation["invariant"]),
            "step": int(violation["step"]),
            "detail": str(violation.get("detail", "")),
        },
        "minimized": bool(minimized),
        "original_actions": int(
            len(plan.actions) if original_actions is None
            else original_actions),
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True, indent=2)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_artifact(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("kind") != "chaos-artifact":
        raise ValueError(f"{path}: not a chaos artifact")
    doc["plan"] = FaultPlan.from_json(doc["plan"])
    return doc


def replay(artifact: Dict, device=None) -> Dict:
    """Re-run the artifact's plan on ``device`` (None: the card); returns
    the harness report with a ``reproduced`` flag (same invariant
    observed again)."""
    from ratelimiter_tpu_torch.chaos.harness import run_plan

    report = run_plan(artifact["plan"], device=device)
    expected = artifact["violation"]["invariant"]
    got = (report.get("violation") or {}).get("invariant")
    report["expected_invariant"] = expected
    report["reproduced"] = (got == expected)
    return report


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay a chaos conductor failure artifact.")
    ap.add_argument("artifact",
                    help="path to a chaos-artifact JSON file")
    ap.add_argument("--device", default="cuda",
                    help="where the fleet's cells run (default: the card)")
    args = ap.parse_args(argv)

    art = load_artifact(args.artifact)
    v = art["violation"]
    print(f"replaying plan seed={art['plan'].seed} "
          f"steps={art['plan'].steps} actions={len(art['plan'].actions)}"
          f"{' (minimized)' if art.get('minimized') else ''} "
          f"on {args.device}")
    print(f"expecting [{v['invariant']}] at step {v['step']}: "
          f"{v['detail']}")
    report = replay(art, device=args.device)
    got = report.get("violation")
    if report["reproduced"]:
        print(f"REPRODUCED [{got['invariant']}] at step {got['step']}: "
              f"{got['detail']}")
        return 0
    if got is None:
        print("NOT reproduced: run completed with zero violations")
    else:
        print(f"DIFFERENT failure: [{got['invariant']}] at step "
              f"{got['step']}: {got['detail']}")
    return 1


if __name__ == "__main__":
    sys.exit(_main())
