"""The plan-settling warm-up.

A frozen copy of the warm-up in ``bench_end_to_end_stream``
(``ratelimiter_tpu_torch/bench/harness.py`` at commit 6150e04): untimed
passes of the stream until the storage's chunk-plan map stops changing.
An election brings new chunk shapes, and with them new staging buffers
and a first pass at the new schedule, so no timed pass meets a fresh
shape.  The first pass also builds the kernels.
"""

from __future__ import annotations


def plan_signature(storage) -> dict:
    """The storage's elected chunk plans: kind and schedule per stream
    shape."""
    return {k: (v["kind"], v.get("schedule", v.get("chunk")))
            for k, v in storage._chunk_plans.items()}


def settle(storage, one_pass, max_passes: int = 4) -> int:
    """Run ``one_pass()`` until the plan map is unchanged by a pass (at
    least two passes, at most ``max_passes``); returns the passes run."""
    for i in range(max_passes):
        sig = plan_signature(storage)
        one_pass()
        if i > 0 and plan_signature(storage) == sig:
            return i + 1
    return max_passes
