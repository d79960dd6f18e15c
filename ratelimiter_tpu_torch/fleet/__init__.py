"""Fleet autopilot: the deployment layer above the failover orchestrator
(counterpart of ``ratelimiter_tpu/fleet/``).

- :mod:`executor` — the process-execution boundary (``LocalExecutor``
  runs the port's ``hostproc`` as local subprocesses, on the card unless
  built with ``device="cpu"``; anything with the same duck-typed surface
  slots in unchanged).
- :mod:`manager` — the :class:`~manager.NodeManager`: spawns, adopts,
  probes, and retires nodes, tracking per-node lifecycle state
  (SPAWNING → READY → SERVING → DRAINING → RETIRED/FAILED).
- :mod:`autopilot` — the :class:`~autopilot.FleetAutopilot`: watches
  the orchestrator's standby set and, when a promotion consumes a
  standby, spawns a fresh one, drives the control-RPC re-seed, and
  hands the consistent replica back — the cell returns to N+1 with
  zero operator calls.
"""

from ratelimiter_tpu_torch.fleet.autopilot import FleetAutopilot
from ratelimiter_tpu_torch.fleet.executor import LocalExecutor, SpawnError
from ratelimiter_tpu_torch.fleet.manager import (
    DRAINING,
    FAILED,
    READY,
    RETIRED,
    SERVING,
    SPAWNING,
    Node,
    NodeManager,
)

__all__ = [
    "DRAINING",
    "FAILED",
    "FleetAutopilot",
    "LocalExecutor",
    "Node",
    "NodeManager",
    "READY",
    "RETIRED",
    "SERVING",
    "SPAWNING",
    "SpawnError",
]
