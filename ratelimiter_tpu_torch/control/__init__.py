"""Adaptive policy control plane (counterpart of
``ratelimiter_tpu/control/``).

Closes the loop from observation (the fleet telemetry plane's
``UsageSignals``) to actuation (``LimiterTable.set_policy`` row-wise
updates of the policy tensors on the card): per-tenant AIMD limits, a
hierarchical global aggregate cap, operator pinning, and lease-backed
concurrency slots.  ``control/fleet.py`` makes the same loop fleet-true:
epoch-fenced controller leadership over the control RPC, cross-host
signal aggregation, and monotone-generation policy broadcast.  Both are
host code; the decisions the policies govern run in the port's kernels.
"""

from ratelimiter_tpu_torch.control.controller import (
    AdaptivePolicyController,
    ControlConfig,
)
from ratelimiter_tpu_torch.control.fleet import (
    ControllerElection,
    FleetControlPlane,
    NotLeader,
)

__all__ = [
    "AdaptivePolicyController",
    "ControlConfig",
    "ControllerElection",
    "FleetControlPlane",
    "NotLeader",
]
