"""Chaos conductor: seeded multi-fault schedules, a fleet-wide invariant
monitor, and failure minimization (counterpart of
``ratelimiter_tpu/chaos/``).

Everything except the harness imports eagerly — plan, monitor,
minimizer, and replay helpers are all stdlib-light (the minimizer and
replay pull the harness in lazily, inside their functions).  The
harness itself loads the torch-backed stack, so ``FleetHarness`` and
``run_plan`` resolve through a module ``__getattr__``.

The eager function imports for ``minimize`` and ``replay`` double as
shadow-busting: importing those submodules binds the MODULE objects as
package attributes, and the assignments below overwrite them so
``from ratelimiter_tpu_torch.chaos import minimize`` yields the
callable, never the module (the submodules stay importable via
sys.modules).
"""

from ratelimiter_tpu_torch.chaos.plan import (  # noqa: F401
    DEFAULT_TOPOLOGY, DEFECT_OPS, FAULT_OPS, FaultAction, FaultPlan)
from ratelimiter_tpu_torch.chaos.monitor import (  # noqa: F401
    InvariantMonitor, InvariantViolation)
from ratelimiter_tpu_torch.chaos.minimize import minimize  # noqa: F401
from ratelimiter_tpu_torch.chaos.replay import (  # noqa: F401
    dump_artifact, load_artifact, replay)

_LAZY = {
    "FleetHarness": ("ratelimiter_tpu_torch.chaos.harness", "FleetHarness"),
    "run_plan": ("ratelimiter_tpu_torch.chaos.harness", "run_plan"),
}

__all__ = [
    "DEFAULT_TOPOLOGY", "DEFECT_OPS", "FAULT_OPS", "FaultAction",
    "FaultPlan", "InvariantMonitor", "InvariantViolation",
    "dump_artifact", "load_artifact", "minimize", "replay",
] + sorted(_LAZY)


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module), attr)
