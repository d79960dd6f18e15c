"""FleetAutopilot: automated cross-host re-seed (back to N+1); the
counterpart of ``ratelimiter_tpu/fleet/autopilot.py``.

The cross-host topology (replication/remote.py, hostproc) fails over
once, then the cell is N+0
until an operator hand-builds a standby.  The autopilot closes that
loop: it watches the orchestrator's standby set and, the moment a
promotion CONSUMES shard q's standby (``receivers[q].promoted``), runs
the re-seed job the operator used to:

1. spawn a fresh single-shard ``hostproc --role standby`` at the
   configured deploy version (NodeManager -> executor boundary);
2. RETARGET the now-serving backend's replication stream at the new
   node's listener — the control op stops the pipeline, swaps the
   sink, forces a full re-baseline frame, and ships it synchronously
   (replication/hostproc.py);
3. poll the new replica to ``consistent`` and hand it back: swap the
   orchestrator's StandbySet entry, re-point the shard's witness at
   the new vantage (the witness dict is read at call time, so an
   in-place mutation is the whole rewire), and re-aim the serving-
   lease relay leg at the new node's mailbox.

Every job is bounded by ``reseed_deadline_s`` — a job past it is
FAILED loudly (flight event) instead of silently wedging the cell at
N+0.  Jobs advance from the NodeManager's tick; no extra threads.

``witness_wrap`` adds the rolling-upgrade leg: a shard whose SERVING
node is DRAINING answers "dead" regardless of the standby's vantage —
without it, the still-heartbeating draining primary's "alive" verdict
would veto its own graceful promote-away forever.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from ratelimiter_tpu_torch.fleet import manager as _mgr
from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("fleet.autopilot")


class FleetAutopilot:
    """Per-cell re-seed driver.

    Parameters
    ----------
    manager : NodeManager spawning replacement nodes.
    orchestrator : FailoverOrchestrator (its router resolves the
        serving backend; ``set_lease_channel`` re-aims renewals).
    standby_set : the orchestrator's RemoteStandbySet (watched for
        consumption; ``replace`` hands the fresh replica back).
    witness_ctls : the LIVE dict behind ``standby_witness`` — entries
        are mutated in place to swap a shard's witness vantage.
    node_defaults : spawn kwargs for replacement standbys (num_slots,
        lease, host, repl_interval_ms, ack_timeout_ms,
        boot_timeout_s).  Geometry must match the serving nodes.
    version : deploy version tag for replacements (a rolling upgrade
        bumps this, then drains nodes — every respawn lands new).
    """

    def __init__(self, manager, orchestrator, standby_set,
                 witness_ctls: Dict[int, object],
                 node_defaults: Optional[dict] = None,
                 version: str = "v0",
                 reseed_deadline_s: float = 120.0,
                 recorder=None,
                 clock: Callable[[], float] = time.monotonic):
        self.manager = manager
        self.orch = orchestrator
        self.standby_set = standby_set
        self.witness_ctls = witness_ctls
        self.node_defaults = dict(node_defaults or {})
        self.version = str(version)
        self.reseed_deadline_s = float(reseed_deadline_s)
        self._clock = clock
        # Optional ControllerElection (control/fleet.py): a node handed
        # back into the cell is announced so the controller leader
        # anti-entropies it to the fleet's policy generation before it
        # can serve a stale one.
        self.election = None
        # q -> (node_name, shard_on_node): who serves / shadows shard q.
        self._serving: Dict[int, tuple] = {}
        self._standby: Dict[int, tuple] = {}
        self._jobs: Dict[int, dict] = {}
        self.completed: list = []
        self.failed_jobs: list = []
        self._seq = 0
        if recorder is not None:
            self._recorder = recorder
        else:
            from ratelimiter_tpu_torch.observability import flight_recorder

            self._recorder = flight_recorder()

    # -- topology bookkeeping --------------------------------------------------
    def bind(self, q: int, serving: tuple, standby: tuple) -> None:
        """Register shard q's placement: ``(node_name, shard_on_node)``
        for the serving and standby side."""
        self._serving[int(q)] = (str(serving[0]), int(serving[1]))
        self._standby[int(q)] = (str(standby[0]), int(standby[1]))

    def serving_node(self, q: int) -> Optional[str]:
        entry = self._serving.get(int(q))
        return entry[0] if entry is not None else None

    def standby_node(self, q: int) -> Optional[str]:
        entry = self._standby.get(int(q))
        return entry[0] if entry is not None else None

    def serving_placement(self, q: int) -> Optional[tuple]:
        return self._serving.get(int(q))

    def standby_placement(self, q: int) -> Optional[tuple]:
        return self._standby.get(int(q))

    def witness_wrap(self, inner: Callable[[int], str]
                     ) -> Callable[[int], str]:
        """Drain-aware witness: a shard whose serving node is DRAINING
        reads "dead" so the orchestrator promotes away from it — the
        graceful leg of a rolling upgrade.  Every other shard defers
        to ``inner`` (the standby-vantage witness)."""

        def witness(q: int) -> str:
            entry = self._serving.get(int(q))
            if entry is not None:
                node = self.manager.nodes.get(entry[0])
                if node is not None and node.state == _mgr.DRAINING:
                    return "dead"
            return inner(q)

        return witness

    # -- the re-seed state machine ---------------------------------------------
    def tick(self) -> None:
        # Two passes: FIRST swap the serving bindings of every newly
        # consumed shard (cheap, keeps the drain-aware probe/witness
        # truthful), THEN advance jobs — _advance can block for seconds
        # on a replacement node's boot, and shard 1's stale binding
        # must not wait out shard 0's spawn.
        for q in range(self.standby_set.n_shards):
            if q in self._jobs:
                continue
            rx = self.standby_set.receivers[q]
            if getattr(rx, "promoted", False):
                self._begin(q)
        for q, job in list(self._jobs.items()):
            self._advance(q, job)

    def _begin(self, q: int) -> None:
        """Shard q's standby was consumed by a promotion: the old
        standby node now serves q; open a re-seed job."""
        consumed = self._standby.pop(q, None)
        if consumed is not None:
            self._serving[q] = consumed
            node = self.manager.nodes.get(consumed[0])
            if node is not None and node.state in (_mgr.READY,
                                                   _mgr.SERVING):
                self.manager.mark_serving(consumed[0])
        job = {"q": q, "state": "spawn", "started_at": self._clock(),
               "node": None, "rx": None, "backend": None, "error": None}
        self._jobs[q] = job
        self._recorder.record("fleet.reseed_started", shard=q,
                              serving=self.serving_node(q))

    def _advance(self, q: int, job: dict) -> None:
        if job["state"] in ("done", "failed"):
            return
        elapsed = self._clock() - job["started_at"]
        if elapsed > self.reseed_deadline_s:
            job["state"] = "failed"
            job["elapsed_s"] = round(elapsed, 3)
            self.failed_jobs.append(
                {k: job[k] for k in ("q", "state", "node", "error",
                                     "elapsed_s")})
            self._jobs.pop(q, None)
            _log.warning("re-seed job for shard %d missed its %.1fs "
                         "deadline (last error: %s) — cell stays N+0",
                         q, self.reseed_deadline_s, job["error"])
            self._recorder.record("fleet.reseed_deadline", shard=q,
                                  deadline_s=self.reseed_deadline_s,
                                  error=job["error"])
            return
        try:
            if job["state"] == "spawn":
                backend = self.orch.router.serving(q)
                if backend is None:
                    return  # promotion not installed yet; next tick
                job["backend"] = backend
                name = f"reseed-q{q}-{self._seq}"
                self._seq += 1
                self.manager.spawn(name, "standby", shards=1,
                                   version=self.version, respawn=True,
                                   **self.node_defaults)
                job["node"] = name
                job["state"] = "retarget"
            if job["state"] == "retarget":
                from ratelimiter_tpu_torch.replication.remote import (
                    RemoteReceiver,
                )

                node = self.manager.node(job["node"])
                job["backend"].retarget(node.host, node.repl_ports()[0])
                job["rx"] = RemoteReceiver(node.ctl, shard=0)
                job["state"] = "wait_consistent"
            if job["state"] == "wait_consistent":
                rx = job["rx"]
                if rx.consistent and not rx.promoted:
                    self._finalize(q, job)
        except Exception as exc:  # noqa: BLE001 — retried every tick
            # until the deadline; the error rides along for the
            # deadline event and /actuator/fleet.
            job["error"] = f"{type(exc).__name__}: {exc}"[:200]

    def install_standby(self, q: int, node_name: str, shard: int, rx,
                        serving_backend=None) -> None:
        """Hand a consistent replica back to the orchestrator: swap the
        StandbySet entry, re-point shard q's witness vantage (the
        witness dict is read at call time, so the in-place mutation IS
        the rewire — replication/remote.py:standby_witness), and re-aim
        the serving-lease relay leg at the new node's mailbox.  Also
        the planned-replacement path: a rolling upgrade's graceful
        standby swap calls this directly."""
        node = self.manager.node(node_name)
        self.standby_set.replace(q, None, rx)
        self.witness_ctls[q] = (node.ctl, int(shard))
        if serving_backend is not None and \
                float(getattr(self.orch.cfg,
                              "fence_lease_ttl_ms", 0.0)) > 0:
            from ratelimiter_tpu_torch.replication.remote import (
                FanoutLeaseChannel,
            )

            self.orch.set_lease_channel(
                q, FanoutLeaseChannel(serving_backend, node.ctl,
                                      shard=int(shard)))
        self._standby[int(q)] = (node.name, int(shard))
        if self.election is not None:
            from ratelimiter_tpu_torch.replication.remote import RemoteBackend

            # The join-side half of the generation-convergence
            # invariant: the fresh node is converged
            # to the leader's generation before anything can read a
            # stale policy from it.
            self.election.note_join(
                node.name, RemoteBackend(node.ctl, label=node.name,
                                         shard=int(shard)))

    def _finalize(self, q: int, job: dict) -> None:
        node = self.manager.node(job["node"])
        self.install_standby(q, job["node"], 0, job["rx"],
                             serving_backend=job["backend"])
        elapsed = self._clock() - job["started_at"]
        job["state"] = "done"
        job["elapsed_s"] = round(elapsed, 3)
        self.completed.append(
            {k: job[k] for k in ("q", "node", "elapsed_s")})
        self._jobs.pop(q, None)
        self.manager.note_reseed()
        _log.info("re-seed for shard %d complete in %.2fs (standby %s, "
                  "version %s) — cell back at N+1", q, elapsed,
                  node.name, node.version)
        self._recorder.record("fleet.reseeded", shard=q, node=node.name,
                              elapsed_s=job["elapsed_s"],
                              version=node.version)

    # -- observability ---------------------------------------------------------
    def status(self) -> dict:
        now = self._clock()
        return {
            "version": self.version,
            "serving": {str(q): e[0] for q, e in self._serving.items()},
            "standby": {str(q): e[0] for q, e in self._standby.items()},
            "jobs": {
                str(q): {
                    "state": j["state"], "node": j["node"],
                    "elapsed_s": round(now - j["started_at"], 3),
                    "error": j["error"],
                }
                for q, j in self._jobs.items()
            },
            "completed": len(self.completed),
            "failed": len(self.failed_jobs),
        }
