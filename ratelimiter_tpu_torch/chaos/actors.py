"""The conductor's unified actor layer: one ``apply(action)`` surface
over every fault primitive the repo already has (counterpart of
``ratelimiter_tpu/chaos/actors.py``).

Actions come from a :class:`~ratelimiter_tpu_torch.chaos.plan.FaultPlan` and
land on the live :class:`~ratelimiter_tpu_torch.chaos.harness.FleetHarness`:

- edge-link actions drive the ``FaultInjectingProxy`` (TCP topology)
  or the in-process :class:`GatedTransport` (direct topology);
- shard actions flip the per-shard probe flags the orchestrator's
  failure detector reads — a kill ships the replication backlog first
  (the crash loses nothing the wire already carried, which is what
  keeps the oracle reconciliation exact), a pause preserves state and
  the RESUME runs the zombie probe: if a promotion happened mid-pause,
  the old backend must answer direct dispatch with ``FencedError``, and
  serving instead is reported as a ``zombie-serving`` violation;
- clock actions step one cell's skew offset (every storage in the cell
  reads ``base_clock + skew``, mirroring storage/gpu.py's injectable
  process offset for real deployments);
- ``storage_fault`` arms :class:`LeaseFaultGate` (the deterministic
  in-process stand-in for ``FaultInjectingStorage``'s forced-failure
  mode) on the lease path;
- defect actions (``epoch_rollback``, ``pool_leak``) corrupt state ON
  PURPOSE — they exist so tests can prove the monitor catches, the
  minimizer isolates, and the artifact replays a real violation.

Everything here is deterministic given the plan: no wall clocks, no
RNG — replaying the same actions against a fresh harness reproduces
the same trajectory bit for bit (TCP-topology timing faults excepted;
those can shift latencies but never invariant outcomes).

:class:`ProcActor` is the real-subprocess sibling used by the
cross-host drills and the slow soak: it wraps a spawned port
``hostproc``/``edgeproc`` (``python -m ratelimiter_tpu_torch...``; a
node runs on the card unless its argv says ``--device cpu``) and speaks
in signals to the child's own pid — SIGSTOP/SIGCONT for the pause (the
classic zombie shape), SIGTERM for the graceful stop the processes
honor (drain, release serving lease, exit 0), SIGKILL for the crash.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
from typing import Dict, List, Optional

from ratelimiter_tpu_torch.storage.errors import StorageException


class GatedTransport:
    """In-process stand-in for a partitioned edge upstream link: while
    ``cut``, every call raises ``StorageException`` (the aggregator's
    callers see exactly the timeout/error a dead TCP link produces,
    with zero wall-clock cost and full determinism)."""

    def __init__(self, inner):
        self._inner = inner
        self.cut = False
        self.drops = 0

    def __getattr__(self, name):
        target = getattr(self._inner, name)
        if not callable(target):
            return target

        def call(*args, **kwargs):
            if self.cut:
                self.drops += 1
                raise StorageException("edge upstream link partitioned "
                                       "(chaos conductor)")
            return target(*args, **kwargs)

        return call


class LeaseFaultGate:
    """Deterministic storage-fault injector for the lease path: wraps
    the serving storage and force-fails the next ``n`` lease device ops
    (``lease_reserve`` / ``lease_credit``) with ``StorageException`` —
    the manager's deny/refuse paths under storage trouble, with none of
    ``FaultInjectingStorage``'s RNG (the conductor's schedule IS the
    randomness source)."""

    FAIL_OPS = ("lease_reserve", "lease_credit")

    def __init__(self, inner):
        self._inner = inner
        self._forced = 0
        self.injected = 0

    def fail_next(self, n: int = 1) -> None:
        self._forced += int(n)

    def heal(self) -> None:
        self._forced = 0

    def __getattr__(self, name):
        target = getattr(self._inner, name)
        if not callable(target) or name not in self.FAIL_OPS:
            return target

        def call(*args, **kwargs):
            if self._forced > 0:
                self._forced -= 1
                self.injected += 1
                raise StorageException(
                    f"injected lease-path failure in {name} "
                    "(chaos conductor)")
            return target(*args, **kwargs)

        return call


class Actors:
    """Dispatch one plan action onto the harness.  Raises
    ``InvariantViolation`` (via the harness's monitor hook) only from
    the zombie probe — every other action just mutates fault state."""

    def __init__(self, harness):
        self.h = harness
        self.applied: List[Dict] = []

    def apply(self, action, step: int) -> None:
        fn = getattr(self, "_op_" + action.op, None)
        if fn is None:
            raise ValueError(f"unknown chaos op: {action.op!r}")
        fn(step, **dict(action.params))
        self.applied.append(action.to_dict())

    # -- edge link -------------------------------------------------------------
    def _op_edge_partition(self, step, direction: str = "both") -> None:
        self.h.edge_link.partition(direction)

    def _op_edge_flap(self, step, period_s: float = 0.1) -> None:
        self.h.edge_link.flap(float(period_s))

    def _op_edge_delay(self, step, delay_ms: float = 2.0) -> None:
        self.h.edge_link.delay(float(delay_ms))

    def _op_edge_garbage(self, step, n: int = 32) -> None:
        self.h.edge_link.garbage(int(n))

    def _op_edge_heal(self, step) -> None:
        self.h.edge_link.heal()

    # -- shard lifecycle -------------------------------------------------------
    def _op_kill_shard(self, step, cell: int = 0, shard: int = 0) -> None:
        c = self.h.cells[int(cell)]
        # Ship the replication backlog first: the crash takes the
        # process, not bytes already on the wire — and it is what keeps
        # the post-promotion oracle reconciliation exact (the drills'
        # "final deterministic epoch" discipline).
        c.repl.ship_now()
        f = c.flags[int(shard)]
        f["down"] = True
        f["paused"] = False
        f["at_promotions"] = c.orch.promotions
        f["backend"] = c.serving_backend(int(shard))

    def _op_pause_shard(self, step, cell: int = 0, shard: int = 0) -> None:
        c = self.h.cells[int(cell)]
        f = c.flags[int(shard)]
        f["down"] = True
        f["paused"] = True
        f["at_promotions"] = c.orch.promotions
        f["backend"] = c.serving_backend(int(shard))

    def _op_resume_shard(self, step, cell: int = 0,
                         shard: int = 0) -> None:
        c = self.h.cells[int(cell)]
        f = c.flags[int(shard)]
        if not f.get("paused"):
            return  # resume of a shard that was killed meanwhile: no-op
        # Promotion of THIS shard, not the global counter: a concurrent
        # promotion elsewhere in the cell must not flag this backend.
        promoted_during_pause = (
            c.serving_backend(int(shard)) is not f.get("backend"))
        f["down"] = False
        f["paused"] = False
        if promoted_during_pause:
            # The classic zombie: a paused-then-resumed primary whose
            # keyspace was promoted away mid-pause.  Its old backend
            # MUST refuse direct dispatch with the typed fence error.
            self.h.zombie_probe(c, int(shard), f.get("backend"), step)

    # -- clock -----------------------------------------------------------------
    def _op_clock_jump(self, step, cell: int = 0, ms: int = 0) -> None:
        self.h.skew[int(cell)] += int(ms)

    # -- lease-path storage faults --------------------------------------------
    def _op_storage_fault(self, step, n: int = 1) -> None:
        self.h.gate.fail_next(int(n))

    # -- control-plane churn ---------------------------------------------------
    def _op_policy_bump(self, step) -> None:
        c0 = self.h.cells[0]
        c0.primary.set_policy(c0.lid_lease, c0.cfg_lease)

    def _op_controller_claim(self, step, cell: int = 0) -> None:
        seat = self.h.cells[int(cell)].seat
        seat.claim(f"ctl-{int(cell)}", seat.epoch + 1, ttl_ms=60_000.0)

    # -- deliberate defects (fixtures) ----------------------------------------
    def _op_epoch_rollback(self, step, cell: int = 0) -> None:
        # Regress the cell's fence epoch by force — the epoch-
        # monotonicity invariant must catch this at the step's check.
        self.h.cells[int(cell)].primary._fence_epoch -= 1

    def _op_pool_leak(self, step, cell: int = 0) -> None:
        # Mint one permit out of thin air in the first live bulk pool —
        # the conservation invariant must catch this at the step's
        # check.  (No pool yet: leak into the one the next edge grant
        # creates, by retrying on the following step via the monitor's
        # pending-defect latch.)
        pools = sorted(self.h.agg._pools.items())
        if pools:
            pools[0][1].remaining += 1
        else:
            self.h.pending_pool_leak = True


class ProcActor:
    """A real port ``hostproc``/``edgeproc`` subprocess under conductor
    control.  ``spawn`` blocks for the one-line ready JSON; the fault
    verbs are signals to the child's own pid, never to a process group:

    - :meth:`pause` / :meth:`resume` — SIGSTOP/SIGCONT (the zombie
      shape: the process keeps ALL state and its sockets, it just
      stops scheduling);
    - :meth:`stop_graceful` — SIGTERM; the processes drain, release
      the serving lease, and exit 0 (distinguishable from a crash);
    - :meth:`kill` — SIGKILL, the crash.

    The child gets standard streams of its own: stdin a pipe (closing it
    is :meth:`stop_eof`), stdout a pipe a daemon thread drains (the
    ready line, then nothing), stderr a temporary file (:meth:`stderr`),
    and ``OMP_NUM_THREADS=1``.
    """

    def __init__(self, argv: List[str], env: Optional[Dict] = None):
        self.argv = list(argv)
        self.env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
        self.proc: Optional[subprocess.Popen] = None
        self.ready: Dict = {}
        self._err = None
        self._pump: Optional[threading.Thread] = None

    def spawn(self, timeout_s: float = 60.0) -> Dict:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self._err = tempfile.TemporaryFile()
        lines: "queue.Queue[bytes]" = queue.Queue()
        self.proc = subprocess.Popen(
            [sys.executable, "-m"] + self.argv,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._err, env=self.env, cwd=root)
        proc = self.proc

        def pump() -> None:
            try:
                for raw in proc.stdout:
                    lines.put(raw)
            except (OSError, ValueError):
                pass
            lines.put(b"")

        self._pump = threading.Thread(target=pump, name="procactor-stdout",
                                      daemon=True)
        self._pump.start()
        try:
            line = lines.get(timeout=timeout_s).decode("utf-8", "replace")
        except queue.Empty:
            line = ""
        if not line.strip():
            self.close()
            raise RuntimeError(f"{self.argv[0]} died before ready (or "
                               f"gave no ready line within {timeout_s} s): "
                               f"{self.stderr()}")
        self.ready = json.loads(line)
        return self.ready

    @property
    def pid(self) -> int:
        return self.proc.pid

    def stderr(self, n: int = 4000) -> str:
        if self._err is None:
            return ""
        try:
            self._err.seek(0)
            return self._err.read().decode("utf-8", "replace")[-n:]
        except (OSError, ValueError):
            return ""

    def pause(self) -> None:
        os.kill(self.pid, signal.SIGSTOP)

    def resume(self) -> None:
        os.kill(self.pid, signal.SIGCONT)

    def stop_graceful(self, timeout_s: float = 20.0) -> int:
        """SIGTERM and reap; returns the exit code (0 = the drain/
        release path ran)."""
        self.proc.send_signal(signal.SIGTERM)
        return self.wait(timeout_s)

    def stop_eof(self, timeout_s: float = 20.0) -> int:
        """Close stdin (the launcher-pipe stop the drills use)."""
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        return self.wait(timeout_s)

    def kill(self) -> int:
        self.proc.kill()
        return self.wait(10.0)

    def wait(self, timeout_s: float) -> int:
        try:
            return self.proc.wait(timeout=timeout_s)
        finally:
            if self.proc.returncode is not None:
                self._release()

    def _release(self) -> None:
        if self._pump is not None:
            self._pump.join(timeout=5.0)
        for pipe in (self.proc.stdin, self.proc.stdout):
            try:
                if pipe is not None:
                    pipe.close()
            except OSError:
                pass

    def close(self) -> None:
        """Reap the child (SIGCONT first: a stopped process holds its
        SIGKILL until it runs), then release the pipes and the stderr
        file."""
        if self.proc is None:
            return
        if self.proc.returncode is None and self.proc.poll() is None:
            try:
                self.resume()
            except (OSError, ProcessLookupError):
                pass
            try:
                self.proc.kill()
                self.proc.wait(timeout=10.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
        self._release()
        if self._err is not None:
            try:
                self._err.close()
            except OSError:
                pass
