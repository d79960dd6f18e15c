"""FleetHarness: the chaos conductor's stage (counterpart of
``ratelimiter_tpu/chaos/harness.py``).

Boots the FULL stack in one process — ``cells`` cells, each a sharded
primary (``parallel/``: a ``GpuBatchedStorage`` over a
``ShardedDeviceEngine`` whose shards all live on the harness's device,
the card unless ``device="cpu"`` is asked for) behind a
``ShardFailoverRouter`` with an N+1
``ShardStandbySet``, per-shard replication, a ``FailoverOrchestrator``
on a simulated probe clock, and a ``ControllerSeat``; cell 0 adds the
lease tier (``LeaseManager`` + a strict leased client) and the edge
tier (``EdgeAggregator`` subleasing to two edge clients, upstream
either in-process or through a real TCP ``FaultInjectingProxy``) —
then executes a :class:`~ratelimiter_tpu_torch.chaos.plan.FaultPlan` step by
step, driving deterministic traffic between fault actions and running
the :class:`~ratelimiter_tpu_torch.chaos.monitor.InvariantMonitor` after
every step.

Determinism contract (what makes minimize/replay work):

- the decision clock is a shared simulated millisecond counter plus a
  per-cell skew offset (the ``clock_jump`` actor's target — the same
  injection surface ``storage/gpu.py`` exposes per process);
- traffic at step ``s`` is a pure function of ``(plan.seed, s)`` —
  removing actions from the schedule never shifts what traffic any
  surviving step carries, which is the property delta-debugging needs,
  and the same plan yields the same report on the card and on the CPU;
- the oracle mirror reproduces the storage stamp discipline exactly:
  each wave's expected stamp is ``max(serving_storage._last_stamp,
  cell_now)`` per serving storage (the backward clamp), and after
  every orchestrator tick all of a cell's storages are synced to the
  cell's stamp high-water mark so a promotion can never hand a key a
  stamp from the past.

In-process fictions, stated honestly: a "killed" shard is a probe that
answers False — replication is shipped at the kill and at every step
end, so the state a promotion restores is exactly what a real crash
with a drained wire leaves (the drills' discipline), and traffic the
doomed backend serves before the fence lands stays oracle-tracked.
Pause/resume is the zombie shape: on resume, if the shard's serving
backend was replaced mid-pause, the OLD backend is dispatched directly
and must raise ``FencedError`` — serving instead is the
``zombie-serving`` violation.  Real-subprocess kills/SIGSTOP live in
:class:`~ratelimiter_tpu_torch.chaos.actors.ProcActor` and the slow soak.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from ratelimiter_tpu_torch.chaos.actors import (
    Actors,
    GatedTransport,
    LeaseFaultGate,
)
from ratelimiter_tpu_torch.chaos.monitor import InvariantMonitor, InvariantViolation
from ratelimiter_tpu_torch.chaos.plan import FaultPlan
from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.leases import DirectTransport, LeaseClient, LeaseManager
from ratelimiter_tpu_torch.engine.routing import (
    shard_of_int_keys,
    shard_of_key,
)
from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine, make_devices
from ratelimiter_tpu_torch.replication import (
    FailoverOrchestrator,
    OrchestratorConfig,
    ShardedReplicationLog,
    ShardedReplicator,
    ShardFailoverRouter,
    ShardStandbySet,
)
from ratelimiter_tpu_torch.replication.control import ControllerSeat
from ratelimiter_tpu_torch.semantics.oracle import TokenBucketOracle
from ratelimiter_tpu_torch.storage.errors import FencedError, StorageException
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

_EPOCH_MS = 1_753_000_000_000


class _Cell:
    """One cell: sharded primary + router + standbys + replication +
    orchestrator + controller seat, all on the harness's clocks and its
    device."""

    def __init__(self, idx: int, topo: Dict, base: Dict,
                 skew: List[int], sim: Dict, device: str):
        self.idx = int(idx)
        self.topo = topo
        self.n_shards = int(topo["shards_per_cell"])
        slots = int(topo["slots_per_shard"])
        self.now = lambda: int(base["t"]) + int(skew[self.idx])
        devs = make_devices([device] * self.n_shards)
        self.engine = ShardedDeviceEngine(
            slots, LimiterTable(device=devs[0]), devices=devs)
        self.primary = GpuBatchedStorage(engine=self.engine,
                                         clock_ms=self.now)
        self.router = ShardFailoverRouter(self.primary)
        self.cfg_tb = RateLimitConfig(max_permits=25, window_ms=2000,
                                      refill_rate=8.0)
        self.lid_tb = self.primary.register_limiter("tb", self.cfg_tb)
        # Lease-tier lids (registered in every cell so topologies stay
        # congruent; only cell 0 runs lease/edge traffic).
        self.cfg_lease = RateLimitConfig(max_permits=1 << 14,
                                         window_ms=60_000,
                                         refill_rate=1000.0)
        self.lid_lease = self.primary.register_limiter(
            "tb", self.cfg_lease)
        self.lid_edge = self.primary.register_limiter(
            "tb", self.cfg_lease)

        def standby_factory():
            # One C index a standby: a shard's frames carry one index's
            # fingerprints.
            return GpuBatchedStorage(num_slots=slots, clock_ms=self.now,
                                     device=device, host_parallel=0)

        self.standby_factory = standby_factory
        self.mesh_set = ShardStandbySet(self.n_shards, standby_factory)
        self.repl = ShardedReplicator(
            ShardedReplicationLog(self.primary),
            self.mesh_set.in_process_sinks())
        # Per-shard fault flags the conductor's actors flip; the probe
        # reads them (a "down" shard answers False until ITS replacement
        # is installed, exactly the drills' dead-flag discipline).
        self.flags = [{"down": False, "paused": False,
                       "at_promotions": 0, "backend": None}
                      for _ in range(self.n_shards)]
        ocfg = OrchestratorConfig(
            probe_interval_ms=float(topo["probe_interval_ms"]),
            suspect_threshold=int(topo["suspect_threshold"]),
            hysteresis_ms=float(topo["hysteresis_ms"]),
            promote_backoff_ms=1.0)
        self.ocfg = ocfg

        def probe(q):
            f = self.flags[q]
            if f["down"] and self.orch.promotions == f["at_promotions"]:
                return False
            return True

        self.orch = FailoverOrchestrator(
            self.router, self.mesh_set, self.repl,
            standby_factory=standby_factory, config=ocfg, probe=probe,
            clock=lambda: sim["s"], sleep=lambda s: None)
        self.seat = ControllerSeat(clock=lambda: sim["s"])
        # Direct-path keyspace: ids 0..n_direct-1 are traffic, id
        # n_direct is the liveness probe's reserved key.
        n_direct = int(topo["n_direct_keys"])
        self.key_shard = shard_of_int_keys(
            np.arange(n_direct + 1, dtype=np.int64), self.n_shards)
        self.oracle = TokenBucketOracle(self.cfg_tb)

    def serving_backend(self, q: int):
        return self.router.replacements.get(int(q), self.primary)

    def blocked(self, q: int) -> bool:
        f = self.flags[int(q)]
        return bool(f["down"]
                    and self.orch.promotions == f["at_promotions"])

    def policy_generation(self) -> Optional[int]:
        try:
            return int(self.engine.table.row_generation(self.lid_lease))
        except Exception:  # noqa: BLE001 — optional introspection
            return None

    def sync_stamps(self) -> None:
        """Raise every storage in the cell to the cell's stamp
        high-water mark, so a promotion never serves a key a stamp
        older than one it already saw (the per-key monotonicity the
        oracle mirror depends on)."""
        storages = ([self.primary]
                    + list(self.router.replacements.values())
                    + list(self.mesh_set.storages))
        m = max(getattr(s, "_last_stamp", 0) for s in storages)
        for s in storages:
            if getattr(s, "_last_stamp", 0) < m:
                s._last_stamp = m

    def close(self) -> None:
        for closer in (self.orch.close, self.repl.stop,
                       self.router.close, self.mesh_set.close):
            try:
                closer()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


class DirectEdgeLink:
    """In-process edge link: faults collapse to an atomic cut of the
    gated upstream transport (delay has no in-process analogue and is
    only counted; garbage/flap desync a framed link, so both read as an
    outage until healed)."""

    def __init__(self, gate: GatedTransport):
        self.gate = gate
        self.faults = 0

    @property
    def healthy(self) -> bool:
        return not self.gate.cut

    def partition(self, direction: str = "both") -> None:
        self.faults += 1
        self.gate.cut = True

    def flap(self, period_s: float = 0.1) -> None:
        self.faults += 1
        self.gate.cut = True

    def garbage(self, n: int = 32) -> None:
        self.faults += 1
        self.gate.cut = True

    def delay(self, delay_ms: float = 2.0) -> None:
        self.faults += 1  # counted; zero in-process latency dimension

    def heal(self) -> None:
        self.gate.cut = False

    def close(self) -> None:
        self.gate.cut = False


class TcpEdgeLink:
    """Real-wire edge link: a ``FaultInjectingProxy`` between the
    aggregator's ``SidecarClient`` and a sidecar front for the core.
    ``heal`` reconnects the upstream client (a partitioned/garbaged
    stream is desynced for good — exactly like production)."""

    def __init__(self, proxy, agg, client_factory):
        self.proxy = proxy
        self.agg = agg
        self._client_factory = client_factory
        self.faults = 0
        self._cut = False

    @property
    def healthy(self) -> bool:
        return not self._cut

    def partition(self, direction: str = "both") -> None:
        self.faults += 1
        self._cut = True
        self.proxy.partition(direction)

    def flap(self, period_s: float = 0.1) -> None:
        self.faults += 1
        self._cut = True
        self.proxy.flap(float(period_s))

    def garbage(self, n: int = 32) -> None:
        self.faults += 1
        self._cut = True
        self.proxy.set_fault("garbage", n=int(n))

    def delay(self, delay_ms: float = 2.0) -> None:
        self.faults += 1
        self._cut = True
        self.proxy.set_fault("delay", delay_ms=float(delay_ms))

    def heal(self) -> None:
        self.proxy.heal()
        old, self.agg.upstream = self.agg.upstream, \
            self._client_factory()
        try:
            old.close()
        except Exception:  # noqa: BLE001 — old stream may be dead
            pass
        self._cut = False

    def close(self) -> None:
        try:
            self.agg.upstream.close()
        except Exception:  # noqa: BLE001
            pass
        self.proxy.stop()


class FleetHarness:
    """Execute one FaultPlan against a freshly-booted fleet on ``device``
    (None: the card)."""

    def __init__(self, plan: FaultPlan, device=None):
        self.plan = plan
        self.device = str(device) if device is not None else "cuda"
        self.topo = dict(plan.topology)
        self.base = {"t": _EPOCH_MS}
        self.sim = {"s": 0.0}
        self.skew = [0] * int(self.topo["cells"])
        self.cells = [_Cell(i, self.topo, self.base, self.skew,
                            self.sim, self.device)
                      for i in range(int(self.topo["cells"]))]
        c0 = self.cells[0]
        self.n_direct = int(self.topo["n_direct_keys"])
        # Lease tier (cell 0): manager behind the deterministic
        # storage-fault gate, one strict leased client.
        self.gate = LeaseFaultGate(c0.router)
        self.mgr = LeaseManager(
            self.gate,
            default_budget=int(self.topo["budget"]),
            max_budget=int(self.topo["budget"]),
            max_bulk_budget=int(self.topo["bulk_budget"]),
            ttl_ms=float(self.topo["lease_ttl_ms"]),
            record_ops=True, clock_ms=c0.now)
        self.cli_lease = LeaseClient(
            DirectTransport(self.mgr), c0.lid_lease,
            budget=int(self.topo["budget"]), clock_ms=c0.now,
            direct_fallback=False, telemetry=False)
        self.lease_keys = [f"lk-{i}"
                           for i in range(int(self.topo["n_lease_keys"]))]
        # Edge tier (cell 0): aggregator + two edge clients.
        self.edge_keys = [f"ek-{i}"
                          for i in range(int(self.topo["n_edge_keys"]))]
        self._tcp = None
        if self.topo.get("edge") == "tcp":
            self.edge_link, self.agg = self._build_tcp_edge(c0)
        else:
            gated = GatedTransport(DirectTransport(self.mgr))
            from ratelimiter_tpu_torch.edge.aggregator import EdgeAggregator

            self.agg = EdgeAggregator(
                gated, bulk_budget=int(self.topo["bulk_budget"]),
                slice_budget=int(self.topo["slice_budget"]),
                flush_ms=200.0, clock_ms=c0.now)
            self.edge_link = DirectEdgeLink(gated)
        self.edge_clients = [
            LeaseClient(self.agg.session(), c0.lid_edge,
                        budget=int(self.topo["slice_budget"]),
                        clock_ms=c0.now, direct_fallback=False,
                        telemetry=False)
            for _ in range(2)]
        self.monitor = InvariantMonitor(self)
        self.actors = Actors(self)
        self.pending_pool_leak = False
        self.zombies_fenced = 0
        # Per-step oracle tallies the monitor reads.
        self.step_decisions = 0
        self.step_mismatches = 0
        self.decisions_total = 0
        self.lease_admitted = 0
        self.edge_admitted = 0

    def _build_tcp_edge(self, c0):
        from ratelimiter_tpu_torch.edge.aggregator import EdgeAggregator
        from ratelimiter_tpu_torch.edge.edgeproc import LockedSidecarClient
        from ratelimiter_tpu_torch.service.sidecar import (
            SidecarClient,
            SidecarServer,
        )
        from ratelimiter_tpu_torch.storage.chaos import FaultInjectingProxy

        server = SidecarServer(c0.router, host="127.0.0.1", port=0,
                               drain_timeout_ms=200.0)
        server.expose(c0.lid_edge, "tb", c0.cfg_lease)
        server.attach_leases(self.mgr)
        server.start()
        proxy = FaultInjectingProxy(server.port,
                                    seed=int(self.plan.seed)).start()

        def client_factory():
            return LockedSidecarClient(
                SidecarClient("127.0.0.1", proxy.port, timeout=2.0))

        agg = EdgeAggregator(
            client_factory(),
            bulk_budget=int(self.topo["bulk_budget"]),
            slice_budget=int(self.topo["slice_budget"]),
            flush_ms=200.0, clock_ms=c0.now)
        link = TcpEdgeLink(proxy, agg, client_factory)
        self._tcp = server
        return link, agg

    # -- clocks ----------------------------------------------------------------
    def tick(self, n: int = 1) -> None:
        for _ in range(int(n)):
            self.sim["s"] += self.cells[0].ocfg.probe_interval_ms / 1000.0
            for c in self.cells:
                c.orch.tick()
        for c in self.cells:
            c.sync_stamps()

    # -- the zombie probe (called by the resume actor) -------------------------
    def zombie_probe(self, cell, shard: int, backend, step: int) -> None:
        if backend is None:
            return
        ids = [i for i in range(self.n_direct)
               if int(cell.key_shard[i]) == int(shard)][:8]
        if not ids:
            return
        try:
            backend.acquire_stream_ids(
                "tb", cell.lid_tb, np.asarray(ids, dtype=np.int64))
        except FencedError:
            self.zombies_fenced += 1
            return
        self.monitor.violation(
            "zombie-serving", step,
            f"cell {cell.idx} shard {shard}: paused-then-resumed "
            f"backend served direct dispatches after its keyspace was "
            f"promoted away (fence lease failed to stop the zombie)")

    # -- traffic ---------------------------------------------------------------
    def _direct_wave(self, c: _Cell, rng: random.Random,
                     step: int) -> None:
        ids = [rng.randrange(self.n_direct) for _ in range(24)]
        ids.append(self.n_direct)  # the liveness probe key
        blocked = {q for q in range(c.n_shards) if c.blocked(q)}
        use = [i for i in ids if int(c.key_shard[i]) not in blocked]
        if not use:
            return
        # Expected stamps mirror storage._stamp per SERVING storage:
        # max(last stamp, cell now) — the backward clamp, byte for byte.
        now = c.now()
        stamps: Dict[int, int] = {}
        for i in use:
            b = c.serving_backend(int(c.key_shard[i]))
            if id(b) not in stamps:
                stamps[id(b)] = max(getattr(b, "_last_stamp", 0), now)
        out = c.router.acquire_stream_ids(
            "tb", c.lid_tb, np.asarray(use, dtype=np.int64))
        live_served = None
        for i, got in zip(use, out):
            b = c.serving_backend(int(c.key_shard[i]))
            d = c.oracle.try_acquire(int(i), 1, stamps[id(b)])
            self.step_decisions += 1
            if bool(got) != d.allowed:
                self.step_mismatches += 1
            if i == self.n_direct:
                live_served = bool(got)
        if c.idx == 0 and live_served is not None:
            self.monitor.note_probe("direct", step, live_served, True)

    def _lease_traffic(self, c0: _Cell, rng: random.Random,
                       step: int) -> None:
        blocked = {q for q in range(c0.n_shards) if c0.blocked(q)}
        healthy = self.gate._forced == 0
        for key in self.lease_keys:
            if shard_of_key((c0.lid_lease, key), c0.n_shards) in blocked:
                continue
            for _ in range(rng.choice([1, 1, 2])):
                if self._guarded(step, self.cli_lease.try_acquire, key):
                    self.lease_admitted += 1
        live = "lk-live"
        if shard_of_key((c0.lid_lease, live), c0.n_shards) not in blocked:
            served = self._guarded(step, self.cli_lease.try_acquire,
                                   live)
            self.monitor.note_probe("lease", step, bool(served),
                                    healthy and not blocked)

    def _edge_traffic(self, c0: _Cell, rng: random.Random,
                      step: int) -> None:
        blocked = {q for q in range(c0.n_shards) if c0.blocked(q)}
        healthy = (self.edge_link.healthy and self.gate._forced == 0
                   and not blocked)
        for key in self.edge_keys:
            if shard_of_key((c0.lid_edge, key), c0.n_shards) in blocked:
                continue
            for cli in self.edge_clients:
                if self._guarded(step, cli.try_acquire, key):
                    self.edge_admitted += 1
        live = "ek-live"
        if shard_of_key((c0.lid_edge, live), c0.n_shards) not in blocked:
            served = self._guarded(step,
                                   self.edge_clients[0].try_acquire,
                                   live)
            self.monitor.note_probe("edge", step, bool(served), healthy)

    def _guarded(self, step: int, fn, *args) -> bool:
        """One client call under chaos: transport/storage faults read
        as a denial; a broken conservation assertion surfaces as the
        violation it is."""
        try:
            return bool(fn(*args))
        except AssertionError as e:
            self.monitor.violation("conservation", step, str(e))
        except (StorageException, OSError):
            return False
        return False

    # -- the run loop ----------------------------------------------------------
    def run(self) -> Dict:
        by_step = self.plan.by_step()
        report: Dict = {"violation": None, "steps_completed": 0,
                        "actions_applied": 0}
        try:
            for step in range(int(self.plan.steps)):
                for action in by_step.get(step, []):
                    self.actors.apply(action, step)
                self.step_decisions = 0
                self.step_mismatches = 0
                rng = random.Random(f"{self.plan.seed}:{step}")
                self.base["t"] += rng.choice([1, 7, 250, 999, 2000, 2001])
                for c in self.cells:
                    self._direct_wave(c, rng, step)
                self._lease_traffic(self.cells[0], rng, step)
                self._edge_traffic(self.cells[0], rng, step)
                if self.pending_pool_leak and self.agg._pools:
                    sorted(self.agg._pools.items())[0][1].remaining += 1
                    self.pending_pool_leak = False
                self.decisions_total += self.step_decisions
                for c in self.cells:
                    c.repl.ship_now()
                self.tick(2)
                self.monitor.check(step)
                report["steps_completed"] = step + 1
            self._finish(report)
        except InvariantViolation as v:
            report["violation"] = v.to_dict()
        finally:
            report["actions_applied"] = len(self.actors.applied)
            report.update(self._counters())
            self.close()
        return report

    # -- drain + reconciliation ------------------------------------------------
    def _finish(self, report: Dict) -> None:
        step = int(self.plan.steps)
        self.edge_link.heal()
        self.gate.heal()
        for c in self.cells:
            for q, f in enumerate(c.flags):
                if f.get("paused"):
                    promoted = (c.serving_backend(q)
                                is not f.get("backend"))
                    f["down"] = False
                    f["paused"] = False
                    if promoted:
                        self.zombie_probe(c, q, f.get("backend"), step)
        for _ in range(64):
            if not any(c.blocked(q) for c in self.cells
                       for q in range(c.n_shards)):
                break
            self.tick(1)
        for c in self.cells:
            c.repl.ship_now()
        self.tick(4)
        for cli in self.edge_clients:
            cli.release_all()
        self.agg.release_all()
        self.cli_lease.release_all()
        for c in self.cells:
            c.router.flush()
        # Advance the decision clock past every stamp any storage ever
        # issued, so the availability comparison below reads wall time
        # on both sides regardless of residual skew.
        hw = 0
        for c in self.cells:
            for s in ([c.primary]
                      + list(c.router.replacements.values())):
                hw = max(hw, getattr(s, "_last_stamp", 0))
        self.base["t"] = hw + 10_000 - min(0, min(self.skew))
        self._reconcile(step)

    def _reconcile(self, step: int) -> None:
        """Replay the manager's recorded reserve/credit stream into the
        oracle and demand bit-identity — grants AND final availability
        (the lease drill's Phase D, under the whole schedule's chaos)."""
        c0 = self.cells[0]
        oracle = TokenBucketOracle(c0.cfg_lease)
        for op in self.mgr.ops:
            if op[0] == "reserve":
                _, _algo, _lid, key, req, granted, ws, stamp = op
                g, w = oracle.reserve(key, req, stamp)
                if (g, w) != (granted, ws):
                    self.monitor.violation(
                        "oracle-divergence", step,
                        f"replayed lease reserve diverged for {key!r}: "
                        f"oracle ({g}, {w}) vs device "
                        f"({granted}, {ws})")
            else:
                _, _algo, _lid, key, unused, ws, stamp = op
                oracle.credit(key, unused, ws, stamp)
        now = c0.now()
        checks = [(c0.lid_lease, self.lease_keys + ["lk-live"]),
                  (c0.lid_edge, self.edge_keys + ["ek-live"])]
        for lid, keys in checks:
            for key in keys:
                got = int(c0.router.available_many("tb", lid, [key])[0])
                want = oracle.get_available_permits(key, now)
                if got != want:
                    self.monitor.violation(
                        "oracle-divergence", step,
                        f"final availability diverged for lid {lid} "
                        f"{key!r}: device {got} vs oracle {want}")

    def _counters(self) -> Dict:
        c0 = self.cells[0]
        return {
            "decisions": self.decisions_total,
            "lease_admitted": self.lease_admitted,
            "edge_admitted": self.edge_admitted,
            "zombies_fenced": self.zombies_fenced,
            "invariant_checks": self.monitor.checks_total,
            "promotions": [c.orch.promotions for c in self.cells],
            "fence_epochs": [c.orch.fence_epoch for c in self.cells],
            "seat_epochs": [c.seat.epoch for c in self.cells],
            "lease_status": self.mgr.status(),
            "edge_status": self.agg.status(),
            "forward_clamps": self.mgr.table.forward_clamps,
            "backward_clamps": sum(
                getattr(c.primary, "backward_clamps", 0)
                for c in self.cells),
            "storage_faults_injected": self.gate.injected,
            "edge_faults": self.edge_link.faults,
        }

    def close(self) -> None:
        for closer in ([self.edge_link.close]
                       + ([self._tcp.stop] if self._tcp else [])):
            try:
                closer()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for c in self.cells:
            c.close()


def run_plan(plan: FaultPlan, device=None) -> Dict:
    """Boot a fresh fleet on ``device`` (None: the card), run the plan,
    tear down.  The conductor's one-shot entry point — same plan in,
    same report out, on either device."""
    return FleetHarness(plan, device=device).run()
