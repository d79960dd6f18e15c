"""NodeManager: node lifecycle for a cross-host cell (counterpart of
``ratelimiter_tpu/fleet/manager.py``).

One NodeManager owns the port's ``hostproc`` node processes of a cell
(on the card unless its executor was built for the CPU).  It SPAWNS
them through the executor boundary (fleet/executor.py), ADOPTS ones
something else launched (a drill, an init system), probes every node
over the control RPC (replication/control.py) — one ``probe_all`` round trip per
NODE per tick, not per shard — and walks each through the lifecycle::

    SPAWNING -> READY -> SERVING -> DRAINING -> RETIRED
                  \\________________/     |
                          v               v
                        FAILED <----------+

- SPAWNING: exec'd, ready line not yet seen (transient inside
  ``spawn`` — a node that never leaves it raises ``SpawnError``).
- READY: booted and probing OK; a standby, or a primary not yet
  carrying traffic.
- SERVING: owns live keyspace (at least one shard routes here).
- DRAINING: scheduled for retirement; the drain-aware witness reads
  its shards "dead" so the orchestrator promotes away gracefully.
- RETIRED: terminal, clean exit (stdin EOF honored).
- FAILED: terminal, declared dead — probe-failure streak over the
  threshold or the process exited on its own.

The manager is the fleet actuator's data source (``GET /actuator/
fleet``) and the FleetAutopilot's substrate: attached autopilots are
driven from the same tick, so re-seed jobs advance on the probe
cadence with no extra threads.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

from ratelimiter_tpu_torch.fleet.executor import LocalExecutor
from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("fleet.manager")

SPAWNING = "SPAWNING"
READY = "READY"
SERVING = "SERVING"
DRAINING = "DRAINING"
RETIRED = "RETIRED"
FAILED = "FAILED"

# States a node can be probed in (terminal ones are left alone).
_LIVE = (READY, SERVING, DRAINING)


class Node:
    """One managed node: identity, lifecycle state, control handle."""

    __slots__ = ("name", "role", "version", "shards", "state", "handle",
                 "ctl", "host", "control_port", "ready", "lid_base",
                 "since", "since_wall_ms", "last_probe", "last_probe_at",
                 "probe_fail_streak", "last_error", "boot_s")

    def __init__(self, name: str, role: str, ready: dict, host: str,
                 ctl, handle=None, now: float = 0.0):
        self.name = name
        self.role = role
        self.version = str(ready.get("version", "v0"))
        self.shards = int(ready.get("shards", 1))
        self.state = READY
        self.handle = handle
        self.ctl = ctl
        self.host = host
        self.control_port = int(ready["control_port"])
        self.ready = dict(ready)
        self.lid_base = ready.get("lid_base")
        self.since = now
        self.since_wall_ms = time.time_ns() // 1_000_000
        self.last_probe: Dict[str, dict] = {}
        self.last_probe_at: Optional[float] = None
        self.probe_fail_streak = 0
        self.last_error: Optional[str] = None
        # Wall seconds from exec to the ready line (None when adopted).
        self.boot_s: Optional[float] = None

    def repl_ports(self) -> List[int]:
        if "repl_ports" in self.ready:
            return list(self.ready["repl_ports"])
        if "repl_port" in self.ready:
            return [int(self.ready["repl_port"])]
        return []

    def sidecar_ports(self) -> List[int]:
        if "sidecar_ports" in self.ready:
            return list(self.ready["sidecar_ports"])
        if "sidecar_port" in self.ready:
            return [int(self.ready["sidecar_port"])]
        return []


class NodeManager:
    """Spawn/adopt/probe/retire nodes; drive attached autopilots.

    ``clock`` and the control-client factory are injectable for
    deterministic tests; metrics land in the ``ratelimiter.fleet.*``
    family.
    """

    def __init__(self, executor=None, probe_interval_ms: float = 500.0,
                 probe_fail_threshold: int = 3,
                 probe_timeout_s: float = 1.0,
                 registry=None, recorder=None,
                 clock: Callable[[], float] = time.monotonic,
                 control_client_factory: Optional[Callable] = None):
        self.executor = executor if executor is not None else LocalExecutor()
        self.probe_interval_ms = float(probe_interval_ms)
        self.probe_fail_threshold = int(probe_fail_threshold)
        self.probe_timeout_s = float(probe_timeout_s)
        self._clock = clock
        if control_client_factory is None:
            from ratelimiter_tpu_torch.replication.control import ControlClient

            control_client_factory = ControlClient
        self._ctl_factory = control_client_factory
        self.nodes: Dict[str, Node] = {}
        self.respawns = 0
        self.reseeds = 0
        self.upgrade_steps = 0
        self._autopilots: List[object] = []
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if recorder is not None:
            self._recorder = recorder
        else:
            from ratelimiter_tpu_torch.observability import flight_recorder

            self._recorder = flight_recorder()
        if registry is not None:
            self._m_nodes = registry.gauge(
                "ratelimiter.fleet.nodes",
                "Live managed nodes (READY/SERVING/DRAINING)")
            self._m_respawns = registry.counter(
                "ratelimiter.fleet.respawns",
                "Replacement nodes spawned by the fleet autopilot "
                "(after a promotion consumed a standby, or a rolling-"
                "upgrade step)")
            self._m_reseeds = registry.counter(
                "ratelimiter.fleet.reseeds",
                "Automated cross-host re-seeds completed (fresh "
                "standby baselined and handed back — cell at N+1)")
            self._m_upgrades = registry.counter(
                "ratelimiter.fleet.upgrade_steps",
                "Rolling-upgrade node replacements completed")
        else:
            self._m_nodes = self._m_respawns = None
            self._m_reseeds = self._m_upgrades = None

    # -- membership ------------------------------------------------------------
    def spawn(self, name: str, role: str, *, version: str = "v0",
              shards: int = 1, host: str = "127.0.0.1",
              limiters: Optional[list] = None,
              repl_targets: Optional[List[str]] = None,
              standby_control: str = "", lease: bool = False,
              num_slots: int = 512, repl_interval_ms: float = 100.0,
              ack_timeout_ms: Optional[float] = None,
              boot_timeout_s: Optional[float] = None,
              extra_args: tuple = (), respawn: bool = False) -> Node:
        """Exec a hostproc node, wait out its boot, adopt it READY.

        ``respawn=True`` marks this spawn as a replacement (autopilot
        re-seed, upgrade step) for the ``fleet.respawns`` counter."""
        argv = ["--role", role, "--host", host,
                "--num-slots", str(int(num_slots)),
                "--shards", str(int(shards)), "--version", str(version),
                "--repl-interval-ms", str(float(repl_interval_ms))]
        if limiters:
            argv += ["--limiters", json.dumps(limiters)]
        if repl_targets:
            argv += ["--repl-target", ",".join(repl_targets)]
        if standby_control:
            argv += ["--standby-control", standby_control]
        if ack_timeout_ms is not None:
            argv += ["--ack-timeout-ms", str(float(ack_timeout_ms))]
        if lease:
            argv += ["--lease"]
        argv += list(extra_args)
        with self._lock:
            if name in self.nodes:
                raise ValueError(f"node {name!r} already managed")
        t0 = time.monotonic()
        handle, ready = self.executor.spawn(argv,
                                            boot_timeout_s=boot_timeout_s)
        boot_s = time.monotonic() - t0
        try:
            node = self.adopt(name, ready, handle=handle, host=host)
        except Exception:
            self.executor.terminate(handle, grace_s=2.0)
            raise
        node.boot_s = round(boot_s, 3)
        if respawn:
            self.respawns += 1
            if self._m_respawns is not None:
                self._m_respawns.increment()
        self._recorder.record("fleet.spawned", node=name, role=role,
                              version=str(version), respawn=bool(respawn))
        return node

    def adopt(self, name: str, ready: dict, handle=None,
              host: str = "127.0.0.1", ctl=None) -> Node:
        """Take ownership of an already-running node from its ready
        line.  Refuses a duplicate NAME and a duplicate control
        endpoint — adopting the same process twice would double-probe
        it and let two retire() calls race over one lifetime handle."""
        from ratelimiter_tpu_torch.replication.remote import parse_ready

        info = parse_ready(dict(ready))
        with self._lock:
            if name in self.nodes:
                raise ValueError(f"node {name!r} already managed")
            port = int(info["control_port"])
            for other in self.nodes.values():
                if other.state in _LIVE and other.host == host \
                        and other.control_port == port:
                    raise ValueError(
                        f"control endpoint {host}:{port} already "
                        f"managed as node {other.name!r} — refusing "
                        f"double-adopt")
            if ctl is None:
                ctl = self._ctl_factory(host, port,
                                        timeout=self.probe_timeout_s)
            node = Node(name, info["role"], info, host, ctl,
                        handle=handle, now=self._clock())
            self.nodes[name] = node
        self._export()
        return node

    def node(self, name: str) -> Node:
        with self._lock:
            return self.nodes[name]

    # -- lifecycle transitions -------------------------------------------------
    def _transition(self, node: Node, to: str, **fields) -> None:
        if node.state == to:
            return
        self._recorder.record("fleet.transition", node=node.name,
                              **{"from": node.state, "to": to}, **fields)
        _log.info("fleet node %s: %s -> %s %s", node.name, node.state,
                  to, fields or "")
        node.state = to
        node.since = self._clock()
        node.since_wall_ms = time.time_ns() // 1_000_000

    def mark_serving(self, name: str) -> None:
        with self._lock:
            node = self.nodes[name]
            if node.state not in (READY, SERVING):
                raise ValueError(
                    f"node {name!r} is {node.state}, cannot serve")
            self._transition(node, SERVING)

    def mark_draining(self, name: str) -> None:
        with self._lock:
            node = self.nodes[name]
            if node.state not in (READY, SERVING, DRAINING):
                raise ValueError(
                    f"node {name!r} is {node.state}, cannot drain")
            self._transition(node, DRAINING)

    def retire(self, name: str, grace_s: float = 10.0) -> None:
        """Graceful exit: DRAIN (if not already), stdin-EOF terminate
        through the executor, then RETIRED."""
        with self._lock:
            node = self.nodes[name]
            if node.state in (RETIRED, FAILED):
                return
            self._transition(node, DRAINING)
        if node.handle is not None:
            self.executor.terminate(node.handle, grace_s=grace_s)
        with self._lock:
            self._transition(node, RETIRED)
            self._close_ctl(node)
        self._export()

    def fail(self, name: str, error: str = "declared failed") -> None:
        with self._lock:
            node = self.nodes[name]
            self._fail(node, error)

    def kill(self, name: str) -> None:
        """Hard-kill a node we hold the handle for (chaos drills' mid-
        upgrade primary kill) and mark it FAILED immediately."""
        with self._lock:
            node = self.nodes[name]
        if node.handle is not None:
            self.executor.kill(node.handle)
        with self._lock:
            if node.state not in (RETIRED, FAILED):
                self._fail(node, "killed")

    def _fail(self, node: Node, error: str) -> None:
        node.last_error = error
        self._transition(node, FAILED, error=error)
        self._close_ctl(node)
        self._export()

    def _close_ctl(self, node: Node) -> None:
        try:
            node.ctl.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass

    # -- probe loop ------------------------------------------------------------
    def tick(self) -> None:
        """One probe round over every live node (one ``probe_all`` RPC
        per node — mux_handlers answers every shard in a single round
        trip; a pre-fleet single-shard node falls back to bare
        ``probe``), then drive attached autopilots."""
        with self._lock:
            nodes = list(self.nodes.values())
        for node in nodes:
            if node.state not in _LIVE:
                continue
            if node.handle is not None \
                    and not self.executor.alive(node.handle):
                with self._lock:
                    if node.state in _LIVE:
                        self._fail(node, "process exited")
                continue
            shards = self._probe(node)
            if shards is None:
                node.probe_fail_streak += 1
                if node.probe_fail_streak >= self.probe_fail_threshold:
                    with self._lock:
                        if node.state in _LIVE:
                            self._fail(node,
                                       f"{node.probe_fail_streak} "
                                       f"consecutive probe failures")
            else:
                node.probe_fail_streak = 0
                node.last_probe = shards
                node.last_probe_at = self._clock()
        self._export()
        for autopilot in list(self._autopilots):
            try:
                autopilot.tick()
            except Exception as exc:  # noqa: BLE001 — the probe loop
                # outlives a wedged re-seed job
                _log.warning("fleet autopilot tick failed: %s", exc)

    def _probe(self, node: Node) -> Optional[Dict[str, dict]]:
        resp = node.ctl.try_call("probe_all",
                                 timeout=self.probe_timeout_s)
        if resp is not None and resp.get("ok"):
            return dict(resp.get("shards", {}))
        resp = node.ctl.try_call("probe", timeout=self.probe_timeout_s)
        if resp is not None and resp.get("ok"):
            return {"0": dict(resp, ok=True)}
        return None

    # -- autopilot + counters --------------------------------------------------
    def attach(self, autopilot) -> None:
        """Drive ``autopilot.tick()`` from this manager's probe tick.
        Anything with ``tick()`` (+ optional ``status()``) rides the
        cadence: FleetAutopilot re-seed jobs, NodeLifecycle plans, and
        the ControllerElection (control/fleet.py) — so controller
        leader death is detected and repaired on the SAME tick that
        notices the node died, with no extra threads."""
        self._autopilots.append(autopilot)

    def note_reseed(self) -> None:
        self.reseeds += 1
        if self._m_reseeds is not None:
            self._m_reseeds.increment()

    def note_upgrade_step(self) -> None:
        self.upgrade_steps += 1
        if self._m_upgrades is not None:
            self._m_upgrades.increment()

    # -- observability ---------------------------------------------------------
    def live_nodes(self) -> List[str]:
        with self._lock:
            return sorted(n.name for n in self.nodes.values()
                          if n.state in _LIVE)

    def degraded_nodes(self) -> List[str]:
        """Nodes the health state machine folds to DEGRADED: FAILED
        (declared dead, keyspace moved or moving) and DRAINING
        (scheduled out — capacity leaving)."""
        with self._lock:
            return sorted(n.name for n in self.nodes.values()
                          if n.state in (FAILED, DRAINING))

    def status(self) -> dict:
        now = self._clock()
        with self._lock:
            nodes = {
                n.name: {
                    "role": n.role,
                    "state": n.state,
                    "version": n.version,
                    "shards": n.shards,
                    "host": n.host,
                    "control_port": n.control_port,
                    "lid_base": n.lid_base,
                    "pid": (n.handle.pid if n.handle is not None
                            and hasattr(n.handle, "pid") else None),
                    "since_ms": n.since_wall_ms,
                    "in_state_ms": round((now - n.since) * 1000.0, 3),
                    "probe_age_ms": (
                        None if n.last_probe_at is None
                        else round((now - n.last_probe_at) * 1000.0, 3)),
                    "probe_fail_streak": n.probe_fail_streak,
                    "last_error": n.last_error,
                }
                for n in self.nodes.values()
            }
        out = {"nodes": nodes, "respawns": self.respawns,
               "reseeds": self.reseeds,
               "upgrade_steps": self.upgrade_steps}
        jobs = []
        for autopilot in self._autopilots:
            status = getattr(autopilot, "status", None)
            if status is not None:
                jobs.append(status())
        if jobs:
            out["autopilot"] = jobs
        return out

    def _export(self) -> None:
        if self._m_nodes is not None:
            with self._lock:
                live = sum(1 for n in self.nodes.values()
                           if n.state in _LIVE)
            self._m_nodes.set(float(live))

    # -- cadence ---------------------------------------------------------------
    def start(self) -> "NodeManager":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="fleet-manager", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.probe_interval_ms / 1000.0):
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — loop survives
                _log.warning("fleet tick failed: %s", exc)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._stop.clear()

    def close(self, terminate: bool = True) -> None:
        """Stop the cadence and (by default) retire every node this
        manager spawned — their stdin pipes die with us anyway; an
        explicit EOF beats an orphan hunting for a closed pipe."""
        self.stop()
        with self._lock:
            nodes = list(self.nodes.values())
        for node in nodes:
            if terminate and node.handle is not None \
                    and node.state in _LIVE:
                try:
                    self.executor.terminate(node.handle, grace_s=5.0)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
                with self._lock:
                    self._transition(node, RETIRED)
            self._close_ctl(node)
        self._export()
