"""Cross-host node process: shard primaries or standbys, runnable as
``python -m ratelimiter_tpu_torch.replication.hostproc`` (counterpart of
``ratelimiter_tpu/replication/hostproc.py``).

This is the process the multi-process topology is made of.  A node hosts
``--shards k`` independent flat shard storages (k=1 by default) on one
device, the card unless ``--device cpu`` is asked for; several nodes
share one card.  A PRIMARY node serves decisions over one sidecar per
shard (service/sidecar.py, optional token leases), ships each shard's
replication stream to its standby (``--repl-target``, comma-separated
for k>1), exposes ONE control port multiplexing every shard (PROBE /
PROBE_ALL / FENCE / LEASE / RESTORE / SHIP / RETARGET and the
controller ops), and runs the LEASE KEEPER per shard: when the
orchestrator's direct renewals stop arriving, the keeper fetches the
newest deposited grant from the standby's mailbox over the replication-
side link — so a primary partitioned only from the ORCHESTRATOR keeps
serving, while one partitioned from everything runs its lease down and
self-fences within one TTL.  A STANDBY node applies the replication
streams, answers the witness probe (``repl_rx_age_ms``), holds the
lease mailboxes, and serves the remote-promotion RPC — a successful
PROMOTE starts a sidecar over the now-serving storage and reports its
port for clients to re-point.

RETARGET points this shard's replication stream at a NEW standby's
listener — swap the sink under the existing replicator (primary), or
build one on a promoted storage that never had one (post-promotion
standby) — then forces a full re-baseline frame and ships it
synchronously.  An unpromoted standby refuses (re-seeding from a shadow
would fork the authority chain).

The process prints ONE JSON line on stdout when ready (ports, explicit
``lid_base``, ``version``, and shard count included; the same keys as
the reference's, so either package's ``parse_ready`` reads either node)
and writes nothing more there.  It exits cleanly on stdin EOF **or
SIGTERM** — the launcher owns its lifetime through the pipe — and on
that clean exit prints one JSON line to stderr with the kernel launch
counts of its run (``{"launches": {...}}``).  Exit code therefore
distinguishes a graceful stop (0) from a crash-kill (signal death).
Without a CUDA device and without ``--device cpu`` it raises and exits
non-zero: it never carries on on the CPU by itself.

``storage/chaos.py:cross_host_failover_drill`` spawns these as real OS
subprocesses with ``FaultInjectingProxy`` links between them.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import Callable, Dict, List, Optional


def _build_limiters(spec_json: str, shards: int) -> List[List[dict]]:
    """Parse ``--limiters``: a JSON list of limiter specs applied to
    EVERY shard, or a list of k lists for per-shard policies."""
    spec = json.loads(spec_json) if spec_json else []
    if not isinstance(spec, list):
        raise ValueError("--limiters must be a JSON list")
    if spec and all(isinstance(s, list) for s in spec):
        if len(spec) != shards:
            raise ValueError(
                f"--limiters gave {len(spec)} per-shard lists for "
                f"--shards {shards}")
        return spec
    return [list(spec) for _ in range(shards)]


def _split_targets(arg: str, shards: int) -> List[str]:
    """Split a comma-separated ``host:port`` list, one per shard
    (empty string = that shard ships nowhere)."""
    if not arg:
        return [""] * shards
    targets = [t.strip() for t in arg.split(",")]
    if len(targets) == 1 and shards > 1:
        raise ValueError(
            f"--repl-target gave 1 target for --shards {shards}; pass "
            f"a comma-separated list, one per shard")
    if len(targets) != shards:
        raise ValueError(
            f"--repl-target gave {len(targets)} targets for "
            f"--shards {shards}")
    return targets


def _make_lease_manager(storage, props: Optional[dict] = None):
    from ratelimiter_tpu_torch.leases import LeaseManager

    props = props or {}
    return LeaseManager(
        storage,
        default_budget=int(props.get("default_budget", 64)),
        max_budget=int(props.get("max_budget", 1024)),
        ttl_ms=float(props.get("ttl_ms", 2000.0)),
        deny_ttl_ms=float(props.get("deny_ttl_ms", 25.0)),
    )


def _make_storage(args):
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    return GpuBatchedStorage(num_slots=args.num_slots, max_delay_ms=0.2,
                             device=args.device)


class LeaseKeeper:
    """Primary-side relay fetcher: while a serving lease is installed,
    poll the standby's mailbox and apply any deposit that would EXTEND
    the local deadline (a stale deposit can only shorten it and is
    skipped — the lease still expires on the original schedule).

    Age accounting makes the relay skew-free: the deposit's ``age_ms``
    is measured on the STANDBY's clock between orchestrator deposit and
    our fetch, so the applied TTL is ``ttl - age - slack`` — always at
    or under what the orchestrator believes it granted, never past it.

    ``shard`` addresses the mailbox on a multiplexed standby control
    port (None keeps the bare op for raw single-shard handler tables).
    """

    def __init__(self, storage, standby_ctl, poll_ms: float = 100.0,
                 slack_ms: float = 25.0, shard: Optional[int] = None):
        self.storage = storage
        self.ctl = standby_ctl
        self.poll_ms = float(poll_ms)
        self.slack_ms = float(slack_ms)
        self.shard = shard
        self.fetches = 0
        self.applied = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="lease-keeper", daemon=True)

    def start(self) -> "LeaseKeeper":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_ms / 1000.0):
            try:
                self._poll_once()
            except Exception:  # noqa: BLE001 — the keeper never dies;
                # a broken relay just lets the lease run down (by design)
                pass

    def _poll_once(self) -> None:
        info = self.storage.serving_lease_info()
        if not info["installed"]:
            return  # no lease granted yet, or already expired/fenced
        kw = {} if self.shard is None else {"shard": int(self.shard)}
        resp = self.ctl.try_call("lease_fetch", **kw)
        self.fetches += 1
        if resp is None or not resp.get("ok") or not resp.get("deposited"):
            return
        effective = (float(resp["ttl_ms"]) - float(resp["age_ms"])
                     - self.slack_ms)
        if effective <= info["ttl_remaining_ms"]:
            return  # stale deposit: applying it would SHORTEN the lease
        try:
            self.storage.grant_serving_lease(int(resp["epoch"]), effective)
            self.applied += 1
        except ValueError:
            # Stale epoch or fenced storage: the deposit is from an old
            # generation (or we already self-fenced) — never resurrect.
            pass


def _shard_extras(storage, box: dict, args,
                  allowed: Optional[Callable[[], bool]] = None) -> Dict:
    """The per-shard ``ship`` + ``retarget`` ops, reading the shard's
    replicator through a mutable ``box`` so a replicator created or
    re-pointed AFTER the handler table was built is still the one the
    ops drive (a closure over the boot-time object would go stale the
    moment retarget runs)."""
    from ratelimiter_tpu_torch.replication.log import ReplicationLog
    from ratelimiter_tpu_torch.replication.replicator import Replicator
    from ratelimiter_tpu_torch.replication.transport import SocketSink

    def ship() -> dict:
        storage.flush()
        repl = box.get("replicator")
        shipped = repl.ship_now() if repl is not None else 0
        return {"frames": int(shipped)}

    def retarget(host: str, port: int,
                 interval_ms: Optional[float] = None) -> dict:
        if allowed is not None and not allowed():
            raise RuntimeError(
                "retarget refused: shard is an unpromoted standby "
                "(re-seeding from a shadow would fork authority)")
        interval = float(interval_ms if interval_ms is not None
                         else args.repl_interval_ms)
        sink = SocketSink(host, int(port), timeout=2.0, max_retries=1,
                          backoff_ms=20.0,
                          ack_timeout=args.ack_timeout_ms / 1000.0,
                          dead_after=2)
        repl = box.get("replicator")
        if repl is not None:
            # Sink swap under a stopped pipeline: stop() leaves the
            # replicator restartable, so the SAME object carries its
            # counters across the re-point and every handler that
            # captured it stays valid.
            repl.stop()
            try:
                repl.sink.close()
            except Exception:  # noqa: BLE001 — old link teardown
                pass
            repl.sink = sink
            repl.interval_ms = interval
        else:
            repl = Replicator(ReplicationLog(storage), sink,
                              interval_ms=interval)
            box["replicator"] = repl
        # The new peer has empty state: re-baseline with a full frame
        # and ship it synchronously so the caller's success means "the
        # new standby holds a consistent snapshot", not "queued".
        repl.log.request_full()
        repl.start()
        storage.flush()
        frames = repl.ship_now()
        return {"target": f"{host}:{int(port)}", "frames": int(frames)}

    return {"ship": ship, "retarget": retarget}


def _node_extras() -> Dict[str, Callable]:
    """Process-global control ops (both roles): ``skew`` sets the
    injected clock offset every default now-source in this process
    reads (storage/gpu.py), so a drill can step one NODE's clock
    mid-run without touching the others."""
    from ratelimiter_tpu_torch.storage.gpu import (
        clock_skew_ms,
        set_clock_skew_ms,
    )

    def skew(skew_ms: Optional[int] = None) -> dict:
        if skew_ms is None:
            return {"skew_ms": clock_skew_ms()}
        prev = set_clock_skew_ms(int(skew_ms))
        return {"skew_ms": int(skew_ms), "prev_ms": prev}

    return {"skew": skew}


def run_primary(args) -> int:
    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.replication.control import (
        ControlClient,
        ControlServer,
        mux_handlers,
        primary_handlers,
    )
    from ratelimiter_tpu_torch.replication.log import ReplicationLog
    from ratelimiter_tpu_torch.replication.replicator import Replicator
    from ratelimiter_tpu_torch.replication.transport import SocketSink
    from ratelimiter_tpu_torch.service.sidecar import SidecarServer

    specs = _build_limiters(args.limiters, args.shards)
    targets = _split_targets(args.repl_target, args.shards)
    standby_ctl = None
    if args.standby_control:
        host, _, port = args.standby_control.rpartition(":")
        standby_ctl = ControlClient(host or "127.0.0.1", int(port),
                                    timeout=0.5)

    per_shard: Dict[int, Dict] = {}
    storages, sidecars, boxes, keepers = [], [], [], []
    lids_per_shard: List[List[int]] = []
    for q in range(args.shards):
        storage = _make_storage(args)
        sidecar = SidecarServer(storage, host=args.host, port=0,
                                drain_timeout_ms=200.0)
        if args.lease:
            sidecar.attach_leases(_make_lease_manager(storage))
        lids = []
        for spec in specs[q]:
            spec = dict(spec)
            algo = spec.pop("algo")
            lids.append(sidecar.register(algo, RateLimitConfig(**spec)))
        sidecar.start()
        box: dict = {"replicator": None}
        if targets[q]:
            host, _, port = targets[q].rpartition(":")
            sink = SocketSink(host or "127.0.0.1", int(port), timeout=2.0,
                              max_retries=1, backoff_ms=20.0,
                              ack_timeout=args.ack_timeout_ms / 1000.0,
                              dead_after=2)
            box["replicator"] = Replicator(
                ReplicationLog(storage), sink,
                interval_ms=args.repl_interval_ms).start()
        if standby_ctl is not None:
            keepers.append(LeaseKeeper(
                storage, standby_ctl, poll_ms=args.keeper_poll_ms,
                shard=q).start())
        per_shard[q] = primary_handlers(
            storage, replicator=box["replicator"],
            extra=_shard_extras(storage, box, args))
        storages.append(storage)
        sidecars.append(sidecar)
        boxes.append(box)
        lids_per_shard.append(lids)

    control = ControlServer(mux_handlers(per_shard, extra=_node_extras()),
                            host=args.host).start()
    print(json.dumps(_ready_line(
        "primary", control, args,
        sidecar_ports=[s.port for s in sidecars],
        lids=lids_per_shard)), flush=True)
    _wait_for_shutdown()
    for keeper in keepers:
        keeper.stop()
    for box in boxes:
        if box["replicator"] is not None:
            box["replicator"].close()
    control.stop()
    for sidecar in sidecars:
        sidecar.stop()  # drains in-flight frames (drain_timeout_ms)
    for storage in storages:
        # Graceful hand-back: drop the serving lease BEFORE close so
        # the orchestrator reads "stopped on purpose", not a TTL runout.
        try:
            storage.release_serving_lease()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        storage.close()
    if standby_ctl is not None:
        standby_ctl.close()
    return 0


def run_standby(args) -> int:
    from ratelimiter_tpu_torch.replication.control import (
        ControlServer,
        LeaseMailbox,
        mux_handlers,
        standby_handlers,
    )
    from ratelimiter_tpu_torch.replication.standby import StandbyReceiver
    from ratelimiter_tpu_torch.replication.transport import (
        ReplicationServer,
    )
    from ratelimiter_tpu_torch.service.sidecar import SidecarServer

    per_shard: Dict[int, Dict] = {}
    storages, repl_servers, boxes = [], [], []
    promoted_sidecars: List[dict] = []
    for q in range(args.shards):
        storage = _make_storage(args)
        receiver = StandbyReceiver(storage)
        repl_server = ReplicationServer(receiver, host=args.host).start()
        promoted_sidecar: dict = {}

        def on_promote(storage=storage,
                       promoted_sidecar=promoted_sidecar) -> dict:
            # The shadow is now the serving primary for this shard's
            # keyspace: open the front door and expose every limiter the
            # replication stream registered (lids mean the same policies
            # as on the dead primary — StandbyReceiver verified that on
            # apply).
            sidecar = SidecarServer(storage, host=args.host, port=0,
                                    drain_timeout_ms=200.0)
            if args.lease:
                sidecar.attach_leases(_make_lease_manager(storage))
            for lid, (algo, cfg) in sorted(storage._configs.items()):
                sidecar.expose(lid, algo, cfg)
            sidecar.start()
            promoted_sidecar["server"] = sidecar
            return {"serve_port": sidecar.port}

        box: dict = {"replicator": None}
        per_shard[q] = standby_handlers(
            storage, receiver, repl_server=repl_server,
            mailbox=LeaseMailbox(), on_promote=on_promote,
            extra=_shard_extras(
                storage, box, args,
                allowed=lambda receiver=receiver: receiver.promoted))
        storages.append(storage)
        repl_servers.append(repl_server)
        boxes.append(box)
        promoted_sidecars.append(promoted_sidecar)

    control = ControlServer(mux_handlers(per_shard, extra=_node_extras()),
                            host=args.host).start()
    print(json.dumps(_ready_line(
        "standby", control, args,
        repl_ports=[s.port for s in repl_servers])), flush=True)
    _wait_for_shutdown()
    for box in boxes:
        if box["replicator"] is not None:
            box["replicator"].close()
    control.stop()
    for repl_server in repl_servers:
        repl_server.stop()
    for promoted_sidecar in promoted_sidecars:
        sidecar = promoted_sidecar.get("server")
        if sidecar is not None:
            sidecar.stop()
    for storage in storages:
        storage.close()
    return 0


def _ready_line(role: str, control, args,
                sidecar_ports: Optional[List[int]] = None,
                repl_ports: Optional[List[int]] = None,
                lids: Optional[List[List[int]]] = None) -> dict:
    """The one-line ready JSON.  ``lid_base`` is EXPLICIT (the smallest
    lid any shard registered) so launchers assert agreement instead of
    relying on the storage's lids-start-at-1 convention; k=1 keeps the
    scalar field names."""
    info = {"ready": True, "role": role, "control_port": control.port,
            "version": args.version, "shards": args.shards}
    if lids and any(lids):
        bases = sorted({min(ls) for ls in lids if ls})
        if len(bases) != 1:
            raise RuntimeError(f"shards disagree on lid base: {bases}")
        info["lid_base"] = bases[0]
    if args.shards == 1:
        if sidecar_ports:
            info["sidecar_port"] = sidecar_ports[0]
        if repl_ports:
            info["repl_port"] = repl_ports[0]
        if lids:
            info["lids"] = lids[0]
    else:
        if sidecar_ports:
            info["sidecar_ports"] = sidecar_ports
        if repl_ports:
            info["repl_ports"] = repl_ports
        if lids:
            info["lids"] = lids
    return info


class NodeProcess:
    """A node as a child process of the caller (a drill, a test, the
    on-card smoke script), launched so that it cannot disturb the
    caller's own standard streams:

    - its stdin is a pipe the caller holds (closing it is the graceful
      stop), its stdout a pipe a daemon thread drains (the ready line,
      then nothing), its stderr a temporary file (read back for the
      launch-count line and for diagnostics);
    - it runs with ``OMP_NUM_THREADS=1`` (``--device cpu`` also sets
      torch's own thread count to 1);
    - it is stopped by its own pid only: :meth:`stop` closes stdin and
      waits, :meth:`kill` sends SIGKILL to ``proc`` and reaps it.

    The constructor blocks until the ready line arrives or
    ``boot_timeout_s`` passes (then the child is killed and a
    RuntimeError carries the tail of its stderr)."""

    def __init__(self, args: List[str], device: str = "cuda",
                 boot_timeout_s: float = 180.0):
        import queue
        import subprocess
        import tempfile

        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.args = list(args)
        self._err = tempfile.TemporaryFile()
        self._lines: "queue.Queue[bytes]" = queue.Queue()
        t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ratelimiter_tpu_torch.replication."
             "hostproc", "--device", device, *self.args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._err, cwd=root,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        self._drain = threading.Thread(target=self._pump,
                                       name="hostproc-stdout", daemon=True)
        self._drain.start()
        try:
            line = self._lines.get(timeout=boot_timeout_s)
        except queue.Empty:
            line = b""
        if not line:
            self.kill()
            self.close()
            raise RuntimeError(
                f"hostproc {self.args} gave no ready line within "
                f"{boot_timeout_s} s; stderr: {self.stderr_tail()!r}")
        self.ready_s = time.monotonic() - t0
        self.info = json.loads(line)
        self.rc: Optional[int] = None

    def _pump(self) -> None:
        try:
            for raw in self.proc.stdout:
                self._lines.put(raw)
        except (OSError, ValueError):
            pass
        self._lines.put(b"")

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self, timeout_s: float = 30.0) -> int:
        """Graceful stop: close stdin, wait up to ``timeout_s``, then
        kill.  Returns the exit code (0 on a clean exit)."""
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.rc = self.proc.wait(timeout=timeout_s)
        except Exception:  # noqa: BLE001 — a hung child is killed
            self.kill()
        return self.rc

    def kill(self) -> int:
        """SIGKILL this child (its own pid) and reap it."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.rc = self.proc.wait(timeout=30.0)
        return self.rc

    def stderr_tail(self, n: int = 4000) -> str:
        self._err.seek(0)
        return self._err.read().decode("utf-8", "replace")[-n:]

    def launches(self) -> Optional[Dict[str, int]]:
        """The launch counts the node printed on its clean exit (None
        when it did not exit cleanly)."""
        self._err.seek(0)
        for raw in reversed(self._err.read().splitlines()):
            if raw.startswith(b'{"launches"'):
                return json.loads(raw)["launches"]
        return None

    def close(self) -> None:
        """Reap (graceful, then SIGKILL) and release the pipes."""
        if self.proc.poll() is None:
            self.stop(timeout_s=10.0)
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                f.close()
            except (OSError, ValueError):
                pass
        self._drain.join(timeout=5.0)


# Graceful-shutdown latch: set by stdin EOF (the launcher dropped its
# pipe) or SIGTERM (an init system / a drill's graceful stop).  Either
# way the caller runs the SAME ordered teardown and exits 0 — only an
# actual kill signal dies nonzero.
_SHUTDOWN = threading.Event()


def _install_sigterm() -> None:
    """Route SIGTERM into the shutdown latch.  Best-effort: signal
    handlers only install from the main thread (in-process tests that
    drive ``run_primary`` from a worker thread just skip this)."""
    try:
        signal.signal(signal.SIGTERM, lambda *_: _SHUTDOWN.set())
    except ValueError:
        pass


def _wait_for_eof() -> None:
    """Block until the launcher closes our stdin (its handle on our
    lifetime); also returns if stdin was never a pipe.  Reads the raw
    fd — a buffered ``sys.stdin`` read would hold the reader's lock
    across the block, and interpreter finalization aborts if a SIGTERM
    exit races a daemon thread parked inside it."""
    try:
        fd = sys.stdin.fileno()
        while os.read(fd, 4096):
            pass
    except (OSError, ValueError):
        time.sleep(3600.0)


def _wait_for_shutdown() -> None:
    """Block until stdin EOF or SIGTERM, whichever first.  The EOF
    watch runs on a daemon thread so a TERM can interrupt a blocked
    pipe read (PEP 475 would otherwise retry it forever)."""

    def eof_watch() -> None:
        _wait_for_eof()
        _SHUTDOWN.set()

    threading.Thread(target=eof_watch, name="eof-watch",
                     daemon=True).start()
    _SHUTDOWN.wait()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--role", choices=("primary", "standby"),
                        required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the node's storages live: the card "
                             "(default; raises without one) or, only "
                             "when asked, the CPU")
    parser.add_argument("--num-slots", type=int, default=512)
    parser.add_argument("--shards", type=int, default=1,
                        help="independent shard storages hosted by this "
                             "node behind ONE multiplexed control port")
    parser.add_argument("--version", default="v0",
                        help="deploy version tag echoed in the ready "
                             "line")
    parser.add_argument("--limiters", default="",
                        help="JSON list of limiter specs to register "
                             "(primary; algo + RateLimitConfig kwargs), "
                             "or a list of per-shard lists")
    parser.add_argument("--lease", action="store_true",
                        help="attach a token-lease manager to the "
                             "sidecar (v3 LEASE/RENEW/RELEASE)")
    parser.add_argument("--repl-target", default="",
                        help="host:port of the standby's replication "
                             "listener (primary; comma-separated, one "
                             "per shard, for --shards > 1)")
    parser.add_argument("--standby-control", default="",
                        help="host:port of the standby's CONTROL port "
                             "(primary; enables the lease-relay keeper)")
    parser.add_argument("--repl-interval-ms", type=float, default=100.0)
    # Generous by default: the standby's first frame apply may build the
    # row-scatter kernel on a fresh checkout, and an ack deadline under
    # that reads as a dead link.
    parser.add_argument("--ack-timeout-ms", type=float, default=5000.0)
    parser.add_argument("--keeper-poll-ms", type=float, default=100.0)
    args = parser.parse_args(argv)
    if args.shards < 1:
        parser.error("--shards must be >= 1")
    import torch

    if args.device == "cpu":
        torch.set_num_threads(1)
    elif not torch.cuda.is_available():
        raise RuntimeError(
            "hostproc runs its storages on a CUDA device and none is "
            "available; pass --device cpu to run on the CPU")
    _install_sigterm()
    rc = (run_primary if args.role == "primary" else run_standby)(args)
    from ratelimiter_tpu_torch.ops.cuda import launch_counts

    print(json.dumps({"launches": launch_counts()}), file=sys.stderr,
          flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
