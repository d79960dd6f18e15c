"""Process-execution boundary for the fleet layer (counterpart of
``ratelimiter_tpu/fleet/executor.py``).

The :class:`~ratelimiter_tpu_torch.fleet.manager.NodeManager` never
touches ``subprocess`` directly; it talks to an EXECUTOR duck type::

    spawn(args, boot_timeout_s=None) -> (handle, ready: dict)
    alive(handle) -> bool
    terminate(handle, grace_s=...)   # graceful: stdin EOF first
    kill(handle)                     # hard kill (drills' primary kill)

so where a node runs (a local subprocess here; a container runtime or a
remote exec agent elsewhere) is swappable without touching lifecycle
logic.  :class:`LocalExecutor` is the subprocess implementation: it
launches ``python -m ratelimiter_tpu_torch.replication.hostproc --device
<device>`` (the card unless the caller asks for the CPU), reads the ONE
ready-JSON line off stdout under a boot deadline, and surfaces every
boot pathology as :class:`SpawnError` (timeout, early exit, malformed
line) instead of a hang.

A child gets standard streams of its own, as
``replication.hostproc.NodeProcess`` gives them: stdin a pipe (the
node's lifetime handle: hostproc exits on stdin EOF), stdout drained by
a thread after the ready line, stderr a temporary file (read back for
the launch-count line a node prints on its clean exit, and for the
diagnostics of a failed boot), ``OMP_NUM_THREADS=1``.  A child never
inherits the caller's stdin, stdout or stderr, so a test worker's own
channel stays its own.  Signals go to the child's own pid, never to a
process group.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("fleet.executor")

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class SpawnError(RuntimeError):
    """A node failed to boot: no ready line within the deadline, the
    process exited first, or the line was not a JSON object."""


class ProcessHandle:
    """The LocalExecutor's opaque handle: one node subprocess, its stdout
    pump and its stderr file."""

    def __init__(self, proc: subprocess.Popen, err, pump: threading.Thread,
                 lines: "queue.Queue[bytes]"):
        self.proc = proc
        self._err = err
        self._pump = pump
        self._lines = lines
        # Filled when the process is reaped: the launch counts a clean
        # exit printed (None after a kill) and the tail of its stderr.
        self.launch_counts: Optional[Dict[str, int]] = None
        self.stderr_text: Optional[str] = None

    @property
    def pid(self) -> int:
        return self.proc.pid

    def stderr_tail(self, n: int = 4000) -> str:
        if self.stderr_text is not None:
            return self.stderr_text[-n:]
        try:
            self._err.seek(0)
            return self._err.read().decode("utf-8", "replace")[-n:]
        except (OSError, ValueError):
            return ""

    def _release(self) -> None:
        """After the reap: keep the launch line and the stderr tail,
        close the pipes and the file, join the pump."""
        if self.stderr_text is None:
            try:
                self._err.seek(0)
                raw = self._err.read()
            except (OSError, ValueError):
                raw = b""
            for line in reversed(raw.splitlines()):
                if line.startswith(b'{"launches"'):
                    try:
                        self.launch_counts = json.loads(line)["launches"]
                    except (ValueError, KeyError):
                        pass
                    break
            self.stderr_text = raw.decode("utf-8", "replace")[-8000:]
        # The child is reaped, so its stdout reaches EOF and the pump
        # ends on its own; join it before closing what it reads.
        self._pump.join(timeout=5.0)
        for f in (self.proc.stdin, self.proc.stdout, self._err):
            try:
                if f is not None:
                    f.close()
            except (OSError, ValueError):
                pass

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"ProcessHandle(pid={self.proc.pid})"


class LocalExecutor:
    """Run nodes as local OS subprocesses.

    ``argv_prefix`` defaults to the hostproc module on ``device`` (the
    card unless ``"cpu"`` is asked for); tests override it (e.g.
    ``[sys.executable, "-c", ...]``) to exercise the boot-pathology paths
    without a real node.  ``env`` entries are added to the caller's
    environment.
    """

    def __init__(self, argv_prefix: Optional[List[str]] = None,
                 env: Optional[dict] = None,
                 boot_timeout_s: float = 180.0,
                 device: str = "cuda"):
        self.device = str(device)
        if argv_prefix is None:
            argv_prefix = [sys.executable, "-m", "ratelimiter_tpu_torch."
                           "replication.hostproc", "--device", self.device]
        self.argv_prefix = list(argv_prefix)
        self.env = dict(env or {})
        self.boot_timeout_s = float(boot_timeout_s)

    def spawn(self, args: List[str],
              boot_timeout_s: Optional[float] = None,
              ) -> Tuple[ProcessHandle, dict]:
        """Launch a node and block for its ready line; returns the
        lifetime handle plus the parsed ready JSON.  Raises
        :class:`SpawnError` on any boot pathology (the half-started
        process is killed and reaped first: no orphans)."""
        timeout = float(boot_timeout_s if boot_timeout_s is not None
                        else self.boot_timeout_s)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env.update(self.env)
        argv = self.argv_prefix + list(args)
        err = tempfile.TemporaryFile()
        lines: "queue.Queue[bytes]" = queue.Queue()
        proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=err,
                                cwd=_ROOT, env=env)

        def pump() -> None:
            try:
                for raw in proc.stdout:
                    lines.put(raw)
            except (OSError, ValueError):
                pass
            lines.put(b"")

        reader = threading.Thread(target=pump, name="node-stdout",
                                  daemon=True)
        reader.start()
        handle = ProcessHandle(proc, err, reader, lines)
        try:
            raw = lines.get(timeout=timeout)
        except queue.Empty:
            self.kill(handle)
            raise SpawnError(
                f"node {argv!r} printed no ready line within "
                f"{timeout:.1f}s; stderr: {handle.stderr_tail(2000)!r}")
        line = raw.decode("utf-8", "replace").strip()
        if not line:
            try:
                rc = proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                rc = proc.poll()
            self.kill(handle)
            raise SpawnError(
                f"node exited (rc={rc}) before printing a ready line; "
                f"stderr: {handle.stderr_tail(2000)!r}")
        try:
            ready = json.loads(line)
        except json.JSONDecodeError as exc:
            self.kill(handle)
            raise SpawnError(
                f"malformed ready line {line!r}: {exc}") from exc
        if not isinstance(ready, dict):
            self.kill(handle)
            raise SpawnError(f"ready line is not a JSON object: {line!r}")
        return handle, ready

    def alive(self, handle: ProcessHandle) -> bool:
        return handle.proc.poll() is None

    def terminate(self, handle: ProcessHandle,
                  grace_s: float = 10.0) -> None:
        """Graceful retirement: close stdin (hostproc's exit signal),
        wait out the grace period, then escalate SIGTERM -> SIGKILL, all
        to the child's own pid."""
        proc = handle.proc
        try:
            if proc.stdin is not None:
                proc.stdin.close()
        except OSError:
            pass
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            _log.warning("node pid=%d ignored stdin EOF for %.1fs; "
                         "terminating", proc.pid, grace_s)
            proc.terminate()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        handle._release()

    def kill(self, handle: ProcessHandle) -> None:
        """Hard kill (no stdin courtesy): SIGKILL the child's own pid and
        reap it."""
        proc = handle.proc
        if proc.poll() is None:
            proc.kill()
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:  # pragma: no cover — the kernel
            pass                           # owes us a reaped SIGKILL
        handle._release()
