"""Standalone edge aggregator process, runnable as
``python -m ratelimiter_tpu_torch.edge.edgeproc`` (counterpart of
``ratelimiter_tpu/edge/edgeproc.py``).

The process is the hierarchical tier's unit of deployment: it connects
ONE upstream ``SidecarClient`` (wire v6) to the core sidecar, wraps it
in an :class:`~ratelimiter_tpu_torch.edge.aggregator.EdgeAggregator`, and
opens a FRONT sidecar of its own that lease clients point at instead of
the core.  Lease ops terminate at the aggregator (each front connection
gets its own :class:`EdgeSession` — ``SidecarServer`` resolves the
per-connection session through the backend's ``.session()``), so a
sublease grant or renewal never crosses the upstream link; only the
periodic ``OP_BULK_RENEW`` portfolio flush does.  Plain decision ops
(TRY_ACQUIRE / AVAILABLE / RESET / PING) are proxied upstream
frame-for-frame through :class:`UpstreamProxyStorage` — the core's
device stays the only arbiter for traffic the aggregator holds no
budget for.

The process prints ONE JSON line on stdout when ready (front port, upstream address, lids) and exits
cleanly on stdin EOF **or SIGTERM** — the launcher (a drill, an init
system wrapper) owns its lifetime through the pipe, and a TERM gets
the same graceful teardown (final portfolio flush, bulk releases, exit
0), so a chaos conductor can tell a crash-kill (signal death, budget
abandoned upstream) from a graceful stop (exit 0, accounting settled).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


class LockedSidecarClient:
    """Serialize one ``SidecarClient`` across the front server's handler
    threads.  The client's request/response stream is strictly ordered,
    so concurrent callers would interleave frames and desync it; the
    lock makes every public call an atomic round trip."""

    def __init__(self, client):
        self._cli = client
        self._lock = threading.RLock()

    def __getattr__(self, name):
        target = getattr(self._cli, name)
        if not callable(target):
            return target
        lock = self._lock

        def call(*args, **kwargs):
            with lock:
                return target(*args, **kwargs)

        return call


class UpstreamProxyStorage:
    """Duck-typed storage for the front ``SidecarServer``: every
    decision op becomes one upstream frame on the shared client.  No
    async surface is offered (``acquire_async`` et al. absent), so the
    server rides its synchronous fallback path — identical answers,
    one-in one-out."""

    def __init__(self, client):
        self._cli = client

    def is_available(self) -> bool:
        try:
            return bool(self._cli.ping())
        except Exception:  # noqa: BLE001 — a dead upstream reads as down
            return False

    def acquire(self, algo: str, lid: int, key: str,
                permits: int = 1) -> dict:
        allowed = self._cli.try_acquire(int(lid), key, int(permits))
        return {"allowed": bool(allowed), "remaining": 0}

    def available_many(self, algo: str, lid: int, keys) -> list:
        return [int(self._cli.available(int(lid), k)) for k in keys]

    def reset_key(self, algo: str, lid: int, key: str) -> None:
        self._cli.reset(int(lid), key)


def build_edge(upstream_host: str, upstream_port: int, lids,
               *, host: str = "127.0.0.1", port: int = 0,
               bulk_budget: int = 4096, slice_budget: int = 64,
               flush_ms: float = 50.0, registry=None,
               upstream_timeout: float = 10.0):
    """Wire the aggregator tier: upstream client → aggregator → front
    sidecar.  Returns ``(server, aggregator, upstream_client)`` —
    shared by ``main`` and in-process callers.
    """
    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.edge.aggregator import EdgeAggregator
    from ratelimiter_tpu_torch.service.sidecar import (
        SidecarClient,
        SidecarServer,
    )

    upstream = LockedSidecarClient(
        SidecarClient(upstream_host, int(upstream_port),
                      timeout=upstream_timeout))
    if upstream.server_version < 6:
        raise RuntimeError(
            f"edgeproc needs a v6 core sidecar (bulk leases); upstream "
            f"negotiated v{upstream.server_version}")
    agg = EdgeAggregator(upstream, bulk_budget=bulk_budget,
                         slice_budget=slice_budget, flush_ms=flush_ms,
                         registry=registry)
    server = SidecarServer(UpstreamProxyStorage(upstream), host=host,
                           port=int(port), drain_timeout_ms=200.0)
    server.attach_leases(agg)
    # The front door answers for the CORE's limiter ids: the config here
    # is a placeholder for the registry lookup only — every decision is
    # proxied upstream, where the real policy lives.
    placeholder = RateLimitConfig(max_permits=1, window_ms=1000)
    for lid in lids:
        server.expose(int(lid), "tb", placeholder)
    server.start()
    return server, agg, upstream


# Graceful-shutdown latch: stdin EOF or SIGTERM, one teardown path, exit
# 0 either way.
_SHUTDOWN = threading.Event()


def _install_sigterm() -> None:
    try:
        signal.signal(signal.SIGTERM, lambda *_: _SHUTDOWN.set())
    except ValueError:  # not the main thread (in-process harnesses)
        pass


def _wait_for_eof() -> None:
    """Block until the launcher closes our stdin (its handle on our
    lifetime); also returns if stdin was never a pipe.  Raw-fd read:
    a buffered ``sys.stdin`` read holds the reader's lock, and a
    SIGTERM exit racing a daemon thread parked in it is a fatal
    ``_enter_buffered_busy`` abort at interpreter shutdown."""
    try:
        fd = sys.stdin.fileno()
        while os.read(fd, 4096):
            pass
    except (OSError, ValueError):
        time.sleep(3600.0)


def _wait_for_shutdown() -> None:
    """Block until stdin EOF or SIGTERM, whichever first (the EOF
    watch rides a daemon thread so TERM can interrupt a blocked pipe
    read)."""

    def eof_watch() -> None:
        _wait_for_eof()
        _SHUTDOWN.set()

    threading.Thread(target=eof_watch, name="eof-watch",
                     daemon=True).start()
    _SHUTDOWN.wait()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--upstream-host", default="127.0.0.1")
    parser.add_argument("--upstream-port", type=int, required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0,
                        help="front sidecar port (0 = ephemeral)")
    parser.add_argument("--lids", default="1",
                        help="comma-separated core limiter ids to front")
    parser.add_argument("--bulk-budget", type=int, default=4096)
    parser.add_argument("--slice-budget", type=int, default=64)
    parser.add_argument("--flush-ms", type=float, default=50.0)
    args = parser.parse_args(argv)
    _install_sigterm()

    lids = [int(x) for x in args.lids.split(",") if x.strip()]
    server, agg, upstream = build_edge(
        args.upstream_host, args.upstream_port, lids,
        host=args.host, port=args.port,
        bulk_budget=args.bulk_budget, slice_budget=args.slice_budget,
        flush_ms=args.flush_ms)
    print(json.dumps({
        "ready": True, "role": "edge", "port": server.port,
        "upstream": f"{args.upstream_host}:{args.upstream_port}",
        "lids": lids, "version": upstream.server_version,
    }), flush=True)
    _wait_for_shutdown()
    # Graceful: final portfolio flush + bulk releases BEFORE the front
    # door closes, so the core's accounting is settled.
    agg.release_all()
    server.stop()
    try:
        upstream.close()
    except Exception:  # noqa: BLE001 — teardown best-effort
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
