"""Multi-host key routing (counterpart of
``ratelimiter_tpu/parallel/multihost.py``).

Scaling past one host follows the rule of scaling past one card
(``parallel/sharded.py``): pin keys, don't coordinate.  Each host process
owns the shards of its local cards; a stateless router in front of them
(or in every client) maps a key to its owning host by a deterministic
hash, so the hot path never crosses hosts, as Redis Cluster clients route
hash slots.

``HostRouter`` is that mapping plus the connections to the hosts'
decision sidecars (``service/sidecar.py``): give it the host:port list of
the fleet's sidecars and call it like a limiter.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from ratelimiter_tpu_torch.service.sidecar import SidecarClient, SidecarSendError


def host_of_key(key: str, n_hosts: int) -> int:
    """Deterministic key -> host hash.

    Uses another stream than ``engine/routing.py:shard_of_key`` (the
    card tier), so the two tiers stripe independently.
    """
    return zlib.crc32(b"host:" + key.encode()) % n_hosts


class HostRouter:
    """Routes decisions to the owning host's sidecar.

    Failure semantics: a DOWN endpoint surfaces its ``ConnectionError`` /
    ``OSError`` to the caller immediately (nothing broken is cached — the
    next call attempts a fresh connection, so recovery is automatic).  A
    STALE connection (owner restarted since the last call) is dropped and
    retried once against a fresh connection before the error surfaces,
    which makes host restarts invisible to callers as long as the endpoint
    is back up.  No cross-host failover exists by design: keys are pinned
    to their owner's state, and deciding a key on a different host would
    silently hand it a fresh quota (the same reason Redis Cluster clients
    don't fail over hash slots to arbitrary nodes).
    """

    def __init__(self, endpoints: Sequence[Tuple[str, int]]):
        if not endpoints:
            raise ValueError("at least one endpoint required")
        self._endpoints = list(endpoints)
        self._clients: Dict[int, SidecarClient] = {}
        self._lock = threading.Lock()

    def _client(self, host_idx: int) -> SidecarClient:
        with self._lock:
            client = self._clients.get(host_idx)
        if client is not None:
            return client
        # Connect OUTSIDE the lock: a blackholed endpoint's connect timeout
        # must not head-of-line-block traffic to healthy hosts.
        host, port = self._endpoints[host_idx]
        fresh = SidecarClient(host, port)
        with self._lock:
            current = self._clients.get(host_idx)
            if current is None:
                self._clients[host_idx] = fresh
                return fresh
        fresh.close()  # lost a benign connect race; use the winner
        return current

    def _drop(self, host_idx: int, client: SidecarClient) -> None:
        with self._lock:
            if self._clients.get(host_idx) is client:
                del self._clients[host_idx]
        try:
            client.close()
        except OSError:
            pass

    def _call(self, host_idx: int, op, replay_safe: bool = True):
        """Run ``op(client)``; on a dead connection drop it and (when safe)
        retry once against a fresh one.

        ``replay_safe=False`` (the batch path) limits the retry to
        SEND-phase failures — the server cannot have processed a request
        whose frames never arrived, whereas replaying after a READ-phase
        failure could double-charge every key of a batch the server
        already decided.  Single-key ops replay unconditionally (reference
        parity with the per-op Redis retry; blast radius one permit).
        """
        client = self._client(host_idx)
        try:
            return op(client)
        except (ConnectionError, OSError) as exc:
            self._drop(host_idx, client)
            if not replay_safe and not isinstance(exc, SidecarSendError):
                raise
            client = self._client(host_idx)  # raises if the host is down
            try:
                return op(client)
            except (ConnectionError, OSError):
                self._drop(host_idx, client)
                raise

    def try_acquire(self, lid: int, key: str, permits: int = 1) -> bool:
        return self._call(host_of_key(key, len(self._endpoints)),
                          lambda c: c.try_acquire(lid, key, permits))

    def acquire_batch(self, lid: int, keys: Sequence[str],
                      permits: Optional[Sequence[int]] = None) -> List[bool]:
        """Split a batch by owning host, pipeline each sub-batch, reassemble."""
        permits = list(permits) if permits is not None else [1] * len(keys)
        n = len(self._endpoints)
        per_host: Dict[int, List[int]] = {}
        for i, key in enumerate(keys):
            per_host.setdefault(host_of_key(key, n), []).append(i)
        out: List[bool] = [False] * len(keys)
        for host_idx, positions in per_host.items():
            res = self._call(host_idx, lambda c, p=positions: c.acquire_batch(
                lid, [keys[i] for i in p], [permits[i] for i in p]),
                replay_safe=False)
            for pos, (_status, allowed, _rem) in zip(positions, res):
                out[pos] = allowed
        return out

    def available(self, lid: int, key: str) -> int:
        return self._call(host_of_key(key, len(self._endpoints)),
                          lambda c: c.available(lid, key))

    def reset(self, lid: int, key: str) -> None:
        self._call(host_of_key(key, len(self._endpoints)),
                   lambda c: c.reset(lid, key))

    def close(self) -> None:
        with self._lock:
            for client in self._clients.values():
                client.close()
            self._clients.clear()
