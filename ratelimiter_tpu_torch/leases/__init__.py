"""Token leases: client-side enforcement with server reconciliation
(counterpart of ``ratelimiter_tpu/leases/``).

The server grants a client a bounded per-key permit budget (a *lease*)
charged atomically against the live device counters; the client burns
it locally at memory speed and renews one wire frame per budget instead
of one per decision — the 10-100x ingress collapse of "Rethinking HTTP
API Rate Limiting: A Client-Side Approach" (PAPERS.md).

Layers: ``ops/lease.py`` (the device RESERVE/CREDIT steps, specified
bit-for-bit by ``semantics/oracle.py:reserve/credit``), ``table.py``
(host lease accounting), ``manager.py`` (grant/renew/release/revoke,
fence-epoch revocation), ``client.py`` (the local burner, in process
over ``DirectTransport`` or remote over ``service/sidecar.py``'s
``SidecarClient``, wire v3 and up) and ``sublease.py`` (the edge
aggregator's slices).  The reference's chaos drill
``storage/chaos.py:lease_failover_drill`` is not in the port yet (it
needs sharded replication, ROADMAP A5 b).
"""

from ratelimiter_tpu_torch.leases.client import DirectTransport, LeaseClient
from ratelimiter_tpu_torch.leases.manager import LeaseGrant, LeaseManager
from ratelimiter_tpu_torch.leases.sublease import BulkPool, Sublease
from ratelimiter_tpu_torch.leases.table import Lease, LeaseTable

__all__ = [
    "BulkPool",
    "DirectTransport",
    "Lease",
    "LeaseClient",
    "LeaseGrant",
    "LeaseManager",
    "LeaseTable",
    "Sublease",
]
