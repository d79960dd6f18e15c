"""Edge aggregator tier (ARCHITECTURE §14b): hierarchical token leases
(counterpart of ``ratelimiter_tpu/edge/``: the in-process aggregator, and
the standalone process ``python -m ratelimiter_tpu_torch.edge.edgeproc``
in front of a sidecar).

An :class:`EdgeAggregator` sits between a fleet of lease clients and
the core sidecar.  It takes one BULK lease per hot ``(lid, key)`` from
the core (leases/manager.py, ``bulk=True``) and subleases slices to its
clients at memory speed, renewing its whole portfolio in one columnar
``OP_BULK_RENEW`` frame (wire v6) per flush interval — so ingress
collapses multiplicatively on top of the per-client lease collapse, and
failover cost drops from O(clients) to O(affected aggregators): the
core's scoped fence epoch revokes only the bulk leases whose keys route
to a promoted shard, and survivors keep their slices.
"""

from ratelimiter_tpu_torch.edge.aggregator import EdgeAggregator, EdgeSession

__all__ = ["EdgeAggregator", "EdgeSession"]
