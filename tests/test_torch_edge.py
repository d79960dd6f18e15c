"""The in-process edge aggregator tier, port against the JAX package
(``edge/aggregator.py``, ``leases/sublease.py``, and the wiring's
``ratelimiter.edge.*`` with ``/actuator/edge``): the in-process cases of
``tests/test_edge.py``, each run on both packages.

- ``BulkPool`` conservation on random slice / burn / return / lost /
  over-report / renewal schedules: both packages' pools take the same
  schedule and must hold the same fields after every step.
- The aggregator over ``LeaseManager`` over ``DirectTransport``, on
  ``GpuBatchedStorage(device="cpu")`` and ``TpuBatchedStorage`` (the same
  explicit ``host_parallel``, 0 and 4, one manual clock): frame collapse
  and reconciliation, the nested over-admission bound, session isolation
  and the stale-epoch bulk row.  Every decision, the aggregator's and the
  manager's ``status()`` and ``manager.ops`` must be equal.  Fence-epoch
  advances go through the thin double of ``tests/test_torch_leases.py``
  (the storage's own fences are ROADMAP A6).
- The wiring: the edge stays off without leases; with both on, edge
  sessions serve and ``/actuator/edge`` answers as the reference's app.

The reference's wire cases (sidecar v6, ``edgeproc``) are in
``tests/test_torch_edgeproc.py``.
"""

import dataclasses
import http.client
import json
import random
import threading
import types

import pytest
import torch

from ratelimiter_tpu import edge as ref_edge
from ratelimiter_tpu import leases as ref_leases
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.leases import sublease as ref_sublease
from ratelimiter_tpu.service import app as ref_app
from ratelimiter_tpu.service.props import AppProperties as RefProps
from ratelimiter_tpu.service.wiring import build_app as ref_build_app
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch import edge, leases
from ratelimiter_tpu_torch.leases import sublease
from ratelimiter_tpu_torch.service import app as port_app
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.service.wiring import build_app
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from test_torch_leases import Fenced
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_753_000_000_000
HOST_PARALLEL = [0, 4]


# ---------------------------------------------------------------------------
# BulkPool conservation
# ---------------------------------------------------------------------------

def _fresh_pools(budget):
    return [mod.BulkPool(lid=1, key="k", budget=budget, remaining=budget,
                         epoch=0, deadline_ms=10_000, granted_total=budget)
            for mod in (ref_sublease, sublease)]


def _same(pools):
    ref, port = (dataclasses.asdict(p) for p in pools)
    assert port == ref
    for pool in pools:
        pool.check_conservation()
        assert pool.outstanding() <= pool.budget + pool.deficit
        assert pool.remaining >= 0 and pool.sliced_out >= 0
        assert pool.used_pending >= 0 and pool.deficit >= 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bulk_pool_conservation_random_schedule(seed):
    """Any interleaving of slice / burn report / return / lost holder /
    over-report / top-up / renewal keeps every permit in one bucket, and
    both packages' pools agree field for field after every step."""
    rng = random.Random(seed)
    budget = 200
    pools = _fresh_pools(budget)
    for _ in range(400):
        op = rng.choice(["slice", "burn", "ret", "lost", "over", "renew",
                         "topup"])
        sid = rng.randrange(6)
        subs = [p.subs.get(sid) for p in pools]
        has = subs[1] is not None
        if op == "slice":
            amt = rng.randrange(1, 40)
            for p in pools:
                p.slice(sid, amt)
        elif op == "burn" and has:
            # Sometimes over-reports past the slice: folds conservatively.
            used = rng.randrange(0, subs[1].amount + 3)
            assert len({p.fold_used(s, used)
                        for p, s in zip(pools, subs)}) == 1
        elif op == "ret" and has:
            assert len({p.return_unused(s) for p, s in zip(pools, subs)}) \
                == 1
        elif op == "lost" and has:
            for p, s in zip(pools, subs):
                p.fold_lost(s)
                p.drop_sub(sid)
        elif op == "over":
            used = rng.randrange(0, 10)
            for p in pools:
                p.fold_over_report(used)
        elif op == "topup" and has and subs[1].amount == 0:
            amt = rng.randrange(1, 40)
            assert len({p.top_up(s, amt) for p, s in zip(pools, subs)}) == 1
        elif op == "renew":
            # A renewal may shrink below what is sliced out: the gap
            # becomes deficit, never free permits.
            granted = rng.randrange(0, budget + 1)
            now = rng.randrange(0, 5000)
            for p in pools:
                p.apply_renewal(granted, 1000, p.epoch, now, p.used_pending)
        _same(pools)
    for p in pools:
        for sid in list(p.subs):
            p.fold_lost(p.subs[sid])
            p.drop_sub(sid)
    _same(pools)
    assert pools[1].sliced_out == 0


def test_bulk_pool_shrinking_renewal_builds_then_pays_deficit():
    pools = _fresh_pools(100)
    subs = [p.slice(1, 60) for p in pools]
    assert [s.amount for s in subs] == [60, 60]
    # The core re-grants only 20 while 60 are in the client's hands.
    for p in pools:
        p.apply_renewal(20, 1000, 0, 0, 0)
    _same(pools)
    assert pools[1].deficit == 40 and pools[1].remaining == 0
    # Returns pay the deficit down before anything re-enters remaining.
    for p, s in zip(pools, subs):
        p.return_unused(s)
    _same(pools)
    assert pools[1].deficit == 0 and pools[1].remaining == 20


# ---------------------------------------------------------------------------
# The aggregator over a live core
# ---------------------------------------------------------------------------

def _package(port: bool):
    lz, eg = (leases, edge) if port else (ref_leases, ref_edge)

    def stack(clock, host_parallel, *, bulk_budget=96, slice_budget=12,
              flush_ms=50.0, max_permits=100_000):
        """Storage (behind the fence double) + manager + one aggregator
        over a DirectTransport."""
        kw = dict(num_slots=1024, clock_ms=lambda: clock["t"],
                  host_parallel=host_parallel)
        raw = (GpuBatchedStorage(device="cpu", **kw) if port
               else TpuBatchedStorage(**kw))
        cfg = dict(max_permits=max_permits, window_ms=60_000,
                   refill_rate=float(max_permits) / 10.0)
        lid = raw.register_limiter(
            "tb", (RateLimitConfig if port else RefConfig)(**cfg))
        st = Fenced(raw)
        mgr = lz.LeaseManager(st, default_budget=slice_budget,
                              max_budget=slice_budget,
                              max_bulk_budget=bulk_budget, ttl_ms=10_000.0,
                              record_ops=True, clock_ms=lambda: clock["t"])
        agg = eg.EdgeAggregator(lz.DirectTransport(mgr),
                                bulk_budget=bulk_budget,
                                slice_budget=slice_budget, flush_ms=flush_ms,
                                clock_ms=lambda: clock["t"])
        return types.SimpleNamespace(raw=raw, st=st, lid=lid, mgr=mgr,
                                     agg=agg)

    def client(s, clock, budget):
        return lz.LeaseClient(s.agg.session(), s.lid, budget=budget,
                              clock_ms=lambda: clock["t"],
                              direct_fallback=False, telemetry=False)

    return types.SimpleNamespace(stack=stack, client=client,
                                 Transport=lz.DirectTransport)


PACKAGES = (_package(False), _package(True))


def _both(scenario, host_parallel):
    """``scenario(pkg, host_parallel)`` on the reference, then on the
    port; the transcripts must be equal.  Returns the port's."""
    require_reference_native()
    ref, port = (scenario(pkg, host_parallel) for pkg in PACKAGES)
    assert port == ref
    return port


def _books(s):
    """The aggregator's and the manager's books, and the manager's log."""
    return [s.agg.status(), s.mgr.status(), s.mgr.ops]


def _collapse(pkg, hp):
    clock = {"t": T0}
    s = pkg.stack(clock, hp)
    clients = [pkg.client(s, clock, 12) for _ in range(4)]
    try:
        out = []
        for i in range(600):
            clock["t"] += 1
            out.append(clients[i % 4].try_acquire(f"k{i % 3}"))
        for lc in clients:
            lc.release_all()
        s.agg.release_all()
        s.raw.flush()
        avail = [int(s.raw.available_many("tb", s.lid, [f"k{j}"])[0])
                 for j in range(3)]
        return [out, s.agg.upstream_frames, avail] + _books(s)
    finally:
        s.raw.close()


def _nested(pkg, hp):
    """Fence-epoch advances revoke the bulk pools; burns clients land on
    revoked slices fold into over_admission at both tiers."""
    clock = {"t": T0}
    s = pkg.stack(clock, hp, bulk_budget=48, slice_budget=8)
    rng = random.Random(7)
    keys = [f"k{i}" for i in range(4)]
    clients = [pkg.client(s, clock, 8) for _ in range(3)]
    out = []
    try:
        revoked_budget_sum = 0
        for epoch in range(1, 6):
            for _ in range(150):
                clock["t"] += 1
                out.append(clients[rng.randrange(3)].try_acquire(
                    rng.choice(keys)))
            # Settle the pending burn reports, then advance the fence
            # epoch: every live bulk lease is now stale.
            s.agg.flush()
            revoked_budget_sum += sum(p.budget for p in s.agg._pools.values())
            s.st.epoch = epoch
            over_core0 = s.mgr.over_admission_total
            over_agg0 = s.agg.over_admission_total
            revoked0 = s.agg.scoped_revocations_total
            s.agg.flush()
            assert s.mgr.over_admission_total == over_core0
            assert s.agg.scoped_revocations_total > revoked0
            # Clients drain their stranded slices (served locally: the
            # bounded over-admission), then grant again.
            burned = 0
            for lc in clients:
                for k in list(lc._leases):
                    lease = lc._leases[k]
                    while lease.remaining > 0:
                        clock["t"] += 1
                        assert lc.try_acquire(k)
                        burned += 1
                    clock["t"] += 1
                    assert lc.try_acquire(k)  # a new grant at the new epoch
            s.agg.flush()
            assert s.agg.over_admission_total - over_agg0 >= burned
            assert s.mgr.over_admission_total - over_core0 \
                == s.agg.over_admission_total - over_agg0, (
                    "core and aggregator over-admission folds diverged")
            out.append((burned, s.mgr.over_admission_total))
        assert s.mgr.over_admission_total <= revoked_budget_sum
        for lc in clients:
            lc.release_all()
        s.agg.release_all()
        assert s.mgr.table.outstanding() == 0
        return out + _books(s)
    finally:
        s.raw.close()


def _isolation(pkg, hp):
    """Two sessions on one key get independent slices of one pool; a
    session's release folds only its own slice."""
    clock = {"t": T0}
    s = pkg.stack(clock, hp, bulk_budget=64, slice_budget=8)
    try:
        s1, s2 = s.agg.session(), s.agg.session()
        out = [tuple(s1.grant(s.lid, "k", 8)), tuple(s2.grant(s.lid, "k", 8))]
        pool = next(iter(s.agg._pools.values()))
        out += [len(s.agg._pools), len(pool.subs), pool.sliced_out,
                s.mgr.table.outstanding()]
        s1.release(s.lid, "k", used=3)
        pool.check_conservation()
        out += [len(pool.subs), pool.used_pending]
        s.agg.release_all()
        out.append(s.mgr.table.outstanding())
        return out + _books(s)
    finally:
        s.raw.close()


def _stale_epoch(pkg, hp):
    """A dead bulk lease's burn report lands in over_admission, not in the
    successor lease's books (the epochs column names the instance)."""
    clock = {"t": T0}
    s = pkg.stack(clock, hp, bulk_budget=64, slice_budget=16)
    t = pkg.Transport(s.mgr)
    try:
        g = t.lease_grant(s.lid, "k", 64, bulk=True)
        dead_epoch = g.epoch
        s.st.epoch = 3
        g2 = t.lease_grant(s.lid, "k", 64, bulk=True)
        successor = s.mgr.table.get("tb", s.lid, "k")
        used0 = successor.used_total
        over0, rev0 = s.mgr.over_admission_total, s.mgr.revoked_total
        rows = t.lease_bulk_renew(s.lid, ["k"], [40], [0],
                                  epochs=[dead_epoch])
        out = [tuple(g), tuple(g2), rows,
               s.mgr.over_admission_total - over0,
               s.mgr.revoked_total - rev0, successor.used_total - used0]
        # The successor still renews with its own epoch.
        out.append(tuple(s.mgr.renew(s.lid, "k", used=5, requested=64,
                                     epoch=successor.epoch)))
        return out + _books(s)
    finally:
        s.raw.close()


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_aggregator_collapses_frames_and_reconciles(host_parallel):
    out, frames, avail, agg, mgr, ops = _both(_collapse, host_parallel)
    assert all(out) and len(out) == 600
    # 4 clients x 3 keys through one aggregator: at most decisions / 5
    # upstream frames.
    assert frames * 5 <= 600
    assert mgr["outstanding"] == 0 and agg["pools"] == 0
    assert all(0 <= a <= 100_000 for a in avail)


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_aggregator_nested_over_admission_bound(host_parallel):
    out = _both(_nested, host_parallel)
    agg, mgr = out[-3], out[-2]
    assert agg["scoped_revocations"] >= 5
    assert mgr["over_admission"] == agg["over_admission"] > 0


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_aggregator_session_isolation_one_slice_each(host_parallel):
    out = _both(_isolation, host_parallel)
    g1, g2, pools, subs, sliced, core = out[:6]
    assert g1[0] == 8 and g2[0] == 8
    # One pool, two slices; the core sees one bulk lease, not two.
    assert (pools, subs, sliced, core) == (1, 2, 16, 1)
    assert out[6:9] == [1, 3, 0]


@pytest.mark.parametrize("host_parallel", HOST_PARALLEL)
def test_bulk_renew_stale_epoch_row_folds_to_over_admission(host_parallel):
    g, g2, rows, over, revoked, leaked, renewed = _both(
        _stale_epoch, host_parallel)[:7]
    assert g[0] == 64 and g2[0] == 64 and g2[2] != g[2]
    assert rows == [(0, 0, 0, True)]
    assert (over, revoked, leaked) == (40, 0, 0)
    assert renewed[0] == 64


# ---------------------------------------------------------------------------
# Wiring: config gating and /actuator/edge
# ---------------------------------------------------------------------------

_WIRED = {
    "storage.backend": "tpu", "storage.num_slots": "1024",
    "parallel.shard": "off", "warmup.enabled": "false",
    "link.probe.enabled": "false",
}


def _apps(props):
    require_reference_native()
    return (ref_build_app(RefProps(dict(props))),
            build_app(AppProperties(dict(props)), device="cpu"))


def test_wiring_edge_disabled_without_leases():
    ctxs = _apps({**_WIRED, "ratelimiter.edge.enabled": "true"})
    try:
        assert [c.edge for c in ctxs] == [None, None]
        assert [c.leases for c in ctxs] == [None, None]
    finally:
        for c in ctxs:
            c.close()


def _get(srv, path):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=10)
    conn.request("GET", path)
    body = json.loads(conn.getresponse().read())
    conn.close()
    return body


def test_wiring_edge_sessions_and_actuator():
    """Both tiers on: 40 decisions of an edge session's client on the
    burst limiter, then ``/actuator/edge`` and ``/actuator/tenants`` over
    loopback, equal between the two apps."""
    ctxs = _apps({
        **_WIRED,
        "ratelimiter.lease.enabled": "true",
        "ratelimiter.lease.max_bulk_budget": "4096",
        "ratelimiter.edge.enabled": "true",
        "ratelimiter.edge.bulk_budget": "512",
        "ratelimiter.edge.slice_budget": "32",
    })
    servers = []
    try:
        bodies = []
        for ctx, app, lz in zip(ctxs, (ref_app, port_app),
                                (ref_leases, leases)):
            srv = app.make_server(ctx, port=0)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            servers.append(srv)
            lid = ctx.limiters["burst"]._lid
            # The reference's first lease step compiles, which can take
            # longer than the 2 s lease TTL on a slow host; its edge pool
            # would then be granted already expired. Grant and release a
            # lease on another key first, on both apps alike.
            ctx.leases.grant(lid, "warm-up", 1)
            ctx.leases.release(lid, "warm-up", 0)
            cli = lz.LeaseClient(ctx.edge.session(), lid, budget=32,
                                 telemetry=False, direct_fallback=False)
            allowed = [cli.try_acquire("edge-wired") for _ in range(40)]
            tenants = _get(srv, "/actuator/tenants")
            bodies.append((allowed, _get(srv, "/actuator/edge"),
                           tenants["enabled"], tenants["leases"]))
            cli.release_all()
        assert bodies[1] == bodies[0]
        allowed, edge_body, _, lease_status = bodies[1]
        assert sum(allowed) == 40
        assert edge_body["enabled"] is True
        assert edge_body["pools"] >= 1 and edge_body["subleases"] >= 1
        assert lease_status["outstanding"] == 1
    finally:
        for srv in servers:
            srv.shutdown()
        for c in ctxs:
            c.close()
