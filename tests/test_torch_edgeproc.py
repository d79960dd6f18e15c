"""The standalone edge process and the v6 wire it speaks, port against the
JAX package: the bulk-renew and ``edgeproc`` cases of
``tests/test_edge.py``.

- Wide (v6) bulk budgets past the old u16 cap, and the bulk-renew epoch
  column row by row, over the port's sidecar beside the reference's.
- ``build_edge`` in process: lease clients on the edge's own front port
  burn subleases locally, the edge's upstream frames collapse, plain
  frames proxy to the core; the port's edge over the port's core, the
  reference's over the reference's, and the port's edge in front of the
  reference's core, all with equal answers.
- ``python -m ratelimiter_tpu_torch.edge.edgeproc`` as a subprocess: one
  JSON ready line, lease clients served through BULK_RENEW upstream, a
  clean exit on stdin EOF and on SIGTERM.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import types

import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.edge import edgeproc as ref_edgeproc
from ratelimiter_tpu import leases as ref_leases
from ratelimiter_tpu.service import sidecar as ref_sc
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch import leases
from ratelimiter_tpu_torch.edge import edgeproc
from ratelimiter_tpu_torch.service import sidecar as sc
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_753_000_000_000
REPO = pathlib.Path(__file__).resolve().parents[1]


def _package(port: bool):
    return types.SimpleNamespace(
        port=port, sc=sc if port else ref_sc,
        Config=RateLimitConfig if port else RefConfig,
        leases=leases if port else ref_leases,
        edgeproc=edgeproc if port else ref_edgeproc)


PACKAGES = (_package(False), _package(True))


def _core(pkg, clock=None, max_bulk_budget=8192, num_slots=1024):
    """A core sidecar with one roomy token bucket and a lease manager."""
    kw = dict(num_slots=num_slots, host_parallel=0)
    if clock is not None:
        kw["clock_ms"] = lambda: clock["t"]
    st = (GpuBatchedStorage(device="cpu", **kw) if pkg.port
          else TpuBatchedStorage(**kw))
    server = pkg.sc.SidecarServer(st, host="127.0.0.1").start()
    lid = server.register("tb", pkg.Config(
        max_permits=1 << 20, window_ms=60_000, refill_rate=1e6))
    mgr = pkg.leases.LeaseManager(
        st, default_budget=64, max_budget=64,
        max_bulk_budget=max_bulk_budget, ttl_ms=60_000.0,
        **({} if clock is None else {"clock_ms": lambda: clock["t"]}))
    server.attach_leases(mgr)
    return types.SimpleNamespace(st=st, server=server, lid=lid, mgr=mgr)


def _stop(core):
    core.server.stop()
    core.st.close()


def test_v6_bulk_budget_straddles_u16():
    """Bulk budgets past the old u16 wire ceiling survive the LEASE /
    BULK_RENEW round trip full-width (the v6 granted64 trailer), on both
    packages' servers, with equal answers."""
    require_reference_native()
    big = 200_000
    got = []
    for pkg in PACKAGES:
        clock = {"t": T0}
        core = _core(pkg, clock, max_bulk_budget=big)
        try:
            cli = pkg.sc.SidecarClient("127.0.0.1", core.server.port,
                                       timeout=30.0)
            try:
                assert cli.server_version >= 6
                granted, ttl, epoch = cli.lease_grant(core.lid, "wide", big,
                                                      bulk=True)
                assert granted == big > 0xFFFF
                rows = cli.lease_bulk_renew(core.lid, ["wide"], [70_000],
                                            [big], epochs=[epoch])
                g2, _ttl2, _ep2, revoked = rows[0]
                assert not revoked and g2 == big > 0xFFFF
                cli.lease_release(core.lid, "wide", 0)
                got.append(((granted, ttl, epoch), rows,
                            core.mgr.status()))
            finally:
                cli.close()
        finally:
            _stop(core)
    assert got[1] == got[0]


def test_bulk_renew_wire_epoch_column_matches_direct():
    """The OP_BULK_RENEW epochs column decodes row for row: a stale epoch
    in one row folds that row to over_admission while its neighbors renew
    normally, on both packages alike."""
    require_reference_native()
    got = []
    for pkg in PACKAGES:
        clock = {"t": T0}
        core = _core(pkg, clock, max_bulk_budget=256)
        mgr = core.mgr
        try:
            cli = pkg.sc.SidecarClient("127.0.0.1", core.server.port,
                                       timeout=30.0)
            try:
                eps = {}
                for k in ("a", "b", "c"):
                    granted, _ttl, epoch = cli.lease_grant(core.lid, k, 256,
                                                           bulk=True)
                    assert granted == 256
                    eps[k] = epoch
                over0 = mgr.over_admission_total
                rows = cli.lease_bulk_renew(
                    core.lid, ["a", "b", "c"], [10, 20, 30],
                    [256, 256, 256],
                    epochs=[eps["a"], eps["b"] + 7, eps["c"]])
                assert rows[0][0] == 256 and rows[2][0] == 256
                assert rows[1][0] == 0
                assert mgr.over_admission_total - over0 == 20
                assert mgr.table.get("tb", core.lid, "b").used_total == 0
                for k in ("a", "b", "c"):
                    cli.lease_release(core.lid, k, 0)
                got.append((rows, mgr.status()))
            finally:
                cli.close()
        finally:
            _stop(core)
    assert got[1] == got[0]


def _front_door(epkg, core_port, lid):
    """The in-process front door of ``tests/test_edge.py``: 1500 leased
    decisions on two hot keys through the edge, then plain frames."""
    edge_server, agg, upstream = epkg.edgeproc.build_edge(
        "127.0.0.1", core_port, [lid], bulk_budget=2048, slice_budget=64)
    try:
        wire = epkg.sc.SidecarClient("127.0.0.1", edge_server.port,
                                     timeout=30.0)
        try:
            cli = epkg.leases.LeaseClient(wire, lid, budget=64,
                                          telemetry=False,
                                          direct_fallback=False)
            n = 1500
            allowed = [cli.try_acquire(f"hot{i % 2}") for i in range(n)]
            cli.release_all()
            assert all(allowed)
            # The edge spent <= n/5 frames upstream for n decisions.
            assert agg.upstream_frames * 5 <= n
            plain = (wire.try_acquire(lid, "proxy-key"), wire.ping())
            # The core's bucket refills on the wall clock: one permit
            # spent at most.
            assert wire.available(lid, "proxy-key") >= (1 << 20) - 1
        finally:
            wire.close()
        agg.release_all()
        return (plain, upstream.server_version)
    finally:
        upstream.close()
        edge_server.stop()


@pytest.mark.parametrize("edge_port,core_port", [
    (False, False), (True, True), (True, False)],
    ids=["reference", "port", "port_edge_reference_core"])
def test_edgeproc_in_process_front_door(edge_port, core_port):
    """build_edge fronts a real core: clients on the edge's own wire port
    burn subleases locally, the upstream traffic collapses, plain ops
    proxy through, every bulk budget returns to the core; the answers
    equal the reference's pair."""
    require_reference_native()
    results = []
    for epkg, cpkg in ((PACKAGES[0], PACKAGES[0]),
                       (PACKAGES[edge_port], PACKAGES[core_port])):
        core = _core(cpkg)
        try:
            results.append(_front_door(epkg, core.server.port, core.lid))
            assert core.mgr.table.outstanding() == 0
        finally:
            _stop(core)
    assert results[1] == results[0]
    assert results[1] == ((True, True), sc.PROTOCOL_VERSION)


def _spawn_edge(core_port, lid):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "ratelimiter_tpu_torch.edge.edgeproc",
         "--upstream-host", "127.0.0.1", "--upstream-port", str(core_port),
         "--lids", str(lid), "--bulk-budget", "128"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, cwd=REPO)


@pytest.mark.parametrize("how", ["eof", "sigterm"])
def test_edgeproc_subprocess_ready_and_clean_exit(how):
    """``python -m ratelimiter_tpu_torch.edge.edgeproc``: one JSON ready
    line on stdout, lease clients on its front port served through
    BULK_RENEW upstream, exit 0 on stdin EOF or SIGTERM with every bulk
    budget returned to the core."""
    core = _core(PACKAGES[1])
    proc = _spawn_edge(core.server.port, core.lid)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] and ready["role"] == "edge"
        assert ready["version"] == sc.PROTOCOL_VERSION
        assert ready["lids"] == [core.lid]
        wire = sc.SidecarClient("127.0.0.1", int(ready["port"]),
                                timeout=30.0)
        try:
            cli = leases.LeaseClient(wire, core.lid, budget=64,
                                     telemetry=False, direct_fallback=False)
            for i in range(600):
                assert cli.try_acquire(f"sub{i % 3}")
            cli.release_all()
        finally:
            wire.close()
        renewed = core.mgr.status()["renewed"]
        assert renewed >= 1, "no bulk renewal reached the core"
        if how == "eof":
            proc.stdin.close()
        else:
            proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert core.mgr.table.outstanding() == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        for f in (proc.stdin, proc.stdout):
            if f is not None and not f.closed:
                f.close()
        _stop(core)


def test_edgeproc_refuses_a_pre_v6_core(monkeypatch):
    """The edge needs bulk leases: a core that negotiates below v6 is
    refused at build time."""
    core = _core(PACKAGES[1])
    real = sc.SidecarClient
    monkeypatch.setattr(sc, "SidecarClient", lambda host, port, timeout: (
        real(host, port, timeout=timeout, protocol=5)))
    try:
        with pytest.raises(RuntimeError, match="v6"):
            edgeproc.build_edge("127.0.0.1", core.server.port, [core.lid])
    finally:
        _stop(core)
