"""The cross-host topology as processes, on the CPU: the port's node
process (``python -m ratelimiter_tpu_torch.replication.hostproc
--device cpu``) and ``storage/chaos.py:cross_host_failover_drill``.

Every child is launched through ``hostproc.NodeProcess``: stdin a pipe
this process holds, stdout a pipe a thread drains, stderr a temporary
file, ``OMP_NUM_THREADS=1``; it is stopped by closing its stdin, killed
by its own pid, and reaped in a ``finally`` even when the test fails.
Ports come from the OS and are read from the ready lines.  Every wait is
a poll against a deadline, and no assertion here bounds a wall time: a
loaded host stretches them (the on-card smoke script reports and bounds
the times where nothing else loads the host).  What is asserted is what
the counts show — zero mismatches against ``semantics/oracle.py``, the
witness veto, exactly one promotion at a higher epoch, the self-fence
before it, and the zombie's over-admission bounded against its own
lease deadline.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.replication.control import ControlClient
from ratelimiter_tpu_torch.replication.hostproc import NodeProcess
from ratelimiter_tpu_torch.replication.orchestrator import (
    FailoverOrchestrator,
    OrchestratorConfig,
)
from ratelimiter_tpu_torch.replication.remote import (
    FanoutLeaseChannel,
    RemoteBackend,
    RemoteReceiver,
    RemoteShardDirectory,
    RemoteStandbySet,
    parse_ready,
    standby_witness,
)
from ratelimiter_tpu_torch.semantics.oracle import (
    SlidingWindowOracle,
    TokenBucketOracle,
)
from ratelimiter_tpu_torch.service import sidecar as sc
from ratelimiter_tpu_torch.storage.chaos import cross_host_failover_drill
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
)

torch.set_num_threads(1)

BOOT_S = 60.0  # a torch import under load
SETTLE_S = 120.0
NOW = 1_753_000_000_000
GIANT_WINDOW = 1 << 30


def _poll(pred, what, timeout_s=SETTLE_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _order_only_limiters():
    """A bucket that never refills and a window that never rolls: the
    decisions depend on arrival order alone, not on any process's
    clock."""
    cfg_tb = RateLimitConfig(max_permits=7, window_ms=GIANT_WINDOW,
                             refill_rate=1e-9)
    cfg_sw = RateLimitConfig(max_permits=5, window_ms=GIANT_WINDOW,
                             enable_local_cache=False)
    assert cfg_tb.refill_rate_fp == 0
    spec = json.dumps([
        {"algo": "tb", "max_permits": 7, "window_ms": GIANT_WINDOW,
         "refill_rate": 1e-9},
        {"algo": "sw", "max_permits": 5, "window_ms": GIANT_WINDOW}])
    return cfg_tb, cfg_sw, spec


def test_cross_host_failover_drill_on_cpu_nodes():
    """The port's drill with its nodes on ``--device cpu``, at timings
    that leave a loaded host room (a lease of 3 s, a 1.5 s hysteresis,
    a 1 s witness window): scenario A vetoed, scenario B self-fenced at
    the zombie's own lease deadline and promoted once at a higher epoch,
    every decision equal to the oracle."""
    r = cross_host_failover_drill(
        device="cpu", boot_timeout_s=BOOT_S, settle_s=SETTLE_S,
        hysteresis_ms=1500.0, lease_ttl_ms=3000.0, witness_fresh_ms=1000.0)
    assert r["mismatches"] == 0 and r["decisions"] > 0
    assert r["scenario_a"]["witness_vetoes"] >= 1
    assert not r["scenario_a"]["lease"]["self_fenced"]
    b = r["scenario_b"]
    st = r["status"]
    assert st["promotions"] == 1 and st["fence_epoch"] == 1
    assert b["new_epoch"] > b["old_epoch"]
    # The self-fence came before the promotion (order, not a stopwatch).
    assert b["promotion_after_s"] >= b["self_fence_after_s"]
    # Over-admission held by counts against the zombie's own deadline:
    # no grant after the cut, at most one TTL left on it there, every
    # decision after the first refusal refused and counted by its fence.
    assert b["lease_at_cut"]["epoch"] == b["old_epoch"]
    assert b["lease_at_cut"]["ttl_remaining_ms"] <= 3000
    assert b["refused_after_fence"] == 8 and b["fence_rejected"] >= 9
    assert b["burns_after_cut"] <= b["outstanding_at_cut"]
    assert all(n <= 30 for n in r["zombie_allows"].values())
    assert r["launches"] == dict.fromkeys(
        ("solver", "tb_writeback", "sw_writeback", "block_scatter",
         "relay_step"), 0)


def test_primary_and_standby_processes_fail_over():
    """A primary and a standby node on ``--device cpu``: a seeded preload
    through BATCH frames from two connections, SHIP, SIGKILL of the
    primary, the orchestrator (witness, fence lease, remote promotion)
    promotes the standby once, and its sidecar answers sampled preloaded
    and fresh keys as the oracle."""
    rng = np.random.default_rng(7)
    cfg_tb, cfg_sw, spec = _order_only_limiters()
    nodes, clients = [], []
    orch = None
    try:
        standby = NodeProcess(["--role", "standby", "--num-slots", "4096",
                               "--lease"], device="cpu",
                              boot_timeout_s=BOOT_S)
        nodes.append(standby)
        primary = NodeProcess([
            "--role", "primary", "--num-slots", "4096", "--lease",
            "--limiters", spec,
            "--repl-target", f"127.0.0.1:{standby.info['repl_port']}",
            "--standby-control",
            f"127.0.0.1:{standby.info['control_port']}"],
            device="cpu", boot_timeout_s=BOOT_S)
        nodes.append(primary)
        pinfo = parse_ready(primary.info)
        sinfo = parse_ready(standby.info)
        assert pinfo["role"] == "primary" and sinfo["role"] == "standby"
        lid_tb, lid_sw = pinfo["lids"]
        assert pinfo["lid_base"] == lid_tb

        def ctl(port, timeout=2.0):
            c = ControlClient("127.0.0.1", port, timeout=timeout)
            clients.append(c)
            return c

        backend = RemoteBackend(ctl(pinfo["control_port"]))
        directory = RemoteShardDirectory({0: backend})
        rx = RemoteReceiver(ctl(sinfo["control_port"]),
                            promote_timeout_s=SETTLE_S)
        orch = FailoverOrchestrator(
            directory, RemoteStandbySet([rx]), None,
            config=OrchestratorConfig(
                probe_interval_ms=100.0, suspect_threshold=3,
                hysteresis_ms=2000.0, promote_retries=2,
                promote_backoff_ms=100.0, reseed=False,
                fence_lease_ttl_ms=5000.0, fence_wait_slack_ms=150.0),
            probe=lambda q: directory.serving(q) is not None
            and directory.serving(q).is_available(),
            witness=standby_witness({0: ctl(sinfo["control_port"])},
                                    fresh_ms=1500.0),
            lease_channels={0: FanoutLeaseChannel(
                backend, ctl(sinfo["control_port"]))}).start()
        direct = ctl(pinfo["control_port"])
        _poll(lambda: direct.call_ok("probe")["lease"]["installed"],
              "the first serving-lease grant")

        oracles = {lid_tb: TokenBucketOracle(cfg_tb),
                   lid_sw: SlidingWindowOracle(cfg_sw)}
        keys = [f"p{i}" for i in range(1536)]
        perm_of = dict(zip(keys, rng.integers(1, 3, len(keys)).tolist()))
        mismatches = [0]

        def preload(t):
            cli = sc.SidecarClient("127.0.0.1", pinfo["sidecar_port"],
                                   timeout=60.0)
            clients.append(cli)
            mine = keys[t::2]
            for lid in (lid_tb, lid_sw):
                perms = [perm_of[k] for k in mine]
                for _ in range(2):
                    got = cli.acquire_block(lid, mine, perms, max_rows=128)
                    with lock:
                        for k, p, a in zip(mine, perms, got):
                            want = oracles[lid].try_acquire(k, p, NOW)
                            mismatches[0] += bool(a) != want.allowed

        # Two connections on disjoint keys: per-key order is each
        # connection's own, so one oracle per limiter holds.
        lock = threading.Lock()
        threads = [threading.Thread(target=preload, args=(t,))
                   for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=SETTLE_S)
        assert not any(th.is_alive() for th in threads)
        assert mismatches[0] == 0
        direct.call_ok("ship")
        assert direct.call_ok("probe")["replication"]["frames_shipped"] >= 1
        _poll(lambda: rx.consistent and rx.last_epoch >= 1,
              "the standby's consistency after the ship")

        assert primary.kill() == -signal.SIGKILL
        _poll(lambda: orch.promotions >= 1
              and directory.shard_health()[0] == "promoted",
              "the remote promotion")
        st = orch.status()
        assert st["promotions"] == 1 and st["fence_epoch"] == 1
        port = rx.serve_port
        assert port
        cli = sc.SidecarClient("127.0.0.1", port, timeout=60.0)
        clients.append(cli)
        sample = [keys[i] for i in rng.choice(len(keys), 256, replace=False)]
        sample += [f"fresh{i}" for i in range(64)]
        for lid in (lid_tb, lid_sw):
            got = cli.acquire_block(lid, sample, [1] * len(sample))
            want = [oracles[lid].try_acquire(k, 1, NOW).allowed
                    for k in sample]
            assert [bool(a) for a in got] == want, lid
        probe = ctl(sinfo["control_port"]).call_ok("probe")
        assert probe["promoted"] and probe["lease"]["epoch"] == 2
    finally:
        if orch is not None:
            orch.close()
        for c in clients:
            c.close()
        for node in nodes:
            node.close()
    assert standby.rc == 0
    assert standby.launches() == dict.fromkeys(
        ("solver", "tb_writeback", "sw_writeback", "block_scatter",
         "relay_step"), 0)


@pytest.mark.parametrize("how", ["eof", "sigterm"])
def test_node_exits_cleanly_and_writes_nothing_after_ready(how):
    """A node exits 0 on stdin EOF or SIGTERM (to its own pid), prints its
    launch counts to stderr, and writes nothing to stdout after the
    ready line."""
    node = NodeProcess(["--role", "standby", "--lease"], device="cpu",
                       boot_timeout_s=BOOT_S)
    try:
        assert parse_ready(node.info)["role"] == "standby"
        ControlClient("127.0.0.1", node.info["control_port"],
                      timeout=5.0).call_ok("probe")
        if how == "sigterm":
            node.proc.send_signal(signal.SIGTERM)
            rc = node.proc.wait(timeout=SETTLE_S)
        else:
            rc = node.stop(timeout_s=SETTLE_S)
    finally:
        node.close()
    assert rc == 0
    assert node.launches() is not None
    rest = []
    while not node._lines.empty():
        rest.append(node._lines.get_nowait())
    assert rest == [b""], rest


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
def test_node_without_a_card_exits_nonzero():
    """``--device`` defaults to the card: without one the node raises and
    exits non-zero instead of carrying on on the CPU."""
    with pytest.raises(RuntimeError, match="no ready line") as info:
        NodeProcess(["--role", "standby"], boot_timeout_s=BOOT_S)
    assert "CUDA" in str(info.value)


NO_JAX = """
import json, sys
from ratelimiter_tpu_torch.replication import hostproc

def check():
    bad = sorted(n for n in sys.modules
                 if n.split('.')[0] in ('jax', 'jaxlib', 'ratelimiter_tpu'))
    print(json.dumps({"bad": bad}), flush=True)

hostproc._wait_for_shutdown = check
sys.exit(hostproc.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("role", ["primary", "standby"])
def test_node_imports_no_jax(role):
    """A node started with ``--device cpu`` and built to ready (sidecar,
    leases, control port, replication listener) has neither jax nor the
    JAX package in ``sys.modules``."""
    args = ["--role", role, "--device", "cpu", "--lease"]
    if role == "primary":
        args += ["--limiters", _order_only_limiters()[2]]
    with tempfile.TemporaryFile() as err:
        res = subprocess.run(
            [sys.executable, "-c", NO_JAX, *args], input=b"",
            stdout=subprocess.PIPE, stderr=err, timeout=SETTLE_S,
            cwd=str(pathlib.Path(__file__).parents[1]),
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        err.seek(0)
        tail = err.read()[-2000:]
    assert res.returncode == 0, tail
    lines = res.stdout.decode().splitlines()
    assert json.loads(lines[0])["ready"] and json.loads(lines[0])["role"] \
        == role
    assert json.loads(lines[1]) == {"bad": []}
