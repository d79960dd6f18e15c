"""The link profile and the elections that read it, against the JAX
package's, on the CPU.

- The elections as functions, fed the same inputs and the same rates
  dict on both sides: ``_elect_digest_mode``, ``_sort_affordable`` (the
  host's cores patched), ``_schedule_candidates`` / ``_fold_tail`` (equal
  lists, and the reference's invariants), ``_sim_schedule_wall`` (equal
  floats), ``_ChunkCursor``, and the storages' ``_elect_chunk_plan`` /
  ``_maybe_revert_plan`` on the same totals and walls (equal plan
  records, the 128-plan bound's eviction order too).
- The profile surface: ``probe_link`` and the reset of the plans, and
  ``engine/device_rates.py``'s opt-out, disk cache and raising probe.
- Storage pairs with ``host_parallel`` pinned equal on both sides: a
  forced pipelined plan (a fixed chunk, and a schedule) decides equal to
  the reference's pass for pass with equal chunks, for the relay and the
  weighted relay, with ``_RELAY_CHUNK`` patched on both modules.
- ``build_app`` on the CPU: ``link.probe.enabled`` sets a profile on the
  raw storage; off, none.

The split digest has its own file (``tests/test_torch_split_digest.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine import device_rates as ref_rates
from ratelimiter_tpu.storage import tpu as ref_mod
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine import device_rates
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.service.wiring import build_app
from ratelimiter_tpu_torch.storage import gpu as gpu_mod
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from ratelimiter_tpu_torch.utils.link import PROBE_BYTES, measure_link
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

# One rates dict for both sides wherever a storage's elections read rates:
# the reference's fallback constants (the port's are the H100's).
RATES = dict(ref_rates.FALLBACK_RATES)


# -- the elections as functions ---------------------------------------------
def test_elect_digest_mode_matches_reference():
    """A seeded sweep over links (none, fast, slow, one direction
    degraded, a two-value profile), chunk shapes (u / n from 0.05 to 1),
    lid deltas, the one-limiter and tenant wire costs, sorted or not, u8
    and u16 counts, and three rates dicts: every verdict equal, and both
    verdicts present."""
    rng = np.random.default_rng(21)
    rate_sets = [RATES, dict(device_rates.FALLBACK_RATES),
                 {"s_per_lane": 5e-9, "s_per_unique_sorted": 1e-9,
                  "s_per_unique_unsorted": 300e-9}]
    links = [None, (85e6, 0.1), (5e6, 0.1, 5e6), (62e6, 0.05, 5.3e6),
             (6e9, 1e-4, 1.6e9), (2e6, 0.05, 2e6)]
    seen = set()
    for _ in range(600):
        link = links[int(rng.integers(len(links)))]
        cn = int(rng.integers(1_000, 2_000_000))
        u = max(1, int(cn * rng.uniform(0.05, 1.0)))
        multi = bool(rng.integers(2))
        bpu, bpr = (10.0, 8.125) if multi else (6.0, 4.125)
        n_delta = int(rng.integers(0, u + 1)) if multi else 0
        args = (link, u, cn, n_delta, bpu, bpr, bool(rng.integers(2)))
        kw = dict(cdt_size=int(rng.choice([1, 2])),
                  rates=rate_sets[int(rng.integers(len(rate_sets)))])
        got = gpu_mod._elect_digest_mode(*args, **kw)
        assert got == ref_mod._elect_digest_mode(*args, **kw), (args, kw)
        seen.add(got)
    assert seen == {True, False}


@pytest.mark.parametrize("cores", [1, 2, 8])
def test_sort_affordable_matches_reference(monkeypatch, cores):
    """``RATELIMITER_SORT_UNIQUES`` auto / always / never, read at each
    call, on a host of 1, 2 and 8 cores (``os.sched_getaffinity``
    patched), with no profile and links on both sides of the threshold."""
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(cores)), raising=False)
    for policy in ("auto", "always", "never", None):
        if policy is None:
            monkeypatch.delenv("RATELIMITER_SORT_UNIQUES", raising=False)
        else:
            monkeypatch.setenv("RATELIMITER_SORT_UNIQUES", policy)
        for link in (None, (1e6, 0.1), (39e6, 0.1), (41e6, 0.1),
                     (5e9, 1e-4)):
            for u in (1, 4096, 1 << 20):
                assert (gpu_mod._sort_affordable(link, u)
                        == ref_mod._sort_affordable(link, u)), (
                    policy, link, u)
    monkeypatch.setenv("RATELIMITER_SORT_UNIQUES", "auto")
    assert gpu_mod._sort_affordable((5e9, 1e-4), 4096) is (cores > 2)


def test_schedule_candidates_match_reference():
    """Equal candidate lists (the reference's ``_fold_tail`` and its
    halving at the chunk ceiling included), and the reference's
    invariants: each covers n, no chunk passes ``_RELAY_CHUNK_MAX``, no
    tail under ``_RELAY_CHUNK``; short streams get none."""
    head, cmax = gpu_mod._RELAY_CHUNK, gpu_mod._RELAY_CHUNK_MAX
    assert (head, cmax) == (ref_mod._RELAY_CHUNK, ref_mod._RELAY_CHUNK_MAX)
    ns = [1 << 24, (1 << 24) + 1234, 12_582_912, head + cmax + 300_000,
          1 << 26, 4 * head, 4 * head - 1, 3 * cmax + 7, 5_000_000]
    for n in ns:
        for words_pow2 in (False, True):
            got = gpu_mod._schedule_candidates(n, head, words_pow2)
            assert got == ref_mod._schedule_candidates(n, head, words_pow2)
            for sched in got:
                assert sum(sched) == n, (n, words_pow2, sched)
                assert max(sched) <= cmax, sched
                assert sched[-1] >= head, (n, words_pow2, sched)
    assert gpu_mod._schedule_candidates(2 * head, head, False) == []
    for sizes, rem in (([head, cmax], 5), ([head, cmax - 3], 2),
                       ([head, 1 << 20], 1 << 18)):
        a, b = list(sizes), list(sizes)
        gpu_mod._fold_tail(a, rem)
        ref_mod._fold_tail(b, rem)
        assert a == b and sum(a) == sum(sizes) + rem


def test_sim_schedule_wall_matches_reference():
    """Seeded model inputs (digest and words passes) over every candidate
    schedule and the giant pair: equal floats."""
    rng = np.random.default_rng(22)
    head = gpu_mod._RELAY_CHUNK
    for _ in range(40):
        n = int(rng.integers(4 * head, 1 << 26))
        kw = dict(cpu_per_req=float(rng.uniform(1e-9, 1e-7)),
                  digest_frac=float(rng.choice([0.0, 0.4, 1.0])),
                  dedup_a=float(rng.uniform(0.5, 40.0)),
                  dedup_alpha=float(rng.uniform(0.55, 1.0)),
                  bpu_up=float(rng.choice([4.0, 8.0])),
                  bpu_down=float(rng.choice([1.0, 2.0])),
                  words_up=float(rng.choice([4.0, 8.0])),
                  link_up=float(rng.uniform(1e6, 5e9)),
                  link_down=float(rng.uniform(1e6, 5e9)),
                  rtt=float(rng.uniform(1e-5, 0.2)),
                  dev_per_lane=float(rng.uniform(1e-10, 6e-8)))
        scheds = [[head, n - head]] + gpu_mod._schedule_candidates(
            n, head, kw["digest_frac"] <= 0.5)
        for sched in scheds:
            assert (gpu_mod._sim_schedule_wall(sched, **kw)
                    == ref_mod._sim_schedule_wall(sched, **kw))


def test_chunk_cursor_matches_reference():
    """A schedule shorter than the stream drains the overflow at its last
    entry, ``peek`` equals the next ``next_size``; a fixed chunk grows;
    the growth cursor of a giant plan starts at ``_RELAY_CHUNK``."""
    plans = [({"kind": "pipelined", "schedule": (100, 500, 200),
               "chunk": 500}, True),
             ({"kind": "pipelined", "chunk": 300}, True),
             (None, False)]
    for plan, pipelined in plans:
        cursors = [gpu_mod._ChunkCursor(plan, pipelined),
                   ref_mod._ChunkCursor(plan, pipelined)]
        runs = []
        for cur in cursors:
            sizes, start, n = [], 0, 1600
            while start < n:
                peek = cur.peek(n - start)
                c = cur.next_size(n - start)
                assert peek == c
                sizes.append(c)
                start += c
                if len(sizes) == 2:
                    cur.grow(700)
            runs.append(sizes)
        assert runs[0] == runs[1]
    assert runs[0][0] == min(gpu_mod._RELAY_CHUNK, 1600)


def _plan_pair():
    port = GpuBatchedStorage(num_slots=1 << 12, device="cpu",
                             host_parallel=0)
    ref = TpuBatchedStorage(num_slots=1 << 12, host_parallel=0)
    for st in (port, ref):
        st._device_rates_obj = dict(RATES)
    return port, ref


def test_chunk_plan_election_matches_reference():
    """The reference's election scenario (``tests/test_tpu_storage.py:
    test_chunk_plan_election_logic``) on both storages, the plan records
    equal after every call: a CPU-bound words pass elects a schedule on
    its second measurement; a slow link's digest pass with strong dedup
    stays giant; a pipelined plan reverts only past 1.1x the measured
    giant wall over two passes, and then stays locked; a provisional
    giant re-elects once clean totals arrive."""
    port, ref = _plan_pair()
    n = 1 << 24
    key = ("relay", "ints", "tb", False, n)
    giant_tot = {"walk_s": 1.6, "host_s": 0.4, "wire": 4.125 * n,
                 "fetch_s": 1.5, "chunks": 2, "digest_chunks": 0,
                 "bpr": 4.125, "device_s": 1.0,
                 "cu": [(1 << 19, 480_000), (n - (1 << 19), 14_800_000)]}
    slow_tot = {"walk_s": 0.05, "host_s": 0.02, "wire": 8.1e6,
                "fetch_s": 3.0, "chunks": 2, "digest_chunks": 2,
                "bpu": 6.0, "device_s": 0.07,
                "cu": [(1 << 19, 150_000), (n - (1 << 19), 1_200_000)]}
    kinds = []

    def both(fn, *args):
        for st in (port, ref):
            getattr(st, fn)(*args)
        assert port._chunk_plans == ref._chunk_plans, fn
        kinds.append(port._chunk_plans.get(key, {}).get("kind"))

    def profile(*link):
        for st in (port, ref):
            st.set_link_profile(*link)
        assert port._link_profile == ref._link_profile

    try:
        profile(85e6, 0.107, 85e6)
        both("_elect_chunk_plan", key, n, giant_tot, 3.5)
        both("_elect_chunk_plan", key, n, giant_tot, 3.5)
        plan = port._chunk_plans[key]
        assert plan["chunk"] >= 1 << 19 and sum(plan["schedule"]) >= n
        profile(5e6, 0.107, 5e6)
        both("_elect_chunk_plan", key, n, slow_tot, 3.2)
        both("_elect_chunk_plan", key, n, slow_tot, 3.2)
        profile(85e6, 0.107)
        both("_elect_chunk_plan", key, n, giant_tot, 0.95)
        both("_elect_chunk_plan", key, n, giant_tot, 0.95)
        ref_s = port._chunk_plans[key]["ref"]
        both("_maybe_revert_plan", key, 10.0)
        both("_maybe_revert_plan", key, 2.0 * ref_s)
        both("_elect_chunk_plan", key, n, giant_tot, 0.95)
        for st in (port, ref):
            st._chunk_plans.clear()
        both("_elect_chunk_plan", key, n, dict(giant_tot, fetch_s=12.0),
             13.0)
        both("_elect_chunk_plan", key, n, giant_tot, 0.95)
        # The weighted key's per-unique wire model.
        wkey = ("weighted", "ints", "tb", n)
        wtot = dict(giant_tot, digest_chunks=0, bpr=2.2,
                    cu=[(1 << 19, 60_000), (n - (1 << 19), 700_000)])
        for wall in (4.0, 4.0, 4.0, 4.0):
            for st in (port, ref):
                st._elect_chunk_plan(wkey, n, wtot, wall)
            assert port._chunk_plans == ref._chunk_plans
        # Passes of a short stream elect nothing.
        both("_elect_chunk_plan", ("relay", "ints", "sw", False, 1 << 20),
             1 << 20, giant_tot, 1.0)
    finally:
        port.close()
        ref.close()
    assert kinds == ["giant", "pipelined",              # fast words pass
                     "giant", "giant",                  # slow digest pass
                     "giant", "pipelined",              # elected again
                     "pipelined", "giant", "giant",     # reverted, locked
                     "giant", "pipelined",              # provisional, clean
                     "pipelined"]                       # short stream


def test_chunk_plan_bound_evicts_like_reference():
    """At 128 plans a new shape evicts as the reference does: giant and
    provisional plans first, then pipelined ones, then locked ones."""
    port, ref = _plan_pair()
    n = 1 << 24
    tot = {"walk_s": 1.0, "host_s": 0.1, "wire": 1e7, "chunks": 2,
           "cu": [(1 << 19, 400_000), (n - (1 << 19), 9_000_000)]}
    records = [{"kind": "giant", "chunk": 0, "ref": 1.0, "passes": 1},
               {"kind": "pipelined", "schedule": (1 << 19, n - (1 << 19)),
                "chunk": n - (1 << 19), "ref": 1.0, "giant_wall": 1.0,
                "passes": 0, "best": None},
               {"kind": "giant", "chunk": 0, "ref": 1.0, "locked": True}]
    try:
        for st in (port, ref):
            st.set_link_profile(85e6, 0.1)
        for fill in ((40, 60, 28), (100, 20, 8), (0, 130, 0),
                     (0, 0, 128)):
            for st in (port, ref):
                st._chunk_plans = {
                    ("relay", "ints", "tb", False, i): dict(
                        records[0 if i < fill[0] else 1
                                if i < fill[0] + fill[1] else 2])
                    for i in range(sum(fill))}
                st._elect_chunk_plan(("relay", "ints", "sw", False, n), n,
                                     tot, 1.0)
            assert port._chunk_plans == ref._chunk_plans, fill
            assert len(port._chunk_plans) <= 129
    finally:
        port.close()
        ref.close()


# -- the profile surface ------------------------------------------------------
def test_link_probe_and_profile_reset():
    """``probe_link`` measures the CPU device, sets the profile it
    returns (a bandwidth below the clamp's ceiling, a round trip under a
    minute); ``set_link_profile`` defaults the download rate to the
    upload rate and drops every plan, as the reference's does."""
    st = GpuBatchedStorage(num_slots=256, device="cpu")
    ref = TpuBatchedStorage(num_slots=256)
    try:
        assert st._link_profile is None
        prof = st.probe_link()
        assert st._link_profile == prof and len(prof) == 3
        assert 0 < prof[0] < PROBE_BYTES / 1e-6
        assert 0 < prof[2] <= PROBE_BYTES / 1e-6
        assert 0 < prof[1] < 60.0
        plan = {"kind": "pipelined", "chunk": 512, "ref": 1.0,
                "giant_wall": 1.2, "passes": 0, "best": None}
        for s in (st, ref):
            s._chunk_plans[("relay", "ints", "tb", False, 4096)] = dict(plan)
            s.set_link_profile(1e9, 0.001)
        assert st._link_profile == ref._link_profile == (1e9, 0.001, 1e9)
        assert st._chunk_plans == ref._chunk_plans == {}
    finally:
        st.close()
        ref.close()
    up, rtt, down = measure_link("cpu", rtt_reps=1, upload_reps=1)
    assert up > 0 and rtt > 0 and down > 0


def test_storage_rates_follow_the_profile(monkeypatch):
    """Without a profile the storage charges the fallback constants and
    probes nothing; once a profile is set it asks ``get_device_rates``
    for its own device, once."""
    asked = []

    def fake(device):
        asked.append(str(device))
        return dict(RATES, source="probe")
    monkeypatch.setattr(gpu_mod, "get_device_rates", fake)
    st = GpuBatchedStorage(num_slots=256, device="cpu")
    try:
        assert st._device_rates() is device_rates.FALLBACK_RATES
        st.set_link_profile(1e9, 1e-4)
        assert st._device_rates()["source"] == "probe"
        assert st._device_rates()["source"] == "probe"
        assert asked == ["cpu"]
    finally:
        st.close()


def test_device_rates_opt_out_and_disk_cache(monkeypatch, tmp_path):
    """``RATELIMITER_RATE_PROBE=0`` gives the fallback constants even
    where a probe left its file (the reference's order); allowed to
    probe, the disk file is read and nothing probes; with no file the
    probe runs once, its rates are cached in the process and written to
    ``<platform>_<name>.json``; a failing probe raises."""
    monkeypatch.setattr(device_rates, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(device_rates, "_mem_cache", {})
    monkeypatch.setenv("RATELIMITER_RATE_PROBE", "0")
    got = device_rates.get_device_rates("cpu")
    assert got["source"] == "fallback" and got["device"] == "cpu/cpu"
    assert {k: got[k] for k in device_rates.FALLBACK_RATES} == \
        device_rates.FALLBACK_RATES
    assert all(v > 0 for v in device_rates.FALLBACK_RATES.values())
    path = device_rates._cache_path("cpu", "cpu")
    assert path.parent == tmp_path and path.name == "cpu_cpu.json"
    seeded = {"s_per_lane": 1e-9, "s_per_unique_sorted": 2e-9,
              "s_per_unique_unsorted": 3e-9, "source": "probe"}
    path.write_text(json.dumps(seeded), encoding="utf-8")
    monkeypatch.setattr(device_rates, "_mem_cache", {})
    assert device_rates.get_device_rates("cpu")["source"] == "fallback"

    def no_probe(dev):
        raise AssertionError("the disk cache must prevent probing")
    monkeypatch.setenv("RATELIMITER_RATE_PROBE", "1")
    monkeypatch.setattr(device_rates, "_probe", no_probe)
    monkeypatch.setattr(device_rates, "_mem_cache", {})
    assert device_rates.get_device_rates("cpu") == seeded

    path.unlink()
    probed = []

    def probe(dev):
        probed.append(dev.type)
        return {"s_per_lane": 4e-9, "s_per_unique_sorted": 5e-9,
                "s_per_unique_unsorted": 6e-9}
    monkeypatch.setattr(device_rates, "_probe", probe)
    monkeypatch.setattr(device_rates, "_mem_cache", {})
    first = device_rates.get_device_rates("cpu")
    assert device_rates.get_device_rates("cpu") is first
    assert probed == ["cpu"] and first["source"] == "probe"
    on_disk = json.loads(path.read_text(encoding="utf-8"))
    assert on_disk == first and on_disk["probed_at_ms"] > 0
    assert not list(tmp_path.glob("*.tmp"))

    def broken(dev):
        raise RuntimeError("probe failed")
    path.unlink()
    monkeypatch.setattr(device_rates, "_probe", broken)
    monkeypatch.setattr(device_rates, "_mem_cache", {})
    with pytest.raises(RuntimeError, match="probe failed"):
        device_rates.get_device_rates("cpu")


def test_rate_probe_runs_on_the_cpu_device(monkeypatch):
    """The probe itself at small shapes: three positive rates from the
    words step and the sorted and shuffled digest."""
    for name, value in (("PROBE_SLOTS", 1 << 12), ("PROBE_LANES", 1 << 10),
                        ("PROBE_STEPS", 2)):
        monkeypatch.setattr(device_rates, name, value)
    rates = device_rates._probe(torch.device("cpu"))
    assert set(rates) == set(device_rates.FALLBACK_RATES)
    assert all(v > 0 for v in rates.values())


# -- a forced pipelined plan through the stream loops ------------------------
PLANS = {
    "chunk": {"kind": "pipelined", "chunk": 600, "ref": 1e9, "passes": 0,
              "best": None},
    "schedule": {"kind": "pipelined", "schedule": (256, 1024, 512),
                 "chunk": 1024, "ref": 1e9, "giant_wall": 1e9,
                 "passes": 0, "best": None},
}


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["relay", "weighted"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_pipelined_plan_decides_like_reference(monkeypatch, weighted, plan):
    """The reference's forced-plan scenario (``tests/test_tpu_storage.py:
    test_chunk_plan_pipelined_preserves_decisions``) on both packages,
    ``_RELAY_CHUNK`` 256 and ``_RELAY_CHUNK_MAX`` 2^14 on both modules:
    decisions equal pass for pass, the chunks' sizes equal, and the plan
    still pipelined after three passes."""
    require_reference_native()
    for mod in (gpu_mod, ref_mod):
        monkeypatch.setattr(mod, "_RELAY_CHUNK", 256)
        monkeypatch.setattr(mod, "_RELAY_CHUNK_MAX", 1 << 14)
    now = [1_000_000]
    rng = np.random.default_rng(3)
    n = 4096
    ids = rng.integers(0, 1500, n).astype(np.int64)
    perms = rng.integers(1, 8, n).astype(np.int64) if weighted else None
    key = (("weighted", "ints", "tb", n) if weighted
           else ("relay", "ints", "tb", False, n))
    cfg = dict(max_permits=20, window_ms=60_000, refill_rate=1.0)
    port = GpuBatchedStorage(num_slots=4096, clock_ms=lambda: now[0],
                             device="cpu", host_parallel=0)
    ref = TpuBatchedStorage(num_slots=4096, clock_ms=lambda: now[0],
                            host_parallel=0)
    try:
        lid = port.register_limiter("tb", RateLimitConfig(**cfg))
        assert ref.register_limiter("tb", RefConfig(**cfg)) == lid
        for st in (port, ref):
            st._chunk_plans[key] = dict(PLANS[plan])
        for _ in range(3):
            ref.stream_stats = stats = []
            want = ref.acquire_stream_ids("tb", lid, ids, perms)
            ref.stream_stats = None
            got = port.acquire_stream_ids("tb", lid, ids, perms)
            np.testing.assert_array_equal(got, want)
            sizes = [rec["requests"] for rec in port.last_stream_chunks]
            assert sizes == [rec["n"] for rec in stats]
            assert sizes == (
                [600] * 6 + [496] if plan == "chunk"
                else [256, 1024, 512, 512, 512, 512, 512, 256])
            now[0] += 700
        assert port._chunk_plans[key]["kind"] == "pipelined"
        assert port._chunk_plans[key]["passes"] == 3
        np.testing.assert_array_equal(port.engine.tb_packed.numpy(),
                                      np.asarray(ref.engine.tb_packed))
    finally:
        port.close()
        ref.close()


def test_giant_passes_record_the_plan_like_reference(monkeypatch):
    """Profiled giant passes of a stream past 4 * ``_RELAY_CHUNK``: both
    storages record a provisional giant plan after the first pass, and
    every chunk record carries its wire bytes."""
    require_reference_native()
    for mod in (gpu_mod, ref_mod):
        monkeypatch.setattr(mod, "_RELAY_CHUNK", 256)
        monkeypatch.setattr(mod, "_RELAY_CHUNK_MAX", 1 << 14)
    rng = np.random.default_rng(8)
    n = 4096
    ids = rng.integers(0, 3000, n).astype(np.int64)
    cfg = dict(max_permits=20, window_ms=60_000, refill_rate=1.0)
    port = GpuBatchedStorage(num_slots=4096, clock_ms=lambda: 5_000,
                             device="cpu", host_parallel=0)
    ref = TpuBatchedStorage(num_slots=4096, clock_ms=lambda: 5_000,
                            host_parallel=0)
    try:
        lid = port.register_limiter("tb", RateLimitConfig(**cfg))
        ref.register_limiter("tb", RefConfig(**cfg))
        for st in (port, ref):
            st._device_rates_obj = dict(RATES)
            st.set_link_profile(1e9, 1e-4, 1e9)
        np.testing.assert_array_equal(
            port.acquire_stream_ids("tb", lid, ids),
            ref.acquire_stream_ids("tb", lid, ids))
        key = ("relay", "ints", "tb", False, n)
        for st in (port, ref):
            plan = st._chunk_plans[key]
            assert (plan["kind"], plan["passes"]) == ("giant", 1)
        assert all(rec["wire_bytes"] > 0 for rec in port.last_stream_chunks)
    finally:
        port.close()
        ref.close()


# -- the service's boot probe -------------------------------------------------
@pytest.mark.parametrize("enabled", [True, False])
def test_build_app_probes_the_link(enabled):
    """``link.probe.enabled`` (on by default) probes the link on the raw
    device storage at boot; off, the storage keeps no profile."""
    values = {**AppProperties.load("application.properties")._values,
              "storage.num_slots": "4096"}
    if not enabled:
        values["link.probe.enabled"] = "false"
    ctx = build_app(AppProperties(values), device="cpu")
    try:
        raw = ctx.storage._inner._inner
        assert isinstance(raw, GpuBatchedStorage)
        if enabled:
            assert raw._link_profile is not None
            assert all(v > 0 for v in raw._link_profile)
        else:
            assert raw._link_profile is None
    finally:
        ctx.close()
