"""The port's durability surface against the JAX package's, on the CPU.

- The whole-state pack / unpack of both algorithms
  (``ops/sliding_window.py``, ``ops/token_bucket.py``) and the engine's
  ``sw_state`` / ``tb_state`` views equal the reference's, extreme field
  values included; setting a view writes the resident tensor in place.
- The C index's fingerprint enumeration (``dump_fp``, ``restore_fp``,
  ``lookup_fps``) and the partitioned index's (``dump_fp``,
  ``lookup_fps``) equal the reference's, and a restored index evicts
  what the reference's evicts.
- Checkpoints interchange: what one package saves the other restores, at
  ``host_parallel`` 0 and 4, token bucket and sliding window, and the
  decisions, packed rows and index after the restore (eviction churn
  included) equal the reference package's own restore and the oracle.
  Both packages write the same files from the same state.  The
  reference's format 1 and 2 dumps restore; corrupted files are refused.
- Per-key export / import, fingerprint and keyed, both directions, with
  the capacity refusal and the eviction order after an import; the
  limiter-policy reconciliation's drift cases.
- A restore serves a micro decision, a lease step and a hybrid-tier
  serve from the resident tensors it wrote in place.

Every comparison is exact.  Every storage pair pins ``host_parallel``.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine import checkpoint as ref_ckpt
from ratelimiter_tpu.engine import native_index as ref_native
from ratelimiter_tpu.engine.partitioned import (
    PartitionedSlotIndex as RefPartitioned,
)
from ratelimiter_tpu.engine.state import SWState as RefSWState
from ratelimiter_tpu.engine.state import TBState as RefTBState
from ratelimiter_tpu.ops import sliding_window as ref_sw
from ratelimiter_tpu.ops import token_bucket as ref_tb
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine import checkpoint as ckpt
from ratelimiter_tpu_torch.engine import native_index
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.partitioned import PartitionedSlotIndex
from ratelimiter_tpu_torch.engine.state import LimiterTable, SWState, TBState
from ratelimiter_tpu_torch.ops import sliding_window as port_sw
from ratelimiter_tpu_torch.ops import token_bucket as port_tb
from ratelimiter_tpu_torch.semantics import (
    SlidingWindowOracle,
    TokenBucketOracle,
)
from ratelimiter_tpu_torch.storage.gpu import (
    GpuBatchedStorage,
    elect_host_parallel,
)
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_760_000_000_000
SLOTS = 1 << 12
I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)
POLICIES = {"tb": dict(max_permits=20, window_ms=1000, refill_rate=5.0),
            "sw": dict(max_permits=20, window_ms=1000,
                       enable_local_cache=False)}
LIDS = {"tb": 1, "sw": 2}
ORACLES = {"tb": TokenBucketOracle, "sw": SlidingWindowOracle}


# -- helpers -------------------------------------------------------------------
def storage(ref: bool, clock, num_slots: int = SLOTS, host_parallel=0,
            **kw):
    """One package's storage on the test clock with the token bucket
    (lid 1) and the sliding window (lid 2) registered."""
    kw.setdefault("observability", False)
    kw.update(num_slots=num_slots, clock_ms=lambda: clock["t"],
              host_parallel=host_parallel)
    if ref:
        require_reference_native()
        st, cfg = TpuBatchedStorage(**kw), RefConfig
    else:
        st, cfg = GpuBatchedStorage(device="cpu", **kw), RateLimitConfig
    for algo in ("tb", "sw"):
        assert st.register_limiter(algo, cfg(**POLICIES[algo])) == LIDS[algo]
    return st


def oracle(algo: str):
    return ORACLES[algo](RateLimitConfig(**POLICIES[algo]))


def plan(rng, n_calls: int, n_keys: int, base: int = 0, size: int = 600,
         zipf: bool = True):
    """Seeded calls ``(clock step, kind, keys, permits)``: relay streams
    (int keys, unit permits), weighted streams (permits in [1, 5]),
    string streams, and synchronous string batches with permits."""
    calls = []
    for i in range(n_calls):
        raw = ((rng.zipf(1.3, size) - 1) % n_keys if zipf
               else rng.integers(0, n_keys, size))
        keys = base + raw
        kind = ("ids", "weighted", "strs", "many")[i % 4]
        if kind == "ids":
            call = (keys, None)
        elif kind == "weighted":
            call = (keys, rng.integers(1, 6, size))
        elif kind == "strs":
            call = ([f"s{k}" for k in keys], None)
        else:
            call = ([f"s{k}" for k in keys[:64]], rng.integers(1, 4, 64))
        calls.append((int(rng.integers(0, 300)), kind) + call)
    return calls


def apply(st, algo: str, kind: str, keys, permits) -> np.ndarray:
    lid = LIDS[algo]
    if kind in ("ids", "weighted"):
        return np.asarray(st.acquire_stream_ids(algo, lid, keys, permits))
    if kind == "strs":
        return np.asarray(st.acquire_stream_strs(algo, lid, keys))
    return np.asarray(st.acquire_many(algo, [lid] * len(keys), keys,
                                      [int(p) for p in permits])["allowed"])


def run(storages, algo: str, calls, clock, orc=None) -> None:
    """Each call on every storage at one clock: decisions equal (and equal
    to the oracle's, when given)."""
    for dt, kind, keys, permits in calls:
        clock["t"] += dt
        outs = [apply(st, algo, kind, keys, permits) for st in storages]
        for got in outs[1:]:
            np.testing.assert_array_equal(got, outs[0], err_msg=kind)
        if orc is not None:
            p = np.ones(len(keys), dtype=np.int64) if permits is None \
                else permits
            want = [orc.try_acquire(k, int(q), clock["t"]).allowed
                    for k, q in zip(keys, p)]
            np.testing.assert_array_equal(outs[0], want, err_msg=kind)


def packed(st, algo: str) -> np.ndarray:
    arr = getattr(st.engine, f"{algo}_packed")
    return (arr.numpy() if isinstance(arr, torch.Tensor)
            else np.asarray(arr))


def index_dump(st) -> dict:
    pkg = ckpt if isinstance(st, GpuBatchedStorage) else ref_ckpt
    return pkg.dump_slot_indexes(st)


def same(got, want, what="") -> None:
    """Equal nested dicts / lists of arrays and scalars, dtypes too."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), what
        for k in want:
            same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{what}[{i}]")
    else:
        assert got == want and type(got) is type(want), (what, got, want)


def same_storages(a, b, algos=("tb", "sw")) -> None:
    for algo in algos:
        np.testing.assert_array_equal(packed(a, algo), packed(b, algo))
    same(index_dump(a), index_dump(b))


def close(*storages) -> None:
    for st in storages:
        st.close()


# -- (a) pack / unpack and the engine's state views -----------------------------
def _fields(rng, n: int, k: int) -> np.ndarray:
    """k int64 fields of n values: random, small, and int32 / int64
    extremes."""
    out = rng.integers(I64.min, I64.max, (k, n), dtype=np.int64)
    edges = np.array([0, 1, -1, I32.min, I32.max, I32.max + 1, I32.min - 1,
                      I64.min, I64.max, 1 << 40, -(1 << 40)], dtype=np.int64)
    out[:, :len(edges)] = edges
    out[:, len(edges):2 * n // 3] = rng.integers(-(1 << 33), 1 << 33,
                                                 (k, 2 * n // 3 - len(edges)))
    return out


@pytest.mark.parametrize("algo", ["sw", "tb"])
def test_pack_unpack_state_matches_reference(algo):
    rng = np.random.default_rng(7 if algo == "sw" else 8)
    n = 3000
    if algo == "sw":
        pack, unpack = port_sw.sw_pack_state, port_sw.sw_unpack_state
        rpack, runpack = ref_sw.sw_pack_state, ref_sw.sw_unpack_state
        kind, rkind, lanes = SWState, RefSWState, 6
    else:
        pack, unpack = port_tb.tb_pack_state, port_tb.tb_unpack_state
        rpack, runpack = ref_tb.tb_pack_state, ref_tb.tb_unpack_state
        kind, rkind, lanes = TBState, RefTBState, 4
    fields = _fields(rng, n, len(kind._fields))
    got = pack(kind(*(torch.from_numpy(f.copy()) for f in fields))).numpy()
    want = np.asarray(rpack(rkind(*fields)))
    assert got.dtype == want.dtype == np.int32 and got.shape == (n, lanes)
    np.testing.assert_array_equal(got, want)
    rows = rng.integers(I32.min, I32.max, (n, lanes), dtype=np.int64
                        ).astype(np.int32)
    rows[:8] = [[I32.min] * lanes, [I32.max] * lanes, [0] * lanes,
                [-1] * lanes, [1] * lanes, [I32.max, I32.min] * (lanes // 2),
                [I32.min, I32.max] * (lanes // 2), [-1, 0] * (lanes // 2)]
    for g, w in zip(unpack(torch.from_numpy(rows)), runpack(rows)):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # A round trip through the packed form is exact (the sliding window's
    # deadline offsets are stored non-negative: a negative one encodes
    # as 0, an equally dead deadline).
    if algo == "sw":
        rows[:, 4:] &= I32.max
    for g, w in zip(unpack(torch.from_numpy(rows.copy())),
                    unpack(pack(unpack(torch.from_numpy(rows.copy()))))):
        assert torch.equal(g, w)


def test_engine_state_views_write_the_resident_tensors_in_place():
    rng = np.random.default_rng(9)
    table = LimiterTable(device="cpu")
    eng = DeviceEngine(64, table, device="cpu")
    sw_ref, tb_ref = eng.sw_packed, eng.tb_packed
    ptrs = (sw_ref.data_ptr(), tb_ref.data_ptr())
    sw = SWState(*_fields(rng, 64, 5))
    tb = TBState(*_fields(rng, 64, 2))
    eng.sw_state = sw  # numpy fields
    eng.tb_state = TBState(*(torch.from_numpy(f) for f in tb))  # tensors
    assert eng.sw_packed is sw_ref and eng.tb_packed is tb_ref
    assert (eng.sw_packed.data_ptr(), eng.tb_packed.data_ptr()) == ptrs
    np.testing.assert_array_equal(
        eng.sw_packed.numpy(), np.asarray(ref_sw.sw_pack_state(RefSWState(
            *sw))))
    np.testing.assert_array_equal(
        eng.tb_packed.numpy(), np.asarray(ref_tb.tb_pack_state(RefTBState(
            *tb))))
    # Reading a view decodes; the decoded tensors do not alias the state.
    view = eng.tb_state
    np.testing.assert_array_equal(view.tokens_fp.numpy(), tb.tokens_fp)
    view.tokens_fp.zero_()
    np.testing.assert_array_equal(eng.tb_state.tokens_fp.numpy(),
                                  tb.tokens_fp)
    with pytest.raises(ValueError, match="shape"):
        eng.sw_state = SWState(*_fields(rng, 63, 5))


# -- (b) fingerprint enumeration of the host indexes ------------------------------
def _churn_index(port_ix, ref_ix, rng, rounds: int, n_keys: int,
                 base: int = 0) -> None:
    """The same int and string batches through both indexes (evictions
    included): slots and clears equal."""
    for r in range(rounds):
        keys = base + rng.integers(0, n_keys, 300)
        lid = 1 + r % 3
        if r % 2:
            strs = [f"k{k}" for k in keys]
            got = port_ix.assign_batch_strs(strs, lid)
            want = ref_ix.assign_batch_strs(strs, lid)
        else:
            got = port_ix.assign_batch_ints(keys, lid)
            want = ref_ix.assign_batch_ints(keys, lid)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(np.sort(np.asarray(got[1])),
                                      np.sort(np.asarray(want[1])))


@pytest.mark.parametrize("kind", ["native", "partitioned"])
def test_index_dump_restore_lookup_match_reference(kind):
    require_reference_native()
    rng = np.random.default_rng(11)
    n = 1024
    if kind == "native":
        port_ix = native_index.NativeSlotIndex(n)
        ref_ix = ref_native.NativeSlotIndex(n)
    else:
        port_ix = PartitionedSlotIndex(n, 4)
        ref_ix = RefPartitioned(n, 4)
    try:
        _churn_index(port_ix, ref_ix, rng, 12, 1600)
        dump = port_ix.dump_fp()
        same(dump, ref_ix.dump_fp())
        assert len(dump[0]) == len(port_ix) == n  # full: churn evicted
        h1, h2 = dump[0].copy(), dump[1].copy()
        h1[::7] ^= np.uint64(0x5555)  # absent fingerprints in the mix
        same(port_ix.lookup_fps(h1, h2), ref_ix.lookup_fps(h1, h2))
        # Restore into fresh indexes of each package: the same LRU order,
        # so the same keys are evicted by the same later traffic.
        if kind == "native":
            port2 = native_index.NativeSlotIndex(n)
            ref2 = ref_native.NativeSlotIndex(n)
            port2.restore_fp(*dump)
            ref2.restore_fp(*dump)
        else:
            port2 = PartitionedSlotIndex(n, 4)
            ref2 = RefPartitioned(n, 4)
            for p in range(4):
                part = port_ix._parts[p].dump_fp()
                port2._parts[p].restore_fp(*part)
                ref2._parts[p].restore_fp(*part)
        same(port2.dump_fp(), dump)
        _churn_index(port2, ref2, rng, 8, 2400, base=10_000)
        same(port2.dump_fp(), ref2.dump_fp())
        if kind == "native":
            # A bad dump is refused by both and leaves the index empty.
            bad = (dump[0][:3], dump[1][:3], np.array([5, 5, 6], np.int32))
            for ix in (port2, ref2):
                with pytest.raises(ValueError, match="invalid"):
                    ix.restore_fp(*bad)
                assert len(ix) == 0
        else:
            port2.close()
            ref2.close()
    finally:
        if kind == "partitioned":
            port_ix.close()
            ref_ix.close()


# -- (c) checkpoints: interchange, files, older formats, corruption -------------
@pytest.mark.parametrize("algo", ["tb", "sw"])
@pytest.mark.parametrize("host_parallel", [0, 4])
@pytest.mark.parametrize("saver", ["reference", "port"])
def test_checkpoint_interchange(tmp_path, saver, host_parallel, algo):
    """One package saves, the other restores; the saver's own package
    restores the same files beside it.  The next calls decide alike on
    both and as the oracle (no eviction), then an eviction churn leaves
    the same rows and the same index on both."""
    rng = np.random.default_rng(100 + 10 * host_parallel + (algo == "sw"))
    clock = {"t": T0}
    src_ref = saver == "reference"
    pre, post = plan(rng, 8, 500), plan(rng, 8, 500)
    churn = plan(rng, 4, 20_000, base=1_000_000, size=3000, zipf=False)
    orc = oracle(algo)
    src = storage(src_ref, clock, host_parallel=host_parallel)
    tgt = twin = None
    try:
        run([src], algo, pre, clock, orc)
        path = str(tmp_path / "ckpt")
        src.save_checkpoint(path)
        tgt = storage(not src_ref, clock, host_parallel=host_parallel)
        twin = storage(src_ref, clock, host_parallel=host_parallel)
        tgt.restore_checkpoint(path)
        twin.restore_checkpoint(path)
        same_storages(tgt, twin)
        same_storages(tgt, src)
        run([tgt, twin, src], algo, post, clock, orc)
        same_storages(tgt, twin)
        run([tgt, twin], algo, churn, clock)
        same_storages(tgt, twin)
    finally:
        close(*(s for s in (src, tgt, twin) if s is not None))


@pytest.mark.parametrize("index", ["native", "partitioned", "keyed"])
def test_both_packages_write_the_same_files(tmp_path, index):
    """From the same traffic both packages write the same arrays (names,
    dtypes, values) and the same manifest but for its time stamp."""
    kw = {"native": dict(host_parallel=0),
          "partitioned": dict(host_parallel=4),
          "keyed": dict(host_parallel=0, checkpointable=True)}[index]
    rng = np.random.default_rng(31)
    calls = {algo: plan(rng, 6, 400) for algo in ("tb", "sw")}
    files = {}
    for ref in (True, False):
        clock = {"t": T0}
        st = storage(ref, clock, **kw)
        try:
            for algo in ("tb", "sw"):
                run([st], algo, calls[algo], clock)
            path = str(tmp_path / f"ckpt-{ref}")
            st.save_checkpoint(path)
        finally:
            st.close()
        arrays = dict(np.load(os.path.join(path, "state.npz")))
        with open(os.path.join(path, "index.json")) as fh:
            meta = json.load(fh)
        assert isinstance(meta["taken_at_ms"], int)
        for k in ("taken_at_ms", "manifest_crc"):
            meta.pop(k)
        files[ref] = (arrays, meta)
    same(files[False], files[True])
    arrays, meta = files[False]
    assert meta["format"] == 3 and meta["num_slots"] == SLOTS
    for algo, fields in (("sw", SWState._fields), ("tb", TBState._fields)):
        for f in fields:
            assert arrays[f"{algo}_{f}"].dtype == np.int64
            assert arrays[f"{algo}_{f}"].shape == (SLOTS,)
    kinds = {a: p["kind"] for a, p in meta["index"]["algos"].items()}
    assert set(kinds.values()) == {{"native": "native_fp",
                                     "partitioned": "partitioned_native_fp",
                                     "keyed": "flat"}[index]}


@pytest.mark.parametrize("version", [1, 2])
def test_reference_older_formats_restore_in_the_port(tmp_path, version):
    """A format 2 dump (no checksums) and a format 1 dump (no checksums,
    a stored ``tb_deadline`` array) restore in the port as in the
    reference."""
    rng = np.random.default_rng(40 + version)
    clock = {"t": T0}
    src = storage(True, clock)
    tgt = twin = None
    try:
        run([src], "tb", plan(rng, 6, 300), clock)
        path = str(tmp_path / "old")
        src.save_checkpoint(path)
        idx = os.path.join(path, "index.json")
        with open(idx) as fh:
            meta = json.load(fh)
        meta["format"] = version
        meta.pop("checksums")
        meta.pop("manifest_crc")
        with open(idx, "w") as fh:
            json.dump(meta, fh)
        if version == 1:
            npz = os.path.join(path, "state.npz")
            arrays = dict(np.load(npz))
            arrays["tb_deadline"] = arrays["tb_last_refill"] + 2000
            np.savez(npz, **arrays)
        assert ckpt.load_checkpoint(path)["meta"]["format"] == version
        tgt, twin = storage(False, clock), storage(True, clock)
        tgt.restore_checkpoint(path)
        twin.restore_checkpoint(path)
        same_storages(tgt, twin)
        run([tgt, twin], "tb", plan(rng, 4, 300), clock)
        same_storages(tgt, twin)
    finally:
        close(*(s for s in (src, tgt, twin) if s is not None))


def _small_checkpoint(tmp_path, clock):
    """A port checkpoint of a little traffic, and the storage that wrote
    it (still open)."""
    st = storage(False, clock)
    run([st], "sw", plan(np.random.default_rng(5), 3, 50), clock)
    path = str(tmp_path / "ckpt")
    st.save_checkpoint(path)
    return st, path


def _refused_everywhere(st, path, match=None) -> None:
    """Both packages' loaders refuse ``path`` with their typed error, and
    the port's restore raises before it touches the state."""
    before = (packed(st, "sw").copy(), index_dump(st))
    with pytest.raises(ckpt.CheckpointCorruptError, match=match):
        ckpt.load_checkpoint(path)
    with pytest.raises(ref_ckpt.CheckpointCorruptError, match=match):
        ref_ckpt.load_checkpoint(path)
    with pytest.raises(ckpt.CheckpointCorruptError, match=match):
        st.restore_checkpoint(path)
    np.testing.assert_array_equal(packed(st, "sw"), before[0])
    same(index_dump(st), before[1])


def test_checkpoint_bit_flip_refused(tmp_path):
    clock = {"t": T0}
    st, path = _small_checkpoint(tmp_path, clock)
    try:
        npz = os.path.join(path, "state.npz")
        blob = bytearray(open(npz, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(npz, "wb") as fh:
            fh.write(bytes(blob))
        _refused_everywhere(st, path)
    finally:
        st.close()


def test_checkpoint_truncated_npz_refused(tmp_path):
    clock = {"t": T0}
    st, path = _small_checkpoint(tmp_path, clock)
    try:
        npz = os.path.join(path, "state.npz")
        blob = open(npz, "rb").read()
        with open(npz, "wb") as fh:
            fh.write(blob[: len(blob) // 3])
        _refused_everywhere(st, path)
    finally:
        st.close()


def test_checkpoint_manifest_tamper_refused(tmp_path):
    clock = {"t": T0}
    st, path = _small_checkpoint(tmp_path, clock)
    try:
        idx = os.path.join(path, "index.json")
        meta = json.load(open(idx))
        meta["num_slots"] = 999  # a geometry lie the checksum must catch
        with open(idx, "w") as fh:
            json.dump(meta, fh)
        _refused_everywhere(st, path, match="manifest")
    finally:
        st.close()


def test_checkpoint_geometry_and_partition_refusals(tmp_path):
    clock = {"t": T0}
    st = storage(False, clock, host_parallel=4)
    others = []
    try:
        run([st], "tb", plan(np.random.default_rng(6), 3, 80), clock)
        path = str(tmp_path / "ckpt")
        st.save_checkpoint(path)
        for kw, match in ((dict(num_slots=2 * SLOTS, host_parallel=4),
                           "geometry"),
                          (dict(host_parallel=2), "4 partitions"),
                          (dict(host_parallel=0), "4 partitions")):
            for ref in (False, True):
                other = storage(ref, clock, **kw)
                others.append(other)
                with pytest.raises(ValueError, match=match):
                    other.restore_checkpoint(path)
    finally:
        close(st, *others)


# -- (d) per-key export / import ---------------------------------------------------
@pytest.mark.parametrize("source_parallel", [0, 4])
@pytest.mark.parametrize("exporter", ["reference", "port"])
def test_fp_export_imports_both_ways(exporter, source_parallel):
    """A fingerprint export of a storage on ``source_parallel`` partitions
    imports into a larger flat storage of the other package and of its
    own; both continue alike and as the oracle, and an eviction churn
    after the import evicts the same keys on both."""
    rng = np.random.default_rng(200 + source_parallel)
    clock = {"t": T0}
    src_ref = exporter == "reference"
    orcs = {algo: oracle(algo) for algo in ("tb", "sw")}
    src = storage(src_ref, clock, host_parallel=source_parallel)
    targets = []
    try:
        for algo in ("tb", "sw"):
            run([src], algo, plan(rng, 6, 400), clock, orcs[algo])
        dump = src.export_keys()
        assert {p["kind"] for p in dump["algos"].values()} == {"fp"}
        targets = [storage(ref, clock, num_slots=2 * SLOTS)
                   for ref in (not src_ref, src_ref)]
        for tgt in targets:
            tgt.import_keys(dump)
        same_storages(*targets)
        for algo in ("tb", "sw"):
            run(targets + [src], algo, plan(rng, 4, 400), clock, orcs[algo])
        same_storages(*targets)
        run(targets, "tb", plan(rng, 4, 40_000, base=5_000_000, size=3000,
                                zipf=False), clock)
        same_storages(*targets)
    finally:
        close(src, *targets)


@pytest.mark.parametrize("target_parallel", [0, 4])
@pytest.mark.parametrize("exporter", ["reference", "port"])
def test_keyed_export_imports_into_another_geometry(exporter,
                                                    target_parallel):
    """A keyed export (``checkpointable=True``) carries the keys, so it
    imports into a storage of another size and partition count; the
    port's import equals the reference's, decisions follow the oracle,
    and churn after the import evicts the same keys."""
    rng = np.random.default_rng(300 + target_parallel)
    clock = {"t": T0}
    src_ref = exporter == "reference"
    orcs = {algo: oracle(algo) for algo in ("tb", "sw")}
    src = storage(src_ref, clock, checkpointable=True)
    targets = []
    try:
        for algo in ("tb", "sw"):
            run([src], algo, plan(rng, 4, 300, size=200), clock, orcs[algo])
        dump = src.export_keys()
        assert all(isinstance(e, list) and e for e in dump["algos"].values())
        json.dumps(dump)  # keys and rows are plain JSON values
        targets = [storage(ref, clock, num_slots=2 * SLOTS,
                           host_parallel=target_parallel)
                   for ref in (not src_ref, src_ref)]
        for tgt in targets:
            tgt.import_keys(dump)
        same_storages(*targets)
        for algo in ("tb", "sw"):
            run(targets, algo, plan(rng, 4, 300, size=200), clock,
                orcs[algo])
        same_storages(*targets)
        run(targets, "sw", plan(rng, 4, 40_000, base=5_000_000, size=3000,
                                zipf=False), clock)
        same_storages(*targets)
    finally:
        close(src, *targets)


@pytest.mark.parametrize("kind", ["fp", "keyed"])
def test_import_refuses_a_target_too_small(kind):
    clock = {"t": T0}
    kw = dict(checkpointable=True) if kind == "keyed" else {}
    src = storage(False, clock, **kw)
    small = []
    try:
        run([src], "tb", plan(np.random.default_rng(8), 2, 3000, size=2000,
                              zipf=False), clock)
        dump = src.export_keys()
        for ref in (False, True):
            tgt = storage(ref, clock, num_slots=256)
            small.append(tgt)
            before = packed(tgt, "tb").copy()
            with pytest.raises(ValueError, match="too small"):
                tgt.import_keys(dump)
            np.testing.assert_array_equal(packed(tgt, "tb"), before)
            assert len(tgt._index["tb"]) == 0
    finally:
        close(src, *small)


def test_fp_import_into_partitions_refused():
    """Fingerprints do not say how their key routed: both packages refuse
    a fingerprint import into a partitioned target."""
    clock = {"t": T0}
    src = storage(False, clock)
    tgts = []
    try:
        run([src], "tb", plan(np.random.default_rng(9), 2, 100), clock)
        dump = src.export_keys()
        for ref in (False, True):
            tgt = storage(ref, clock, host_parallel=4)
            tgts.append(tgt)
            with pytest.raises(ValueError, match="flat native-index"):
                tgt.import_keys(dump)
    finally:
        close(src, *tgts)


def _policies(st) -> dict:
    info = st.policy_info()
    return {"generation": int(info["generation"]),
            "lids": {int(k): dict(v) for k, v in info["lids"].items()}}


POLICY_CASES = {
    # name: (edit of the dump's rows, register_missing, error or None)
    "missing_lid": (lambda d: d.update({"3": dict(d["1"])}), False,
                    "not registered"),
    "register_missing": (lambda d: d.update({"3": dict(d["1"], gen=4)}),
                         True, None),
    "shape_drift": (lambda d: d["2"].update(window_ms=2000), False,
                    "algo/window"),
    "rate_drift_without_generation": (
        lambda d: d["1"].update(max_permits=30), False, "mismatch"),
    "rate_drift_with_newer_generation": (
        lambda d: d["1"].update(max_permits=30, refill_rate=7.5, gen=6),
        False, None),
    "same_rates_newer_generation": (lambda d: d["2"].update(gen=9), False,
                                    None),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_apply_limiter_policies_drift_cases(case):
    """``apply_limiter_policies`` on both packages from the same dump:
    the same refusal, or the same policies and generations after."""
    edit, register, err = POLICY_CASES[case]
    clock = {"t": T0}
    out = {}
    for ref in (False, True):
        st = storage(ref, clock)
        try:
            pkg = ref_ckpt if ref else ckpt
            dump = json.loads(json.dumps(pkg.limiter_policy_dump(st)))
            edit(dump)
            if err is not None:
                with pytest.raises(ValueError, match=err):
                    pkg.apply_limiter_policies(st, dump,
                                               register_missing=register)
            else:
                pkg.apply_limiter_policies(st, dump,
                                           register_missing=register)
            out[ref] = _policies(st)
        finally:
            st.close()
    same(out[False], out[True])
    if case == "rate_drift_with_newer_generation":
        assert out[False]["lids"][1]["max_permits"] == 30
        assert out[False]["lids"][1]["generation"] == 6
    if case == "same_rates_newer_generation":
        assert out[False]["generation"] == 9


# -- (e) the keyed index and the restore's resident tensors ------------------------
def test_checkpointable_election_and_refusal():
    assert elect_host_parallel(1 << 20, checkpointable=True) == 0
    for ref in (False, True):
        with pytest.raises(ValueError, match="checkpointable=True"):
            storage(ref, {"t": T0}, host_parallel=4, checkpointable=True)
    clock = {"t": T0}
    st = storage(False, clock, num_slots=1 << 16, host_parallel=None,
                 checkpointable=True)
    try:
        assert st._host_parallel == 0 and hasattr(st._index["tb"], "_map")
    finally:
        st.close()


def test_keyed_storage_matches_reference_on_every_surface():
    """``checkpointable=True`` on both packages: micro decisions, batches,
    int and string streams and the lease steps decide alike and leave
    the same rows and the same keyed index (eviction churn included)."""
    rng = np.random.default_rng(12)
    clock = {"t": T0}
    sides = [storage(ref, clock, num_slots=512, checkpointable=True)
             for ref in (False, True)]
    try:
        for algo in ("tb", "sw"):
            run(sides, algo, plan(rng, 8, 900, size=300), clock)
            ids = rng.integers(0, 900, 64)
            permits = rng.integers(1, 3, 64)
            outs = [st.acquire_many_ids(algo, LIDS[algo], ids, permits)
                    ["allowed"] for st in sides]
            np.testing.assert_array_equal(outs[0], outs[1])
            for k in ("s1", "s2", "fresh"):
                clock["t"] += 7
                got = [st.acquire(algo, LIDS[algo], k, 2)["allowed"]
                       for st in sides]
                assert bool(got[0]) == bool(got[1])
                got = [st.lease_reserve(algo, LIDS[algo], k, 5)
                       for st in sides]
                assert got[0] == got[1]
                got = [st.lease_credit(algo, LIDS[algo], k, 2,
                                       got[0]["ws"]) for st in sides]
                assert got[0] == got[1]
        same_storages(*sides)
    finally:
        close(*sides)


def test_restore_serves_micro_lease_and_hybrid_from_the_same_tensors(
        tmp_path):
    """Right after a restore into a storage with the hybrid tier on, a
    micro decision, a lease step and hybrid-tier serves go through the
    resident tensors the restore wrote in place; the port answers as the
    reference and as the oracle."""
    rng = np.random.default_rng(13)
    clock = {"t": T0}
    src = storage(False, clock)
    sides = []
    try:
        orc = oracle("tb")
        run([src], "tb", plan(rng, 4, 200), clock, orc)
        path = str(tmp_path / "ckpt")
        src.save_checkpoint(path)
        sides = [storage(ref, clock, serving_cache=True, max_delay_ms=0.1)
                 for ref in (False, True)]
        port = sides[0]
        held = (port.engine.tb_packed, port.engine.sw_packed)
        ptrs = tuple(t.data_ptr() for t in held)
        for st in sides:
            st.restore_checkpoint(path)
        assert (port.engine.tb_packed, port.engine.sw_packed) == held
        assert tuple(t.data_ptr() for t in held) == ptrs
        same_storages(*sides)
        clock["t"] += 5
        # A restored key's micro decision, then fresh keys: their first
        # device decisions see full buckets, so the tier adopts them and
        # serves the repeats host-side.
        keys = ["s1", "s2"] + [f"n{i}" for i in range(4)]
        for _ in range(4):
            for k in keys:
                got = [st.acquire("tb", 1, k, 2) for st in sides]
                d = orc.try_acquire(k, 2, clock["t"])
                for out in got:
                    assert (bool(out["allowed"]), int(out["observed"])) == (
                        d.allowed, d.observed), k
        assert port._serving.stats()["served"] > 0
        got = [st.lease_reserve("tb", 1, "s3", 4) for st in sides]
        assert got[0] == got[1]
        assert got[0]["granted"] == orc.reserve("s3", 4, clock["t"])[0]
        for st in sides:
            st.flush()
        same_storages(*sides)
    finally:
        close(src, *sides)


@pytest.mark.parametrize("rewrite", ["restore", "import"])
def test_rewritten_rows_are_not_served_from_the_hybrid_tier(tmp_path,
                                                            rewrite):
    """ROADMAP C9.  A restore (or an import) rewrites rows under keys the
    hybrid tier adopted.  The port's tier forgets them, so the next
    decisions follow the rewritten state, as the oracle does.  The
    reference's ``restore_checkpoint`` and ``import_keys`` leave the
    tier's adopted state in place: its next serves answer from the state
    before the rewrite."""
    clock = {"t": T0}
    keys = [f"h{i}" for i in range(6)]
    sides = [storage(ref, clock, serving_cache=True, max_delay_ms=0.1)
             for ref in (False, True)]
    donors = []
    try:
        orc = oracle("tb")

        def decide(rounds, permits):
            """Each key ``rounds`` times on both storages: (allowed,
            observed) of each, and the oracle's."""
            out = []
            for _ in range(rounds):
                for k in keys:
                    d = orc.try_acquire(k, permits, clock["t"])
                    got = [st.acquire("tb", 1, k, permits) for st in sides]
                    out.append([(bool(g["allowed"]), int(g["observed"]))
                                for g in got] + [(d.allowed, d.observed)])
                for st in sides:
                    st.flush()
            return out

        for port, ref, want in decide(2, 3):
            assert port == ref == want
        assert all(st._serving.stats()["tracked"] == 6 for st in sides)
        if rewrite == "restore":
            paths = [str(tmp_path / f"ckpt{i}") for i in range(2)]
            for st, path in zip(sides, paths):
                st.save_checkpoint(path)
            saved = copy.deepcopy(orc)
            for port, ref, want in decide(4, 4):  # drains the buckets
                assert port == ref == want
            for st, path in zip(sides, paths):
                st.restore_checkpoint(path)
            orc = saved
        else:
            # Donors hold the same keys one permit in; their exports
            # overwrite the adopted keys' rows.
            donors = [storage(ref, clock) for ref in (False, True)]
            orc = oracle("tb")
            for k in keys:
                orc.try_acquire(k, 1, clock["t"])
                for st in donors:
                    assert st.acquire("tb", 1, k, 1)["allowed"]
            for st, donor in zip(sides, donors):
                st.import_keys(donor.export_keys())
        clock["t"] += 3
        after = decide(1, 4)
        assert all(port == want for port, _, want in after), after
        assert any(ref != want for _, ref, want in after), after
    finally:
        close(*sides, *donors)
