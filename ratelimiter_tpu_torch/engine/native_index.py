"""ctypes binding for the C slot index (``native/slot_index.cpp``).

The port's own copy of ``ratelimiter_tpu/engine/native_index.py``, cut to
what the micro route and the stream routes use: the scalar
``SlotIndex`` interface (``get``, ``assign``, ``remove``, ``len``), the
batched string-key and int-key assigns (one limiter, or one limiter per
request; plain or unique-compacting; string keys hashed once into
fingerprints, which the partitioned index also routes by), held pins and
their release, the routing passes of the partitioned index
(``shard_route``, ``route_hashes``) and of the sharded engine
(``shard_route_gather``, ``route_hashes_gather``), the host passes of the
relay route (``sort_uniques``, ``relay_decide``, words mode's
``rebuild_words_into`` and the split digest's ``split_layout``), the two
of the weighted relay (``weighted_layout``, ``weighted_decide``), and the
fingerprint enumeration that checkpoints read and restore (``dump_fp``,
``restore_fp``, ``lookup_fps``).

The library is built at first use from the repository's
``native/slot_index.cpp`` with the recipe of ``native/Makefile``
(``g++ -O3 -march=native -fPIC -std=c++17 -shared``) into ``build/native/``
at the repository root, named by a hash of the source, the flags and the
processor ``-march=native`` resolves to: an edited source (or another
processor) builds anew, an unchanged one loads the library already built.
Nothing is written into ``native/`` and no library found there is loaded.
A failed build raises with the compiler's output; there is no fallback to
the pure-Python index.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Hashable, Optional, Set, Tuple

import numpy as np

from ratelimiter_tpu_torch.engine.errors import SlotCapacityError
from ratelimiter_tpu_torch.utils.tracing import (INDEX_HASH, INDEX_KEY_PACK,
                                                span)

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "slot_index.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None
_target = None


def _native_target() -> bytes:
    """What ``-march=native`` selects on this host, as g++ reports it: a
    checkout carried to another host with its build directory builds
    anew rather than loading code for another processor."""
    global _target
    if _target is None:
        try:
            res = subprocess.run(["g++", "-march=native", "-Q",
                                  "--help=target"], capture_output=True,
                                 timeout=120)
        except FileNotFoundError as exc:
            raise RuntimeError(f"C slot index build failed: {exc}") from exc
        if res.returncode != 0:
            raise RuntimeError("C slot index build failed: g++ could not "
                               "report its target\n"
                               + res.stderr.decode(errors="replace"))
        _target = res.stdout
    return _target


def library_path() -> Path:
    """Where the library is built: keyed by a hash of the source, the
    compiler flags and the processor they target."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()
                            + _native_target()).hexdigest()
    return BUILD_DIR / f"libslotindex-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"C slot index build failed: g++ exited "
                           f"{res.returncode}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib) -> None:
    """Declare the C ABI of the entry points the port calls."""
    vp, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_uint64)
    lib.rl_index_new.restype = vp
    lib.rl_index_new.argtypes = [i64]
    lib.rl_index_free.argtypes = [vp]
    lib.rl_index_len.restype = i64
    lib.rl_index_len.argtypes = [vp]
    lib.rl_index_assign_ints.argtypes = [vp, vp, i64, u64, vp, vp]
    lib.rl_index_assign_ints_multi.argtypes = [vp, vp, vp, i64, vp, vp]
    lib.rl_index_assign_bytes.argtypes = [vp, vp, vp, i64, u64, vp, vp]
    lib.rl_index_assign_ints_uniques.restype = i64
    lib.rl_index_assign_ints_uniques.argtypes = [vp, vp, i64, u64, i32, vp,
                                                 vp, vp, vp]
    lib.rl_index_assign_ints_multi_uniques.restype = i64
    lib.rl_index_assign_ints_multi_uniques.argtypes = [vp, vp, vp, i64, i32,
                                                       vp, vp, vp, vp]
    lib.rl_index_get_bytes.restype = i32
    lib.rl_index_get_bytes.argtypes = [vp, ctypes.c_char_p, i64, u64]
    lib.rl_index_get_int.restype = i32
    lib.rl_index_get_int.argtypes = [vp, i64, u64]
    lib.rl_index_remove_bytes.restype = i32
    lib.rl_index_remove_bytes.argtypes = [vp, ctypes.c_char_p, i64, u64]
    lib.rl_index_remove_int.restype = i32
    lib.rl_index_remove_int.argtypes = [vp, i64, u64]
    lib.rl_index_pin.argtypes = [vp, i32]
    lib.rl_index_pin_batch.argtypes = [vp, vp, i64]
    lib.rl_index_unpin_batch.argtypes = [vp, vp, i64]
    lib.rl_index_dump.restype = i64
    lib.rl_index_dump.argtypes = [vp, vp, vp, vp]
    lib.rl_index_restore.restype = i32
    lib.rl_index_restore.argtypes = [vp, vp, vp, vp, i64]
    lib.rl_index_lookup_fps.argtypes = [vp, vp, vp, i64, vp]
    lib.rl_relay_decide.argtypes = [vp, i32, vp, vp, i64, vp]
    lib.rl_sort_uniques.restype = i32
    lib.rl_sort_uniques.argtypes = [vp, i64, i32, vp, i64]
    lib.rl_weighted_layout.restype = i32
    lib.rl_weighted_layout.argtypes = [vp, i64, i32, vp, vp, i64, vp, i64,
                                       vp, vp, vp, vp]
    lib.rl_weighted_decide.argtypes = [vp, vp, vp, vp, vp, i64, vp]
    lib.rl_rebuild_words.argtypes = [vp, vp, vp, i64, i32, vp]
    lib.rl_split_layout.restype = i64
    lib.rl_split_layout.argtypes = [vp, i64, i32, vp, i64, vp, vp, vp, vp]
    lib.rl_index_assign_fps.argtypes = [vp, vp, vp, i64, vp, vp]
    lib.rl_index_assign_fps_uniques.restype = i64
    lib.rl_index_assign_fps_uniques.argtypes = [vp, vp, vp, i64, i32, vp, vp,
                                                vp, vp]
    lib.rl_hash_bytes_batch.argtypes = [vp, vp, i64, u64, vp, vp]
    lib.rl_shard_route.argtypes = [vp, i64, i32, vp, vp, vp]
    lib.rl_route_hashes.argtypes = [vp, i64, i32, vp, vp, vp]
    lib.rl_shard_route2.argtypes = [vp, i64, i32, vp, vp, vp, vp]
    lib.rl_route_hashes2.argtypes = [vp, vp, i64, i32, vp, vp, vp, vp, vp]


def relay_decide(counts: np.ndarray, uidx: np.ndarray,
                 rank: np.ndarray) -> np.ndarray:
    """allowed[i] = rank[i] < counts[uidx[i]] — the digest route's
    decision reconstruction, one C pass.  ``counts`` is the device's
    u8/u16 per-unique allowed counts."""
    if counts.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"relay_decide: counts must be uint8 or uint16, "
                         f"got {counts.dtype}")
    lib = _library()
    counts = np.ascontiguousarray(counts)
    uidx = np.ascontiguousarray(uidx, dtype=np.int32)
    rank = np.ascontiguousarray(rank, dtype=np.int32)
    if len(uidx) != len(rank):
        raise ValueError("relay_decide: uidx and rank differ in length")
    out = np.empty(len(uidx), dtype=np.uint8)
    lib.rl_relay_decide(counts.ctypes.data, counts.dtype.itemsize,
                        uidx.ctypes.data, rank.ctypes.data, len(uidx),
                        out.ctypes.data)
    return out.view(np.bool_)


def sort_uniques(uwords: np.ndarray, rank_bits: int,
                 uidx: np.ndarray) -> None:
    """Sort ``uwords`` by slot IN PLACE (radix on the slot field) and remap
    ``uidx`` to the new positions.  Decision reconstruction reads
    ``counts[uidx]``, so it is order-agnostic; the sort gives the device
    step ascending row addresses."""
    if not (isinstance(uwords, np.ndarray) and uwords.dtype == np.uint32
            and uwords.flags["C_CONTIGUOUS"]
            and isinstance(uidx, np.ndarray) and uidx.dtype == np.int32
            and uidx.flags["C_CONTIGUOUS"]):
        raise ValueError("sort_uniques: needs C-contiguous uint32 uwords "
                         "and int32 uidx")
    _library().rl_sort_uniques(uwords.ctypes.data, len(uwords),
                               int(rank_bits), uidx.ctypes.data, len(uidx))


def _require(arr, name: str, dtype, size: int | None = None) -> None:
    """Raise ValueError unless ``arr`` is a C-contiguous numpy array of
    ``dtype`` (with at least ``size`` elements when given): the C passes
    take raw pointers."""
    if not (isinstance(arr, np.ndarray) and arr.dtype == dtype
            and arr.flags["C_CONTIGUOUS"]):
        raise ValueError(f"{name}: needs a C-contiguous {np.dtype(dtype)} "
                         f"array")
    if size is not None and arr.size < size:
        raise ValueError(f"{name}: {arr.size} elements, needs {size}")


def rebuild_words_into(uwords: np.ndarray, uidx: np.ndarray,
                       rank: np.ndarray, rank_bits: int,
                       out: np.ndarray) -> None:
    """Words mode's per-request (slot | clamped rank | last) words from
    the digest output, written into ``out[:len(uidx)]`` (the caller's
    padded dispatch buffer) in one C pass.  Raises ValueError unless every array is a
    C-contiguous one of its dtype and ``out`` holds a lane per request."""
    n = len(uidx)
    _require(uwords, "uwords", np.uint32)
    _require(uidx, "uidx", np.int32)
    _require(rank, "rank", np.int32, n)
    _require(out, "out", np.uint32, n)
    _library().rl_rebuild_words(uwords.ctypes.data, uidx.ctypes.data,
                                rank.ctypes.data, n, int(rank_bits),
                                out.ctypes.data)


def weighted_layout(uwords: np.ndarray, rank_bits: int, uidx: np.ndarray,
                    rank: np.ndarray, perms: np.ndarray, r_b: int,
                    uw_sorted: np.ndarray, spos: np.ndarray,
                    roff: np.ndarray, perms_rank: np.ndarray) -> None:
    """The weighted relay's count-descending rank-major layout, in one C
    pass (``rl_weighted_layout``): the unique words sorted by their count
    field, descending and stable, into the caller-padded ``uw_sorted``;
    each unique's position there in ``spos``; the offset of each rank
    step's block in ``roff`` (``r_b`` entries); and each request's permits
    at ``roff[rank] + spos[uidx]`` of the caller-zeroed ``perms_rank``.
    Raises ValueError when a count field exceeds ``r_b`` or ``r_b`` is
    past the C pass's ceiling of 4096."""
    u, n = len(uwords), len(uidx)
    _require(uwords, "uwords", np.uint32)
    _require(uidx, "uidx", np.int32)
    _require(rank, "rank", np.int32, n)
    _require(perms, "perms", np.int64, n)
    _require(uw_sorted, "uw_sorted", np.uint32, u)
    _require(spos, "spos", np.int32, u)
    _require(roff, "roff", np.int64, r_b)
    _require(perms_rank, "perms_rank", np.uint8, n)
    rc = _library().rl_weighted_layout(
        uwords.ctypes.data, u, int(rank_bits), uidx.ctypes.data,
        rank.ctypes.data, n, perms.ctypes.data, int(r_b),
        uw_sorted.ctypes.data, spos.ctypes.data, roff.ctypes.data,
        perms_rank.ctypes.data)
    if rc != 0:
        raise ValueError(f"weighted_layout: a count exceeds r_b={r_b} (or "
                         f"r_b is past 4096)")


def weighted_decide(bits: np.ndarray, roff: np.ndarray, spos: np.ndarray,
                    uidx: np.ndarray, rank: np.ndarray) -> np.ndarray:
    """Per-request decisions from the weighted relay's packed bits: bit
    ``roff[rank] + spos[uidx]`` of ``bits`` (MSB first, as
    ``np.packbits``), one C pass."""
    n = len(uidx)
    _require(bits, "bits", np.uint8)
    _require(roff, "roff", np.int64)
    _require(spos, "spos", np.int32)
    _require(uidx, "uidx", np.int32)
    _require(rank, "rank", np.int32, n)
    out = np.empty(n, dtype=np.uint8)
    _library().rl_weighted_decide(bits.ctypes.data, roff.ctypes.data,
                                  spos.ctypes.data, uidx.ctypes.data,
                                  rank.ctypes.data, n, out.ctypes.data)
    return out.view(np.bool_)


def split_layout(uwords: np.ndarray, rank_bits: int, uidx: np.ndarray):
    """The split digest's host layout, one C pass (``rl_split_layout``):
    a chunk's uniques partitioned into SINGLETONS (count field 1; the
    relay forces rank_bits >= 2, so the clamp sentinel cannot alias 1) and
    multi-count uniques.  Returns ``(s3, mwords, uidx2, n_singles)``: the
    singles' slots as a uint8[S, 3] little-endian 24-bit plane, the multis'
    words unchanged, and ``uidx`` remapped to singles-then-multis positions
    (a position below S reads an allow bit, the rest a count).  Raises
    ValueError unless ``uwords`` / ``uidx`` are C-contiguous uint32 /
    int32 arrays."""
    _require(uwords, "uwords", np.uint32)
    _require(uidx, "uidx", np.int32)
    u, n = len(uwords), len(uidx)
    s3 = np.empty((u, 3), dtype=np.uint8)
    mwords = np.empty(max(u, 1), dtype=np.uint32)
    uidx2 = np.empty(n, dtype=np.int32)
    scratch = np.empty(max(u, 1), dtype=np.int32)
    n_s = int(_library().rl_split_layout(
        uwords.ctypes.data, u, int(rank_bits), uidx.ctypes.data, n,
        s3.ctypes.data, mwords.ctypes.data, uidx2.ctypes.data,
        scratch.ctypes.data))
    return s3[:n_s], mwords[:u - n_s], uidx2, n_s


def _split_key(key: Hashable) -> Tuple[int, bytes | int]:
    """Index keys arrive as (limiter_id, user_key); the lid becomes the hash
    seed so tenants are isolated."""
    if isinstance(key, tuple) and len(key) == 2:
        lid, user = key
        seed = int(lid) if isinstance(lid, int) else abs(hash(lid))
    else:
        seed, user = 0, key
    if isinstance(user, int):
        return seed, user
    if isinstance(user, bytes):
        return seed, user
    return seed, str(user).encode()


def _pack_str_keys(keys):
    """(packed bytes u8[:], offsets i64[n+1]) for a batch of string keys,
    encoded as the reference's batch path encodes them.  A batch of str
    without NUL characters packs in one join and encode and a separator
    scan; any other key by key (:func:`_pack_keys_each`), to the same
    bytes.  The string stream times it on every chunk (the stream
    records' ``key_pack_s``, :func:`hash_str_keys`)."""
    n = len(keys)
    try:
        joined = "\x00".join(keys).encode()
    except TypeError:  # a key that is not a str
        return _pack_keys_each(keys)
    buf = np.frombuffer(joined, dtype=np.uint8)
    seps = np.flatnonzero(buf == 0)
    if n == 0 or len(seps) != n - 1:  # a key holds a NUL
        return _pack_keys_each(keys)
    # Key i spans seps[i - 1] + 1 .. seps[i] of the joined bytes; dropping
    # the separators shifts it left by i.
    offsets = np.empty(n + 1, dtype=np.int64)
    offsets[0] = 0
    offsets[1:n] = seps - np.arange(n - 1)
    offsets[n] = len(buf) - (n - 1)
    keep = np.ones(len(buf), dtype=bool)
    keep[seps] = False
    return buf[keep], offsets


def _pack_keys_each(keys):
    """:func:`_pack_str_keys` key by key: str keys UTF-8 encoded, others
    as ``bytes``."""
    encoded = [k.encode() if isinstance(k, str) else bytes(k) for k in keys]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, encoded), dtype=np.int64,
                          count=len(encoded)), out=offsets[1:])
    return np.frombuffer(b"".join(encoded), dtype=np.uint8), offsets


def hash_str_keys(keys, seed: int, start: int = 0,
                  count: int | None = None, *,
                  timing: dict | None = None):
    """The 128-bit index fingerprints (h1 u64[n], h2 u64[n]) of the string
    keys ``keys[start:start + count]`` under the hash seed ``seed`` (the
    limiter id), one C pass over the packed keys: the fingerprints every
    string entry point of the index computes for the same key and lid.

    Spans ``rl.index.hash`` over the whole and ``rl.index.key_pack`` over
    the slice and :func:`_pack_str_keys`; ``timing``, where given, gets
    their seconds as ``hash_s`` and ``key_pack_s``, read at the spans'
    boundaries."""
    n = (len(keys) - start) if count is None else int(count)
    if start < 0 or n < 0 or start + n > len(keys):
        raise ValueError(f"hash_str_keys: window [{start}, {start + n}) "
                         f"outside {len(keys)} keys")
    t0 = time.perf_counter()
    with span(INDEX_HASH):
        with span(INDEX_KEY_PACK):
            sub = (keys if (start == 0 and n == len(keys))
                   else keys[start:start + n])
            data, offsets = _pack_str_keys(sub)
        t1 = time.perf_counter()
        h1 = np.empty(n, dtype=np.uint64)
        h2 = np.empty(n, dtype=np.uint64)
        _library().rl_hash_bytes_batch(
            data.ctypes.data if len(data) else None, offsets.ctypes.data, n,
            int(seed) & ((1 << 64) - 1), h1.ctypes.data, h2.ctypes.data)
    if timing is not None:
        timing["hash_s"] = time.perf_counter() - t0
        timing["key_pack_s"] = t1 - t0
    return h1, h2


def _routed(fn, values, n_shards: int):
    n = len(values)
    shard = np.empty(n, dtype=np.int32)
    order = np.empty(n, dtype=np.int64)
    counts = np.empty(n_shards, dtype=np.int64)
    fn(values.ctypes.data, n, int(n_shards), shard.ctypes.data,
       order.ctypes.data, counts.ctypes.data)
    return shard, order, counts


def shard_route(key_ids: np.ndarray, n_shards: int):
    """(shard i32[n], stable order i64[n], counts i64[n_shards]) of an
    int64 key batch, one C pass: the splitmix64 partition of
    ``routing.shard_of_int_keys`` and a stable counting sort by it, so
    each partition's requests are one slice of ``order``, in arrival
    order."""
    return _routed(_library().rl_shard_route,
                   np.ascontiguousarray(key_ids, dtype=np.int64), n_shards)


def route_hashes(h1: np.ndarray, n_shards: int):
    """:func:`shard_route` for hashed string keys: partition ``h1 %
    n_shards`` (``routing.shard_of_key``'s string branch)."""
    return _routed(_library().rl_route_hashes,
                   np.ascontiguousarray(h1, dtype=np.uint64), n_shards)


def shard_route_gather(key_ids: np.ndarray, n_shards: int):
    """:func:`shard_route` with the keys gathered into shard order in the
    same C pass: ``(shard i32[n], order i64[n], counts i64[n_shards],
    keys_sorted i64[n])``, ``keys_sorted == key_ids[order]``.  The sharded
    engine's stream routing (``storage/gpu.py:_route_sharded``)."""
    key_ids = np.ascontiguousarray(key_ids, dtype=np.int64)
    n = len(key_ids)
    shard = np.empty(n, dtype=np.int32)
    order = np.empty(n, dtype=np.int64)
    counts = np.empty(n_shards, dtype=np.int64)
    kst = np.empty(n, dtype=np.int64)
    _library().rl_shard_route2(key_ids.ctypes.data, n, int(n_shards),
                               shard.ctypes.data, order.ctypes.data,
                               counts.ctypes.data, kst.ctypes.data)
    return shard, order, counts, kst


def route_hashes_gather(h1: np.ndarray, h2: np.ndarray, n_shards: int):
    """:func:`route_hashes` with both fingerprint streams gathered into
    shard order in the same C pass: ``(shard, order, counts, h1_sorted,
    h2_sorted)``."""
    h1, h2 = _fingerprints(h1, h2)
    n = len(h1)
    shard = np.empty(n, dtype=np.int32)
    order = np.empty(n, dtype=np.int64)
    counts = np.empty(n_shards, dtype=np.int64)
    h1s = np.empty(n, dtype=np.uint64)
    h2s = np.empty(n, dtype=np.uint64)
    _library().rl_route_hashes2(h1.ctypes.data, h2.ctypes.data, n,
                                int(n_shards), shard.ctypes.data,
                                order.ctypes.data, counts.ctypes.data,
                                h1s.ctypes.data, h2s.ctypes.data)
    return shard, order, counts, h1s, h2s


def _fingerprints(h1, h2):
    """C-contiguous uint64 (h1, h2), or a ValueError when their lengths
    differ (the C walks read both at the same index)."""
    h1 = np.ascontiguousarray(h1, dtype=np.uint64)
    h2 = np.ascontiguousarray(h2, dtype=np.uint64)
    if len(h1) != len(h2):
        raise ValueError(f"fingerprints: {len(h1)} h1, {len(h2)} h2")
    return h1, h2


def _slots_i32(slots) -> np.ndarray:
    return np.ascontiguousarray(np.fromiter(slots, dtype=np.int32)
                                if isinstance(slots, (set, frozenset))
                                else slots, dtype=np.int32)


class NativeSlotIndex:
    """The contract of the reference's pure-Python ``SlotIndex``
    (``ratelimiter_tpu/engine/slots.py``: LRU assignment over a fixed slot
    capacity, evictions reported for clearing, pinned slots never evicted)
    over the C++ table, plus batched int-key assignment.  Thread-safe
    through one lock, which the batch calls amortize over thousands of
    keys."""

    def __init__(self, num_slots: int):
        if num_slots <= 0:
            raise ValueError("num_slots must be positive")
        self._lib = _library()
        self.num_slots = int(num_slots)
        self._h = ctypes.c_void_p(self._lib.rl_index_new(self.num_slots))
        self._lock = threading.Lock()
        # Scalar-assign scratch, used under the lock: the key, the offsets
        # of one packed key, and the (slot, evicted) outputs, with their
        # addresses taken once.
        self._key1 = np.empty(1, dtype=np.int64)
        self._offs = np.zeros(2, dtype=np.int64)
        self._out = np.empty(2, dtype=np.int32)
        self._key1_p = self._key1.ctypes.data
        self._offs_p = self._offs.ctypes.data
        self._slot_p = self._out.ctypes.data
        self._ev_p = self._slot_p + self._out.itemsize

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.rl_index_free(h)
            self._h = None

    def _pin(self, pinned, fn) -> None:
        """Pin (or unpin) the caller's ``pinned`` slot set in one call.
        Must be called with self._lock held."""
        if pinned:
            arr = _slots_i32(pinned)
            fn(self._h, arr.ctypes.data, len(arr))

    def _assign_locked(self, pinned, assign) -> None:
        """Run ``assign()`` with the caller's pinned slots held, so that no
        slot of queued requests is evicted by it."""
        self._pin(pinned, self._lib.rl_index_pin_batch)
        try:
            assign()
        finally:
            self._pin(pinned, self._lib.rl_index_unpin_batch)

    # -- scalar interface (SlotIndex parity) ----------------------------------
    def get(self, key: Hashable) -> Optional[int]:
        """Slot for key, or None; refreshes recency."""
        seed, user = _split_key(key)
        with self._lock:
            if isinstance(user, int):
                slot = self._lib.rl_index_get_int(self._h, user, seed)
            else:
                slot = self._lib.rl_index_get_bytes(self._h, user, len(user),
                                                    seed)
        return None if slot < 0 else slot

    def assign(self, key: Hashable, pinned: Optional[Set[int]] = None,
               hold_pin: bool = False) -> Tuple[int, Optional[int]]:
        """Slot for key, allocating (and possibly evicting) if absent.
        Returns (slot, evicted_slot); ``hold_pin`` pins the slot under the
        same lock hold as the assignment (release with unpin_batch)."""
        seed, user = _split_key(key)
        lib = self._lib
        with self._lock:
            if isinstance(user, int):
                self._key1[0] = user
                args = (lib.rl_index_assign_ints, self._key1_p)
            else:
                self._offs[1] = len(user)
                args = (lib.rl_index_assign_bytes, user, self._offs_p)
            self._assign_locked(pinned, lambda: args[0](
                self._h, *args[1:], 1, seed, self._slot_p, self._ev_p))
            slot, evicted = int(self._out[0]), int(self._out[1])
            if hold_pin and slot >= 0:
                lib.rl_index_pin(self._h, slot)
        if evicted == -2:
            raise RuntimeError("all slots pinned; increase num_slots or flush")
        return slot, (evicted if evicted >= 0 else None)

    def remove(self, key: Hashable) -> Optional[int]:
        """Drop a key (admin reset); returns its slot (caller clears it).
        A pinned slot is freed only at its last unpin."""
        seed, user = _split_key(key)
        with self._lock:
            if isinstance(user, int):
                slot = self._lib.rl_index_remove_int(self._h, user, seed)
            else:
                slot = self._lib.rl_index_remove_bytes(self._h, user,
                                                       len(user), seed)
        return None if slot < 0 else slot

    def __len__(self) -> int:
        with self._lock:
            return int(self._lib.rl_index_len(self._h))

    # -- vectorized interface -------------------------------------------------
    def assign_batch_ints(self, keys: np.ndarray, lid: int,
                          pinned: Optional[Set[int]] = None,
                          hold_pins: bool = False):
        """Assign slots for an int64 key batch in one C call.  ``pinned``
        slots (queued requests) are never evicted; ``hold_pins`` pins the
        returned slots under the same lock hold (the caller unpins them
        once its dispatch is enqueued).  Returns (slots i32[n], evictions
        i32[k])."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        n = len(keys)
        out_slots = np.empty(n, dtype=np.int32)
        out_ev = np.empty(n, dtype=np.int32)
        with self._lock:
            self._assign_locked(pinned, lambda: self._lib.rl_index_assign_ints(
                self._h, keys.ctypes.data, n, int(lid),
                out_slots.ctypes.data, out_ev.ctypes.data))
            # Pin only on full success: the caller raises on -2 and never
            # dispatches, so pinning the successful lanes would leak.
            failed = bool((out_ev == -2).any())
            if hold_pins and not failed:
                self._lib.rl_index_pin_batch(self._h, out_slots.ctypes.data,
                                             n)
        if failed:
            raise SlotCapacityError("slot capacity exhausted (all pinned)",
                                    pending_clears=out_ev[out_ev >= 0])
        return out_slots, out_ev[out_ev >= 0]

    def assign_batch_ints_multi(self, keys: np.ndarray, lids: np.ndarray,
                                pinned: Optional[Set[int]] = None,
                                hold_pins: bool = False):
        """:meth:`assign_batch_ints` with one limiter id per request: the
        same (lid, key) namespace, so a key maps to the same slot whichever
        path touches it first.  Returns (slots i32[n], evictions i32[k])."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        seeds = np.ascontiguousarray(lids, dtype=np.uint64)
        n = len(keys)
        if len(seeds) != n:
            raise ValueError(f"assign_batch_ints_multi: {n} keys, "
                             f"{len(seeds)} limiter ids")
        out_slots = np.empty(n, dtype=np.int32)
        out_ev = np.empty(n, dtype=np.int32)
        with self._lock:
            self._assign_locked(
                pinned, lambda: self._lib.rl_index_assign_ints_multi(
                    self._h, keys.ctypes.data, seeds.ctypes.data, n,
                    out_slots.ctypes.data, out_ev.ctypes.data))
            failed = bool((out_ev == -2).any())
            if hold_pins and not failed:  # see assign_batch_ints
                self._lib.rl_index_pin_batch(self._h, out_slots.ctypes.data,
                                             n)
        if failed:
            raise SlotCapacityError("slot capacity exhausted (all pinned)",
                                    pending_clears=out_ev[out_ev >= 0])
        return out_slots, out_ev[out_ev >= 0]

    def assign_batch_fps(self, h1: np.ndarray, h2: np.ndarray,
                         pinned: Optional[Set[int]] = None,
                         hold_pins: bool = False):
        """Assign slots for precomputed fingerprints (:func:`hash_str_keys`)
        in one C call.  Returns (slots i32[n], evictions i32[k]);
        ``pinned``/``hold_pins`` as in :meth:`assign_batch_ints`."""
        h1, h2 = _fingerprints(h1, h2)
        n = len(h1)
        out_slots = np.empty(n, dtype=np.int32)
        out_ev = np.empty(n, dtype=np.int32)
        with self._lock:
            self._assign_locked(pinned, lambda: self._lib.rl_index_assign_fps(
                self._h, h1.ctypes.data, h2.ctypes.data, n,
                out_slots.ctypes.data, out_ev.ctypes.data))
            failed = bool((out_ev == -2).any())
            if hold_pins and not failed:  # see assign_batch_ints
                self._lib.rl_index_pin_batch(self._h, out_slots.ctypes.data,
                                             n)
        if failed:
            raise SlotCapacityError("slot capacity exhausted (all pinned)",
                                    pending_clears=out_ev[out_ev >= 0])
        return out_slots, out_ev[out_ev >= 0]

    def assign_batch_bytes(self, data, offsets, lid: int,
                           pinned: Optional[Set[int]] = None,
                           hold_pins: bool = False):
        """Assign slots straight off a packed UTF-8 key column (the
        sidecar's v5 batch frame: data uint8[klen] + offsets i64[n+1] is
        exactly rl_index_assign_bytes' input), so a whole frame of keys
        assigns with no per-key Python objects.  Fingerprints are seeded
        by lid like the per-key string path: the same key lands in the
        same slot through either.  Returns (slots i32[n], evictions
        i32[k]); ``pinned``/``hold_pins`` as in :meth:`assign_batch_ints`."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        n = len(offsets) - 1
        out_slots = np.empty(n, dtype=np.int32)
        out_ev = np.empty(n, dtype=np.int32)
        with self._lock:
            self._assign_locked(pinned, lambda: self._lib.rl_index_assign_bytes(
                self._h, data.ctypes.data if len(data) else 0,
                offsets.ctypes.data, n, int(lid),
                out_slots.ctypes.data, out_ev.ctypes.data))
            failed = bool((out_ev == -2).any())
            if hold_pins and not failed:  # see assign_batch_ints
                self._lib.rl_index_pin_batch(self._h, out_slots.ctypes.data,
                                             n)
        if failed:
            raise SlotCapacityError("slot capacity exhausted (all pinned)",
                                    pending_clears=out_ev[out_ev >= 0])
        return out_slots, out_ev[out_ev >= 0]

    def assign_batch_strs(self, keys, lid: int,
                          pinned: Optional[Set[int]] = None,
                          hold_pins: bool = False, start: int = 0,
                          count: int | None = None):
        """Assign slots for the string keys ``keys[start:start + count]`` of
        one limiter: one hashing pass, one C walk (the same slots as
        per-key ``assign`` of ``(lid, key)``, with the batch's recency: a
        key's repeats in the batch count as one touch, at its first
        occurrence).  Returns (slots i32[n], evictions i32[k]);
        ``pinned``/``hold_pins`` as in :meth:`assign_batch_ints`."""
        h1, h2 = hash_str_keys(keys, lid, start, count)
        return self.assign_batch_fps(h1, h2, pinned=pinned,
                                     hold_pins=hold_pins)

    def assign_batch_ints_uniques(self, keys: np.ndarray, lid: int,
                                  rank_bits: int,
                                  pinned: Optional[Set[int]] = None,
                                  hold_pins: bool = False):
        """Unique-compaction assign (the relay digest route): returns
        (uwords uint32[u], uidx i32[n], rank i32[n], evictions i32[k]).
        ``uwords`` carries (slot | clamped segment count) per unique in
        first-appearance order; ``uidx``/``rank`` stay on the host for the
        decision reconstruction.  ``hold_pins`` pins the unique slots."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        n = len(keys)
        uwords = np.empty(n, dtype=np.uint32)
        uidx = np.empty(n, dtype=np.int32)
        rank = np.empty(n, dtype=np.int32)
        out_ev = np.empty(n, dtype=np.int32)
        box = [0]

        def assign():
            box[0] = self._lib.rl_index_assign_ints_uniques(
                self._h, keys.ctypes.data, n, int(lid), int(rank_bits),
                uwords.ctypes.data, uidx.ctypes.data, rank.ctypes.data,
                out_ev.ctypes.data)

        return self._finish_uniques(pinned, assign, box, rank_bits, uwords,
                                    uidx, rank, out_ev, hold_pins)

    def _finish_uniques(self, pinned, assign, box, rank_bits, uwords, uidx,
                        rank, out_ev, hold_pins):
        """Run a unique-compacting ``assign`` (its unique count lands in
        ``box[0]``) under the lock with ``pinned`` held, pin the unique
        slots on full success with ``hold_pins``, and return the
        assign's outputs; raise SlotCapacityError (carrying the evictions
        already applied) when a lane found every slot pinned."""
        with self._lock:
            self._assign_locked(pinned, assign)
            u = box[0]
            failed = bool((out_ev == -2).any())
            if hold_pins and not failed:
                uslots = np.ascontiguousarray(
                    uwords[:u] >> np.uint32(rank_bits + 1), dtype=np.int32)
                self._lib.rl_index_pin_batch(self._h, uslots.ctypes.data, u)
        if failed:
            raise SlotCapacityError("slot capacity exhausted (all pinned)",
                                    pending_clears=out_ev[out_ev >= 0])
        return uwords[:u], uidx, rank, out_ev[out_ev >= 0]

    def assign_batch_ints_multi_uniques(self, keys: np.ndarray,
                                        lids: np.ndarray, rank_bits: int,
                                        pinned: Optional[Set[int]] = None,
                                        hold_pins: bool = False):
        """:meth:`assign_batch_ints_uniques` with one limiter id per
        request (the relay's tenant streams): the (lid, key) namespace of
        :meth:`assign_batch_ints_multi`, so the same key of two limiters
        is two uniques.  Returns (uwords uint32[u], uidx i32[n], rank
        i32[n], evictions i32[k])."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        seeds = np.ascontiguousarray(lids, dtype=np.uint64)
        n = len(keys)
        if len(seeds) != n:
            raise ValueError(f"assign_batch_ints_multi_uniques: {n} keys, "
                             f"{len(seeds)} limiter ids")
        uwords = np.empty(n, dtype=np.uint32)
        uidx = np.empty(n, dtype=np.int32)
        rank = np.empty(n, dtype=np.int32)
        out_ev = np.empty(n, dtype=np.int32)
        box = [0]

        def assign():
            box[0] = self._lib.rl_index_assign_ints_multi_uniques(
                self._h, keys.ctypes.data, seeds.ctypes.data, n,
                int(rank_bits), uwords.ctypes.data, uidx.ctypes.data,
                rank.ctypes.data, out_ev.ctypes.data)

        return self._finish_uniques(pinned, assign, box, rank_bits, uwords,
                                    uidx, rank, out_ev, hold_pins)

    def assign_batch_fps_uniques(self, h1: np.ndarray, h2: np.ndarray,
                                 rank_bits: int,
                                 pinned: Optional[Set[int]] = None,
                                 hold_pins: bool = False):
        """:meth:`assign_batch_ints_uniques` for precomputed fingerprints
        (:func:`hash_str_keys`).  Returns (uwords uint32[u], uidx i32[n],
        rank i32[n], evictions i32[k])."""
        h1, h2 = _fingerprints(h1, h2)
        n = len(h1)
        uwords = np.empty(n, dtype=np.uint32)
        uidx = np.empty(n, dtype=np.int32)
        rank = np.empty(n, dtype=np.int32)
        out_ev = np.empty(n, dtype=np.int32)
        box = [0]

        def assign():
            box[0] = self._lib.rl_index_assign_fps_uniques(
                self._h, h1.ctypes.data, h2.ctypes.data, n, int(rank_bits),
                uwords.ctypes.data, uidx.ctypes.data, rank.ctypes.data,
                out_ev.ctypes.data)

        return self._finish_uniques(pinned, assign, box, rank_bits, uwords,
                                    uidx, rank, out_ev, hold_pins)

    def assign_batch_strs_uniques(self, keys, lid: int, rank_bits: int,
                                  pinned: Optional[Set[int]] = None,
                                  hold_pins: bool = False, start: int = 0,
                                  count: int | None = None):
        """:meth:`assign_batch_ints_uniques` for the string keys
        ``keys[start:start + count]`` of one limiter: one hashing pass,
        one C walk."""
        h1, h2 = hash_str_keys(keys, lid, start, count)
        return self.assign_batch_fps_uniques(h1, h2, rank_bits,
                                             pinned=pinned,
                                             hold_pins=hold_pins)

    # -- fingerprint enumeration (checkpoints) --------------------------------
    def dump_fp(self):
        """All live entries as (h1 u64[n], h2 u64[n], slots i32[n]), in
        LRU order, most recent first: the checkpoint's index payload.
        Fingerprints are one-way; a dump that must carry the keys needs
        the keyed index (``engine/slots.py``)."""
        cap = self.num_slots
        h1 = np.empty(cap, dtype=np.uint64)
        h2 = np.empty(cap, dtype=np.uint64)
        slots = np.empty(cap, dtype=np.int32)
        with self._lock:
            n = self._lib.rl_index_dump(
                self._h, h1.ctypes.data, h2.ctypes.data, slots.ctypes.data)
        return h1[:n].copy(), h2[:n].copy(), slots[:n].copy()

    def restore_fp(self, h1: np.ndarray, h2: np.ndarray,
                   slots: np.ndarray) -> None:
        """Rebuild the index from a :meth:`dump_fp` payload, with the
        dump's LRU order.  Raises ValueError on a bad slot, a duplicate or
        more entries than slots (the index is then left empty)."""
        h1, h2 = _fingerprints(h1, h2)
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        n = len(h1)
        if len(slots) != n:
            raise ValueError("fingerprint dump arrays disagree on length")
        with self._lock:
            rc = self._lib.rl_index_restore(
                self._h, h1.ctypes.data, h2.ctypes.data, slots.ctypes.data, n)
        if rc != 0:
            raise ValueError(
                "invalid fingerprint dump (bad slot, duplicate, or size)")

    def lookup_fps(self, h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
        """Slots of the given fingerprints (-1 if absent); no LRU touch."""
        h1, h2 = _fingerprints(h1, h2)
        out = np.empty(len(h1), dtype=np.int32)
        with self._lock:
            self._lib.rl_index_lookup_fps(
                self._h, h1.ctypes.data, h2.ctypes.data, len(h1),
                out.ctypes.data)
        return out

    # -- held pins (assign -> dispatch-enqueue window) ------------------------
    def pin_batch(self, slots) -> None:
        """Refcounted pins (duplicates fine), released by
        :meth:`unpin_batch`."""
        slots = _slots_i32(slots)
        with self._lock:
            self._lib.rl_index_pin_batch(self._h, slots.ctypes.data,
                                         len(slots))

    def unpin_batch(self, slots) -> None:
        """Release pins taken by ``hold_pin``/``hold_pins`` (refcounted,
        duplicates fine)."""
        slots = _slots_i32(slots)
        with self._lock:
            self._lib.rl_index_unpin_batch(self._h, slots.ctypes.data,
                                           len(slots))
