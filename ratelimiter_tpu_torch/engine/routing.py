"""Key -> partition routing of the partitioned host slot index.

The port's copies of the reference's framework-free routing
(``ratelimiter_tpu/parallel/sharded.py:shard_of_int_keys`` and
``shard_of_key``, and ``ratelimiter_tpu/engine/native_index.py:
fnv_fingerprint_h1``), bit for bit: an int key goes to the partition its
splitmix64 finalizer picks, a string or bytes key of an int limiter id to
the one the h1 stream of its index fingerprint picks (the quantity the C
router ``rl_route_hashes`` bins a hashed batch by), and any other key to
crc32 of its ``repr``.  The C passes ``rl_shard_route`` and
``rl_route_hashes`` (``native/slot_index.cpp``) route batches the same way.

The sharded engine bins a chunk on its device too
(``parallel/sharded.py:ShardedDeviceEngine.route_on_device``), through
:func:`route_count`, the counterpart of the reference's
``parallel/sharded.py:_splitmix64_device`` and ``build_route_count``.
Torch has no uint64, so the finalizer runs on int64 tensors holding the
same bits: additions and products wrap alike in two's complement, each
right shift is masked to a logical one, and the remainder is taken of
the two 32-bit halves, never of a negative int64.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

_FNV_OFF1 = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_U64 = (1 << 64) - 1


def shard_of_int_keys(key_ids, n_shards: int) -> np.ndarray:
    """Partition of each int64 key: the splitmix64 finalizer modulo
    ``n_shards`` (int64[n])."""
    x = np.asarray(key_ids).astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(n_shards)).astype(np.int64)


def _signed(c: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes read as uint64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer of :func:`shard_of_int_keys` over int64
    lanes (uint64 bits in, uint64 bits out as int64)."""
    x = x.to(torch.int64) + _signed(0x9E3779B97F4A7C15)
    x = (x ^ _srl(x, 30)) * _signed(0xBF58476D1CE4E5B9)
    x = (x ^ _srl(x, 27)) * _signed(0x94D049BB133111EB)
    return x ^ _srl(x, 31)


def mod_u64(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x mod n`` of int64 lanes read as uint64 (``0 < n < 2^31``), from
    the halves: ``(hi * (2^32 mod n) + lo) mod n``."""
    n = int(n)
    hi = _srl(x, 32) % n
    lo = (x & 0xFFFFFFFF) % n
    return (hi * ((1 << 32) % n) + lo) % n


def route_count(values: torch.Tensor, n_shards: int, int_keys: bool):
    """The route-and-count pass on ``values``' device: int64 keys binned by
    splitmix64 (``int_keys``), or string fingerprints' h1 (uint64 bits in
    int64) binned as they are.  Returns ``(shard i32[n], order i64[n],
    counts i64[n_shards])``, the C router's contract: ``order`` lists each
    shard's positions in arrival order, shard after shard."""
    h = splitmix64(values) if int_keys else values.to(torch.int64)
    shard = mod_u64(h, n_shards)
    counts = torch.bincount(shard, minlength=int(n_shards))
    order = torch.argsort(shard, stable=True)
    return shard.to(torch.int32), order, counts


def fnv_fingerprint_h1(data: bytes, seed: int) -> int:
    """The h1 stream of the C index's ``hash_bytes`` fingerprint of
    ``data`` under ``seed`` (FNV-1a 64 from the offset basis xor the
    seed)."""
    h = (_FNV_OFF1 ^ (seed & _U64)) & _U64
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _U64
    return h


def shard_of_key(key, n_shards: int) -> int:
    """Partition of one index key: ``(lid, user)`` or a bare user key.
    Int user keys route as :func:`shard_of_int_keys`; str and bytes keys of
    an int limiter id by their fingerprint's h1 under the limiter id, so a
    scalar call and a hashed batch agree on the partition; anything else
    by crc32 of ``repr(key)``."""
    user = key[1] if isinstance(key, tuple) and len(key) == 2 else key
    if isinstance(user, (int, np.integer)):
        return int(shard_of_int_keys(np.asarray([user]), n_shards)[0])
    lid = key[0] if isinstance(key, tuple) and len(key) == 2 else 0
    if isinstance(user, (str, bytes)) and isinstance(lid, (int, np.integer)):
        data = user.encode() if isinstance(user, str) else user
        return fnv_fingerprint_h1(data, int(lid)) % n_shards
    return zlib.crc32(repr(key).encode()) % n_shards
