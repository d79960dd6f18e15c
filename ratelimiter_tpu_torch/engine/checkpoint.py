"""Checkpoint / resume of the card-resident limiter state (the port's
copy of ``ratelimiter_tpu/engine/checkpoint.py``, whose files it writes
and reads: either package restores the other's).

The reference delegates durability to Redis AOF persistence
(docker-compose.yml enables --appendonly): counters survive an app restart
because they live in Redis.  Here the source of truth is the card's
memory, which dies with the process, so durability is an explicit
subsystem: snapshot the slot arrays and the key->slot index to disk,
restore them on boot.

Format: a directory with
  - ``state.npz``  — the SW/TB slot arrays (numpy int64, one per field,
    flattened) and the index's fingerprint arrays (``idx_<algo>_*``)
  - ``index.json`` — limiter registrations + key->slot mappings + metadata

Snapshots are crash-consistent (written to a temp dir, atomically renamed)
but geometry-locked (slot arrays restore 1:1; enforced by metadata check).
Cross-geometry migration — growing the table, changing partition counts —
uses the per-KEY path instead: :func:`export_keys` / :func:`import_keys`
(also on ``GpuBatchedStorage``), which re-assign slots in the target and
carry each key's packed state row across.

The C slot index enumerates as (h1, h2, slot) fingerprint triples
(native/slot_index.cpp:rl_index_dump), so the default storage checkpoints
at native speed: snapshots carry the fingerprints (state.npz) and restore
rebuilds the table with its exact LRU order.  Fingerprints are one-way,
so only dumps from the keyed index (``checkpointable=True``) can be
re-partitioned or re-keyed; flat-to-flat rebalance works from
fingerprints directly (LRU tables assign slots geometry-independently).

Numpy in, numpy out: the engine's ``sw_state`` / ``tb_state`` views are
read into host arrays and set from them (a sharded engine's views
assemble its shards in global slot order).  The sharded index kinds are
read and written as the reference's (``parallel/sharded.py:
ShardedSlotIndex``: ``sharded_native_fp`` over the C sub-indexes,
``sharded`` over keyed ones).  :func:`dump_shard_slot_indexes` dumps one
shard's sub-indexes in local slots, the index journal of a shard's
replication stream (replication/sharded.py).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import zlib
from typing import Dict, Optional

import numpy as np

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.engine.routing import shard_of_key
from ratelimiter_tpu_torch.engine.state import SWState, TBState


# v1: TBState carried a stored deadline array; v2 derives it from
# last_refill + 2*window and drops the lane. Restore iterates the CURRENT
# field set, so v1 checkpoints load in v2 binaries (the extra tb_deadline
# array is ignored); v2 checkpoints refuse to load in v1 binaries via the
# version check rather than failing on a missing array.
# v3 adds integrity: per-array CRC32s + a manifest checksum over
# index.json itself (a bit-flipped or torn dump must refuse to restore
# with a typed CheckpointCorruptError, not silently hand stale/garbage
# counters to live traffic).  v1/v2 dumps predate the checksums and
# still restore (nothing to verify).
FORMAT_VERSION = 3
SUPPORTED_VERSIONS = (1, 2, 3)


class CheckpointCorruptError(ValueError):
    """The checkpoint failed integrity verification (bit flip, torn
    write, truncated state.npz): restore refuses rather than loading
    corrupted counters."""


def _array_crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _manifest_crc(meta: Dict) -> int:
    """CRC of the canonical JSON of the manifest (everything except the
    stored checksum itself) — json.dumps(sort_keys=True) is stable
    across the dump/load round trip, independent of file formatting."""
    canon = json.dumps({k: v for k, v in meta.items()
                        if k != "manifest_crc"}, sort_keys=True)
    return zlib.crc32(canon.encode()) & 0xFFFFFFFF

# Identity of the key->shard routing hash used by sharded indexes
# (parallel/sharded.py:shard_of_key): FNV-fingerprint h1 for string/bytes
# keys (r6 — lets the batched string stream hash once and both route and
# assign from the result), splitmix64 for int keys, crc32-of-repr for
# exotic key types.  Stored in sharded index dumps so a restore into a
# binary with a different routing function fails loudly instead of
# silently orphaning entries.
SHARD_HASH_VERSION = "fp-fnv/splitmix64-v2"
# Sharded dumps written before the shard_hash field existed were produced by
# binaries that routed int user keys via crc32-of-repr.  A missing field
# therefore marks the LEGACY hash, not the current one — restoring a legacy
# dump with int user keys under the current splitmix64 routing would
# silently orphan every int-key entry.
LEGACY_SHARD_HASH = "crc32-repr-v0"
# Dumps under these hashes restore iff every entry already sits where the
# CURRENT hash routes its key (divergence-proof placement check below):
# v0 legacy, and v1 (whose string keys routed by crc32-of-repr — int keys
# route identically in v1 and v2, so int-only v1 dumps restore clean).
PLACEMENT_CHECK_HASHES = (LEGACY_SHARD_HASH, "crc32-repr/splitmix64-v1")


def _host(field) -> np.ndarray:
    """One decoded state field (a tensor) as a flat host int64 array."""
    return field.cpu().numpy().astype(np.int64, copy=False).reshape(-1)


def snapshot_engine_state(engine, index_dump: Optional[Dict] = None) -> Dict:
    """Materialize the device state to host numpy (one blocking transfer)."""
    engine.block_until_ready()
    sw = engine.sw_state
    tb = engine.tb_state
    return {
        "sw": {f: _host(getattr(sw, f)) for f in sw._fields},
        "tb": {f: _host(getattr(tb, f)) for f in tb._fields},
        "meta": {
            "format": FORMAT_VERSION,
            "num_slots": engine.num_slots,
            "taken_at_ms": time.time_ns() // 1_000_000,
            "index": index_dump or {},
        },
    }


def _detach_index_arrays(index_dump: Dict, arrays: Dict) -> Dict:
    """Move fingerprint numpy arrays out of the index dump into the npz
    payload (JSON holds a marker; arrays go to state.npz as idx_*)."""
    out = {"algos": {}}
    for algo, payload in index_dump.get("algos", {}).items():
        p = dict(payload)
        if p.get("kind") == "native_fp":
            for f in ("h1", "h2", "slots"):
                arrays[f"idx_{algo}_{f}"] = p.pop(f)
            p["array_ref"] = f"idx_{algo}"
        elif p.get("kind") == "sharded_native_fp":
            for j, shard_p in enumerate(p.pop("per_shard")):
                for f in ("h1", "h2", "slots"):
                    arrays[f"idx_{algo}_s{j}_{f}"] = shard_p[f]
            p["array_ref"] = f"idx_{algo}"
        elif p.get("kind") == "partitioned_native_fp":
            for j, part_p in enumerate(p.pop("per_part")):
                for f in ("h1", "h2", "slots"):
                    arrays[f"idx_{algo}_p{j}_{f}"] = part_p[f]
            p["array_ref"] = f"idx_{algo}"
        out["algos"][algo] = p
    return out


def _attach_index_arrays(meta_index: Dict, arrays: Dict) -> Dict:
    """Inverse of :func:`_detach_index_arrays` at load time."""
    out = {"algos": {}}
    for algo, payload in meta_index.get("algos", {}).items():
        p = dict(payload)
        ref = p.pop("array_ref", None)
        if p.get("kind") == "native_fp":
            for f in ("h1", "h2", "slots"):
                p[f] = arrays[f"{ref}_{f}"]
        elif p.get("kind") == "sharded_native_fp":
            p["per_shard"] = [
                {f: arrays[f"{ref}_s{j}_{f}"] for f in ("h1", "h2", "slots")}
                for j in range(p["n_shards"])]
        elif p.get("kind") == "partitioned_native_fp":
            p["per_part"] = [
                {f: arrays[f"{ref}_p{j}_{f}"] for f in ("h1", "h2", "slots")}
                for j in range(p["n_parts"])]
        out["algos"][algo] = p
    return out


def save_checkpoint(path: str, engine, index_dump: Optional[Dict] = None) -> None:
    """Write an atomic on-disk checkpoint (temp dir + rename)."""
    snap = snapshot_engine_state(engine, index_dump)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt-tmp-", dir=parent)
    try:
        arrays = {f"sw_{k}": v for k, v in snap["sw"].items()}
        arrays.update({f"tb_{k}": v for k, v in snap["tb"].items()})
        snap["meta"]["index"] = _detach_index_arrays(
            snap["meta"].get("index", {}), arrays)
        # Integrity (v3): per-array CRC32s, then a manifest checksum over
        # the final metadata so a flipped byte in index.json itself is
        # also caught at load.
        snap["meta"]["checksums"] = {
            name: _array_crc(arr) for name, arr in arrays.items()}
        snap["meta"]["manifest_crc"] = _manifest_crc(snap["meta"])
        np.savez(os.path.join(tmp, "state.npz"), **arrays)
        with open(os.path.join(tmp, "index.json"), "w") as fh:
            json.dump(snap["meta"], fh)
        if os.path.exists(path):
            old = path + f".old-{os.getpid()}"
            os.rename(path, old)
            os.rename(tmp, path)
            import shutil

            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
    except Exception:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_checkpoint(path: str) -> Dict:
    with open(os.path.join(path, "index.json")) as fh:
        meta = json.load(fh)
    if meta.get("format") not in SUPPORTED_VERSIONS:
        raise ValueError(f"unsupported checkpoint format: {meta.get('format')}")
    verify = meta.get("format", 0) >= 3
    if verify:
        stored = meta.get("manifest_crc")
        if stored is None or _manifest_crc(meta) != int(stored):
            raise CheckpointCorruptError(
                f"checkpoint manifest checksum mismatch in {path}/"
                "index.json: the manifest is corrupted or was edited — "
                "refusing to restore")
    try:
        # dict() forces every lazily-loaded array out of the zip, so a
        # truncated/torn state.npz fails HERE, typed, not mid-restore.
        data = dict(np.load(os.path.join(path, "state.npz")))
    except CheckpointCorruptError:
        raise
    except Exception as exc:  # noqa: BLE001 — torn/truncated archive
        raise CheckpointCorruptError(
            f"checkpoint state.npz in {path} is unreadable (torn or "
            f"truncated write?): {exc}") from exc
    if verify:
        for name, crc in meta.get("checksums", {}).items():
            if name not in data:
                raise CheckpointCorruptError(
                    f"checkpoint array {name!r} listed in the manifest is "
                    f"missing from state.npz in {path}")
            if _array_crc(data[name]) != int(crc):
                raise CheckpointCorruptError(
                    f"checkpoint array {name!r} failed its CRC32 in "
                    f"{path} (bit flip or torn write) — refusing to "
                    "restore")
    meta["index"] = _attach_index_arrays(meta.get("index", {}), data)
    return {"meta": meta, "arrays": data}


def restore_engine_state(engine, ckpt: Dict) -> None:
    """Load checkpointed slot arrays into an engine of the same geometry,
    through its state views: the resident tensors are written in place."""
    meta = ckpt["meta"]
    if meta["num_slots"] != engine.num_slots:
        raise ValueError(
            f"checkpoint has {meta['num_slots']} slots, engine has "
            f"{engine.num_slots}; geometry must match")
    arrays = ckpt["arrays"]
    shape = (engine.num_slots,)
    engine.sw_state = SWState(*(
        arrays[f"sw_{f}"].reshape(shape) for f in SWState._fields))
    engine.tb_state = TBState(*(
        arrays[f"tb_{f}"].reshape(shape) for f in TBState._fields))


# ---------------------------------------------------------------------------
# Per-key export/import (geometry-free rebalance)
# ---------------------------------------------------------------------------
# Checkpoints are geometry-locked (slot arrays restore 1:1). Rebalancing —
# growing the slot table, changing shard counts, moving to different
# hardware — goes through per-KEY state instead: export every live
# (key -> packed state row), import assigns fresh slots in the target and
# writes the rows back. Works across any source/target geometry, flat or
# sharded, as long as the index is enumerable (checkpointable=True).


def _limiter_table_dump(storage) -> Dict:
    """Registered limiter policies, keyed by lid (import-side validation).

    Each row carries its policy generation (``gen``; 0 = as registered)
    so a standby replaying the dump can tell a LIVE policy update —
    which it must apply via ``set_policy`` at the primary's stamp — from
    registration drift, which stays a hard error (ARCHITECTURE §15)."""
    table = getattr(storage, "table", None)
    return {
        str(lid): {
            "algo": algo,
            "max_permits": cfg.max_permits,
            "window_ms": cfg.window_ms,
            "refill_rate": cfg.refill_rate,
            "gen": (table.row_generation(lid) if table is not None
                    and hasattr(table, "row_generation") else 0),
        }
        for lid, (algo, cfg) in storage._configs.items()
    }


def limiter_policy_dump(storage) -> Dict:
    """Public form of :func:`_limiter_table_dump`: the storage's policy
    rows in exactly the shape the control-plane ``set_policy`` op (and
    :func:`apply_limiter_policies`) consumes.  The fleet controller's
    broadcast and anti-entropy paths (``control/fleet.py``) are built
    on this — one row format end to end, so a checkpoint restore, a
    replication bootstrap, and a leader broadcast all converge a node
    through the same idempotent apply."""
    return _limiter_table_dump(storage)


def apply_limiter_policies(storage, limiters: Dict, *,
                           register_missing: bool = False) -> None:
    """Reconcile a limiter dump against a target storage.

    - Missing lids are registered in lid order when ``register_missing``
      (the standby-bootstrap path); otherwise they are a hard error.
    - Shape drift (algo or window) always raises — replicated rows
      would silently mis-decide under a different window.
    - RATE drift with a strictly newer ``gen`` is a live policy update
      (ARCHITECTURE §15): applied via ``set_policy`` at the dump's
      exact generation stamp, so a promoted standby serves the
      post-update generation.  Rate drift without a newer generation is
      true registration drift and raises, as before.
    """
    have = storage._configs
    table = getattr(storage, "table", None)
    for lid in sorted(limiters, key=int):
        cfg = limiters[lid]
        lid_i = int(lid)
        src_gen = int(cfg.get("gen", 0))
        if lid_i not in have:
            if not register_missing:
                raise ValueError(
                    f"limiter id {lid_i} is not registered on the "
                    "target; register identical limiters in the same "
                    "order first")
            got = storage.register_limiter(
                cfg["algo"],
                RateLimitConfig(max_permits=cfg["max_permits"],
                                window_ms=cfg["window_ms"],
                                refill_rate=cfg["refill_rate"]))
            if got != lid_i:
                raise ValueError(
                    f"standby assigned lid {got} where the primary has "
                    f"{lid_i}; register limiters in the same order on "
                    "both sides (or let replication do all registration)")
            if src_gen > 0 and table is not None \
                    and hasattr(table, "set_policy"):
                # Freshly registered from a dump that already carries a
                # live update: stamp the primary's generation.
                storage.set_policy(lid_i, RateLimitConfig(
                    max_permits=cfg["max_permits"],
                    window_ms=cfg["window_ms"],
                    refill_rate=cfg["refill_rate"]), generation=src_gen)
            continue
        algo, existing = have[lid_i]
        if algo != cfg["algo"] or existing.window_ms != cfg["window_ms"]:
            raise ValueError(
                f"limiter {lid_i} diverges from the dump in its "
                "algo/window shape; replicated state cannot be served "
                "under a different window")
        rates_match = (existing.max_permits == cfg["max_permits"]
                       and existing.refill_rate == cfg["refill_rate"])
        local_gen = (table.row_generation(lid_i)
                     if table is not None
                     and hasattr(table, "row_generation") else 0)
        if rates_match:
            if src_gen > local_gen and table is not None \
                    and hasattr(table, "bump_generation"):
                table.bump_generation(src_gen)
            continue
        if src_gen > local_gen and hasattr(storage, "set_policy"):
            storage.set_policy(lid_i, RateLimitConfig(
                max_permits=cfg["max_permits"],
                window_ms=cfg["window_ms"],
                refill_rate=cfg["refill_rate"],
                enable_local_cache=existing.enable_local_cache,
                local_cache_ttl_ms=existing.local_cache_ttl_ms,
            ), generation=src_gen)
            continue
        raise ValueError(
            f"limiter {lid_i} mismatch: the target's rates diverge from "
            "the dump's registration with no newer policy generation to "
            "justify it; register identical limiters in the same order "
            "(live set_policy updates carry their generation and apply)")


def export_keys(storage) -> Dict:
    """All live per-key state of a storage.

    Keyed (Python) indexes export ``{algo: [[key, row-ints], ...]}`` —
    importable into ANY geometry (keys re-hash in the target).  Native flat
    indexes export fingerprint payloads ``{kind: 'fp', h1, h2, rows}`` —
    importable into flat native targets of any size (fingerprints are
    geometry-independent for LRU-assigned tables) but not re-shardable.
    """
    # Flush BEFORE dumping: a flush can assign/evict, reusing a dumped
    # slot — the fp export reads rows by slot, so a stale dump would
    # attribute another key's state to a dumped fingerprint.
    storage.flush()
    storage.engine.block_until_ready()
    index_dump = dump_slot_indexes(storage)
    out: Dict = {
        "format": FORMAT_VERSION,
        "limiters": _limiter_table_dump(storage),
        "algos": {},
    }
    for algo, payload in index_dump["algos"].items():
        if payload.get("kind") == "native_fp":
            slots = payload["slots"]
            out["algos"][algo] = {
                "kind": "fp",
                "h1": payload["h1"],
                "h2": payload["h2"],
                "rows": (storage.engine.read_rows(algo, slots)
                         if len(slots) else np.empty((0, 0), np.int32)),
            }
            continue
        if payload.get("kind") == "partitioned_native_fp":
            # Host-partitioned index: fingerprints are geometry-free once
            # merged with their global slot ids (the partitioned dump is
            # only partition-ADDRESSED, not partition-HASHED), so the
            # export is the same flat 'fp' payload — importable into flat
            # native targets; import into a partitioned target refuses
            # (fingerprints cannot be re-routed).
            index = storage._index[algo]
            h1, h2, slots = index.dump_fp()
            out["algos"][algo] = {
                "kind": "fp",
                "h1": h1,
                "h2": h2,
                "rows": (storage.engine.read_rows(algo, slots)
                         if len(slots) else np.empty((0, 0), np.int32)),
            }
            continue
        if payload.get("kind") == "sharded_native_fp":
            raise ValueError(
                "sharded native dumps cannot be exported per key "
                "(fingerprints cannot be re-sharded); construct the "
                "storage with checkpointable=True for keyed export")
        entries = payload["entries"]
        if not entries:
            out["algos"][algo] = []
            continue
        slots = [slot for _, slot in entries]
        rows = storage.engine.read_rows(algo, slots)
        out["algos"][algo] = [
            [key, [int(v) for v in row]] for (key, _), row in zip(entries, rows)
        ]
    return out


def import_keys(storage, dump: Dict) -> None:
    """Assign slots for exported keys in ``storage`` and write their state.

    The target may have any geometry (more slots, different shard count,
    flat vs sharded). Keys route through the target's own index, so shard
    placement follows the target's hash — this IS the rebalance.

    Refuses up front (before touching the target) when the dump's format
    differs, when limiter registrations don't line up, or when the target
    lacks capacity for the new keys — a partial import would silently hand
    fresh quota to keys the export showed as consumed.
    """
    if dump.get("format", FORMAT_VERSION) not in SUPPORTED_VERSIONS:
        raise ValueError(
            f"unsupported export format: {dump.get('format')}")
    # Limiter ids inside index keys are SOURCE lids; they must mean the
    # same policy in the target or imported state attaches to the wrong
    # limiter (or to none).  Rate drift carrying a newer policy
    # generation is a live update and is adopted (the exported keys'
    # state was consumed under the dump's policies); anything else
    # refuses before touching the target.
    apply_limiter_policies(storage, dump.get("limiters", {}),
                           register_missing=False)
    # Capacity pre-check: every key not already present needs a free slot.
    # For sharded targets the check is PER SHARD — capacity there is not
    # fungible (a key's shard is fixed by hash), so a global count could
    # pass while one shard overflows mid-import, leaving a partial import.
    for algo, entries in dump.get("algos", {}).items():
        index = storage._index[algo]
        if isinstance(entries, dict) and entries.get("kind") == "fp":
            # The port's partitioned index assigns fingerprints of string
            # batches (routed by h1), but a fingerprint does not say how
            # its key routed, so it refuses here as the reference's does.
            if (not hasattr(index, "assign_batch_fps")
                    or hasattr(index, "_parts")):
                raise ValueError(
                    "fingerprint export requires a flat native-index "
                    "target (fingerprints cannot be re-keyed or "
                    "re-sharded)")
            present = index.lookup_fps(entries["h1"], entries["h2"]) >= 0
            new = int((~present).sum())
            free = index.num_slots - len(index)
            if new > free:
                raise ValueError(
                    f"target storage is too small for the export ({new} "
                    f"new {algo} fingerprints, {free} free slots)")
        elif hasattr(index, "_sub") or hasattr(index, "_parts"):
            # Capacity is per shard/partition — a key's placement is fixed
            # by hash, so a global count could pass while one bucket
            # overflows mid-import, leaving a partial import.
            subs = index._sub if hasattr(index, "_sub") else index._parts
            per_sub_cap = (index.slots_per_shard if hasattr(index, "_sub")
                           else index.slots_per_part)
            new_per_sub = [0] * len(subs)
            for key, _ in entries:
                key = tuple(key) if isinstance(key, list) else key
                bucket = shard_of_key(key, len(subs))
                if subs[bucket].get(key) is None:
                    new_per_sub[bucket] += 1
            word = "shard" if hasattr(index, "_sub") else "partition"
            for bucket, (sub, new) in enumerate(zip(subs, new_per_sub)):
                free = per_sub_cap - len(sub)
                if new > free:
                    raise ValueError(
                        f"target {word} {bucket} is too small for the "
                        f"export ({new} new {algo} keys, {free} free "
                        "slots)")
        else:
            new = sum(
                1 for key, _ in entries
                if index.get(tuple(key) if isinstance(key, list) else key)
                is None)
            free = index.num_slots - len(index)
            if new > free:
                raise ValueError(
                    f"target storage is too small for the export ({new} new "
                    f"{algo} keys, {free} free slots)")
    for algo, entries in dump.get("algos", {}).items():
        if isinstance(entries, dict) and entries.get("kind") == "fp":
            if not len(entries["h1"]):
                continue
            index = storage._index[algo]
            # Dump order is MRU-first; assign REVERSED so the source's
            # most-recent fingerprint is also assigned last (= most recent
            # in the target), preserving eviction order across a rebalance.
            slots, evicted = index.assign_batch_fps(
                entries["h1"][::-1], entries["h2"][::-1])
            if len(evicted):  # pre-check makes this unreachable
                raise ValueError(
                    "eviction during import despite capacity check")
            rows = np.asarray(entries["rows"], dtype=np.int32)[::-1]
            storage.engine.write_rows(algo, slots, rows)
            continue
        if not entries:
            continue
        index = storage._index[algo]
        slots = []
        for key, _ in entries:
            key = tuple(key) if isinstance(key, list) else key
            slot, evicted = index.assign(key)
            if evicted is not None:  # pre-check makes this unreachable
                raise ValueError("eviction during import despite capacity check")
            slots.append(slot)
        rows = np.asarray([row for _, row in entries], dtype=np.int32)
        storage.engine.write_rows(algo, slots, rows)
    storage.engine.block_until_ready()


# ---------------------------------------------------------------------------
# Index dump/load (Python SlotIndex only — see module docstring)
# ---------------------------------------------------------------------------

def _dump_flat(index) -> list:
    with index._lock:
        return [[list(k) if isinstance(k, tuple) else k, slot]
                for k, slot in index._map.items()]


def _fp_payload(index) -> Dict:
    """Fingerprint dump of a native index (h1/h2/slot numpy arrays, MRU
    order).  save_checkpoint moves the arrays into state.npz."""
    h1, h2, slots = index.dump_fp()
    return {"h1": h1, "h2": h2, "slots": slots}


def _restore_flat(index, entries) -> None:
    with index._lock:
        index._map.clear()
        used = set()
        for key, slot in entries:
            key = tuple(key) if isinstance(key, list) else key
            index._map[key] = int(slot)
            used.add(int(slot))
        index._free = [s for s in range(index.num_slots - 1, -1, -1)
                       if s not in used]


def dump_shard_slot_indexes(storage, shard: int) -> Dict:
    """Serialize ONE shard's key->slot sub-indexes (local slot ids) in
    the payload shape ``restore_slot_indexes`` accepts on a flat storage
    of ``slots_per_shard`` slots with one C index: the per-shard
    replication stream's index journal (replication/sharded.py).  A
    shard's standby is an ordinary flat standby, so its promotion is the
    ordinary ``promote_from_replica``."""
    out: Dict = {"algos": {}}
    for algo, index in storage._index.items():
        if not hasattr(index, "_sub"):
            raise ValueError("per-shard index dump needs the sharded "
                             "slot index")
        sub = index._sub[int(shard)]
        if hasattr(sub, "dump_fp"):
            payload = _fp_payload(sub)
            payload["kind"] = "native_fp"
            out["algos"][algo] = payload
        elif hasattr(sub, "_map"):
            out["algos"][algo] = {"kind": "flat",
                                  "entries": _dump_flat(sub)}
        else:
            raise ValueError("slot sub-index is not enumerable")
    return out


def dump_slot_indexes(storage) -> Dict:
    """Serialize key->slot maps of a GpuBatchedStorage.

    Python indexes dump their keys; native indexes dump (h1, h2, slot)
    fingerprint triples at native speed (rl_index_dump) — checkpoints
    round-trip either way.  Fingerprints are one-way, so dumps that must
    carry keys (cross-shard rebalance) need the Python index
    (checkpointable=True).
    """
    out: Dict = {"algos": {}}
    for algo, index in storage._index.items():
        if hasattr(index, "_map"):
            out["algos"][algo] = {"kind": "flat", "entries": _dump_flat(index)}
        elif hasattr(index, "_parts"):
            # Host-parallel partitioned index: per-partition fingerprint
            # dumps (local slots) + the routing-hash identity, since a
            # restore under different routing would orphan every entry.
            out["algos"][algo] = {
                "kind": "partitioned_native_fp",
                "part_hash": SHARD_HASH_VERSION,
                "n_parts": index.n_parts,
                "per_part": [_fp_payload(s) for s in index._parts],
            }
        elif hasattr(index, "dump_fp"):
            payload = _fp_payload(index)
            payload["kind"] = "native_fp"
            out["algos"][algo] = payload
        elif hasattr(index, "_sub"):
            if all(hasattr(s, "_map") for s in index._sub):
                base = index.slots_per_shard
                entries = []
                for shard, sub in enumerate(index._sub):
                    for key, local in _dump_flat(sub):
                        entries.append([key, shard * base + local])
                out["algos"][algo] = {
                    "kind": "sharded",
                    # Key->shard hash identity: a restore into a binary with
                    # a different shard hash would silently orphan every
                    # entry (lookups would miss the restored shard).
                    "shard_hash": SHARD_HASH_VERSION,
                    "entries": entries,
                }
            elif all(hasattr(s, "dump_fp") for s in index._sub):
                out["algos"][algo] = {
                    "kind": "sharded_native_fp",
                    "shard_hash": SHARD_HASH_VERSION,
                    "n_shards": index.n_shards,
                    "per_shard": [_fp_payload(s) for s in index._sub],
                }
            else:
                raise ValueError("slot sub-indexes are not enumerable")
        else:
            raise ValueError("slot index is not enumerable")
    return out


def restore_slot_indexes(storage, dump: Dict) -> None:
    for algo, payload in dump.get("algos", {}).items():
        index = storage._index[algo]
        kind = payload.get("kind")
        if kind == "native_fp":
            if hasattr(index, "_parts"):
                raise ValueError(
                    "flat fingerprint checkpoint cannot restore into a "
                    "host-partitioned index: fingerprints are one-way, so "
                    "entries cannot be re-routed to their partitions "
                    "(restore with host_parallel=0, or export/import per "
                    "key)")
            if not hasattr(index, "restore_fp"):
                raise ValueError(
                    "fingerprint checkpoint needs the native index "
                    "(restoring binary lacks it)")
            index.restore_fp(payload["h1"], payload["h2"], payload["slots"])
            continue
        if kind == "partitioned_native_fp":
            if payload.get("part_hash") != SHARD_HASH_VERSION:
                raise ValueError(
                    f"checkpoint used partition hash "
                    f"{payload.get('part_hash')!r}; this binary routes "
                    f"with {SHARD_HASH_VERSION!r} — fingerprints cannot "
                    "be re-partitioned (export/import per key instead)")
            if (not hasattr(index, "_parts")
                    or payload["n_parts"] != index.n_parts):
                raise ValueError(
                    "partitioned fingerprint checkpoint needs a "
                    f"host-parallel index with {payload['n_parts']} "
                    "partitions (restore with the same host_parallel)")
            for sub, part_p in zip(index._parts, payload["per_part"]):
                sub.restore_fp(part_p["h1"], part_p["h2"], part_p["slots"])
            continue
        if kind == "sharded_native_fp":
            if payload.get("shard_hash") != SHARD_HASH_VERSION:
                raise ValueError(
                    f"checkpoint used shard hash "
                    f"{payload.get('shard_hash')!r}; this binary routes "
                    f"with {SHARD_HASH_VERSION!r} — fingerprints cannot be "
                    "re-sharded (export/import per key instead)")
            if (not hasattr(index, "_sub")
                    or payload["n_shards"] != index.n_shards
                    or not all(hasattr(s, "restore_fp")
                               for s in index._sub)):
                raise ValueError(
                    "sharded fingerprint checkpoint needs a native sharded "
                    f"index with {payload['n_shards']} shards")
            for sub, shard_p in zip(index._sub, payload["per_shard"]):
                sub.restore_fp(shard_p["h1"], shard_p["h2"],
                               shard_p["slots"])
            continue
        entries = payload["entries"]
        if payload.get("kind") == "sharded" and hasattr(index, "_sub"):
            stored_hash = payload.get("shard_hash", LEGACY_SHARD_HASH)
            if stored_hash != SHARD_HASH_VERSION:
                # A dump written under a different KNOWN routing hash
                # restores safely only if every entry already sits where
                # the CURRENT hash routes its key.  Checking placement
                # directly is divergence-proof: it needs no model of what
                # the old hash did — any entry whose old placement matches
                # the current routing resolves correctly, and everything
                # else fails loudly (e.g. v0 int/bool keys, v1 string
                # keys, both of which routed differently than today).
                sps = index.slots_per_shard
                ok = stored_hash in PLACEMENT_CHECK_HASHES and all(
                    shard_of_key(tuple(key) if isinstance(key, list)
                                 else key, index.n_shards) == gslot // sps
                    for key, gslot in entries)
                if not ok:
                    raise ValueError(
                        f"checkpoint used shard hash {stored_hash!r}; this "
                        f"binary routes with {SHARD_HASH_VERSION!r} — "
                        "restoring would orphan entries (export/import per "
                        "key instead)")
        if hasattr(index, "_map"):
            _restore_flat(index, entries)
        elif hasattr(index, "_sub"):
            base = index.slots_per_shard
            per_shard = [[] for _ in index._sub]
            for key, gslot in entries:
                per_shard[gslot // base].append([key, gslot % base])
            for sub, sub_entries in zip(index._sub, per_shard):
                _restore_flat(sub, sub_entries)
        else:
            raise ValueError("cannot restore into a native slot index")
