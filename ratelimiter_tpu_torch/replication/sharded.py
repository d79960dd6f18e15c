"""Shard-aware replication: per-shard epochs, the standby set, one-shard
failover (counterpart of ``ratelimiter_tpu/replication/sharded.py``).

The flat pipeline (log.py / replicator.py / standby.py) replicates one
engine as one stream.  A sharded deployment must not: a whole-world
standby forces a whole-world promotion.  Here each shard of a
``parallel.ShardedDeviceEngine`` ships its own delta stream:

- ``ShardedReplicationLog`` owns one journal over the global slot space
  (on the engine's first device when that is a card) and cuts per-shard
  epochs: the drained dirty set is bucketed by ``slot //
  slots_per_shard``, and shard q's frames carry LOCAL slot ids, shard q's
  key->slot sub-index and ``num_slots = slots_per_shard``, so a shard's
  standby is an ordinary flat standby of ``slots_per_shard`` slots
  running the ordinary ``StandbyReceiver``.  Nothing on the standby side
  is shard-special, which keeps promotion the flat path.
- ``ShardedReplicator`` ships every shard's stream on one cadence with
  per-shard failure isolation: a dead link to standby q re-marks only q's
  delta and re-baselines only q; the other shards' streams never stall.
- ``ShardStandbySet`` is the standby set: one flat storage and receiver a
  shard.
- ``ShardFailoverRouter`` is the serving facade after a shard failure:
  requests route by the engine's own key->shard hash
  (``engine/routing.py``); a failed shard's keys are denied (fail-closed,
  counted) until its standby is promoted, then served by the promoted
  flat storage while the surviving shards keep serving from the primary:
  the DEGRADED-shard state the health payload reports instead of DOWN.

The cut and the journal's marks (ROADMAP C10).  The reference's sharded
engine marks a dispatch's slots before its step, so a cut that drains
those marks and reads the rows before the step lands ships the old rows
and nothing marks them again.  The port's engine marks after enqueueing
each step, under the shard lock, and ``engine.read_rows`` reads each
shard under every shard lock on the shard's own stream: a mark the cut
drains belongs to a step queued before the row read on the same stream,
and a mark that misses the drain lands in the next epoch.

``storage/chaos.py:shard_failover_drill`` proves the contract: kill one
shard of N mid-Zipf-stream, promote only it, decisions equal to
``semantics/oracle.py`` after promotion while the survivors never stop.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ratelimiter_tpu_torch.engine.routing import (
    shard_of_int_keys,
    shard_of_key,
)
from ratelimiter_tpu_torch.replication.log import (
    make_journal,
    read_rows_padded,
)
from ratelimiter_tpu_torch.replication.wire import (
    DEFAULT_FRAME_BUDGET,
    chunk_frames,
    encode_frame,
)
from ratelimiter_tpu_torch.storage.gpu import check_tb_permits
from ratelimiter_tpu_torch.utils.logging import get_logger

_log = get_logger("replication.sharded")


def _wall_ms() -> int:
    return time.time_ns() // 1_000_000


class ShardedReplicationLog:
    """Per-shard epoch cuts over one global dirty-slot journal."""

    def __init__(self, storage, max_frame_bytes: int = DEFAULT_FRAME_BUDGET,
                 journal_kind: str = "auto"):
        engine = storage.engine
        if not hasattr(engine, "n_shards"):
            raise ValueError(
                "ShardedReplicationLog requires the sharded engine; use "
                "ReplicationLog for a single-device one")
        self.storage = storage
        self.engine = engine
        self.n_shards = int(engine.n_shards)
        self.slots_per_shard = int(engine.slots_per_shard)
        self.max_frame_bytes = int(max_frame_bytes)
        self.journal = make_journal(engine.num_slots, journal_kind,
                                    device=engine.device)
        self.journal_kind = ("device" if getattr(self.journal, "device",
                                                 False) else "host")
        engine.journal = self.journal
        self.epochs = [0] * self.n_shards
        self._full_pending = [True] * self.n_shards  # bootstrap each shard
        # Drained but not yet cut dirty ids a shard an algo (global).
        self._pending: List[Dict[str, List[np.ndarray]]] = [
            {"sw": [], "tb": []} for _ in range(self.n_shards)]
        self._lock = threading.Lock()
        self.last_cut_lag_ms = 0.0
        # The newest cut that shipped, a shard: whether it was full, the
        # rows it read, and its wall milliseconds (the whole cut, the row
        # read, the index dump).
        self.last_cuts: List[Optional[Dict]] = [None] * self.n_shards

    # -- journal plumbing ------------------------------------------------------
    def _drain_into_pending(self) -> None:
        """Drain the global journal and bucket the dirty ids by shard
        (caller holds the lock)."""
        deltas, oldest_ns, was_all = self.journal.drain()
        if was_all:
            # A whole-state mark (a restore or an import) dirties every
            # shard completely: their next cuts ship full frames so the
            # receivers re-baseline instead of seeing a partial overlay.
            for q in range(self.n_shards):
                self._full_pending[q] = True
        for algo, ids in deltas.items():
            shard = ids // self.slots_per_shard
            for q in np.unique(shard):
                self._pending[int(q)][algo].append(ids[shard == q])
        if oldest_ns is not None:
            self.last_cut_lag_ms = (time.time_ns() - oldest_ns) / 1e6
        else:
            self.last_cut_lag_ms = 0.0

    def request_full(self, shard: Optional[int] = None) -> None:
        """Re-baseline one shard's stream (or all of them)."""
        with self._lock:
            shards = range(self.n_shards) if shard is None else [int(shard)]
            for q in shards:
                self._full_pending[q] = True

    def cut_shard(self, shard: int) -> List[Dict]:
        """Cut one epoch of one shard; the frames carry LOCAL slot ids and
        the shard's sub-index (empty when nothing changed)."""
        q = int(shard)
        sps = self.slots_per_shard
        with self._lock:
            t0 = time.perf_counter()
            self.storage.flush()
            self._drain_into_pending()
            full = self._full_pending[q]
            if full:
                # A full frame carries the whole shard.
                base = np.arange(q * sps, (q + 1) * sps, dtype=np.int64)
                for algo in ("sw", "tb"):
                    self._pending[q][algo] = [base]
            deltas = {}
            t_rows = time.perf_counter()
            for algo in ("sw", "tb"):
                chunks = self._pending[q][algo]
                if not chunks:
                    continue
                self._pending[q][algo] = []
                ids = (chunks[0] if len(chunks) == 1
                       else np.unique(np.concatenate(chunks)))
                deltas[algo] = {
                    "slots": ids - q * sps,  # LOCAL: the standby's slots
                    # Under every shard lock, on the shard's stream: after
                    # each step whose marks were drained (C10).
                    "rows": read_rows_padded(self.engine, algo, ids),
                }
            if not deltas and not full:
                return []
            from ratelimiter_tpu_torch.engine.checkpoint import (
                _limiter_table_dump,
                dump_shard_slot_indexes,
            )

            t_index = time.perf_counter()
            index_dump = dump_shard_slot_indexes(self.storage, q)
            t_done = time.perf_counter()
            limiters = _limiter_table_dump(self.storage)
            self.epochs[q] += 1
            self._full_pending[q] = False
            frames = chunk_frames(self.epochs[q], _wall_ms(), sps, deltas,
                                  index_dump, limiters, full=full,
                                  max_bytes=self.max_frame_bytes)
            for f in frames:
                f["shard"] = q
                f["n_shards"] = self.n_shards
            self.last_cuts[q] = {
                "full": bool(full),
                "rows": int(sum(len(d["slots"]) for d in deltas.values())),
                "cut_ms": (time.perf_counter() - t0) * 1e3,
                "rows_ms": (t_index - t_rows) * 1e3,
                "index_ms": (t_done - t_index) * 1e3,
            }
            return frames

    def cut_all(self) -> Dict[int, List[Dict]]:
        return {q: self.cut_shard(q) for q in range(self.n_shards)}

    def remark(self, shard: int, frames: List[Dict]) -> None:
        """Re-journal a failed ship's slots (the frames carry LOCAL ids)."""
        base = int(shard) * self.slots_per_shard
        for frame in frames:
            for algo, payload in frame.get("algos", {}).items():
                self.journal.mark(algo, np.asarray(payload["slots"],
                                                   dtype=np.int64) + base)

    def pending(self) -> int:
        with self._lock:
            queued = sum(len(a) for p in self._pending
                         for algo_chunks in p.values()
                         for a in algo_chunks)
            return queued + self.journal.pending()

    def detach(self) -> None:
        self.engine.journal = None


class ShardedReplicator:
    """Ships every shard's epoch stream; failures isolate a shard.

    ``sinks`` maps shard -> sink (one standby link a shard).  One cadence
    thread cuts and ships all shards; a shard whose sink fails gets its
    delta re-marked and its next frame full, while the other shards'
    streams go on this cycle."""

    def __init__(self, log: ShardedReplicationLog, sinks: Dict[int, object],
                 interval_ms: float = 200.0, registry=None):
        self.log = log
        self.sinks = dict(sinks)
        missing = set(range(log.n_shards)) - set(self.sinks)
        if missing:
            raise ValueError(f"no sink for shard(s) {sorted(missing)}")
        self.interval_ms = float(interval_ms)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._ship_lock = threading.Lock()
        self.frames_shipped = 0
        self.bytes_shipped = 0
        self.errors = 0
        self.shard_errors = [0] * log.n_shards
        self._shard_last_error: List[Optional[str]] = [None] * log.n_shards
        # Shards handed to a promoted replacement: their standby now
        # SERVES, and more frames into it would corrupt it, so the
        # orchestrator drops the shard from the stream.
        self._dropped: set = set()
        self._shard_link_last: List[Optional[str]] = [None] * log.n_shards
        if registry is not None:
            self._m_lag = registry.gauge(
                "ratelimiter.replication.lag_ms",
                "Age (ms) of the oldest unreplicated mutation at the "
                "last epoch cut")
            self._m_frames = registry.counter(
                "ratelimiter.replication.frames",
                "Replication frames shipped to the standby")
            self._m_bytes = registry.counter(
                "ratelimiter.replication.bytes",
                "Encoded replication bytes shipped")
            self._m_errors = registry.counter(
                "ratelimiter.replication.errors",
                "Replication ship failures (frames re-marked, next "
                "frame full)")
            self._m_links_dead = registry.gauge(
                "ratelimiter.replication.links_dead",
                "Standby-set links currently marked DEAD (standby gone, "
                "its replica going stale)")
        else:
            self._m_lag = self._m_frames = None
            self._m_bytes = self._m_errors = None
            self._m_links_dead = None

    def ship_now(self) -> int:
        """One synchronous cycle over every shard; returns the frames
        shipped.  A shard's failure is isolated (counted, re-marked,
        re-baselined); the cycle always completes."""
        shipped = 0
        with self._ship_lock:
            for q in range(self.log.n_shards):
                if q in self._dropped:
                    continue
                shipped += self._ship_shard(q)
                self._observe_link(q)
            if self._m_lag is not None:
                self._m_lag.set(self.log.last_cut_lag_ms)
            if self._m_links_dead is not None:
                self._m_links_dead.set(float(sum(
                    1 for s in self._shard_link_last if s == "dead")))
        return shipped

    def drop_shard(self, q: int) -> None:
        """Stop shipping one shard's stream (its standby was promoted and
        serves).  The shard's pending delta stays in the journal; it is
        never cut."""
        with self._ship_lock:
            self._dropped.add(int(q))

    def restore_shard(self, q: int, sink=None) -> None:
        """Resume a dropped shard's stream (the operator's unfence):
        optionally with a fresh sink (a replaced standby's receiver), and
        re-baselined by a full frame on the next cut."""
        with self._ship_lock:
            self._dropped.discard(int(q))
            if sink is not None:
                self.sinks[int(q)] = sink
        self.log.request_full(int(q))

    def dropped_shards(self) -> set:
        with self._ship_lock:
            return set(self._dropped)

    def shard_link_state(self, q: int) -> str:
        fn = getattr(self.sinks[int(q)], "link_state", None)
        return fn() if fn is not None else "unknown"

    def _observe_link(self, q: int) -> None:
        state = self.shard_link_state(q)
        if state == self._shard_link_last[q] or state == "unknown":
            return
        from ratelimiter_tpu_torch.observability import flight_recorder

        if state == "dead":
            flight_recorder().record("replication.link_dead", shard=q)
            _log.warning("shard %d standby link marked DEAD (standby "
                         "gone, not merely slow); its replica is going "
                         "stale", q)
        elif state == "up" and self._shard_link_last[q] == "dead":
            flight_recorder().record("replication.link_restored", shard=q)
        self._shard_link_last[q] = state

    def _ship_shard(self, q: int) -> int:
        sink = self.sinks[q]
        consume = getattr(sink, "consume_reconnected", None)
        if consume is not None and consume():
            _log.warning("shard %d replication link reconnected; "
                         "re-baselining with a full frame", q)
            self.log.request_full(q)
        frames = self.log.cut_shard(q)
        if not frames:
            # An idle cycle for this shard: a heartbeat, so a silently
            # dead standby shows with no deltas flowing.
            hb = getattr(sink, "heartbeat", None)
            if hb is not None:
                hb()
            return 0
        shipped = 0
        try:
            for frame in frames:
                data = encode_frame(frame)
                sink.send(data)
                shipped += 1
                self.frames_shipped += 1
                self.bytes_shipped += len(data)
                if self._m_frames is not None:
                    self._m_frames.increment()
                    self._m_bytes.add(len(data))
            self._shard_last_error[q] = None
        except Exception as exc:  # noqa: BLE001 — isolate to this shard
            self.errors += 1
            self.shard_errors[q] += 1
            self._shard_last_error[q] = str(exc)[:200]
            if self._m_errors is not None:
                self._m_errors.increment()
            self.log.remark(q, frames[shipped:])
            self.log.request_full(q)
            _log.warning("shard %d replication ship failed: %s (delta "
                         "re-marked; next frame full)", q, exc)
        return shipped

    def start(self) -> "ShardedReplicator":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="sharded-replicator", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_ms / 1000.0):
            try:
                self.ship_now()
            except Exception as exc:  # noqa: BLE001 — the loop survives
                _log.warning("sharded replication cycle failed: %s", exc)

    def stop(self, final_ship: bool = False) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_ship:
            try:
                self.ship_now()
            except Exception as exc:  # noqa: BLE001 — best effort
                _log.warning("final sharded ship failed: %s", exc)
        self._stop.clear()

    def close(self) -> None:
        self.stop()
        self.log.detach()
        for sink in self.sinks.values():
            if hasattr(sink, "close"):
                sink.close()

    def lag_ms(self) -> float:
        return self.log.last_cut_lag_ms

    def shard_status(self) -> Dict[int, Dict]:
        return {q: {"epoch": self.log.epochs[q],
                    "errors": self.shard_errors[q],
                    "last_error": self._shard_last_error[q],
                    "link": self.shard_link_state(q),
                    "dropped": q in self._dropped}
                for q in range(self.log.n_shards)}


class ShardStandbySet:
    """The standby set: one flat storage of ``slots_per_shard`` slots and
    its receiver a shard.  ``storage_factory()`` builds one such storage;
    the caller owns its device, clock and configuration.  A shard's
    frames carry one C index's fingerprint dump, which a partitioned
    index cannot restore, so the factory builds its storage with
    ``host_parallel=0`` (the wiring and the drills do)."""

    def __init__(self, n_shards: int, storage_factory: Callable[[], object],
                 registry=None):
        self.n_shards = int(n_shards)
        from ratelimiter_tpu_torch.replication.standby import StandbyReceiver

        self.storages = [storage_factory() for _ in range(self.n_shards)]
        self.receivers = [StandbyReceiver(s, registry=registry)
                          for s in self.storages]

    def in_process_sinks(self) -> Dict[int, object]:
        from ratelimiter_tpu_torch.replication.transport import InProcessSink

        return {q: InProcessSink(rx) for q, rx in enumerate(self.receivers)}

    def promote(self, shard: int, force: bool = False):
        """Promote ONE shard's standby; returns its (flat) storage."""
        return self.receivers[int(shard)].promote(force=force)

    def replace(self, shard: int, storage, receiver) -> None:
        """Swap in a re-seeded standby for one shard (the orchestrator's
        RESTORED step: the old standby was promoted to serving, this one
        returns the system to N+1)."""
        q = int(shard)
        self.storages[q] = storage
        self.receivers[q] = receiver

    def close(self, except_shards: tuple = ()) -> None:
        for q, storage in enumerate(self.storages):
            if q not in except_shards:
                storage.close()


class ShardFailoverRouter:
    """Serving facade over a sharded primary plus promoted replacements.

    Routes by the engine's own key->shard hash (``engine/routing.py``, as
    ``ShardedSlotIndex`` routes).  A shard marked failed is DENIED
    (fail-closed, counted: bounded under-admission during the promotion
    window) until ``install_replacement`` hands its keys to a promoted
    flat storage; every other shard keeps serving from the primary.  A
    call whose keys span several backends is split by shard and its
    results reassembled in the caller's order.  ``shard_health()`` feeds
    the health payload's DEGRADED-shard state (service/app.py)."""

    def __init__(self, primary):
        engine = primary.engine
        if not hasattr(engine, "n_shards"):
            raise ValueError("ShardFailoverRouter wraps a sharded storage")
        self.primary = primary
        self.n_shards = int(engine.n_shards)
        self.replacements: Dict[int, object] = {}
        self.failed: set = set()
        self.unavailable_denies = 0
        self._lock = threading.Lock()
        # When each shard entered its state (wall ms for operators,
        # monotonic for durations): the DEGRADED-shard payload reports
        # both.
        now_w, now_m = _wall_ms(), time.monotonic()
        self._state_since_wall = [now_w] * self.n_shards
        self._state_since_mono = [now_m] * self.n_shards

    def _mark_transition(self, shard: int) -> None:
        """Caller holds the lock."""
        self._state_since_wall[shard] = _wall_ms()
        self._state_since_mono[shard] = time.monotonic()

    # -- failover control ------------------------------------------------------
    def fail_shard(self, shard: int) -> None:
        with self._lock:
            self.failed.add(int(shard))
            self._mark_transition(int(shard))
        from ratelimiter_tpu_torch.observability import flight_recorder

        flight_recorder().record("shard.failed", shard=int(shard))

    def install_replacement(self, shard: int, storage) -> None:
        """Hand a failed shard's keyspace to a promoted flat storage."""
        with self._lock:
            self.replacements[int(shard)] = storage
            self.failed.discard(int(shard))
            self._mark_transition(int(shard))
        from ratelimiter_tpu_torch.observability import flight_recorder

        flight_recorder().record("shard.promoted", shard=int(shard))

    def repair_shard(self, shard: int) -> None:
        """Operator repair: route ``shard``'s keys back to the PRIMARY.

        The exit from a terminal FAILED shard (orchestrator.unfence): the
        operator has verified that the primary's shard is healthy (a
        false dead) and its fence lifted; both the failed mark and any
        installed replacement are cleared, so routing falls through to
        the primary again."""
        with self._lock:
            self.failed.discard(int(shard))
            self.replacements.pop(int(shard), None)
            self._mark_transition(int(shard))
        from ratelimiter_tpu_torch.observability import flight_recorder

        flight_recorder().record("shard.repaired", shard=int(shard))

    def _state(self, q: int) -> str:
        """Caller holds the lock."""
        return ("failed" if q in self.failed
                else "promoted" if q in self.replacements
                else "active")

    def shard_health(self) -> Dict[int, str]:
        with self._lock:
            return {q: self._state(q) for q in range(self.n_shards)}

    def shard_status(self) -> Dict[int, Dict]:
        """Per-shard state with its transition stamps: the health
        payload's DEGRADED-shard detail (operators and the orchestrated
        drill read promotion-window bounds from ``in_state_ms``)."""
        now = time.monotonic()
        with self._lock:
            return {q: {"state": self._state(q),
                        "since_ms": self._state_since_wall[q],
                        "in_state_ms": round(
                            (now - self._state_since_mono[q]) * 1000.0, 3)}
                    for q in range(self.n_shards)}

    def degraded_shards(self) -> List[int]:
        with self._lock:
            return sorted(self.failed | set(self.replacements))

    # -- routed decision surface -------------------------------------------------
    def _shard_of_keys(self, lids, keys) -> np.ndarray:
        return np.asarray([shard_of_key((int(lid), k), self.n_shards)
                           for lid, k in zip(lids, keys)], dtype=np.int64)

    def _routed(self) -> bool:
        with self._lock:
            return bool(self.failed or self.replacements)

    def _deny(self, n: int) -> None:
        with self._lock:
            self.unavailable_denies += n

    def __getattr__(self, name):
        # Everything that is not a per-key decision surface (limiter
        # registration, flush plumbing, the legacy host-side contract,
        # engine and batcher attributes the health payload reads) passes
        # through to the sharded primary.  Decision surfaces are routed
        # below so a failed shard fails CLOSED.
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.__dict__["primary"], name)

    def acquire(self, algo, lid, key, permits, **kw):
        q = int(shard_of_key((int(lid), key), self.n_shards))
        backend = self._backend(q)
        if backend is None:
            self._deny(1)
            # Fail-closed deny; cache_value is pinned at the ceiling so a
            # local TTL cache can never turn this deny into allows.
            return {"allowed": False, "observed": np.iinfo(np.int64).max,
                    "remaining": 0, "cache_value": np.iinfo(np.int32).max}
        return backend.acquire(algo, lid, key, permits, **kw)

    @staticmethod
    def _merge(out: Dict[str, np.ndarray], idx, res, n: int) -> None:
        for name, vals in res.items():
            if name not in out:
                out[name] = np.zeros(n, dtype=np.asarray(vals).dtype)
            out[name][idx] = vals

    def acquire_many_ids(self, algo, lid, key_ids, permits):
        key_ids = np.ascontiguousarray(key_ids, dtype=np.int64)
        permits = np.asarray(permits)
        if not self._routed():
            return self.primary.acquire_many_ids(algo, lid, key_ids,
                                                 permits)
        check_tb_permits(algo, permits)
        shard = shard_of_int_keys(key_ids, self.n_shards)
        out: Dict[str, np.ndarray] = {}
        for q in np.unique(shard):
            idx = np.nonzero(shard == q)[0]
            backend = self._backend(int(q))
            if backend is None:
                self._deny(len(idx))
                res = {"allowed": np.zeros(len(idx), dtype=bool)}
            else:
                res = backend.acquire_many_ids(algo, lid, key_ids[idx],
                                               permits[idx])
            self._merge(out, idx, res, len(key_ids))
        return out

    def acquire_stream_strs(self, algo, lid, keys, permits=None, **kw):
        if not self._routed():
            return self.primary.acquire_stream_strs(algo, lid, keys,
                                                    permits=permits, **kw)
        check_tb_permits(algo, permits)
        keys = list(keys)
        shard = self._shard_of_keys([lid] * len(keys), keys)
        out = np.zeros(len(keys), dtype=bool)
        for q in np.unique(shard):
            idx = np.nonzero(shard == q)[0]
            backend = self._backend(int(q))
            if backend is None:
                self._deny(len(idx))
                continue  # denied: out is already False
            out[idx] = backend.acquire_stream_strs(
                algo, lid, [keys[i] for i in idx],
                permits=(None if permits is None
                         else np.asarray(permits)[idx]), **kw)
        return out

    def available_many(self, algo, lid, keys):
        keys = list(keys)
        out = np.zeros(len(keys), dtype=np.int64)
        shard = self._shard_of_keys([lid] * len(keys), keys)
        for q in np.unique(shard):
            idx = np.nonzero(shard == q)[0]
            backend = self._backend(int(q))
            if backend is None:
                out[idx] = 0  # a failed shard reports no availability
                continue
            out[idx] = backend.available_many(algo, lid,
                                              [keys[i] for i in idx])
        return out

    def reset_key(self, algo, lid, key) -> None:
        backend = self._backend(int(shard_of_key((int(lid), key),
                                                 self.n_shards)))
        if backend is not None:
            backend.reset_key(algo, lid, key)

    # -- lease routing (leases/manager.py) -------------------------------------
    # Reserve and credit route a key like every other decision surface:
    # the passthrough would hand them to the primary, bypassing a promoted
    # replacement, and a failed shard refuses grants (fail-closed: no
    # budget, no local admission).
    def lease_reserve(self, algo, lid, key, requested):
        backend = self._backend(int(shard_of_key((int(lid), key),
                                                 self.n_shards)))
        if backend is None:
            self._deny(1)
            return {"granted": 0, "ws": 0, "stamp": 0}
        return backend.lease_reserve(algo, lid, key, requested)

    def lease_credit(self, algo, lid, key, credit, grant_ws):
        backend = self._backend(int(shard_of_key((int(lid), key),
                                                 self.n_shards)))
        if backend is None:
            return {"credited": 0, "stamp": 0}
        return backend.lease_credit(algo, lid, key, credit, grant_ws)

    def _backend(self, q: int):
        with self._lock:
            if q in self.failed:
                return None
            return self.replacements.get(q, self.primary)

    # -- policy actuation ------------------------------------------------------
    def set_policy(self, lid, config, generation=None):
        """Broadcast a live policy update to EVERY serving backend: the
        primary assigns the generation, promoted replacements install the
        same stamp, so decisions keep one generation order across a
        failover (the replication stream already carries the updates made
        before a promotion; this covers the ones after)."""
        gen = self.primary.set_policy(lid, config, generation=generation)
        with self._lock:
            replacements = list(self.replacements.values())
        for backend in replacements:
            if backend is self.primary:
                continue
            try:
                backend.set_policy(lid, config, generation=gen)
            except KeyError:
                # A replacement that never saw the lid registered cannot
                # serve it either (registration replicates first).
                pass
        return gen

    def acquire_many(self, algo, lid_per_req, keys, permits):
        check_tb_permits(algo, permits)
        shard = self._shard_of_keys(lid_per_req, keys)
        lids = np.asarray(lid_per_req)
        perms = np.asarray(permits)
        keys = list(keys)
        out: Dict[str, np.ndarray] = {}
        for q in np.unique(shard):
            idx = np.nonzero(shard == q)[0]
            backend = self._backend(int(q))
            if backend is None:
                # The promotion window: fail closed (deny), bounded
                # under-admission, never unbounded over-admission.
                self._deny(len(idx))
                res = {"allowed": np.zeros(len(idx), dtype=bool)}
            else:
                res = backend.acquire_many(
                    algo, [int(lids[i]) for i in idx],
                    [keys[i] for i in idx], [int(perms[i]) for i in idx])
            self._merge(out, idx, res, len(keys))
        return out

    def acquire_stream_ids(self, algo, lid, key_ids, permits=None, **kw):
        key_ids = np.ascontiguousarray(key_ids, dtype=np.int64)
        if not self._routed():
            return self.primary.acquire_stream_ids(algo, lid, key_ids,
                                                   permits=permits, **kw)
        check_tb_permits(algo, permits)
        shard = shard_of_int_keys(key_ids, self.n_shards)
        out = np.zeros(len(key_ids), dtype=bool)
        with self._lock:
            special = sorted(self.failed | set(self.replacements))
        if permits is not None:
            permits = np.asarray(permits)
        multi_lid = np.ndim(lid) != 0
        lid_arr = np.asarray(lid) if multi_lid else None

        def part(idx):
            return (lid_arr[idx] if multi_lid else lid,
                    None if permits is None else permits[idx])

        live_idx = np.nonzero(~np.isin(shard, special))[0]
        if len(live_idx):
            lid_p, perm_p = part(live_idx)
            out[live_idx] = self.primary.acquire_stream_ids(
                algo, lid_p, key_ids[live_idx], permits=perm_p, **kw)
        for q in special:
            idx = np.nonzero(shard == q)[0]
            if not len(idx):
                continue
            backend = self._backend(q)
            if backend is None:
                self._deny(len(idx))
                continue  # denied: out is already False
            lid_p, perm_p = part(idx)
            out[idx] = backend.acquire_stream_ids(
                algo, lid_p, key_ids[idx], permits=perm_p, **kw)
        return out

    # -- passthrough plumbing --------------------------------------------------
    def is_available(self) -> bool:
        """Health probe: the primary must answer (a single failed shard is
        DEGRADED through :meth:`shard_health`, not unavailable)."""
        try:
            return bool(self.primary.is_available())
        except Exception:  # noqa: BLE001 — an erroring probe: unavailable
            return False

    def flush(self) -> None:
        self.primary.flush()
        with self._lock:
            reps = list(self.replacements.values())
        for r in reps:
            r.flush()

    def close(self) -> None:
        self.primary.close()
        with self._lock:
            reps = list(self.replacements.values())
        for r in reps:
            r.close()
