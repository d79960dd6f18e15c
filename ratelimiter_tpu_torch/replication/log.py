"""Replication log: dirty-slot deltas coalesced into epoch-stamped frames
(counterpart of ``ratelimiter_tpu/replication/log.py``).

The primary's engine marks every slot a dispatch touches into a journal —
off the decision path.  Two journal backends exist (engine/state.py):

- ``DeviceSlotJournal``: the touched-slot bitmap lives on the engine's
  device and is marked by a few torch ops over the lane tensor the
  dispatch already uploaded; the decision path pays one attribute check
  plus those launches.  ``drain`` copies the bitmap to the host off the
  decision path.
- ``SlotJournal``: the host-side boolean scatter.

Which one serves: ``make_journal`` takes ``kind="device"`` and
``kind="host"`` as given, and ``kind="auto"`` takes the device journal for
an engine on CUDA and the host journal for one on the CPU.  The
reference elects ``auto`` by a measured A/B through its Pallas election
module (with a ``RATELIMITER_DEVICE_JOURNAL`` override); the port does
not carry that module, so it has neither the measurement nor the switch.

``ReplicationLog.cut()`` turns the journal's accumulated delta into wire
frames:

1. flush the micro-batcher (queued requests dispatch, marking their slots);
2. drain the journal (atomic swap — marks racing the drain land in the
   NEXT epoch, and a row read here that a concurrent dispatch then
   overwrites is simply re-shipped next cut: row writes are idempotent);
3. read the dirty rows from the device (one gather per algo);
4. dump the key->slot index journal + limiter table (the addressing a
   standby needs to serve the rows after promotion);
5. stamp everything with the next epoch and chunk to the wire budget
   (replication/wire.py).

Consistency model: a frame captures every mutation that completed before
its cut began; mutations concurrent with the cut land in this epoch, the
next, or both (both is harmless).  That holds because the engine marks a
step's slots after enqueueing the step, under the lock the row read
takes (the reference marks first, and a step its cut overtakes is lost
to the standby: ROADMAP C10).  Slot REUSE concurrent with a cut (an
eviction remapping a slot between the row read and the index dump) can
pair a new key with its predecessor's row for one epoch — the next cut
repairs it, and keys whose last mutation precedes the cut are exact,
which is precisely the "at or before the replicated epoch" guarantee the
failover drill checks (storage/chaos.py).

A sharded engine replicates per shard in the reference
(``replication/sharded.py``, ROADMAP A5 b in the port); this log
refuses one as the reference's does.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np
import torch

from ratelimiter_tpu_torch.engine.state import DeviceSlotJournal, SlotJournal
from ratelimiter_tpu_torch.replication.wire import (
    DEFAULT_FRAME_BUDGET,
    chunk_frames,
)


def _wall_ms() -> int:
    return time.time_ns() // 1_000_000


def device_journal_elected(device="cuda") -> bool:
    """Whether ``make_journal(kind="auto")`` takes the device journal for
    an engine on ``device``: on CUDA it does, on the CPU it does not."""
    return torch.device(device).type == "cuda"


def make_journal(num_slots: int, kind: str = "auto", device="cuda"):
    """Build the journal a replication log attaches: ``device`` (on
    ``device``), ``host``, or ``auto`` (:func:`device_journal_elected`)."""
    if kind not in ("auto", "device", "host"):
        raise ValueError(f"unknown journal kind: {kind!r}")
    if kind == "device" or (kind == "auto"
                            and device_journal_elected(device)):
        return DeviceSlotJournal(num_slots, device=device)
    return SlotJournal(num_slots)


def read_rows_padded(engine, algo: str, ids: np.ndarray) -> np.ndarray:
    """``engine.read_rows`` with the id lane padded to a power of two (at
    least 256), as the reference pads it to reuse a handful of gather
    shapes; the padding lanes repeat the first id and are dropped."""
    n = len(ids)
    size = 1 << max(int(n - 1).bit_length(), 8) if n else 0
    if size <= n:
        return engine.read_rows(algo, ids)
    padded = np.concatenate(
        [ids, np.full(size - n, ids[0] if n else 0, dtype=np.int64)])
    return engine.read_rows(algo, padded)[:n]


class ReplicationLog:
    """Owns the primary's journal and cuts epoch-stamped frame batches."""

    def __init__(self, storage, max_frame_bytes: int = DEFAULT_FRAME_BUDGET,
                 journal_kind: str = "auto"):
        engine = storage.engine
        if not getattr(engine, "supports_replication", False):
            raise ValueError(
                "replication requires a journaled engine "
                "(this backend has none)")
        if hasattr(engine, "n_shards"):
            raise ValueError(
                "the sharded engine replicates per shard — use "
                "replication.sharded.ShardedReplicationLog so one shard "
                "can be promoted without the world")
        self.storage = storage
        self.engine = engine
        self.max_frame_bytes = int(max_frame_bytes)
        self.journal = make_journal(engine.num_slots, journal_kind,
                                    device=engine.device)
        self.journal_kind = ("device" if getattr(self.journal, "device",
                                                 False) else "host")
        engine.journal = self.journal
        self.epoch = 0
        self._full_pending = True  # first cut bootstraps the standby
        self._lock = threading.Lock()
        # Lag of the newest cut: age of the oldest mutation it shipped.
        self.last_cut_lag_ms = 0.0

    def request_full(self) -> None:
        """Make the next cut ship the complete state (standby bootstrap,
        or recovery after a ship failure left the stream gapped)."""
        with self._lock:
            self._full_pending = True
            self.journal.mark_all("sw")
            self.journal.mark_all("tb")

    def cut(self) -> List[Dict]:
        """Cut one epoch: returns the frame dicts to ship (empty when
        nothing changed since the last cut — the epoch is not consumed)."""
        with self._lock:
            self.storage.flush()
            if self._full_pending:
                self.journal.mark_all("sw")
                self.journal.mark_all("tb")
            deltas_ids, oldest_ns, was_all = self.journal.drain()
            full = self._full_pending or was_all
            if not deltas_ids and not full:
                self.last_cut_lag_ms = 0.0
                return []
            deltas = {}
            for algo, ids in deltas_ids.items():
                deltas[algo] = {
                    "slots": ids,
                    "rows": read_rows_padded(self.engine, algo, ids),
                }
            from ratelimiter_tpu_torch.engine.checkpoint import (
                _limiter_table_dump,
                dump_slot_indexes,
            )

            index_dump = dump_slot_indexes(self.storage)
            limiters = _limiter_table_dump(self.storage)
            self.epoch += 1
            self._full_pending = False
            now = time.time_ns()
            self.last_cut_lag_ms = ((now - oldest_ns) / 1e6
                                    if oldest_ns is not None else 0.0)
            return chunk_frames(self.epoch, _wall_ms(),
                                self.engine.num_slots, deltas, index_dump,
                                limiters, full=full,
                                max_bytes=self.max_frame_bytes)

    def remark(self, frames: List[Dict]) -> None:
        """Put a failed ship's slots back in the journal so the delta is
        re-sent (the replicator also requests a full frame, since the
        standby's epoch stream now has a gap)."""
        for frame in frames:
            for algo, payload in frame.get("algos", {}).items():
                self.journal.mark(algo, payload["slots"])

    def pending(self) -> int:
        return self.journal.pending()

    def detach(self) -> None:
        """Stop journaling (the engine reverts to one attribute check a
        dispatch)."""
        self.engine.journal = None


def engine_state_fingerprint(engine) -> Dict[str, np.ndarray]:
    """Host copies of both packed state arrays (equality checks between a
    primary and a caught-up standby; the layouts are the reference's, so
    the two packages' fingerprints compare byte for byte)."""
    engine.block_until_ready()
    with engine._lock:
        return {"sw": engine.sw_packed.cpu().numpy().copy(),
                "tb": engine.tb_packed.cpu().numpy().copy()}
