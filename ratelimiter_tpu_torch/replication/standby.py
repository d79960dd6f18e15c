"""Hot-standby receiver: applies replication frames to a shadow engine
(counterpart of ``ratelimiter_tpu/replication/standby.py``).

The standby owns an idle ``GpuBatchedStorage`` of the SAME geometry as
the primary (num_slots must match — rows address slots 1:1, like
checkpoints).  Frames apply as they arrive:

- limiter registrations replay in lid order (device decisions gather
  policy rows by lid, so lids must mean the same policy on both sides);
- state rows write straight into the shadow engine's resident tensors
  through ``engine.write_rows`` (the row scatter ``rl_scatter_rows`` on
  the card; idempotent — a re-shipped row is a no-op);
- the epoch's LAST sub-frame carries the key->slot index journal, which
  is stashed (not applied): the standby's own index stays empty until
  promotion, so nothing can route traffic into half-replicated state.

Epoch accounting: frames must arrive in epoch order with no gaps.  A gap
(lost frames, a restarted primary) marks the receiver INCONSISTENT — it
keeps applying rows (they only ever move the shadow closer to the
primary) but refuses to promote until a ``full`` frame re-baselines the
stream.  The ``epoch_gap`` counter makes the event observable.  A STALE
delta frame (epoch at or before the newest applied — reordered or
duplicated delivery) is REFUSED outright: its rows are older truth and
applying them would regress newer state; the receiver counts it in
``reordered``, goes inconsistent, and waits for a full frame.  Full
frames always apply — they carry complete current state and re-baseline
unconditionally (including a restarted primary whose epochs reset).

``promote()`` is failover: rebuild the key->slot index from the last
replicated journal frame (``GpuBatchedStorage.promote_from_replica``),
bump the failover counter, and return the storage — now serving
decisions bit-identical to the oracle for every key whose last mutation
was at or before the promoted epoch (tests/test_torch_replication.py
drives the differential).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ratelimiter_tpu_torch.replication.wire import decode_frame


class ReplicationStateError(RuntimeError):
    """Promotion refused: the replica stream is gapped or unbootstrapped."""


class StandbyReceiver:
    """Applies frames to a shadow storage; promotes it on failover."""

    def __init__(self, storage, registry=None, start_epoch: int = 0):
        self.storage = storage
        self.last_epoch = int(start_epoch)
        # A receiver seeded from a checkpoint taken at epoch E starts
        # consistent at E; a fresh one must first see a full frame.
        self.consistent = start_epoch > 0
        self.promoted = False
        self._index_dump: Optional[Dict] = None
        self._lock = threading.Lock()
        # Promotion race guard: exactly ONE promote() wins; a concurrent
        # caller (orchestrator vs manual actuator POST) gets the typed
        # retryable refusal instead of double-rebuilding the index.
        self._promote_guard = threading.Lock()
        self._promote_inflight = False
        self._frames_applied = 0
        self.reordered = 0
        # Frames arriving AFTER promotion are refused outright: the
        # shadow is now the SERVING primary, and a zombie old-primary
        # still shipping deltas would silently overwrite live decisions
        # (the replication-side twin of the dispatch fence).
        self.refused_after_promote = 0
        if registry is not None:
            self._applied_epoch = registry.gauge(
                "ratelimiter.replication.applied_epoch",
                "Newest fully applied replication epoch")
            self._gaps = registry.counter(
                "ratelimiter.replication.epoch_gap",
                "Replication epoch gaps observed (stream inconsistent "
                "until the next full frame)")
            self._failovers = registry.counter(
                "ratelimiter.replication.failovers",
                "Standby promotions executed")
            self._reordered = registry.counter(
                "ratelimiter.replication.reordered",
                "Stale/reordered delta frames refused (stream "
                "inconsistent until the next full frame)")
        else:
            self._applied_epoch = self._gaps = self._failovers = None
            self._reordered = None

    # -- frame application ----------------------------------------------------
    def apply_bytes(self, data: bytes) -> None:
        self.apply(decode_frame(data))

    def apply(self, frame: Dict) -> None:
        with self._lock:
            if self.promoted:
                self.refused_after_promote += 1
                from ratelimiter_tpu_torch.observability import flight_recorder

                flight_recorder().record(
                    "replication.frame_after_promote", coalesce_ms=1000.0,
                    epoch=int(frame.get("epoch", -1)))
                raise ReplicationStateError(
                    "this standby was promoted and is serving; a frame "
                    "arriving now is a zombie primary still shipping — "
                    "refused (fence the old primary)")
            if frame["num_slots"] != self.storage.engine.num_slots:
                raise ValueError(
                    f"frame geometry {frame['num_slots']} != standby "
                    f"{self.storage.engine.num_slots}; replication is "
                    "geometry-locked (like checkpoints)")
            epoch = int(frame["epoch"])
            if frame.get("full") and frame.get("seq", 0) == 0:
                # A full frame re-baselines the stream unconditionally.
                self.consistent = True
            elif epoch <= self.last_epoch and not frame.get("full"):
                # Stale delta (reordered/duplicated delivery): its rows
                # are OLDER truth — applying them would regress state the
                # newer epochs already wrote.  Refuse the frame, mark the
                # stream inconsistent, wait for a full re-baseline.
                self.consistent = False
                self.reordered += 1
                if self._reordered is not None:
                    self._reordered.increment()
                from ratelimiter_tpu_torch.observability import flight_recorder

                flight_recorder().record(
                    "replication.reordered", coalesce_ms=1000.0,
                    epoch=epoch, applied_epoch=self.last_epoch)
                return
            elif epoch > self.last_epoch + 1 and not frame.get("full"):
                self.consistent = False
                if self._gaps is not None:
                    self._gaps.increment()
            if "limiters" in frame:
                self._register_limiters(frame["limiters"])
            for algo, payload in frame.get("algos", {}).items():
                self.storage.engine.write_rows(
                    algo, payload["slots"], payload["rows"])
            self._frames_applied += 1
            if frame.get("last"):
                self._index_dump = frame.get("index")
                self.last_epoch = epoch
                if self._applied_epoch is not None:
                    self._applied_epoch.set(epoch)

    def _register_limiters(self, limiters: Dict) -> None:
        """Replay the primary's limiter registrations (lid order) and
        verify rows already registered still agree.  A row that differs
        only in its RATES and carries a newer policy generation is a
        live policy update (ARCHITECTURE §15) and is applied at the
        primary's stamp — a promoted standby must serve the post-update
        generation; shape drift (algo/window) or an unexplained rate
        difference stays a hard error, since a drifted policy would
        silently mis-decide every replicated row of that tenant."""
        from ratelimiter_tpu_torch.engine.checkpoint import (
            apply_limiter_policies,
        )

        apply_limiter_policies(self.storage, limiters,
                               register_missing=True)

    # -- failover -------------------------------------------------------------
    def promote(self, force: bool = False):
        """Promote the shadow to serving primary; returns its storage.

        Exactly one caller wins: a promote racing an in-flight promote
        (auto-orchestrator vs manual actuator POST) gets the typed
        retryable ``PromotionInProgressError``; a promote arriving after
        one already completed gets ``ReplicationStateError`` (the storage
        is already serving — promoting twice would rebuild a live index
        under traffic).
        """
        from ratelimiter_tpu_torch.storage.errors import (
            PromotionInProgressError,
        )

        with self._promote_guard:
            if self._promote_inflight:
                raise PromotionInProgressError(
                    "another promotion of this standby is in flight; "
                    "exactly one wins")
            if self.promoted:
                raise ReplicationStateError(
                    "this standby is already promoted and serving")
            self._promote_inflight = True
        try:
            with self._lock:
                if not self.consistent and not force:
                    raise ReplicationStateError(
                        "replica stream is gapped/unbootstrapped; wait "
                        "for a full frame or promote(force=True) to "
                        "accept data loss beyond the last consistent "
                        "epoch")
                if self._index_dump is None and not force:
                    raise ReplicationStateError(
                        "no index journal replicated yet; nothing to "
                        "promote")
                if self._index_dump is not None:
                    self.storage.promote_from_replica(self._index_dump)
                self.promoted = True
                if self._failovers is not None:
                    self._failovers.increment()
                from ratelimiter_tpu_torch.observability import flight_recorder

                flight_recorder().record("replication.promote",
                                         epoch=self.last_epoch,
                                         forced=force)
                return self.storage
        finally:
            with self._promote_guard:
                self._promote_inflight = False

    @property
    def frames_applied(self) -> int:
        return self._frames_applied
