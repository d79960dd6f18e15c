"""Shared engine error types.

``SlotCapacityError`` is raised when a batch slot assignment cannot place
every key (all slots pinned).  The C walk is not transactional: lanes
processed before the failing one WERE assigned — their evicted slots are
already remapped to new keys in the index, so their device state must be
zeroed before any reuse or a later acquire of a newly mapped key would
read the evicted key's stale counters.  ``pending_clears`` carries those
evictions (slot ids local to the raising index) up to the storage layer,
which routes them through ``_clear_slots`` exactly as the success path
does (reference analog: the Redis backend's retry wrapper surfaces every
failure as StorageException AFTER the partial pipeline effects are
already durable — storage/RedisRateLimitStorage.java:155-178).
"""

from __future__ import annotations

import numpy as np


class OverloadedError(RuntimeError):
    """A request was shed by admission control instead of queued.

    Raised by ``MicroBatcher.submit`` when the bounded pending queue is
    full (``reason="queue_full"``), by the dispatch/watchdog path when a
    queued request's deadline budget expires before it can be dispatched
    (``reason="deadline"``), and when the flusher thread has died and
    nothing will ever dispatch the queue (``reason="flusher_dead"``).

    Deliberately NOT a ``StorageException``: shedding is a local
    admission decision, not a backend fault — it must not be retried
    (retrying amplifies the overload), must not trip the circuit
    breaker, and must not be converted into a fail-open allow.  The
    service tier maps it to 429 with a Retry-After header.
    """

    def __init__(self, msg: str, reason: str = "overloaded",
                 retry_after_ms: float = 0.0):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_ms = float(retry_after_ms)


class ShutdownError(RuntimeError):
    """The batcher (or a component above it) is closed: the request was
    refused at submit, or a still-pending future was failed by
    ``MicroBatcher.close()`` instead of being left blocked forever on
    ``Future.result()``."""


class SlotCapacityError(RuntimeError):
    """Batch assignment ran out of evictable slots.

    ``pending_clears``: int32 slot ids (local to the index that raised)
    whose device state must be cleared — evictions applied by the lanes
    that succeeded before the failure.  Consumers that clear them should
    set the attribute to ``None`` so a re-raise through nested handlers
    cannot double-clear.
    """

    def __init__(self, msg: str, pending_clears=None):
        super().__init__(msg)
        self.pending_clears = (
            np.asarray(pending_clears, dtype=np.int64)
            if pending_clears is not None and len(pending_clears)
            else None)


def consume_pending_clears(exc, base: int = 0) -> list:
    """Extract an exception's ``pending_clears`` as a list of GLOBAL slot
    ids (each local id offset by ``base``) and null the attribute, so the
    same raise passing through nested handlers cannot double-clear.  The
    caller takes over responsibility for actually clearing what it got —
    use this where the clears from several sub-indexes are pooled and
    cleared in one call; a handler that clears inline should instead
    clear FIRST and null the attribute only after the clear landed (a
    clear-time failure then still propagates with the information
    intact)."""
    pc = getattr(exc, "pending_clears", None)
    if pc is None or not len(pc):
        return []
    try:
        exc.pending_clears = None
    except AttributeError:  # exotic __slots__ exception: best effort
        pass
    return [base + int(s) for s in pc]
