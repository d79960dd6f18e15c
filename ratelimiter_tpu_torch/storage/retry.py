"""Retrying storage wrapper (counterpart of
``ratelimiter_tpu/storage/retry.py``) — the default-path analog of the
reference's per-op retry (RedisRateLimitStorage.java:155-178: every
storage operation runs through executeWithRetry, 3 attempts with linear
10/20/30 ms backoff, then surfaces StorageException).

Composition order in service/wiring.py is ``retry(chaos(storage))`` so a
chaos drill exercises exactly the production failure path: transient
injected faults are absorbed by retries; only retry exhaustion escalates
to the service tier's fail-open policy (service/app.py).

Only REPLAY-SAFE ops are retried by default.  The Java wrapper retried
atomic per-key Redis commands, where a replay after a post-commit
transport fault charges at most one extra permit for one key — this
wrapper keeps that blast radius: single ``acquire`` (one request), reads,
resets, and the legacy per-key ops.  The multi-dispatch batch/stream ops
(``acquire_many*``, ``acquire_stream_ids``) mutate device state per
super-batch as they go; replaying them after a mid-stream fault would
re-charge every already-committed request in the stream, so they pass
through un-retried (their callers — bench loops, bulk ingest — own the
retry decision at whatever granularity they can make idempotent).
"""

from __future__ import annotations

from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.storage.chaos import _LEGACY_OPS
from ratelimiter_tpu_torch.storage.errors import RetryPolicy

REPLAY_SAFE_OPS = ("acquire", "available_many", "reset_key") + _LEGACY_OPS
_PASSTHROUGH_OPS = ("acquire_many", "acquire_many_ids", "acquire_stream_ids",
                    "acquire_stream_strs")


class RetryingStorage(RateLimitStorage):
    """Wraps a backend; runs replay-safe ops through RetryPolicy."""

    def __init__(self, inner: RateLimitStorage,
                 policy: RetryPolicy | None = None):
        self._inner = inner
        self.policy = policy if policy is not None else RetryPolicy()

    def __getattr__(self, name):
        # Non-op surface (register_limiter, flush, engine, trace, ...)
        # passes straight through, mirroring FaultInjectingStorage.
        return getattr(self._inner, name)

    @property
    def supports_device_batching(self):  # type: ignore[override]
        return getattr(self._inner, "supports_device_batching", False)

    def close(self) -> None:  # shutdown is not retried
        self._inner.close()

    def is_available(self) -> bool:
        # Health checks report state; retrying one would mask flapping.
        return self._inner.is_available()


def _wrap(op: str):
    def method(self, *args, **kwargs):
        return self.policy.execute(
            lambda: getattr(self._inner, op)(*args, **kwargs))

    method.__name__ = op
    return method


def _passthrough(op: str):
    def method(self, *args, **kwargs):
        return getattr(self._inner, op)(*args, **kwargs)

    method.__name__ = op
    return method


for _op in REPLAY_SAFE_OPS:
    setattr(RetryingStorage, _op, _wrap(_op))
for _op in _PASSTHROUGH_OPS:
    setattr(RetryingStorage, _op, _passthrough(_op))
# The abstract-method set was frozen before the loop filled the contract in.
RetryingStorage.__abstractmethods__ = frozenset()
