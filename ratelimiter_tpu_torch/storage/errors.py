"""Storage failure type and retry policy.

Mirrors ``storage/StorageException.java:6-15`` (unchecked failure after
retries are exhausted) and the retry wrapper
``RedisRateLimitStorage.java:155-178`` (3 attempts, linear 10/20/30 ms
backoff).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, TypeVar

from ratelimiter_tpu_torch.engine.errors import OverloadedError, ShutdownError

T = TypeVar("T")


class StorageException(RuntimeError):
    """Raised when a storage operation fails after all retries."""


class CircuitOpenError(StorageException):
    """The circuit breaker is open: the backend was not called.

    A ``StorageException`` subclass so the service tier's existing
    fail-open policy absorbs it on paths with no degraded fallback — but
    listed in ``RetryPolicy.no_retry`` because retrying a deterministic
    short-circuit only burns the backoff budget (the breaker will not
    close until its open window elapses and a half-open probe succeeds).
    """


class PromotionInProgressError(StorageException):
    """A standby promotion is rebuilding this storage's key->slot index.

    Decisions are REFUSED for the promotion window rather than risking a
    half-applied index routing a key into another key's replicated row
    (replication/standby.py).  Transient and retryable: the window is
    one index restore, after which the storage serves normally.
    """


class FencedError(StorageException):
    """This storage (or one of its shards) has been fenced by failover.

    The failover orchestrator (replication/orchestrator.py) bumps a
    monotonic fencing epoch on the storage it is replacing BEFORE
    promoting a standby: a zombie primary — declared dead on a
    false-positive health verdict but actually still running — must not
    keep admitting traffic in parallel with its replacement ("When Two
    is Worse Than One": two uncoordinated primaries over-admit without
    bound).  Unlike :class:`PromotionInProgressError` this is NOT
    transient: a fenced storage stays fenced until an operator lifts
    the fence, so it is listed in ``RetryPolicy.no_retry``.
    """


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Linear-backoff retry (RedisRateLimitStorage.java:19-20,155-178).

    Caller-side programming/validation errors (``no_retry``) pass straight
    through: the Java wrapper retried JedisException — transport faults —
    not argument errors, and converting a ValueError into StorageException
    would hand it to the fail-open policy, silently allowing requests a
    caller bug produced.  The overload/lifecycle family is equally
    non-retryable: replaying a shed request amplifies the overload it was
    shed to relieve, a closed batcher will not reopen, and an open
    breaker is deterministic until its window elapses.
    """

    max_retries: int = 3
    retry_delay_ms: float = 10.0
    no_retry: tuple = (ValueError, TypeError, KeyError,
                       OverloadedError, ShutdownError, CircuitOpenError,
                       FencedError)

    def execute(self, operation: Callable[[], T], sleep=time.sleep) -> T:
        last_exc: Exception | None = None
        for attempt in range(self.max_retries):
            try:
                return operation()
            except self.no_retry:
                raise
            except Exception as exc:  # noqa: BLE001 — transport/storage faults
                last_exc = exc
                if attempt < self.max_retries - 1:
                    sleep(self.retry_delay_ms * (attempt + 1) / 1000.0)
        raise StorageException(
            f"Operation failed after {self.max_retries} retries"
        ) from last_exc
