from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.storage.breaker import CircuitBreakerStorage
from ratelimiter_tpu_torch.storage.chaos import FaultInjectingStorage
from ratelimiter_tpu_torch.storage.degraded import DegradedHostLimiter
from ratelimiter_tpu_torch.storage.errors import (
    CircuitOpenError,
    RetryPolicy,
    StorageException,
)
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from ratelimiter_tpu_torch.storage.memory import InMemoryStorage
from ratelimiter_tpu_torch.storage.retry import RetryingStorage

__all__ = [
    "CircuitBreakerStorage",
    "CircuitOpenError",
    "DegradedHostLimiter",
    "FaultInjectingStorage",
    "GpuBatchedStorage",
    "InMemoryStorage",
    "RateLimitStorage",
    "RetryingStorage",
    "RetryPolicy",
    "StorageException",
]
