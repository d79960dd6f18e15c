from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.storage.errors import StorageException
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

__all__ = ["GpuBatchedStorage", "RateLimitStorage", "StorageException"]
