from ratelimiter_tpu_torch.parallel.mesh import make_devices
from ratelimiter_tpu_torch.parallel.sharded import (
    ShardedDeviceEngine,
    ShardedSlotIndex,
    shard_of_key,
)

__all__ = [
    "make_devices",
    "ShardedDeviceEngine",
    "ShardedSlotIndex",
    "shard_of_key",
]
