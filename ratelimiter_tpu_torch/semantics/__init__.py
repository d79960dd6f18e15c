from ratelimiter_tpu_torch.semantics.oracle import (
    Decision,
    SlidingWindowOracle,
    TokenBucketOracle,
)

__all__ = ["Decision", "SlidingWindowOracle", "TokenBucketOracle"]
