from ratelimiter_tpu_torch.algorithms.sliding_window import SlidingWindowRateLimiter
from ratelimiter_tpu_torch.algorithms.sliding_window_log import SlidingWindowLogRateLimiter
from ratelimiter_tpu_torch.algorithms.token_bucket import TokenBucketRateLimiter

__all__ = [
    "SlidingWindowRateLimiter",
    "SlidingWindowLogRateLimiter",
    "TokenBucketRateLimiter",
]
