from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.core.limiter import RateLimiter

__all__ = ["RateLimitConfig", "RateLimiter"]
