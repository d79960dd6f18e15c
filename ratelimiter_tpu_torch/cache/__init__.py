from ratelimiter_tpu_torch.cache.ttl_cache import TTLCache

__all__ = ["TTLCache"]
