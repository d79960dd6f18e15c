"""The benchmark of ``ratelimiter_tpu_torch``; see ``README.md``."""
