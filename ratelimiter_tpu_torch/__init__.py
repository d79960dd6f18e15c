"""ratelimiter_tpu_torch — the rate limiter on PyTorch and CUDA for an
NVIDIA H100.

The port of ``ratelimiter_tpu`` (JAX on a TPU), which stays beside it as
the reference.  Decisions are micro-batched on the host and applied to
counter rows resident on the card by one gather -> decide -> scatter step
per batch, bit-identical to ``ratelimiter_tpu_torch.semantics.oracle``.
The step's two device kernels are written by hand for Hopper
(``ops/cuda/*.cu``) and built on first use.

Entry points: ``python -m ratelimiter_tpu_torch`` (the HTTP demo service,
``service/app.py``, configured by ``application.properties``), and
``storage.gpu.GpuBatchedStorage`` with the limiters of ``algorithms``.
The port imports torch and numpy, never jax.
"""

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.core.limiter import RateLimiter

__all__ = ["RateLimitConfig", "RateLimiter"]
