from ratelimiter_tpu_torch.metrics.registry import Counter, Gauge, MeterRegistry, Timer

__all__ = ["Counter", "Gauge", "MeterRegistry", "Timer"]
