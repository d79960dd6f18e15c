"""Benchmark harness of the port (counterpart of ``ratelimiter_tpu/bench``)."""
