"""The benchmark's yardstick: traffic generation, the run of one cell,
the reading of traces and stream records into metrics, the roofline
arithmetic and the comparison that decides ``correct``.

Nothing here imports JAX or the JAX package; the system under test is
``ratelimiter_tpu_torch``, reached only through ``lib/system.py``.
"""
