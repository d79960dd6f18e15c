"""The devices a sharded engine spreads its slot array over (counterpart
of ``ratelimiter_tpu/parallel/mesh.py``).

The reference builds a 1-D ``jax.sharding.Mesh`` over its chips: every key
hashes to one shard, and a shard's decisions need no other device.  The
port's counterpart is a plain list of ``torch.device``: shard ``q`` lives
on ``devices[q]`` and runs its steps on that device's own stream
(``parallel/sharded.py``).  A device may repeat, which is how one card
serves several shards and how the CPU tests run shards on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def make_devices(devices: Optional[Sequence] = None,
                 n_devices: Optional[int] = None) -> List[torch.device]:
    """The shard devices: ``devices`` as given (names or ``torch.device``,
    repeats allowed), or every visible CUDA device; the first
    ``n_devices`` of them when that is given.  Without CUDA and without an
    explicit list it raises (a sharded engine is never moved to the CPU
    quietly)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_devices: no CUDA device is visible; pass the devices "
                "(e.g. ['cpu', 'cpu']) to shard on them")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    # cuda means the current device; pin it, so shard q stays where it was
    # built whichever device a later caller makes current.
    out = [torch.device("cuda", torch.cuda.current_device())
           if d.type == "cuda" and d.index is None else d for d in out]
    if n_devices is not None:
        out = out[:int(n_devices)]
    if not out:
        raise ValueError("make_devices: no devices")
    return out
