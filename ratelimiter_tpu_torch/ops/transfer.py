"""Host <-> device copies of the stream steps that never wait for the card.

A copy between pageable host memory and a CUDA device is not asynchronous:
PyTorch's ``non_blocking=False`` copy (``torch.as_tensor(x, device=...)``,
``torch.tensor(x, device=...)``, ``.cpu()``) synchronises the stream, so
the host waits for every step queued before it, and a ``non_blocking``
copy from pageable memory may be staged synchronously by CUDA.  The
stream loops keep several chunks in flight (``storage/gpu.py:
_run_chunks``), so every copy on their path goes through page-locked
memory here:

- :func:`to_device` uploads a host array: a page-locked one (a staging
  pool's buffer) goes up as it is; any other is first copied into
  PyTorch's pinned allocator, which keeps the block until the copy ran;
- :func:`device_scalar` uploads one integer (a step's ``now``, a limiter
  id) the same way;
- :func:`land` starts the copy of a step's result into a page-locked host
  array and records a CUDA event after it: the result is on the host once
  that event has completed (``Event.synchronize``, which releases the
  GIL), and not before.

On a CPU device the upload is the host array itself (no copy), as before.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(values, dtype, device: torch.device,
              counts: dict | None = None) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` (numpy's) on ``device``,
    without waiting for the card.  No copy is made on the host when
    ``values`` already has ``dtype`` and a C layout.  On a CUDA device a
    page-locked array goes up as it is and any other through a pinned
    copy; ``counts`` (``{"pinned": bytes, "copied": bytes}``), when
    given, adds the bytes to the key of the way they went.  On a CPU
    device the tensor may alias the array."""
    host = torch.from_numpy(np.ascontiguousarray(values, dtype=dtype))
    if device.type != "cuda":
        return host.to(device)
    if host.is_pinned():
        kind = "pinned"
    else:
        host = host.pin_memory()
        kind = "copied"
    if counts is not None:
        counts[kind] += host.numel() * host.element_size()
    return host.to(device, non_blocking=True)


def device_scalar(value, device: torch.device,
                  dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """One integer as a 0-d tensor on ``device`` (a tensor is converted as
    ``torch.as_tensor`` converts it), through pinned memory on a CUDA
    device."""
    if isinstance(value, torch.Tensor):
        return torch.as_tensor(value, dtype=dtype, device=device)
    host = torch.tensor(value, dtype=dtype)
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def land(tensor: torch.Tensor, host: np.ndarray) -> torch.cuda.Event:
    """Start copying the CUDA ``tensor`` into the page-locked ``host``
    array (same bytes: its shape and dtype) on the current stream and
    return the event recorded after the copy (timing enabled, blocking:
    a wait sleeps).  ``host`` must not be read, or given to anything that
    writes it, before the event has completed."""
    src = tensor.reshape(-1).view(torch.uint8)
    dst = torch.from_numpy(host.reshape(-1).view(np.uint8))
    if dst.numel() != src.numel():
        raise ValueError(f"landing {tuple(tensor.shape)} {tensor.dtype} in "
                         f"a host array of {host.nbytes} bytes")
    dst.copy_(src, non_blocking=True)
    event = torch.cuda.Event(enable_timing=True, blocking=True)
    event.record()
    return event
