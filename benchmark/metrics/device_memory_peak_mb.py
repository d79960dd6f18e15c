"""``device_memory_peak_mb``: the peak of device memory allocated on the
fullest card (``torch.cuda.max_memory_allocated``, read after the
window), in units of 10^6 bytes; nothing off the card."""


def read(run):
    if run.memory_peak_bytes <= 0:
        return None
    return run.memory_peak_bytes / 1e6
