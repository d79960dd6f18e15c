"""``device_idle_share.stream``: the share of the traced part of a stream
window in which the card ran nothing (1 - the union of its device
events over the traced wall), the mean over the cards used, in %."""

from benchmark.lib.idle import idle_share


def read(run):
    return idle_share(run) if run.kind == "stream" else None
