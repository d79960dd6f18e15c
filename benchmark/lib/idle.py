"""The device idle share that the stream and request readers both give."""


def idle_share(run):
    """100 x (1 - busy / traced wall), busy the union of each card's
    device events inside the traced part, the mean over the cards used;
    None without a trace or without device time."""
    tr = run.window.trace
    if not tr or not tr["busy_us"] or tr["window_us"] <= 0:
        return None
    busy = sum(tr["busy_us"].values()) / run.chips
    return 100.0 * (1.0 - busy / tr["window_us"])
