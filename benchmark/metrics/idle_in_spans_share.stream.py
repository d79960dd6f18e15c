"""``idle_in_spans_share.stream``: the share of the first card's idle
time in the traced part of a stream window whose gaps the trace labels
with one of the program's spans (a label starting ``rl.``: the span
that was open on the calling thread over the gap's middle), over that
card's idle time (``window_us`` - its ``busy_us``), in %.  The labelled
gaps are the ``idle_gaps`` of ``lib/trace.py:summarize``.  None without
a trace or without device time."""

SPAN_PREFIX = "rl."


def read(run):
    tr = run.window.trace
    if run.kind != "stream" or not tr or not tr["busy_us"]:
        return None
    first = sorted(tr["busy_us"])[0]
    idle_s = (tr["window_us"] - tr["busy_us"][first]) / 1e6
    if idle_s <= 0:
        return None
    in_spans = sum(s for label, s in tr["idle_gaps"]
                   if label.startswith(SPAN_PREFIX))
    return 100.0 * in_spans / idle_s
