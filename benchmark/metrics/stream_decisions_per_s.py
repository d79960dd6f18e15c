"""``stream_decisions_per_s``: every decision of the window's stream
calls, over the window's seconds (first call sent to last call
returned)."""


def read(run):
    if run.kind != "stream" or run.window.seconds <= 0:
        return None
    return run.window.completed / run.window.seconds
