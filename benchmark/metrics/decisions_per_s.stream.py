"""``decisions_per_s.stream``: the stream rate of a traced run, every
decision of the window's calls over the window's seconds, as
``stream_decisions_per_s`` reads it untraced."""


def read(run):
    if run.kind != "stream" or run.window.seconds <= 0:
        return None
    return run.window.completed / run.window.seconds
