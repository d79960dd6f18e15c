"""``request_decisions_per_s``: every ``try_acquire`` that returned
inside the window, over the window's seconds."""


def read(run):
    if run.kind != "requests" or run.window.seconds <= 0:
        return None
    return run.window.completed / run.window.seconds
