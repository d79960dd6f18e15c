"""``requests_per_step.requests``: the window's requests over its micro
steps, the steps counted by the write-back kernels' launch counters
(``tb_writeback``, ``sw_writeback``: one launch a micro step); nothing
where no kernel was launched (off the card)."""


def read(run):
    launches = run.window.launches
    if run.kind != "requests" or not launches:
        return None
    steps = launches.get("sw_writeback", 0) + launches.get(
        "tb_writeback", 0)
    return run.window.attempted / steps if steps else None
