"""``walk_ns_per_request.stream``: the host slot index's assign seconds
(``assign_s`` of the storage's ``stream_stats`` records, wherever the
assign ran) per request, over every chunk of the window, in ns."""


def read(run):
    recs = run.window.records
    if run.kind != "stream" or not recs:
        return None
    n = sum(r["n"] for r in recs)
    return sum(r["assign_s"] for r in recs) / n * 1e9 if n else None
