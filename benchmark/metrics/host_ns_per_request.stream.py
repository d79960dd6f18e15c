"""``host_ns_per_request.stream``: the stream loops' host seconds
(``host_s`` of the ``stream_stats`` records: layout, enqueue, packing,
and on the sharded route the routing) per request, over every chunk of
the window, in ns."""


def read(run):
    recs = run.window.records
    if run.kind != "stream" or not recs:
        return None
    n = sum(r["n"] for r in recs)
    return sum(r["host_s"] for r in recs) / n * 1e9 if n else None
