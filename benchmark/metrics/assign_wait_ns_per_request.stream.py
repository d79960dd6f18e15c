"""``assign_wait_ns_per_request.stream``: how long the calling thread
waited for the chunks' slot assigns (``assign_wait_s`` of the storage's
``stream_stats`` records: the first chunk's whole assign, a prefetched
chunk's wait on its future) per request, over every chunk of the window,
in ns.  None where the records carry no such field."""


def read(run):
    recs = run.window.records
    if run.kind != "stream" or not recs or any(
            "assign_wait_s" not in r for r in recs):
        return None
    n = sum(r["n"] for r in recs)
    return sum(r["assign_wait_s"] for r in recs) / n * 1e9 if n else None
