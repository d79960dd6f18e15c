"""``route_ns_per_request.stream``: the sharded route's seconds
(``route_s`` of the ``stream_stats`` records) per request, over every
chunk of the window that carries one, in ns; nothing off the sharded
route."""


def read(run):
    recs = [r for r in (run.window.records or []) if "route_s" in r]
    if run.kind != "stream" or not recs:
        return None
    n = sum(r["n"] for r in recs)
    return sum(r["route_s"] for r in recs) / n * 1e9 if n else None
