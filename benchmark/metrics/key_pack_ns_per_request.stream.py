"""``key_pack_ns_per_request.stream``: the key packing's seconds (the
slice of the key list and its packing into bytes and offsets,
``key_pack_s`` of the storage's ``stream_stats`` records, a part of
``hash_s``) per request, over every chunk of the window, in ns.  None
where the records carry no such field (integer keys)."""


def read(run):
    recs = run.window.records
    if run.kind != "stream" or not recs or any(
            "key_pack_s" not in r for r in recs):
        return None
    n = sum(r["n"] for r in recs)
    return sum(r["key_pack_s"] for r in recs) / n * 1e9 if n else None
