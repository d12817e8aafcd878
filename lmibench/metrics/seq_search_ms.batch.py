"""Plan, scan, merge, rerank and the copy back a call:
``measured["seq_search"]``, mean over the window's calls."""


def read(rec):
    if not rec.calls:
        return None
    return 1e3 * sum(c["seq_search"] for c in rec.calls) / len(rec.calls)
