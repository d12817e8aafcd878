"""Queries a dispatch: ``SearchServer.stats()`` totals over the window."""


def read(rec):
    if rec.stats is None:
        return None
    before, after = rec.stats
    batches = after["batches"] - before["batches"]
    return (after["queries"] - before["queries"]) / batches if batches else None
