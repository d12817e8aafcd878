"""Navigation a call: ``LearnedIndex.search``'s ``measured["inference"]``
(device-synced), mean over the window's calls."""


def read(rec):
    if not rec.calls:
        return None
    return 1e3 * sum(c["inference"] for c in rec.calls) / len(rec.calls)
