"""The median of the mutator's host clock around each insert batch."""

import statistics


def read(rec):
    return 1e3 * statistics.median(rec.insert_s) if rec.insert_s else None
