"""The 95th percentile (nearest rank) of every request due in the window,
each from when it was due to when its answer reached the client; a
failed request counts as infinitely late."""

import math


def read(rec):
    lat = sorted(rec.latencies_s)
    if not lat:
        return None
    return lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] * 1e3
