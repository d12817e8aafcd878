"""The median (nearest rank) of the same requests as ``serve_p95_ms``."""

import math


def read(rec):
    lat = sorted(rec.latencies_s)
    if not lat:
        return None
    return lat[max(math.ceil(0.50 * len(lat)) - 1, 0)] * 1e3
