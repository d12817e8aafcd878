"""Queries answered per second: every query of every call over the
whole window, host clock (each call ends in the copy back)."""


def read(rec):
    if not rec.calls or rec.window_s <= 0:
        return None
    return rec.n_queries / rec.window_s
