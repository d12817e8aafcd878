"""The split merge kernel's device time a dispatch, from the trace."""

from lmibench.trace import MERGE_KERNEL


def read(rec):
    if rec.trace is None or not rec.n_dispatches:
        return None
    t = rec.trace.kernel_seconds(MERGE_KERNEL)
    return 1e3 * t / rec.n_dispatches if t > 0 else None
