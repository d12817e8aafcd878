"""The bucket scan's share of its roofline: ``lmibench.frozen.work``'s
least time for the window's searches over the device time of the scan
and split-merge kernels in the trace."""

from lmibench.trace import SCAN_KERNELS


def read(rec):
    if rec.trace is None or not rec.scan_bound_s:
        return None
    t = rec.trace.kernel_seconds(SCAN_KERNELS)
    return 100.0 * rec.scan_bound_s / t if t > 0 else None
