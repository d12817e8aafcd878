"""Profiling: device traces of a region, and names inside them.

``device_trace`` wraps ``torch.profiler`` and writes a Chrome trace
(open it in Perfetto or ``chrome://tracing``).  On a CUDA device it
records the kernels and copies the region ran; where the profiler cannot
record CUDA activity it raises rather than write a host-only trace.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager

import torch

#: Chrome-trace categories of device activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace_path: str) -> list:
    """The device-activity events (kernels, copies, sets) of a Chrome
    trace ``device_trace`` wrote."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") in DEVICE_CATEGORIES]


@contextmanager
def device_trace(log_dir: str, *, device):
    """Profile the enclosed region::

        with device_trace("/tmp/lmi-trace", device="cuda") as prof:
            index.search(...)
        prof.trace_path  # <log_dir>/lmi_trace_<pid>_<ns>.json

    Yields the ``torch.profiler.profile``, with ``trace_path`` set once
    the region has ended.  On a CUDA ``device`` the trace holds the CUDA
    activity, and the region must have launched some: a trace that
    recorded none raises ``RuntimeError``."""
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot record CUDA activity here (no CUPTI)")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = None
    with prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = os.path.join(log_dir, f"lmi_trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
    if device.type == "cuda" and not device_events(path):
        raise RuntimeError(f"{path}: the profiler recorded no CUDA activity in the region")


def annotate(name: str):
    """Name a region inside a captured trace."""
    return torch.profiler.record_function(name)
