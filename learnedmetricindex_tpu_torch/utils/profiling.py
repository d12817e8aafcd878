"""Profiling: device traces of a region, and named spans inside them.

``device_trace`` wraps ``torch.profiler`` and writes a Chrome trace
(open it in Perfetto or ``chrome://tracing``).  On a CUDA device it
records the kernels and copies the region ran; where the profiler cannot
record CUDA activity it raises rather than write a host-only trace.  It
records every thread, where the installed torch can, so a trace of a
``SearchServer`` holds its dispatcher thread.

``span(name)`` names a region on the profiler's host clock.  The port's
search path, serving dispatcher and mutations open ``lmi.*`` spans; with
no profiler running a span is one flag read.  ``idle_by_span`` reads a
trace ``device_trace`` wrote and says which span the host was in while
the device waited.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

#: Chrome-trace categories of device activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the Chrome-trace category of a ``record_function`` span on the host
SPAN_CATEGORY = "user_annotation"
#: ``idle_by_span``'s key for idle time under no span of the prefix
OUTSIDE = "outside"
#: what ``span`` returns while no profiler runs
NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` while a profiler runs,
    else the shared no-op :data:`NO_SPAN`."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return NO_SPAN


def _trace_events(trace_path: str) -> list:
    with open(trace_path) as f:
        return json.load(f)["traceEvents"]


def device_events(trace_path: str) -> list:
    """The device-activity events (kernels, copies, sets) of a Chrome
    trace ``device_trace`` wrote."""
    return [e for e in _trace_events(trace_path) if e.get("cat") in DEVICE_CATEGORIES]


def _all_threads_config():
    """The profiler's option to record every thread, or ``None`` where the
    installed torch lacks it (it then records the thread that starts it)."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


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
    prof = torch.profiler.profile(activities=activities,
                                  experimental_config=_all_threads_config())
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


def _union(intervals) -> list:
    """Sorted, disjoint ``(start, end)`` covering ``intervals`` (empty
    ones dropped)."""
    out = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_by_span(trace_path: str, prefix: str = "lmi.",
                 within: Optional[str] = None) -> Dict[str, float]:
    """Device-idle seconds by the innermost host span whose name starts
    with ``prefix`` (of those covering the moment, the latest-started,
    at a tie the shortest),
    and under :data:`OUTSIDE` where none does, from a Chrome trace
    ``device_trace`` wrote.  Idle is what no kernel, copy or memset
    covers, between the trace's first and last event; ``within`` names
    a span that bounds it instead (its events' union)."""
    events = [e for e in _trace_events(trace_path) if e.get("ph") == "X" and "dur" in e]
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in DEVICE_CATEGORIES)
    if within is None:
        region = _union([(min(e["ts"] for e in events),
                          max(e["ts"] + e["dur"] for e in events))] if events else [])
    else:
        region = _union((e["ts"], e["ts"] + e["dur"]) for e in events
                        if e.get("cat") == SPAN_CATEGORY and e.get("name") == within)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == SPAN_CATEGORY and e.get("name", "").startswith(prefix)
             and e["dur"] > 0]
    # a sweep over every boundary (time, ends before starts at a tie, what changes)
    points = []
    for i, (s, e, _) in enumerate(spans):
        points += [(s, 1, ("span", i, True)), (e, 0, ("span", i, False))]
    for s, e in busy:
        points += [(s, 1, ("busy", None, True)), (e, 0, ("busy", None, False))]
    for s, e in region:
        points += [(s, 1, ("region", None, True)), (e, 0, ("region", None, False))]
    points.sort(key=lambda p: (p[0], p[1]))
    out: Dict[str, float] = {}
    active: Dict[int, tuple] = {}  # span index -> (start, -end): the innermost is the largest
    in_busy = in_region = False
    last = None
    for t, _, (kind, i, opening) in points:
        if last is not None and t > last and in_region and not in_busy:
            name = spans[max(active, key=active.get)][2] if active else OUTSIDE
            out[name] = out.get(name, 0.0) + (t - last) / 1e6
        last = t
        if kind == "span":
            if opening:
                active[i] = (spans[i][0], -spans[i][1])
            else:
                active.pop(i, None)
        elif kind == "busy":
            in_busy = opening
        else:
            in_region = opening
    return out
