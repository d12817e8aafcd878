"""The traced run: ``torch.profiler`` over the window, reduced in memory.

The benchmark calls the profiler itself (not the port's
``utils/profiling.py``), so a change to the port cannot move the
yardstick.  The raw events are read from the profiler's results without
building its event tree, and only these sums are kept: device time by
kernel, the union of device activity inside the window, and the
longest idle gaps with the host operation that covered each.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "lmibench.window"
#: the port's bucket scan (``csrc/scan_pairs.cu``) and its split merge (``csrc/scan_merge.cu``)
_PORT = r"^(void )?(\(anonymous namespace\)::)?"
SCAN_KERNELS = re.compile(_PORT + r"(scan_\w+_kernel|merge_kernel)\b")
MERGE_KERNEL = re.compile(_PORT + r"merge_kernel\b")
TOP = 10


def profiler() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def short(name: str) -> str:
    """A kernel or operation name without its arguments and template."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name, maxsplit=1)[0].strip()[:96] or name[:96]


def _raw_events(prof):
    """``(name, device type, start ns, end ns)``; the device-side ranges of
    ``record_function`` spans are left out (they are no device work)."""
    return [(e.name(), e.device_type(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if not (e.device_type() == torch.autograd.DeviceType.CUDA
                    and e.is_user_annotation())]


class Trace:
    """Device activity of one window."""

    def __init__(self, prof):
        dev, cpu, window = [], [], None
        for name, kind, s, e in _raw_events(prof):
            if kind == torch.autograd.DeviceType.CUDA:
                dev.append((s, e, name))
            elif name == WINDOW:
                window = (s, e)
            else:
                cpu.append((s, e, name))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        w0, w1 = window
        self.window_s = (w1 - w0) / 1e9
        dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
        self.n_device_events = len(dev)
        self.by_name: Dict[str, float] = {}
        for s, e, n in dev:
            self.by_name[n] = self.by_name.get(n, 0.0) + (e - s) / 1e9
        # union of device activity, and the gaps between
        busy, gaps, cur_s, cur_e = 0, [], None, w0
        for s, e, _ in sorted(dev):
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        gaps.append((cur_e, w1))
        self.busy_s = busy / 1e9
        self._gaps = sorted(((b - a, a, b) for a, b in gaps if b > a), reverse=True)[:TOP]
        self._cpu = cpu
        self.n_host_events = len(cpu)

    def kernel_seconds(self, pattern: re.Pattern) -> float:
        return sum(t for n, t in self.by_name.items() if pattern.search(n))

    def device_ops(self) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for n, t in self.by_name.items():
            by[short(n)] = by.get(short(n), 0.0) + t
        return sorted(by.items(), key=lambda kv: -kv[1])[:TOP]

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """The longest gaps with no device activity, each named by the
        innermost host operation (a runtime call aside) that spans its
        middle."""
        if not self._gaps:
            return []
        ops = [c for c in self._cpu if not c[2].startswith("cuda")]
        starts = np.array([c[0] for c in ops], np.int64)
        ends = np.array([c[1] for c in ops], np.int64)
        out = []
        for length, a, b in self._gaps:
            mid = (a + b) // 2
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0] if len(ops) else []
            label = (f"host in {short(ops[hit[np.argmax(starts[hit])]][2])}" if len(hit)
                     else "host in no recorded operation")
            out.append((label, length / 1e9))
        return out


def breakdown(tr: Optional[Trace]) -> Optional[dict]:
    if tr is None:
        return None
    return {"device_ops": [[n, t] for n, t in tr.device_ops()],
            "idle_gaps": [[n, t] for n, t in tr.idle_gaps()]}
