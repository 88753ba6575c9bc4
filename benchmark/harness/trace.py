"""The traced window: ``torch.profiler`` over the CPU and the card, reduced
to the device operations (kernels, copies, sets), the device's busy time
(the union of their intervals), and the idle gaps labelled by what the host
was doing (the innermost host operation or span open at the gap's middle).
The reading follows the program's ``tools/profile_forward.py``.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

WINDOW_SPAN = "bench.window"
TOP = 10
# the profiler's own bookkeeping on the host, never what the program does
PROFILER_EVENTS = ("Activity Buffer Request",)


class Tracer:
    """Context manager around a traced window; ``summary()`` after it."""

    def __init__(self):
        self._prof = None
        self.host_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = torch.autograd.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        """{"ops": device operations in the window, "busy_s", "window_s",
        "device_ops": the TOP names by device time [[name, s]],
        "idle_gaps": the TOP host labels by idle device time [[label, s]],
        "op_times": {name: s} of every device operation name}."""
        device, host, window = [], [], None
        for e in self._prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # a span's mirror on the device's timeline is no operation
                if not getattr(e, "is_user_annotation", False) and e.name != WINDOW_SPAN:
                    device.append((start, end, e.name))
            elif e.name == WINDOW_SPAN:
                window = (start, end)
            elif e.name not in PROFILER_EVENTS:
                host.append((start, end, e.name))
        spans = {name for _, _, name in host}
        device = [d for d in device if d[2] not in spans]
        if window is None or not device:
            return {"ops": 0, "busy_s": 0.0, "window_s": self.host_s, "device_ops": [],
                    "idle_gaps": [], "op_times": {}}
        lo, hi = window
        device = [d for d in device if d[1] > lo and d[0] < hi]
        device.sort()
        op_times: dict[str, float] = defaultdict(float)
        for s, e, name in device:
            op_times[name] += (e - s) * 1e-6
        merged = []
        for s, e, _ in device:
            s, e = max(s, lo), min(e, hi)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy_us = sum(e - s for s, e in merged)
        gaps = []
        edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
        for i in range(0, len(edges), 2):
            if edges[i + 1] > edges[i]:
                gaps.append((edges[i], edges[i + 1]))
        host.sort()
        starts = [h[0] for h in host]
        idle: dict[str, float] = defaultdict(float)
        for s, e in gaps:
            idle[_label(host, starts, (s + e) / 2)] += (e - s) * 1e-6
        top_ops = sorted(op_times.items(), key=lambda kv: -kv[1])[:TOP]
        top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"ops": len(device), "busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
                "device_ops": [[n[:120], t] for n, t in top_ops],
                "idle_gaps": [[n[:120], t] for n, t in top_gaps], "op_times": dict(op_times)}


def _label(host, starts, t, depth=400) -> str:
    """The innermost host operation open at time t (the one that started
    last among those still running), else "python"."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - depth, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "python"
