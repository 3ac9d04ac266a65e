"""Reading a `torch.profiler` trace of the traced window.

From the profiler's own event list (CUPTI activity on the device, the host
operators beside it): the traced window (the host annotation
`perfbench.window`), the device's busy time inside it (the union of every
kernel, copy and fill), device seconds per kernel name, and the longest
idle gaps, each named by the outermost host operator that was running at
its middle ("host" where none was: Python between operators, or a thread
that made no call into torch).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "perfbench.window"


def _device_type_name(ev) -> str:
    return str(ev.device_type()).rsplit(".", 1)[-1]


def read(prof) -> dict:
    """{window_s, busy_s, kernel_s: {name: s}, device_ops: [[name, s]],
    idle_gaps: [[name, s]]} of a finished profiler."""
    events = prof.profiler.kineto_results.events()
    win = None
    device, host = [], []
    for ev in events:
        kind = _device_type_name(ev)
        if kind == "CUDA":
            if ev.name() == WINDOW or ev.is_user_annotation():
                continue
            device.append((ev.start_ns(), ev.end_ns(), ev.name()))
        elif kind == "CPU":
            if ev.name() == WINDOW:
                win = (ev.start_ns(), ev.end_ns())
            else:
                host.append((ev.start_ns(), ev.end_ns(), ev.name()))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    w0, w1 = win
    per_name: dict = defaultdict(float)
    spans = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            per_name[name] += (e - s) * 1e-9
            spans.append((s, e))
    spans.sort()
    busy_ns, gaps, cur = 0, [], w0
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy_ns += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]

    def name_gap(g0: int, g1: int) -> str:
        mid = (g0 + g1) // 2
        best, best_len = "host", -1
        # the operators open at `mid` started before it; scan back a bounded way
        i = bisect.bisect_right(starts, mid)
        for s, e, name in host[max(0, i - 20000):i]:
            if e >= mid and e - s > best_len:
                best, best_len = name, e - s
        return best

    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "kernel_s": dict(per_name),
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[name_gap(a, b)[:160], (b - a) * 1e-9] for a, b in gaps[:10]]}
