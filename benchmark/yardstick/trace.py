"""What a `torch.profiler` trace of the window says about the card.

From the Chrome trace the profiler exports: the card's activity (kernels,
copies, sets) as intervals; the window (the benchmark's `bench/window`
range); the kernels launched inside each of the benchmark's ranges, by the
correlation id that ties a kernel to the runtime call that launched it;
the idle gaps, each named by the innermost range open on the launching
thread at its middle.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
RANGE_CATS = {"user_annotation"}


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: int
    kernel_s_by_name: dict = field(default_factory=dict)
    range_kernel_s: dict = field(default_factory=dict)  # benchmark range -> kernel seconds inside it
    idle_by_host: dict = field(default_factory=dict)  # innermost host range -> idle seconds

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s_by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(ranges):
    """Properly nested (start, end, name) ranges of one thread -> sorted
    segments (start, name) of the innermost open range ("" where none)."""
    segs = []
    stack = []
    events = []
    for s, e, name in ranges:
        events.append((s, 1, -e, name))
        events.append((e, 0, 0, name))
    events.sort()
    for t, kind, _, name in events:
        if kind == 1:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
        segs.append((t, stack[-1] if stack else ""))
    return segs


def summarize(path: str, ranges: tuple[str, ...]) -> Summary:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = None
    for ev in events:
        if ev.get("name") == "bench/window" and ev.get("cat") in RANGE_CATS:
            window = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev.get("tid"))
    if window is None:
        raise RuntimeError("trace: no bench/window range")
    w0, w1, main_tid = window
    dev_iv, kernels = [], []
    launch_at = {}  # correlation -> (tid, ts)
    host_ranges = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
        if cat in DEVICE_CATS:
            if ts + dur <= w0 or ts >= w1:
                continue
            dev_iv.append((max(ts, w0), min(ts + dur, w1)))
            if cat == "kernel":
                kernels.append(ev)
        elif cat in LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launch_at[corr] = (ev.get("tid"), ts)
        elif cat in RANGE_CATS:
            host_ranges[ev.get("tid")].append((ts, ts + dur, ev["name"]))
    busy = _union(dev_iv)
    busy_us = sum(e - s for s, e in busy)

    by_name = defaultdict(float)
    for k in kernels:
        by_name[k["name"][:120]] += float(k["dur"]) * 1e-6

    # kernels inside the benchmark's ranges, by their launch
    range_iv = {name: defaultdict(list) for name in ranges}
    for tid, rs in host_ranges.items():
        for s, e, name in rs:
            if name in range_iv:
                range_iv[name][tid].append((s, e))
    starts = {name: {tid: sorted(iv) for tid, iv in per.items()} for name, per in range_iv.items()}
    inside = dict.fromkeys(ranges, 0.0)
    for k in kernels:
        corr = (k.get("args") or {}).get("correlation")
        if corr not in launch_at:
            continue
        tid, t = launch_at[corr]
        for name in ranges:
            iv = starts[name].get(tid)
            if not iv:
                continue
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                inside[name] += float(k["dur"]) * 1e-6

    # idle gaps, named by what the launching thread was in
    segs = _innermost(host_ranges.get(main_tid, []))
    seg_t = [s for s, _ in segs]
    idle = defaultdict(float)
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = (prev + s) / 2
            i = bisect.bisect_right(seg_t, mid) - 1
            idle[segs[i][1] if i >= 0 else ""] += (s - prev) * 1e-6
        prev = max(prev, e)
    return Summary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy_us * 1e-6,
        kernels=len(kernels),
        kernel_s_by_name=dict(by_name),
        range_kernel_s=inside,
        idle_by_host={k or "(no range)": v for k, v in idle.items()},
    )
