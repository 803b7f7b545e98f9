"""The profiler's device trace reduced: busy time as the union of device
operation intervals, the operations that took most time, and the idle
gaps labelled by what the host was doing then.

Busy time is the union of intervals, so kernels that overlap count once
(a sum of kernel times counts them twice).  The port's kernels seen are
checked against its launch counters: the profiler has been seen to miss
launches, and a reading over a trace that missed some says so.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start, end) of every device operation in ``prof``'s trace,
    wall-clock nanoseconds, sorted by start."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    base = float(trace.get("baseTimeNanoseconds", 0))
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            t0 = base + float(e["ts"]) * 1e3
            out.append((e["name"], t0, t0 + float(e.get("dur", 0)) * 1e3))
    out.sort(key=lambda x: x[1])
    return out


def busy_intervals(events, lo: float, hi: float) -> list[list[float]]:
    """The union of the events' intervals, clipped to [lo, hi]."""
    merged: list[list[float]] = []
    for _, a, b in events:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(merged) -> float:
    return sum(b - a for a, b in merged) / 1e9


def top_ops(events, n: int = 10) -> list:
    """[[name, seconds], ...]: the device operations that took most time."""
    tot: dict[str, float] = defaultdict(float)
    for name, a, b in events:
        tot[name] += (b - a) / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(merged, lo: float, hi: float, host_spans, n: int = 10) -> list:
    """[[label, seconds], ...]: the device's idle time in [lo, hi], summed
    by what the host was doing at each gap's middle: the label of the
    ``host_spans`` entry (label, start ns, end ns) that holds it, else
    "host between engine calls"; the largest sums first."""
    gaps, t = [], lo
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    tot: dict[str, float] = defaultdict(float)
    spans = sorted(host_spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    import bisect

    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = ("host between engine calls" if i < 0 or spans[i][2] < mid
                 else spans[i][0])
        tot[label] += (b - a) / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def kernels_named(events, names) -> list[tuple[str, float, float]]:
    """The events whose name holds one of ``names``, in trace order."""
    return [e for e in events if any(n in e[0] for n in names)]


def count_within(events, spans) -> int:
    """How many events start inside one of ``spans`` (label, start, end)."""
    import bisect

    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    n = 0
    for _, a, _ in events:
        i = bisect.bisect_right(starts, a) - 1
        n += i >= 0 and a <= spans[i][2]
    return n
