"""The program's spans (``readserver_tpu_torch/trace.py``) read beside the
profiler's device trace, on one wall clock.

* :func:`idle_by_span`: the device's idle time in the window, split by
  the span open at each instant of it: a full collection (``runtime.gc``)
  first, else the device thread's innermost span, else the dispatcher
  loop's innermost span, else "no program span" (the clients' code and
  asyncio's own scheduling).  A block's wait in the queue
  (``dispatcher.queue``) labels nothing: it says what a block waits for,
  not what the loop does.  An idle gap is cut where spans start and end,
  not labelled whole by its middle: with the card idle 99.8% of the
  window, one gap holds a batch's worth of host work.
* :func:`statistics`: the numbers a per-layer metric of each layer
  reads from the spans of the measured window.
* :func:`coverage`, :func:`clock_check` and :func:`clock_skew`: how much
  of a call its stage spans cover; whether each call's kernels and copy
  fall inside its launch and copy-wait spans on the device trace's clock;
  and how far apart the two clocks can be, from probes that bracket one
  kernel each.

A span is the program's ``trace.Span``: ``name``, ``thread``, ``start``,
``end`` (wall-clock ns), ``id``, ``parent``, ``request``, ``cpu_ns``.
"""

from __future__ import annotations

import bisect
import statistics as stats
from collections import defaultdict

NO_SPAN = "no program span"
GC = "runtime.gc"
NOT_A_LABEL = ("dispatcher.queue",)
LOOP_WORK = ("dispatcher.rc", "dispatcher.fold", "dispatcher.take",
             "dispatcher.deliver")
STAGES = ("engine.encode", "engine.h2d", "engine.launch", "engine.copy_wait",
          "engine.assemble")


def within(spans, lo: float, hi: float) -> list:
    """The spans that start and end inside [lo, hi]."""
    return [s for s in spans if lo <= s.start and s.end <= hi]


def threads(spans) -> tuple[set, set]:
    """(device threads: those that ran engine calls, loop threads: those
    that ran the dispatcher's batches), of ``spans``: give it the window's,
    since warm-up runs its engine calls on the loop's thread."""
    dev = {s.thread for s in spans if s.name == "engine.call"}
    loop = {s.thread for s in spans if s.name == "dispatcher.fill"}
    return dev, loop


def _gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    gaps, t = [], lo
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _innermost(spans, points) -> list:
    """For each of the sorted ``points``, the latest-starting span that
    holds it (of two that start together, the one that ends first: the
    inner), or None."""
    spans = sorted(spans, key=lambda s: s.start)
    out, active, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i].start <= p:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s.end >= p]
        out.append(max(active, key=lambda s: (s.start, -s.end, s.id))
                   if active else None)
    return out


def idle_by_span(merged, lo: float, hi: float, spans) -> list:
    """[[label, seconds], ...], the largest first: the device's idle time
    in [lo, hi] (``merged``: the union of its busy intervals) by the span
    open at each instant of it."""
    gaps = _gaps(merged, lo, hi)
    dev, loop = threads(within(spans, lo, hi))
    near = [s for s in spans if s.end > lo and s.start < hi]
    layers = [[s for s in near if s.name == GC],
              [s for s in near if s.thread in dev and s.name != GC],
              [s for s in near if s.thread in loop and s.name != GC
               and s.name not in NOT_A_LABEL]]
    cuts = sorted({t for g in gaps for t in g}
                  | {t for layer in layers for s in layer
                     for t in (s.start, s.end) if lo < t < hi})
    starts = [a for a, _ in gaps]
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        i = bisect.bisect_right(starts, a) - 1
        if b > a and i >= 0 and b <= gaps[i][1]:
            pieces.append((a, b))
    mids = [(a + b) / 2 for a, b in pieces]
    found = [_innermost(layer, mids) for layer in layers]
    tot: dict[str, float] = defaultdict(float)
    for k, (a, b) in enumerate(pieces):
        s = next((f[k] for f in found if f[k] is not None), None)
        tot[s.name if s is not None else NO_SPAN] += (b - a) / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])]


def _descendants(spans) -> dict:
    """id → every span below it."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent:
            kids[s.parent].append(s)
    out = {}

    def walk(sid):
        if sid not in out:
            acc = []
            for k in kids.get(sid, ()):
                acc.append(k)
                acc.extend(walk(k.id))
            out[sid] = acc
        return out[sid]

    for s in spans:
        walk(s.id)
    return out


def _overlap(a0, a1, spans) -> float:
    return sum(max(0, min(a1, s.end) - max(a0, s.start)) for s in spans)


def call_stages(spans, lo: float, hi: float) -> list[tuple]:
    """(call, {stage name: ns summed}) of each engine call in the window."""
    below = _descendants(spans)
    out = []
    for c in within(spans, lo, hi):
        if c.name != "engine.call":
            continue
        ns: dict[str, float] = defaultdict(float)
        for s in below[c.id]:
            ns[s.name] += s.end - s.start
        out.append((c, ns))
    return out


def _median(xs):
    return stats.median(xs) if xs else None


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def statistics(spans, lo: float, hi: float) -> dict:
    """Each per-layer number the spans give over the window [lo, hi]
    (wall-clock ns); a number with nothing to read is None.

    * ``queue_wait_ms``: median ``dispatcher.queue`` of the blocks of the
      requests completed (folded) in the window;
    * ``loop_host_ms``: the loop's reverse complements, folds, takes and
      deliveries in the window, less the full collections inside them,
      per engine call in the window;
    * ``encode_ms``, ``copy_wait_ms``, ``assemble_ms``: the median over
      the window's calls of each call's ``engine.encode`` +
      ``engine.h2d``, ``engine.copy_wait`` and ``engine.assemble``;
    * ``engine_call_cpu_ms``: the mean thread CPU of a call (the mean, as
      a thread's CPU clock may tick in steps of 10 ms: a call then reads
      30, 40 or 50, and only the mean over many calls is its cost);
    * ``warmup_s``: ``setup.warmup`` (every engine's, summed)."""
    win = within(spans, lo, hi)
    done = {s.request for s in win if s.name == "dispatcher.fold"}
    queue = [(s.end - s.start) / 1e6 for s in spans
             if s.name == "dispatcher.queue" and s.request in done]
    calls = call_stages(spans, lo, hi)
    _, loop = threads(win)
    work = [s for s in win if s.name in LOOP_WORK]
    gcs = [s for s in spans if s.name == GC and s.thread in loop]
    loop_ns = sum(s.end - s.start - _overlap(s.start, s.end, gcs)
                  for s in work)
    warm = [s.seconds for s in spans if s.name == "setup.warmup"]
    return {
        "queue_wait_ms": _median(queue),
        "loop_host_ms": loop_ns / 1e6 / len(calls) if calls else None,
        "encode_ms": _median([(ns["engine.encode"] + ns["engine.h2d"]) / 1e6
                              for _, ns in calls]),
        "copy_wait_ms": _median([ns["engine.copy_wait"] / 1e6
                                 for _, ns in calls]),
        "assemble_ms": _median([ns["engine.assemble"] / 1e6
                                for _, ns in calls]),
        "engine_call_cpu_ms": _mean([c.cpu_ns / 1e6 for c, _ in calls
                                     if c.cpu_ns is not None]),
        "warmup_s": sum(warm) if warm else None,
    }


def coverage(spans, lo: float, hi: float) -> float | None:
    """The median over the window's calls of the share of a call's wall
    time that the union of its stage spans covers."""
    below = _descendants(spans)
    shares = []
    for c in within(spans, lo, hi):
        if c.name != "engine.call" or c.end <= c.start:
            continue
        ivs = sorted((s.start, s.end) for s in below[c.id]
                     if s.name in STAGES)
        covered, t = 0, c.start
        for a, b in ivs:
            a = max(a, t)
            if b > a:
                covered += b - a
                t = b
        shares.append(covered / (c.end - c.start))
    return _median(shares)


def clock_check(spans, events, lo: float, hi: float,
                kernel: str = "backward_search_kernel",
                copy: str = "DtoH", skew_ns: float = 50_000) -> dict | None:
    """Each window call's device operations (those that start between the
    previous call's end and the next call's start, the calls outside the
    window counted) against its spans:
    ``early`` = its launch span's start − its first ``kernel``'s start,
    ``late`` = its last ``copy``'s end − its copy-wait span's end, in ns;
    both ≤ ``skew_ns`` means the call agrees.  → the share that agrees and
    the largest early and late seen (negative: a margin)."""
    below = _descendants(spans)
    every = sorted((s for s in spans if s.name == "engine.call"),
                   key=lambda s: s.start)
    early, late, ok = [], [], 0
    for i, c in enumerate(every):
        if not lo <= c.start <= c.end <= hi:
            continue
        a = every[i - 1].end if i else lo
        b = every[i + 1].start if i + 1 < len(every) else hi
        mine = [e for e in events if a < e[1] < b]
        ks = [e for e in mine if kernel in e[0]]
        cs = [e for e in mine if copy in e[0]]
        launch = [s for s in below[c.id] if s.name == "engine.launch"]
        wait = [s for s in below[c.id] if s.name == "engine.copy_wait"]
        if not (ks and cs and launch and wait):
            continue
        e = min(s.start for s in launch) - min(k[1] for k in ks)
        t = max(x[2] for x in cs) - max(s.end for s in wait)
        early.append(e)
        late.append(t)
        ok += e <= skew_ns and t <= skew_ns
    if not early:
        return None
    return {"calls": len(early), "agree_share": ok / len(early),
            "early_max_us": max(early) / 1e3, "late_max_us": max(late) / 1e3,
            "early_median_us": stats.median(early) / 1e3,
            "late_median_us": stats.median(late) / 1e3}


def clock_skew(spans, events, probe: str = "clock.probe",
               kernel: str = "elementwise") -> dict | None:
    """The offset δ = (device trace's clock) − (spans' clock), bracketed:
    each ``probe`` span holds one ``kernel`` launched and waited for
    inside it, so its kernel starts after the span starts and ends before
    it ends; with the kernel nearest each probe, δ lies between the
    largest (kernel end − span end) and the smallest (kernel start − span
    start), in us.  None without probes."""
    ks = sorted((e for e in events if kernel in e[0]), key=lambda e: e[1])
    lows, highs = [], []
    for p in (s for s in spans if s.name == probe):
        if not ks:
            break
        mid = (p.start + p.end) / 2
        e = min(ks, key=lambda e: abs((e[1] + e[2]) / 2 - mid))
        lows.append(e[2] - p.end)
        highs.append(e[1] - p.start)
    if not lows:
        return None
    return {"probes": len(lows), "skew_min_us": max(lows) / 1e3,
            "skew_max_us": min(highs) / 1e3}
