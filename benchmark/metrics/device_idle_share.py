"""device_idle_share: 1 - (union of the device operations' intervals in
the profiler's trace) / the measured window's wall time; the trace spans
the window.  Moves kmers_per_s: it says
how far the host holds the card back."""


def read(run):
    if run.trace_window_s <= 0 or not run.events:
        return None
    from harness import trace

    lo, hi = run.trace_bounds_ns
    busy = trace.busy_seconds(trace.busy_intervals(run.events, lo, hi))
    return 1.0 - busy / run.trace_window_s
