"""engine_call_ms: median host wall time of one engine call
(``count_batch`` / ``query_batch``, serve/engine.py) in the measured
window, timed by the benchmark's proxy between the dispatcher and the
engine.  Moves
kmers_per_s: one device thread makes the calls one after another."""

import statistics


def read(run):
    ms = [(c.t1 - c.t0) * 1e3 for c in run.window_calls]
    return statistics.median(ms) if ms else None
