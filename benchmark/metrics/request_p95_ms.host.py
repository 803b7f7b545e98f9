"""request_p95_ms.host: the 95th percentile (nearest rank) of the latency
of every request completed in the measured window, from the client's send
to its answer, a failed request counted as over any limit.  A per-layer
metric, not an end-to-end one: on these cells the host sets the pace, and
the host's speed moves it by more from run to run than an end-to-end
bound may allow.  Moves kmers_per_s: in a closed loop the tail is the
queue of the clients' requests over the rate."""

import math


def read(run):
    xs = sorted(run.latencies_ms)
    if not xs or math.isinf(xs[max(0, math.ceil(0.95 * len(xs)) - 1)]):
        return None
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]
