"""What a run hands the per-layer metrics' readers."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from harness import trace


@dataclass
class RunRecord:
    engine: object                  # the program's engine (QueryEngine or MultiEngine)
    config: dict
    traffic: dict
    window_calls: list              # load.Call of the measured window
    latencies_ms: list              # each request completed in the window; a failed one inf
    batch_fill: list                # queries of each dispatcher batch in the window
    traced_calls: list = field(default_factory=list)
    gc_full_s: float = 0.0          # the collector's full collections in the window
    events: list = field(default_factory=list)    # (name, start ns, end ns)
    trace_window_s: float = 0.0
    trace_bounds_ns: tuple = (0.0, 0.0)
    notes: list = field(default_factory=list)     # printed to stderr
    ns: object = None               # host perf_counter → trace wall-clock ns

    def partitions(self) -> list:
        """(packed index, serving engine) of each partition the engine
        answers from: one for a single artifact."""
        engines = getattr(self.engine, "engines", None) or [self.engine]
        return [(e.packed, e) for e in engines]

    def width(self, nq: int) -> int:
        """The padded width of a batch of ``nq`` queries: the smallest
        configured width that holds it (the serving configuration's)."""
        serve = self.config["serve"]
        for w in sorted(serve["small_batch_sizes"]):
            if nq <= w <= serve["batch_size"]:
                return w
        return int(serve["batch_size"])

    def kernel_time(self, names, counter: str, sample: list):
        """Device seconds of the kernels named ``names`` that ran inside the
        host spans of the ``sample`` of traced calls (a call waits for its
        answer's copy, so its kernels run inside it); None where none
        did.  A note says where the trace holds fewer of them than the
        launch counter ``counter`` counted in those calls."""
        seen = trace.kernels_named(self.events, names)
        total, found, launched = 0.0, 0, 0
        for c in sample:
            a, b = self.ns(c.t0), self.ns(c.t1)
            mine = [e for e in seen if a <= e[1] <= b]
            total += sum(e[2] - e[1] for e in mine)
            found += len(mine)
            launched += c.launches.get(counter, 0)
        if found != launched:
            self.notes.append(f"{counter}: {found} kernels in the sampled "
                              f"calls' spans, {launched} launched")
        return total / 1e9 if found else None


def evenly(items: list, n: int) -> list:
    if len(items) <= n:
        return list(items)
    pick = np.linspace(0, len(items) - 1, n).round().astype(int)
    return [items[i] for i in pick]


def batch_codes(kmers: list, width: int):
    """A batch as the engine pads it → uint8 [width, k]; None for a batch
    of mixed lengths, which the uniform-length rules do not cover."""
    k = len(kmers[0])
    if any(len(x) != k for x in kmers):
        return None
    raw = np.frombuffer("".join(kmers).encode("ascii"), dtype=np.uint8)
    lut = np.zeros(256, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i + 1
    codes = np.ones((width, k), dtype=np.uint8)   # the padding: "A" * k
    codes[:len(kmers)] = lut[raw].reshape(len(kmers), k)
    return codes
