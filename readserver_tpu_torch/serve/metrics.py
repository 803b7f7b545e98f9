"""Dispatcher observability: counters + latency percentiles.

The reference exposes request logs only (SURVEY.md §5 "Metrics"); here the
dispatcher tracks qps, batch occupancy, and p50/p95/p99 latency (p50 is a
pinned metric, BASELINE.json:2) over a sliding window, served at /stats.
"""

from __future__ import annotations

import time
from collections import deque


class Metrics:
    def __init__(self, window: int = 4096):
        self.t0 = time.time()
        self.queries = 0
        self.batches = 0
        self.errors = 0
        self.batch_fill = deque(maxlen=window)   # queries per batch
        self.latency_s = deque(maxlen=window)    # per-query wall latency

    def record_batch(self, nq: int, latency_s: float) -> None:
        self.queries += nq
        self.batches += 1
        self.batch_fill.append(nq)
        for _ in range(nq):
            self.latency_s.append(latency_s)

    def record_error(self) -> None:
        self.errors += 1

    def _pct(self, p: float) -> float | None:
        if not self.latency_s:
            return None
        xs = sorted(self.latency_s)
        return xs[min(len(xs) - 1, int(p * len(xs)))]

    def snapshot(self) -> dict:
        up = time.time() - self.t0
        fill = sum(self.batch_fill) / max(len(self.batch_fill), 1)
        return {
            "uptime_s": round(up, 1),
            "queries": self.queries,
            "batches": self.batches,
            "errors": self.errors,
            "qps": round(self.queries / up, 2) if up > 0 else 0.0,
            "mean_batch_fill": round(fill, 2),
            "p50_latency_ms": _ms(self._pct(0.50)),
            "p95_latency_ms": _ms(self._pct(0.95)),
            "p99_latency_ms": _ms(self._pct(0.99)),
        }


def _ms(x: float | None) -> float | None:
    return None if x is None else round(x * 1e3, 3)
