"""Closed-loop clients on the program's dispatcher, and the engine proxy
that times each engine call.

Each of C clients sends a request of the mix's size, waits for its
answer, then sends the next; its k-mers are drawn from a pool made from
``--seed``.  Request (c, j) is the j-th of client c, and its k-mers are
the same for a given seed and mix whatever the timing; the answers of a
seed-drawn share of them are kept for the reference to judge.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import numpy as np

from harness import simulate
from harness.judge import Digest

MODES = {"count": "count", "samples": "hist", "reads": "full"}


@dataclass
class Call:
    """One engine call as the proxy saw it (host clock)."""

    mode: str
    nq: int
    t0: float
    t1: float
    kmers: list | None = None          # kept in a traced window
    launches: dict | None = None       # kernel launches during the call


class EngineProxy:
    """Stands in for the engine in the dispatcher: passes every call on and
    times the three the dispatcher makes.  While ``recording`` (a traced
    run's window), each call also keeps its k-mers and the kernel
    launches the program counted during it."""

    def __init__(self, engine, counters=None, fault=None):
        self._engine = engine
        self._counters = counters   # () -> {kernel: launches}
        self._fault = fault         # test hook: (mode, kmers, results) -> results
        self.calls: list[Call] = []
        self.recording = False

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def count_batch(self, kmers, both_strands=False):
        return self._timed("count", kmers,
                           lambda: self._engine.count_batch(kmers))

    def query_batch(self, kmers, both_strands=False, include_hits=True):
        return self._timed(
            "full" if include_hits else "hist", kmers,
            lambda: self._engine.query_batch(kmers,
                                             include_hits=include_hits))

    def _timed(self, mode, kmers, fn):
        keep = self.recording and self._counters is not None
        before = self._counters() if keep else None
        t0 = time.perf_counter()
        out = fn()
        call = Call(mode, len(kmers), t0, time.perf_counter())
        if keep:
            after = self._counters()
            call.kmers = list(kmers)
            call.launches = {k: after[k] - before[k] for k in after}
        self.calls.append(call)
        if self._fault is not None:
            out = self._fault(mode, kmers, out)
        return out


def make_pool(reads: np.ndarray, traffic: dict, seed: int):
    """The seed's k-mer pool → (codes uint8 [P, k], strings)."""
    codes = simulate.sample_query_kmers(
        reads, int(traffic["pool_kmers"]), int(traffic["k"]), seed,
        float(traffic["miss_frac"]))
    return codes, simulate.decode_rows(codes)


def request_rng(seed: int, client: int) -> np.random.Generator:
    return np.random.default_rng([seed, client + 1])


def check_phase(seed: int, client: int, every: int) -> int:
    """Which requests of ``client`` are kept for the reference: those whose
    number is this modulo ``every``."""
    return int(np.random.default_rng([seed, client + 1, 7]).integers(every))


@dataclass
class Load:
    """What the clients saw."""

    done: list = field(default_factory=list)   # (client, j, t0, t1, ok)
    kept: dict = field(default_factory=dict)   # (client, j) -> (idx, Digest)
    window: tuple = (0.0, 0.0)
    window_ns: tuple = (0, 0)                  # the same, wall clock ns
    error: str = ""                            # the last failure seen


async def closed_loop(dispatcher, traffic: dict, pool: list, seed: int,
                      seconds: float, names: list, on_window=None) -> Load:
    """Run the mix's clients for its ramp, then ``seconds`` of window; each
    client finishes the request it has in flight when the window closes."""
    size = int(traffic["kmers_per_request"])
    mode = MODES[traffic["route"]]
    every = int(traffic["check_every"])
    name_ids = {n: i for i, n in enumerate(names)}
    load = Load()
    stop = False

    async def client(c: int) -> None:
        rng = request_rng(seed, c)
        phase = check_phase(seed, c, every)
        j = 0
        while not stop:
            idx = rng.integers(0, len(pool), size)
            kmers = [pool[i] for i in idx.tolist()]
            t0 = time.perf_counter()
            try:
                res = await dispatcher.submit_many(kmers, both_strands=True,
                                                   mode=mode)
                ok = len(res) == size
            except Exception as e:  # a failed request counts as failed
                res, ok = None, False
                load.error = repr(e)
            t1 = time.perf_counter()
            load.done.append((c, j, t0, t1, ok))
            if j % every == phase and ok:
                load.kept[(c, j)] = (idx, Digest(mode, res, name_ids))
            # a client drops its answer once read: held through its next
            # request, the clients' answers (some hundred thousand of the
            # program's hit objects on the reads route) would stay alive
            # for the collector to walk in every full collection
            del res
            j += 1

    tasks = [asyncio.get_running_loop().create_task(client(c))
             for c in range(int(traffic["clients"]))]
    await asyncio.sleep(float(traffic["ramp_s"]))
    if on_window is not None:
        on_window(True)
    t_start, ns_start = time.perf_counter(), time.time_ns()
    await asyncio.sleep(seconds)
    t_end, ns_end = time.perf_counter(), time.time_ns()
    if on_window is not None:
        on_window(False)
    stop = True
    await asyncio.gather(*tasks)
    load.window = (t_start, t_end)
    load.window_ns = (ns_start, ns_end)
    return load
