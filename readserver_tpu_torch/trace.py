"""The port's span recorder: where a served batch spends its host time.

Off by default.  :func:`enable` starts a recording and :func:`disable`
ends it; :func:`spans` returns what was recorded and :func:`export_chrome`
writes it as Chrome-trace JSON.  A span holds its name, its thread, its
start and end, its parent span, the request and the dispatcher batch it
belongs to, and a few attributes.

Every site in the program does one check of :data:`ON` while the recorder
is off, and nothing else: no clock read, no allocation, no collector hook.
No site sits inside a loop over k-mers.

Two ways to record:

* ``t = trace.now()`` before the work and ``trace.span(name, t, ...)``
  after it, under ``if trace.ON:`` — lines that stand alone, for the
  dispatcher, whose file is kept line for line with the JAX package's;
* ``with trace.stage(name) as s:`` around the work, for the engine and
  set-up; a stage is the parent of the spans recorded inside it in the
  same thread (or asyncio task), and ``s.set(...)`` adds attributes.

Clock: ``time.perf_counter_ns()``, mapped to wall-clock nanoseconds through
one ``(time.time_ns(), perf_counter_ns())`` pair taken by :func:`enable`.
That is the clock of ``torch.profiler``'s trace (``baseTimeNanoseconds +
ts``), so host spans and device operations line up in one timeline.

While recording, a ``gc.callbacks`` hook records each full collection as a
``runtime.gc`` span and counts the younger ones.  The request id rides a
context variable (asyncio tasks copy it); the batch in flight is one
module-level id, since the dispatcher flies one batch at a time.
"""

from __future__ import annotations

import contextvars
import functools
import gc
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field

ON = False          # the one flag each site checks
batch = 0           # the dispatcher batch in flight (0: none)
MAX_SPANS = 1 << 20

_clock = time.perf_counter_ns
_cpu = time.thread_time_ns

_request: contextvars.ContextVar[int] = contextvars.ContextVar(
    "readserver_trace_request", default=0)
_open: contextvars.ContextVar["_Stage | None"] = contextvars.ContextVar(
    "readserver_trace_open", default=None)
_in_call: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "readserver_trace_in_call", default=False)


@dataclass(frozen=True)
class Span:
    """One recorded span; ``start`` and ``end`` in wall-clock ns."""

    id: int
    name: str
    thread: str
    start: int
    end: int
    parent: int          # 0: none
    request: int         # 0: none
    batch: int           # 0: none
    cpu_ns: int | None = None     # the thread's CPU time over the span
    attrs: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class _Recording:
    """What one :func:`enable` … :func:`disable` records."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.anchor = (time.time_ns(), _clock())
        self.records: list[tuple] = []
        self.dropped = 0
        self.gc_young = 0
        self.ids = itertools.count(1)
        self.requests = itertools.count(1)
        self.batches = itertools.count(1)
        self.blocks: dict = {}     # dispatcher block → (start, request, batches)
        self.gc_open: dict = {}    # thread id → (start, parent)
        self.lock = threading.RLock()   # the collector's hook may record inside

    def add(self, rec: tuple) -> None:
        with self.lock:
            if len(self.records) < self.capacity:
                self.records.append(rec)
            else:
                self.dropped += 1


_rec: _Recording | None = None


def _record(name, t0, t1, parent, cpu, attrs, span_id=0) -> None:
    _rec.add((span_id or next(_rec.ids), name,
              threading.current_thread().name, t0, t1, parent,
              _request.get(), batch, cpu, attrs))


def _parent() -> int:
    st = _open.get()
    return st.id if st is not None else 0


# ----------------------------------------------------------- switching


def enable(capacity: int = MAX_SPANS) -> None:
    """Start a new recording (what an earlier one recorded is dropped)."""
    global ON, _rec, batch
    disable()
    _rec = _Recording(capacity)
    batch = 0
    gc.callbacks.append(_on_gc)
    ON = True


def disable() -> None:
    """Stop recording; what was recorded stays readable."""
    global ON
    ON = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def _on_gc(phase: str, info: dict) -> None:
    if _rec is None:
        return
    tid = threading.get_ident()
    if info["generation"] != 2:
        if phase == "stop":
            _rec.gc_young += 1
        return
    if phase == "start":
        _rec.gc_open[tid] = (_clock(), _parent())
    elif tid in _rec.gc_open:
        t0, parent = _rec.gc_open.pop(tid)
        _record("runtime.gc", t0, _clock(), parent, None,
                {"collected": int(info.get("collected", 0))})


# ------------------------------------------------ spans that stand alone


def now():
    """A span's start for :func:`span`: (clock ns, thread CPU ns) while
    recording, else 0."""
    if not ON:
        return 0
    return (_clock(), _cpu())


def at(seconds: float):
    """A ``time.perf_counter()`` reading as a start for :func:`span`."""
    return (int(seconds * 1e9), None)


def span(name: str, start, **attrs) -> None:
    """Record ``name`` from ``start`` (:func:`now` or :func:`at`) to now, in
    this thread, under the innermost open stage.  A start taken while the
    recorder was off records nothing."""
    if not ON or not start:
        return
    t0, cpu0 = start
    cpu = None if cpu0 is None else _cpu() - cpu0
    _record(name, t0, _clock(), _parent(), cpu, attrs)


def new_request():
    """Give the spans of this task from here on a new request id → a token
    for :func:`end_request` (None while off)."""
    if not ON:
        return None
    return _request.set(next(_rec.requests))


def end_request(token) -> None:
    if token is not None:
        _request.reset(token)


def next_batch():
    """A new dispatcher batch starts: make it the batch in flight → its
    start, as :func:`now`."""
    global batch
    if not ON:
        return 0
    batch = next(_rec.batches)
    return now()


def enqueued(block) -> None:
    """A dispatcher block joined the queue: its ``dispatcher.queue`` span
    starts, under this task's request id (a new one where it has none)."""
    if ON:
        _rec.blocks[block] = (_clock(), _request.get()
                              or next(_rec.requests), [])


def sliced(block, last: bool) -> None:
    """A slice of ``block`` went into the batch in flight; with ``last`` its
    ``dispatcher.queue`` span ends."""
    if not ON or block not in _rec.blocks:
        return
    t0, req, batches = _rec.blocks[block]
    batches.append(batch)
    if last:
        del _rec.blocks[block]
        _rec.add((next(_rec.ids), "dispatcher.queue",
                  threading.current_thread().name, t0, _clock(), 0, req,
                  batch, None, {"queries": len(block.kmers),
                                "batches": batches}))


# ------------------------------------------------------------------ stages


class _Stage:
    """An open span; the parent of what is recorded inside it."""

    __slots__ = ("name", "id", "t0", "cpu0", "parent", "attrs", "token")

    def __init__(self, name: str, cpu: bool):
        self.name = name
        self.id = next(_rec.ids)
        self.parent = _parent()
        self.attrs: dict = {}
        self.cpu0 = _cpu() if cpu else None
        self.token = _open.set(self)
        self.t0 = _clock()

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        t1 = _clock()
        cpu = None if self.cpu0 is None else _cpu() - self.cpu0
        _open.reset(self.token)
        if ON:
            _record(self.name, self.t0, t1, self.parent, cpu, self.attrs,
                    self.id)


class _Off:
    """What :func:`stage` returns while the recorder is off."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def stage(name: str, cpu: bool = False):
    """``with trace.stage(name) as s:`` records the block as ``name``;
    ``cpu`` also reads the thread's CPU time."""
    if not ON:
        return _OFF
    return _Stage(name, cpu)


def annotate(**attrs) -> None:
    """Add attributes to the innermost open stage of this thread or task."""
    st = _open.get()
    if ON and st is not None:
        st.attrs.update(attrs)


def staged(name: str, attrs=None):
    """Decorator: each call of the function as a stage ``name``;
    ``attrs(result, *args)`` gives its attributes, called only while
    recording."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not ON:
                return fn(*args, **kwargs)
            with stage(name) as st:
                out = fn(*args, **kwargs)
                if attrs is not None:
                    st.set(**attrs(out, *args))
                return out

        return traced

    return wrap


def engine_call(fn):
    """``engine.call`` around an engine's ``count_batch`` / ``query_batch``:
    the outermost call only, with the batch in flight, the answer tier, the
    queries and the thread's CPU time."""

    @functools.wraps(fn)
    def traced(self, kmers, *args, **kwargs):
        if not ON or _in_call.get():
            return fn(self, kmers, *args, **kwargs)
        hits = kwargs.get("include_hits", args[1] if len(args) > 1 else True)
        mode = ("count" if fn.__name__ == "count_batch"
                else "full" if hits else "hist")
        token = _in_call.set(True)
        try:
            with stage("engine.call", cpu=True) as st:
                st.set(mode=mode, nq=len(kmers))
                return fn(self, kmers, *args, **kwargs)
        finally:
            _in_call.reset(token)

    return traced


# ----------------------------------------------------------------- reading


def stats() -> dict:
    """Spans kept, spans dropped when the buffer was full, and the younger
    collections counted, of the last recording."""
    if _rec is None:
        return {"spans": 0, "dropped": 0, "gc_young": 0}
    return {"spans": len(_rec.records), "dropped": _rec.dropped,
            "gc_young": _rec.gc_young}


def spans() -> list[Span]:
    """The last recording's spans, in the order they ended, with wall-clock
    times."""
    if _rec is None:
        return []
    wall, perf = _rec.anchor
    with _rec.lock:
        records = list(_rec.records)
    return [Span(i, name, thread, wall + t0 - perf, wall + t1 - perf,
                 parent, req, b, cpu, attrs)
            for i, name, thread, t0, t1, parent, req, b, cpu, attrs
            in records]


def export_chrome(path) -> None:
    """Write the last recording as Chrome-trace JSON: complete events with
    ``ts`` in microseconds after ``baseTimeNanoseconds``, the convention of
    ``torch.profiler``'s export, so both files read on one clock."""
    got = spans()
    base = min((s.start for s in got), default=0)
    pid = os.getpid()
    tids = {name: i for i, name in
            enumerate(dict.fromkeys(s.thread for s in got), 1)}
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": name}} for name, tid in tids.items()]
    for s in got:
        args = dict(s.attrs, id=s.id, parent=s.parent, request=s.request,
                    batch=s.batch)
        if s.cpu_ns is not None:
            args["cpu_ns"] = s.cpu_ns
        events.append({"ph": "X", "cat": "readserver", "name": s.name,
                       "pid": pid, "tid": tids[s.thread],
                       "ts": (s.start - base) / 1e3,
                       "dur": (s.end - s.start) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base, "displayTimeUnit": "ms",
                   "traceEvents": events, "readserver": stats()}, f)
