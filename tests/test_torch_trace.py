"""The port's span recorder (readserver_tpu_torch/trace.py) and its sites in
the dispatcher, the engines, set-up and ``serve --trace-out``."""

import asyncio
import gc
import json
import signal
import sys
import time

import numpy as np
import pytest

from readserver_tpu_torch import trace
from readserver_tpu_torch.config import ServeConfig
from readserver_tpu_torch.corpus import simulate
from readserver_tpu_torch.index import build_index
from readserver_tpu_torch.serve import Dispatcher, MultiEngine, QueryEngine
from torch_common import thaw_heap  # noqa: F401 (autouse)

CFG = dict(batch_size=64, max_hits=32, batch_deadline_ms=5.0,
           small_batch_sizes=(8,))
STAGES = ("engine.encode", "engine.h2d", "engine.launch",
          "engine.copy_wait", "engine.assemble")


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    yield
    trace.disable()


@pytest.fixture(scope="module")
def corpus():
    return simulate.simulate_config("tiny")


@pytest.fixture(scope="module")
def engines(corpus):
    reads = corpus.reads[:240]
    half = len(reads) // 2
    one = QueryEngine(build_index(reads, sample_ids=corpus.sample_ids[:240]),
                      ServeConfig(**CFG), device="cpu")
    parts = [build_index(reads[:half], sample_ids=np.zeros(half, np.int32)),
             build_index(reads[half:],
                         sample_ids=np.ones(len(reads) - half, np.int32))]
    multi = MultiEngine(parts, ServeConfig(**CFG), device="cpu")
    return {"one": one, "multi": multi}


def _kmers(corpus, n=12, k=15):
    reads = corpus.reads[:240]
    out = ["".join("ACGT"[c - 1] for c in reads[i][3:3 + k])
           for i in range(n)]
    return [km for km in out if km != _rc(km)]


def _rc(km: str) -> str:
    return km[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _run(engine, route, kmers):
    if route == "count":
        return engine.count_batch(kmers)
    return engine.query_batch(kmers, include_hits=route == "full")


def _serve(engine, kmers, mode):
    async def go():
        disp = Dispatcher(engine)
        await disp.start()
        try:
            return await disp.submit_many(kmers, both_strands=True,
                                          mode=mode)
        finally:
            await disp.stop()

    return asyncio.run(go())


def test_off_records_nothing_hooks_nothing_reads_no_clock(
        engines, corpus, monkeypatch):
    trace.enable()
    trace.disable()

    def boom():
        raise AssertionError("a clock was read while the recorder was off")

    monkeypatch.setattr(trace, "_clock", boom)
    monkeypatch.setattr(trace, "_cpu", boom)
    hooks = list(gc.callbacks)
    kms = _kmers(corpus)
    for engine in engines.values():
        for route in ("count", "hist", "full"):
            _run(engine, route, kms)
        _serve(engine, kms, "full")
    gc.collect()
    assert gc.callbacks == hooks and trace._on_gc not in hooks
    assert trace.spans() == [] and trace.stats()["spans"] == 0
    assert trace.batch == 0


def test_stages_nest_and_leaves_take_the_open_stage():
    trace.enable()
    with trace.stage("outer") as a:
        a.set(k=1)
        with trace.stage("inner"):
            t = trace.now()
            trace.span("leaf", t, n=3)
        trace.span("second", trace.now())
    trace.span("root", trace.now())
    got = {s.name: s for s in trace.spans()}
    assert got["outer"].parent == 0 and got["outer"].attrs == {"k": 1}
    assert got["inner"].parent == got["outer"].id
    assert got["leaf"].parent == got["inner"].id
    assert got["leaf"].attrs == {"n": 3} and got["leaf"].cpu_ns >= 0
    assert got["second"].parent == got["outer"].id
    assert got["root"].parent == 0
    o, i, leaf = got["outer"], got["inner"], got["leaf"]
    assert o.start <= i.start <= leaf.start <= leaf.end <= i.end <= o.end


def test_a_both_strands_request_shares_one_id(engines, corpus):
    kms = _kmers(corpus)
    trace.enable()
    got = _serve(engines["one"], kms, "count")
    trace.disable()
    assert len(got) == len(kms)
    spans = trace.spans()
    queue = [s for s in spans if s.name == "dispatcher.queue"]
    assert len(queue) == 2
    req = queue[0].request
    assert req and all(s.request == req for s in queue)
    assert sorted(s.attrs["queries"] for s in queue) == [len(kms)] * 2
    for name in ("dispatcher.rc", "dispatcher.fold"):
        (s,) = [s for s in spans if s.name == name]
        assert s.request == req and s.attrs["n"] == len(kms)
    calls = [s for s in spans if s.name == "engine.call"]
    assert calls and all(s.thread != queue[0].thread for s in calls)
    batches = {s.batch for s in calls}
    assert batches <= {b for s in queue for b in s.attrs["batches"]}
    for name in ("dispatcher.fill", "dispatcher.take", "dispatcher.fly",
                 "dispatcher.deliver"):
        assert {s.batch for s in spans if s.name == name} == batches, name


@pytest.mark.parametrize("which", ["one", "multi"])
@pytest.mark.parametrize("route", ["count", "hist", "full"])
def test_each_engine_call_holds_its_stages_in_order(engines, corpus, which,
                                                    route):
    engine = engines[which]
    trace.enable()
    _run(engine, route, _kmers(corpus))
    engine.count_batch(_kmers(corpus), both_strands=True)   # nests a call
    trace.disable()
    spans = trace.spans()
    calls = [s for s in spans if s.name == "engine.call"]
    assert [c.attrs["mode"] for c in calls] == [route, "count"]
    assert all(c.parent == 0 and c.cpu_ns > 0 for c in calls)
    by_id = {s.id: s for s in spans}

    def call_of(s):
        while s.parent:
            s = by_id[s.parent]
        return s

    for c in calls:
        mine = [s for s in spans if s is not c and call_of(s) is c]
        assert all(c.start <= s.start <= s.end <= c.end for s in mine)
        first_end = [min(s.end for s in mine if s.name == n) for n in STAGES]
        assert first_end == sorted(first_end), [s.name for s in mine]
        h2d = [s for s in mine if s.name == "engine.h2d"]
        assert len(h2d) == (2 if which == "multi" else 1)
        assert all(s.attrs["bytes"] > 0 for s in h2d)
        launch = [s for s in mine if s.name == "engine.launch"]
        if which == "multi":
            assert all(by_id[s.parent].name == "engine.launch" for s in h2d)
            assert launch[0].attrs["partitions"] == 2
    (asm,) = [s for s in spans if s.name == "engine.assemble"
              and call_of(s) is calls[0]]
    assert ("sparse_bytes" in asm.attrs) == (route != "count")


def test_the_anchor_maps_to_wall_clock():
    trace.enable()
    before = time.time_ns()
    t = trace.now()
    time.sleep(0.002)
    trace.span("x", t)
    after = time.time_ns()
    (s,) = trace.spans()
    assert before - 1_000_000 <= s.start <= s.end <= after + 1_000_000
    assert s.end - s.start >= 2_000_000


def test_a_full_buffer_counts_its_drops():
    trace.enable(capacity=5)
    for _ in range(8):
        trace.span("x", trace.now())
    assert trace.stats()["spans"] == 5 and trace.stats()["dropped"] == 3
    assert len(trace.spans()) == 5


def test_full_collections_are_spans_and_young_ones_counts():
    trace.enable()
    assert trace._on_gc in gc.callbacks
    with trace.stage("work"):
        gc.collect()
    gc.collect(0)
    trace.disable()
    assert trace._on_gc not in gc.callbacks
    (g,) = [s for s in trace.spans() if s.name == "runtime.gc"]
    work = [s for s in trace.spans() if s.name == "work"][0]
    assert g.parent == work.id and g.attrs["collected"] >= 0
    assert trace.stats()["gc_young"] >= 1


def test_export_chrome_round_trips(tmp_path):
    trace.enable()
    with trace.stage("a"):
        trace.span("b", trace.now(), n=2)
    trace.disable()
    trace.export_chrome(tmp_path / "t.json")
    got = json.load(open(tmp_path / "t.json"))
    base = got["baseTimeNanoseconds"]
    ev = {e["name"]: e for e in got["traceEvents"] if e["ph"] == "X"}
    assert set(ev) == {"a", "b"} and got["readserver"]["spans"] == 2
    for s in trace.spans():
        assert abs(base + ev[s.name]["ts"] * 1e3 - s.start) < 1e3
        assert ev[s.name]["args"]["id"] == s.id
    assert ev["b"]["args"]["parent"] == ev["a"]["args"]["id"]
    assert ev["b"]["args"]["n"] == 2
    assert any(e["ph"] == "M" for e in got["traceEvents"])


@pytest.mark.parametrize("on", [False, True])
def test_startup_seconds_are_unchanged(corpus, on):
    if on:
        trace.enable()
    packed = build_index(corpus.reads[:200])
    engine = QueryEngine(packed, ServeConfig(**CFG), device="cpu")
    multi = MultiEngine([packed, packed], ServeConfig(**CFG), device="cpu")
    trace.disable()
    assert set(engine.startup_seconds) == {"ship", "lut"}
    assert all(set(e.startup_seconds) == {"ship", "lut"}
               for e in multi.engines)
    assert all(v >= 0 for v in engine.startup_seconds.values())
    if on:
        got = [s for s in trace.spans() if s.name.startswith("setup.")]
        want = [(f"setup.{k}", v) for e in [engine, *multi.engines]
                for k, v in e.startup_seconds.items()]
        assert [s.name for s in got] == [w[0] for w in want]
        for s, (_, v) in zip(got, want):
            assert v <= s.seconds <= v + 1e-3


def test_warmup_is_one_span_over_its_calls(corpus):
    engine = QueryEngine(build_index(corpus.reads[:200]), ServeConfig(**CFG),
                         device="cpu")
    trace.enable()
    engine.warmup()
    trace.disable()
    (w,) = [s for s in trace.spans() if s.name == "setup.warmup"]
    calls = [s for s in trace.spans() if s.name == "engine.call"]
    assert calls and all(c.parent == w.id for c in calls)


def test_serve_trace_out_writes_a_loadable_trace(tmp_path, corpus):
    """``serve --trace-out``: a short serve on the CPU, one request, SIGINT;
    the file it writes at exit loads and holds set-up, the engine and the
    dispatcher."""
    from test_torch_multihost import _answers, _free_port, _launch, _wait

    from readserver_tpu_torch.index import artifact

    artifact.save_artifact(build_index(corpus.reads[:200]), tmp_path / "idx")
    out = tmp_path / "spans.json"
    rest = _free_port()
    (proc,) = _launch(lambda i, port: [
        sys.executable, "-m", "readserver_tpu_torch.cli", "serve",
        "--index", str(tmp_path / "idx"), "--port", str(rest), "--batch",
        "16", "--device", "cpu", "--trace-out", str(out)], 1)
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, _wait([proc], 5)
            try:
                got = _answers(rest, _kmers(corpus, 2), "count")
                break
            except OSError:
                assert time.time() < deadline, "the server never answered"
                time.sleep(0.3)
        proc.send_signal(signal.SIGINT)
        outs = _wait([proc], timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, outs
    assert all(r["count"] > 0 for r in got)
    names = {e["name"] for e in json.load(open(out))["traceEvents"]
             if e["ph"] == "X"}
    assert {"setup.load", "setup.ship", "setup.warmup", "engine.call",
            "engine.assemble", "dispatcher.queue", "dispatcher.fly"} <= names
