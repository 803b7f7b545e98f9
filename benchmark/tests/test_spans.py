"""CPU tests of the program's spans read beside the device trace
(harness/spans.py) and of trace_split.py on tiny cells."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench_tiny import tiny_cell  # noqa: E402
from harness import spans as sp  # noqa: E402

STATS = ("queue_wait_ms", "loop_host_ms", "encode_ms", "copy_wait_ms",
         "assemble_ms", "engine_call_cpu_ms", "warmup_s")


def _s(i, name, thread, start, end, parent=0, request=0, cpu=None):
    return SimpleNamespace(id=i, name=name, thread=thread, start=start,
                           end=end, parent=parent, request=request,
                           cpu_ns=cpu, seconds=(end - start) / 1e9)


def _served():
    """Two engine calls on the device thread, the loop's spans around them,
    a block's queue wait, and a full collection on the loop."""
    d, lp = "device-batch_0", "MainThread"
    return [
        _s(1, "dispatcher.fill", lp, 0, 10),
        _s(2, "engine.call", d, 20, 100, cpu=40),
        _s(3, "engine.encode", d, 22, 30, 2),
        _s(4, "engine.launch", d, 30, 40, 2),
        _s(5, "engine.h2d", d, 31, 35, 4),
        _s(6, "engine.copy_wait", d, 40, 60, 2),
        _s(7, "engine.assemble", d, 60, 98, 2),
        _s(8, "dispatcher.fly", lp, 15, 110),
        _s(9, "dispatcher.rc", lp, 50, 70, request=1),
        _s(10, "runtime.gc", lp, 52, 56, 9),
        _s(11, "dispatcher.queue", lp, 0, 150, request=1),
        _s(12, "dispatcher.fold", lp, 120, 130, request=1),
        _s(13, "engine.call", d, 200, 260, cpu=30),
        _s(14, "engine.encode", d, 200, 204, 13),
        _s(15, "engine.launch", d, 204, 210, 13),
        _s(16, "engine.copy_wait", d, 210, 215, 13),
        _s(17, "engine.assemble", d, 215, 260, 13),
        _s(18, "dispatcher.take", lp, 11, 14),
        _s(19, "setup.warmup", lp, -100, -50),
    ]


def test_idle_by_span_takes_gc_then_device_then_loop_then_none():
    # the card busy over [36, 38] of [0, 300]; every other instant is
    # labelled by the span open there: the collection over the device
    # thread's copy wait, the device thread over the loop's reverse
    # complements, the loop's spans, and nothing between calls (the
    # block's queue wait labels nothing)
    got = dict(sp.idle_by_span([[36, 38]], 0, 300, _served()))
    want = {"dispatcher.fill": 10, sp.NO_SPAN: 122, "dispatcher.take": 3,
            "dispatcher.fly": 15, "engine.call": 4, "engine.encode": 12,
            "engine.launch": 10, "engine.h2d": 4, "engine.copy_wait": 21,
            "runtime.gc": 4, "engine.assemble": 83, "dispatcher.fold": 10}
    assert got == pytest.approx({k: v * 1e-9 for k, v in want.items()},
                                abs=1e-15)
    assert sum(got.values()) == pytest.approx(298e-9)
    # a window that holds only the second call: the loop's spans of the
    # first no longer count, and warm-up's calls on the loop's thread do
    # not make it a device thread
    spans = _served() + [SimpleNamespace(
        id=20, name="engine.call", thread="MainThread", start=-90, end=-60,
        parent=19, request=0, cpu_ns=None, seconds=30e-9)]
    got = dict(sp.idle_by_span([[212, 213]], 190, 270, spans))
    assert got == pytest.approx({sp.NO_SPAN: 20e-9, "engine.encode": 4e-9,
                                 "engine.launch": 6e-9,
                                 "engine.copy_wait": 4e-9,
                                 "engine.assemble": 45e-9}, abs=1e-15)


def test_clock_skew_by_hand():
    probes = [SimpleNamespace(name="clock.probe", start=1000, end=1100),
              SimpleNamespace(name="clock.probe", start=2000, end=2050)]
    events = [("elementwise_add", 1030, 1060),
              ("elementwise_add", 2010, 2040)]
    got = sp.clock_skew(probes, events)
    assert got == {"probes": 2, "skew_min_us": -0.01, "skew_max_us": 0.01}
    assert sp.clock_skew(probes, []) is None


def test_statistics_by_hand():
    got = sp.statistics(_served(), 0, 300)
    assert got["queue_wait_ms"] == 150 / 1e6
    # rc 20 less its collection 4, fold 10, take 3: over two calls
    assert got["loop_host_ms"] == pytest.approx((16 + 10 + 3) / 1e6 / 2)
    assert got["encode_ms"] == pytest.approx(((8 + 4) + 4) / 2 / 1e6)
    assert got["copy_wait_ms"] == pytest.approx((20 + 5) / 2 / 1e6)
    assert got["assemble_ms"] == pytest.approx((38 + 45) / 2 / 1e6)
    assert got["engine_call_cpu_ms"] == pytest.approx(35 / 1e6)   # the mean
    assert got["warmup_s"] == pytest.approx(50e-9)
    # the stages cover 76 of the first call's 80 ns, all of the second's
    assert sp.coverage(_served(), 0, 300) == pytest.approx((76 / 80 + 1) / 2)
    # nothing in a window that holds no call
    assert sp.statistics(_served(), 280, 300)["encode_ms"] is None


def test_clock_check_by_hand():
    events = [("void backward_search_kernel<3>", 33, 34),
              ("Memcpy DtoH (Device -> Pinned)", 41, 45),
              ("void backward_search_kernel<3>", 205, 206),
              ("Memcpy DtoH (Device -> Pinned)", 211, 216)]
    got = sp.clock_check(_served(), events, 0, 300, skew_ns=0)
    assert got["calls"] == 2 and got["agree_share"] == 0.5
    assert got["early_max_us"] == pytest.approx(-1e-3)
    assert got["late_max_us"] == pytest.approx(1e-3)
    assert sp.clock_check(_served(), events, 0, 300,
                          skew_ns=1)["agree_share"] == 1.0


@pytest.mark.parametrize("workload,kw", [
    ("ecoli30x.count", {}),
    ("cohort128.samples", dict(samples=8, coverage=20.0)),
    ("cohort128.count", dict(samples=8, coverage=20.0))])
def test_a_tiny_run_gives_every_number(workload, kw):
    import trace_split

    from readserver_tpu_torch import trace

    got = trace_split.split(tiny_cell(workload, **kw), 2**31 + 91, 1.0,
                            True, "cpu", ROOT / "benchmark" / "cache")
    assert not trace.ON
    assert got["kmers_per_s"] > 0 and got["engine_calls"] > 0
    assert all(got["spans"][k] is not None and got["spans"][k] >= 0
               for k in STATS), got["spans"]
    assert got["spans"]["warmup_s"] > 0
    assert got["recorder"]["dropped"] == 0
    assert 0.5 < got["coverage"] <= 1.0
    assert got["setup"]["setup_s"] > 0 and got["setup_spans"]["setup.load"] > 0
    off = trace_split.split(tiny_cell(workload, **kw), 2**31 + 91, 0.5,
                            False, "cpu", ROOT / "benchmark" / "cache")
    assert "spans" not in off and not trace.ON
