#!/usr/bin/env python3
"""One cell as a ``--trace 1`` run serves it, with the program's span
recorder on from before the engine is made, and the device's idle time
split by span.

    python3 benchmark/trace_split.py --workload <name> --seed <n> --seconds <s> [--spans 0|1] [--chrome PATH]

It builds or loads the cell's deployment as ``run.py`` does, turns on
``readserver_tpu_torch.trace`` (``--spans 1``, the default), warms up,
serves the cell's closed-loop clients through the dispatcher under a
CUDA-only profiler for ``--seconds``, and prints one JSON line: the
window's ``kmers_per_s``, ``engine_call_ms`` (the proxy's wall time a
call) and ``gc_full_s``; the device's busy seconds, ``idle_gaps`` as the
benchmark labels them and ``idle_by_span``; and with the recorder on the
span statistics of ``harness/spans.py``, the stage spans' coverage of a
call, the spans' clock against the device trace, and the recorder's own
counts.  ``--spans 0`` serves the same with the recorder off: the pair
gives the recorder's cost.  ``--chrome`` writes the program's spans as
Chrome-trace JSON.  It judges no answers: ``run.py`` does.  Run by hand, on
a machine with the cell's card(s); not one of the benchmark's runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(1, str(BENCH.parent))
sys.path.insert(1, str(BENCH))


def _probe(program_trace, torch, n: int = 32) -> None:
    """``n`` clock probes: a one-element add launched and waited for inside
    a ``clock.probe`` span, 2 ms apart."""
    x = torch.zeros(1, device="cuda")
    for _ in range(n):
        with program_trace.stage("clock.probe"):
            x.add_(1)
            torch.cuda.synchronize()
        time.sleep(0.002)


def split(cell, seed: int, seconds: float, spans_on: bool, device: str,
          cache_dir=None, chrome=None, t_start: float = T_START) -> dict:
    import torch

    from harness import deploy, load, spans, trace
    from harness.host import HostWatch
    from readserver_tpu_torch import trace as program_trace
    from readserver_tpu_torch.serve.dispatcher import Dispatcher

    cuda = device == "cuda"
    marks = [("start", t_start)]
    reads, sids = deploy.reads_of(cell.config)
    marks.append(("reads", time.perf_counter()))
    path = deploy.artifact_path(cell.config, cache_dir or deploy.CACHE_DIR)
    deploy.ensure_artifact(cell.config, reads, sids, path)
    marks.append(("build", time.perf_counter()))
    if spans_on:
        program_trace.enable()
    engine = deploy.make_engine(cell.config, path, device)
    engine.warmup()
    marks.append(("engine", time.perf_counter()))
    _, pool = load.make_pool(reads, cell.traffic, seed)
    marks.append(("pool", time.perf_counter()))
    proxy = load.EngineProxy(engine)
    prof = None
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    gc.collect()
    watch = HostWatch()

    async def serve():
        disp = Dispatcher(proxy)
        await disp.start()
        got = await load.closed_loop(disp, cell.traffic, pool, seed,
                                     seconds, deploy.sample_names(cell.config),
                                     watch.window)
        await disp.stop()
        return got

    probing = prof is not None and spans_on
    try:
        if probing:
            _probe(program_trace, torch)
        got = asyncio.run(serve())
        if probing:
            _probe(program_trace, torch)
    finally:
        watch.close()
        program_trace.disable()
    if prof is not None:
        torch.cuda.synchronize()
        prof.stop()

    w0, w1 = got.window
    lo, hi = got.window_ns
    size = int(cell.traffic["kmers_per_request"])
    ok = sum(1 for r in got.done if w0 <= r[3] <= w1 and r[4])
    calls = [c for c in proxy.calls if w0 <= c.t0 and c.t1 <= w1]
    out = {"workload": cell.name, "seed": seed, "spans_on": spans_on,
           "kmers_per_s": size * ok / (w1 - w0),
           "engine_call_ms": statistics.median(
               [(c.t1 - c.t0) * 1e3 for c in calls]) if calls else None,
           "engine_calls": len(calls), "gc_full_s": watch.full_s,
           "window_s": (hi - lo) / 1e9}
    # set-up, host clock: the steps from the process's start to the window
    # (the build is left out, as run.py leaves it out of setup_s)
    marks.append(("ramp", w0))
    setup = {f"{b[0]}_s": b[1] - a[1] for a, b in zip(marks, marks[1:])}
    setup["setup_s"] = w0 - t_start - setup.pop("build_s")
    out["setup"] = setup
    found = program_trace.spans() if spans_on else []
    if spans_on:
        out["spans"] = spans.statistics(found, lo, hi)
        out["coverage"] = spans.coverage(found, lo, hi)
        out["recorder"] = program_trace.stats()
        by = defaultdict(float)
        for s in found:
            if s.name.startswith("setup."):
                by[s.name] += s.seconds
        out["setup_spans"] = dict(by)
    if prof is not None:
        events = trace.device_events(prof)
        merged = trace.busy_intervals(events, lo, hi)
        out["busy_s"] = trace.busy_seconds(merged)
        ns = lambda t: lo + (t - w0) * 1e9  # noqa: E731
        out["idle_gaps"] = trace.idle_gaps(
            merged, lo, hi, [(f"in engine call ({c.mode})", ns(c.t0),
                              ns(c.t1)) for c in calls])
        if spans_on:
            out["idle_by_span"] = spans.idle_by_span(merged, lo, hi, found)
            out["clock"] = spans.clock_check(found, events, lo, hi)
            out["skew_before"] = spans.clock_skew(
                [s for s in found if s.end < lo], events)
            out["skew_after"] = spans.clock_skew(
                [s for s in found if s.start > hi], events)
    if chrome and spans_on:
        program_trace.export_chrome(chrome)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--chrome", default="")
    args = ap.parse_args(argv)

    from harness.cell import find_cell

    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 3
    out = split(cell, args.seed, args.seconds, bool(args.spans), "cuda",
                chrome=args.chrome or None)
    out["card"] = torch.cuda.get_device_name(0)
    out["thread_clock"] = str(time.get_clock_info("thread_time"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
