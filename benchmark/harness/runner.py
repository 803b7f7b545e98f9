"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the reference once the window has closed."""

from __future__ import annotations

import asyncio
import gc
import time

from harness import deploy, judge, load, trace
from harness.host import HostWatch
from harness.cell import Cell, metric_reader
from harness.record import RunRecord

GIB = float(1 << 30)


def _window_fill(metrics, b0: int, b1: int) -> list:
    fill = list(metrics.batch_fill)
    first = metrics.batches - len(fill)   # batch number of fill[0]
    return fill[max(b0 - first, 0):max(b1 - first, 0)]


async def _serve(engine_proxy, cell: Cell, pool, seed, seconds, watch):
    from readserver_tpu_torch.serve.dispatcher import Dispatcher

    disp = Dispatcher(engine_proxy)
    await disp.start()
    marks = {}

    def on_window(opening: bool) -> None:
        marks["b0" if opening else "b1"] = disp.metrics.batches
        engine_proxy.recording = opening
        watch.window(opening)

    got = await load.closed_loop(disp, cell.traffic, pool, seed, seconds,
                                 deploy.sample_names(cell.config), on_window)
    await disp.stop()
    return got, disp.metrics, marks


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool,
             device: str, t_start: float, cache_dir=deploy.CACHE_DIR,
             fault=None, log=print):
    """→ (result line as a dict, numbers compared)."""
    import torch

    from readserver_tpu_torch.kernels import KERNELS

    cuda = device == "cuda"
    config, traffic = cell.config, cell.traffic
    reads, sids = deploy.reads_of(config)
    path = deploy.artifact_path(config, cache_dir)
    t0 = time.perf_counter()
    build_s = 0.0
    if deploy.ensure_artifact(config, reads, sids, path):
        # a deployment's index is built once, before it serves: recorded
        # apart, not as set-up
        build_s = time.perf_counter() - t0
        log(f"built {path.name} in {build_s:.1f} s")
    engine = deploy.make_engine(config, path, device)
    engine.warmup()
    pool_codes, pool = load.make_pool(reads, traffic, seed)
    counters = lambda: {k: v.launches for k, v in KERNELS.items()}  # noqa: E731
    proxy = load.EngineProxy(engine, counters if trace_on else None, fault)
    prof = None
    if trace_on and cuda:
        # CUDA activity only: the host runs as it does untraced
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    # set-up's garbage is collected before the load starts
    gc.collect()
    watch = HostWatch()
    try:
        got, metrics, marks = asyncio.run(
            _serve(proxy, cell, pool, seed, seconds, watch))
    finally:
        watch.close()
    w0, w1 = got.window
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if prof is not None:
        torch.cuda.synchronize()
        prof.stop()

    # end to end: every request completed inside the window
    size = int(traffic["kmers_per_request"])
    inwin = [r for r in got.done if w0 <= r[3] <= w1]
    failed = sum(1 for r in inwin if not r[4])
    lat = [(r[3] - r[2]) * 1e3 if r[4] else float("inf") for r in inwin]
    e2e = {
        "kmers_per_s": (size * (len(inwin) - failed) / (w1 - w0), "kmers/s"),
        "device_peak_gib": (peak / GIB, "GiB"),
        "setup_s": (w0 - t_start - build_s, "s"),
    }
    result = {"correct": False, "attempted": len(inwin), "failed": failed}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}

    # per layer: the traced run
    window_calls = [c for c in proxy.calls if w0 <= c.t0 and c.t1 <= w1]
    rec = RunRecord(engine=engine, config=config, traffic=traffic,
                    window_calls=window_calls, latencies_ms=lat,
                    batch_fill=_window_fill(metrics, marks["b0"], marks["b1"]),
                    traced_calls=[c for c in window_calls if c.kmers],
                    gc_full_s=watch.full_s)
    if prof is not None:
        _reduce_trace(rec, prof, got, log)
        device_info["busy_s"] = trace.busy_seconds(
            trace.busy_intervals(rec.events, *rec.trace_bounds_ns))
        device_info["window_s"] = rec.trace_window_s
    if trace_on:
        values = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(rec)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = values
        if rec.events:
            result["breakdown"] = rec.breakdown
    else:
        result["metrics"] = {
            m["name"]: {"value": float(e2e[m["name"]][0]),
                        "unit": e2e[m["name"]][1]}
            for m in cell.end_to_end}
    result["device"] = device_info
    result["build_s"] = build_s
    for note in rec.notes:
        log(note)
    log(watch.summary(w1 - w0))
    sixth = (w1 - w0) / 6
    log("kmers_per_s by sixths of the window: " + ", ".join(
        f"{size * sum(1 for r in inwin if r[4] and i <= (r[3] - w0) / sixth < i + 1) / sixth:.0f}"
        for i in range(6)))
    log(f"window {w1 - w0:.3f} s: {len(inwin)} requests, {failed} failed, "
        f"{len(proxy.calls)} engine calls; artifact built in {build_s:.3f} s; "
        + ", ".join(f"{k} {v[0]!r}" for k, v in e2e.items()))
    if got.error:
        log(f"a request failed: {got.error}")

    # the program's state freed, then the reference
    del rec, proxy, engine, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers, ok = judge.judge(
        load.MODES[traffic["route"]], got.kept, pool_codes, reads, sids,
        deploy.sample_names(config), int(config["serve"]["max_hits"]),
        int(config["deployment"].get("doc_shards", 1)))
    numbers["requests_failed"] = {"value": failed, "at_most": 0}
    result["correct"] = ok and failed == 0
    log(f"reference: {len(got.kept)} requests judged in "
        f"{time.perf_counter() - t0:.1f} s")
    result["compared"] = numbers
    return result


def _reduce_trace(rec: RunRecord, prof, got, log) -> None:
    """The trace's device operations in the measured window, and the
    calls' host spans on the same wall clock."""
    events = trace.device_events(prof)
    lo, hi = got.window_ns
    t0 = got.window[0]
    rec.ns = lambda t: lo + (t - t0) * 1e9
    rec.events = events
    rec.trace_window_s = (hi - lo) / 1e9
    rec.trace_bounds_ns = (lo, hi)
    spans = [(f"in engine call ({c.mode}): host work or copy wait",
              rec.ns(c.t0), rec.ns(c.t1)) for c in rec.window_calls]
    merged = trace.busy_intervals(events, lo, hi)
    inside = [e for e in events if lo <= e[1] <= hi]
    rec.breakdown = {"device_ops": trace.top_ops(inside),
                     "idle_gaps": trace.idle_gaps(merged, lo, hi, spans)}
    in_calls = trace.count_within(inside, spans)
    launched = sum(sum(c.launches.values()) for c in rec.traced_calls)
    log(f"trace: {len(events)} device operations, {len(inside)} in the "
        f"{rec.trace_window_s:.3f} s window, {in_calls} of them inside an "
        f"engine call's host span; {launched} launches of the port's kernels "
        f"counted in the window's calls")
