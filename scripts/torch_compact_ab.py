#!/usr/bin/env python3
"""K14 (the row-budget compaction and its gather back) and K15 (the capped
histogram) of several checkouts of the port, timed in turn on one card,
beside the torch ops they replace.

    python3 scripts/torch_compact_ab.py [OTHER_CHECKOUT ...]

For this checkout and each named one (a directory holding another commit's
``readserver_tpu_torch``, e.g. unpacked by ``git archive``), each in its own
process (both packages are named ``readserver_tpu_torch``), in the order
A B ... then back again:

1. E. coli (``chip_smoke.py``'s artifact cache under ``data/``, built here
   when missing) on a fused-walk engine (``drop_tiers=("dsa",)``, width
   8192, H = 64, the row budget 0.6 x 8192 x 64 = 314,572), as phase 7 of
   ``chip_smoke.py`` drives it;
2. distinct batches of 8192 31-mers (miss fraction 0.1), searched by the
   engine, K14's compaction walked by K6: as many as together need twice
   the 50 MB L2 (``chip_smoke.sets_past_l2`` of the compaction's bytes);
3. each reading over the sets in turn: its wrapper time (CUDA events,
   median of 3 passes), its device time by kernel (one profiler pass,
   every CUDA kernel in the timed calls, summed by name), its bytes bound:
   K14's compaction, its gather back, K15, the single-device hit step's
   tail (the gather back with ``read_to_sample`` and the ``torch.where``s
   where the checkout has no such column), and the interval program's
   compaction, scatter back and histogram over int64 intervals, as torch
   ops (the code ``parallel/sharded.py`` ran before K14 served it) and
   through K14's int64 entry and K15's sample mode where the checkout
   has them; every reading's answers must equal the torch ops'.

Prints one JSON line per run and a table of medians.  Imports torch,
never jax.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
KMER = 31
B = 8192
H = 64


def helpers():
    """This checkout's ``chip_smoke.py`` helpers, loaded by path: the
    package itself comes from the checkout first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def device_by_kernel(fn, iters: int) -> dict:
    """Device milliseconds a call of ``fn`` by CUDA kernel name (one
    profiler pass over ``iters`` calls, after ``iters`` untimed ones)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(5):  # the profiler now and then records no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            with record_function("timed calls"):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        ev = prof.events()
        span = next(e.time_range for e in ev if e.name == "timed calls"
                    and e.device_type == DeviceType.CPU)
        out = {}
        for e in ev:
            if (e.device_type == DeviceType.CUDA and e.name != "timed calls"
                    and span.start <= e.time_range.start <= span.end):
                t, n = out.get(e.name, (0.0, 0))
                out[e.name] = (t + e.self_device_time_total, n + 1)
        if out:
            return {k[:80]: (t / iters / 1e3, n / iters)
                    for k, (t, n) in out.items()}
    return {}


def measure(scale: float, seed: int) -> dict:
    """This process's package (first on sys.path): every reading."""
    import torch

    smoke = helpers()
    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index
    from readserver_tpu_torch.native import native_available
    from readserver_tpu_torch.ops import resolve
    from readserver_tpu_torch.serve import QueryEngine

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = smoke.card_line()
    corpus = simulate.simulate_config("ecoli", scale=scale)
    packed = smoke.load_or_build(
        corpus, REPO / "data" / "chip_smoke" / f"ecoli_s{scale:g}",
        build_index, artifact, native_available)
    cfg = ServeConfig(batch_size=B, warmup_query_lengths=(KMER,),
                      drop_tiers=("dsa",))
    eng = QueryEngine(packed, cfg, device=dev)
    idx = eng.index
    R = eng.row_budget
    S = max(idx.num_samples, 1)
    r2s, m = idx.read_to_sample, idx.num_reads
    new = "smp_c" in inspect.signature(resolve.gather_lanes).parameters
    comp_bytes = 8 * B + 4 * (B + 1) + 5 * R

    def gather3(*args):
        """(read_id, offset, valid) of K14's gather, with no sample
        column."""
        got = resolve.gather_lanes(*args)
        return got[0], got[1], got[-1]

    n_sets = smoke.sets_past_l2(comp_bytes)
    qs = simulate.sample_query_kmers_fast(corpus, n_sets * B, KMER,
                                          seed=seed + 2, miss_frac=0.1)
    sets = []
    for q in np.split(qs, n_sets):
        ce, le, nq = eng._pad_encode(smoke.decode_all(q))
        l, u = eng._search(*eng._to_device(ce, le), *eng._routes(ce, le, nq),
                           eng._new_bad())
        rows_c, valid_c, prefix = resolve.compact_lanes(l, u, H, R)
        rid_c, off_c = resolve.resolve_rows_fused(idx, rows_c, valid_c)
        smp_c = resolve._clip_take(r2s, rid_c, m)
        rid, _, kept = gather3(l, u, H, R, prefix, rid_c, off_c)
        x = dict(l=l, u=u, prefix=prefix, rid_c=rid_c, off_c=off_c,
                 smp_c=smp_c, rid=rid, kept=kept, l64=l.long(), u64=u.long(),
                 slots=min(int(prefix[-1]), R))
        if new:  # the interval programs' lanes: the walk's sample column
            x["smp"], x["kept64"] = resolve.gather_lanes(
                x["l64"], x["u64"], H, R, prefix, rid_c, off_c,
                smp_c=smp_c)[2:]
        sets.append(x)
    slots = int(np.mean([x["slots"] for x in sets]))
    hits = int(np.mean([smoke.distinct(x["rid"][x["kept"]]) for x in sets]))
    F = B * H
    # K15 reads every lane's flag, a lane's id or sample only where the
    # flag is set (the walked slots), and by read id each distinct read's
    # read_to_sample entry once
    hist_bytes = F + 4 * slots + 4 * B * S
    # the gather back with the read_to_sample column: each distinct read's
    # entry once
    r2s_gather_bytes = 4 * (B + 1) + 8 * slots + 4 * hits + 13 * F
    # the interval programs' step: K14's int64 compaction, its gather with
    # the walk's samples and K15's sample mode, each kernel's bytes summed
    interval_bytes = ((16 * B + 4 * (B + 1) + 9 * R)
                      + (4 * (B + 1) + 12 * slots + 13 * F) + hist_bytes)

    def hits_tail_torch(x):
        rid, off, valid = gather3(x["l"], x["u"], H, R, x["prefix"],
                                  x["rid_c"], x["off_c"])
        smp = resolve._clip_take(r2s, rid, m)
        neg = lambda t: torch.full_like(t, -1)  # noqa: E731
        return (torch.where(valid, rid, neg(rid)),
                torch.where(valid, off, neg(off)),
                torch.where(valid, smp, neg(smp)), valid)

    # (name, fn of a set, bytes a set, reference fn or None)
    readings = [
        ("K14 compaction", lambda x: resolve.compact_lanes(
            x["l"], x["u"], H, R), comp_bytes, None),
        ("K14 gather", lambda x: resolve.gather_lanes(
            x["l"], x["u"], H, R, x["prefix"], x["rid_c"], x["off_c"]),
         4 * (B + 1) + 8 * slots + 9 * F, None),
        ("K15", lambda x: resolve.sample_histogram(idx, x["rid"], x["kept"]),
         hist_bytes + 4 * hits, None),
        ("hits tail, torch", hits_tail_torch, r2s_gather_bytes, None),
        ("interval, torch ops", lambda x: smoke.interval_torch_ops(
            x["l64"], x["u64"], H, R, x["rid_c"], x["off_c"], x["smp_c"], S),
         interval_bytes, None),
    ]
    if new:
        def hits_tail_kernel(x):
            return resolve.gather_lanes(
                x["l"], x["u"], H, R, x["prefix"], x["rid_c"], x["off_c"],
                read_to_sample=r2s, num_reads=m)

        readings += [
            ("K14 compaction, int64", lambda x: resolve.compact_lanes(
                x["l64"], x["u64"], H, R), 16 * B + 4 * (B + 1) + 9 * R,
             None),
            ("K14 gather, read_to_sample column", hits_tail_kernel,
             r2s_gather_bytes, hits_tail_torch),
            ("K14 gather, int64, sample column", lambda x:
             resolve.gather_lanes(x["l64"], x["u64"], H, R, x["prefix"],
                                  x["rid_c"], x["off_c"], smp_c=x["smp_c"]),
             4 * (B + 1) + 12 * slots + 13 * F, None),
            ("K15, sample mode", lambda x: resolve.lane_histogram(
                x["smp"], x["kept64"], S), hist_bytes, None),
            ("interval, K14 + K15", lambda x: smoke.interval_kernel_ops(
                x["l64"], x["u64"], H, R, x["rid_c"], x["off_c"], x["smp_c"],
                S),
             interval_bytes, lambda x: smoke.interval_torch_ops(
                 x["l64"], x["u64"], H, R, x["rid_c"], x["off_c"], x["smp_c"],
                 S)),
        ]
    out = {"card": card, "sets": n_sets, "slots_mean": slots, "budget": R}
    for name, fn, nbytes, ref in readings:
        if ref is not None:
            for x in sets:
                got, want = fn(x), ref(x)
                smoke.check(smoke.max_err(zip(got, want)) == 0,
                            f"{name} differs from the torch ops")
        turn = iter(sets * 1000)
        call = lambda: fn(next(turn))  # noqa: E731
        call()
        torch.cuda.synchronize()
        ms = float(np.median([smoke.time_cuda(call, len(sets))
                              for _ in range(3)]))
        by = device_by_kernel(call, len(sets))
        out[name] = dict(ms=ms, device_ms=sum(t for t, _ in by.values()),
                         kernels={k: round(t, 5) for k, (t, _) in by.items()},
                         launches={k: n for k, (_, n) in by.items()},
                         bound_ms=smoke.bound_ms(nbytes), bytes=nbytes)
        print(f"# {name}: wrapper {ms:.4f} ms, device "
              f"{out[name]['device_ms']:.4f} ms ({out[name]['kernels']}), "
              f"bound {out[name]['bound_ms']:.4f} ms | {card}", flush=True)
    return out


def table(runs: dict, card: str) -> None:
    """The medians of each checkout's runs, a reading a line."""
    checkouts = list(runs)
    names = list(dict.fromkeys(n for c in checkouts for r in runs[c]
                               for n in r if isinstance(r[n], dict)))
    print(f"# median of 2 runs each ({card}): device ms (wrapper ms) "
          f"[bound ms]")
    print("# reading | " + " | ".join(Path(c).name for c in checkouts))
    for n in names:
        cells = []
        for c in checkouts:
            rs = [r[n] for r in runs[c] if n in r]
            cells.append("not measured" if not rs else
                         f"{np.median([r['device_ms'] for r in rs]):.4f} "
                         f"({np.median([r['ms'] for r in rs]):.4f}) "
                         f"[{rs[0]['bound_ms']:.4f}]")
        print(f"# {n} | " + " | ".join(cells))
    for c in checkouts:
        for n in names:
            rs = [r[n] for r in runs[c] if n in r]
            if rs:
                ks = {k: float(np.median([r["kernels"].get(k, 0.0)
                                          for r in rs]))
                      for k in rs[0]["kernels"]}
                print(f"# {Path(c).name}, {n}, by kernel: {ks}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="*", help="other checkouts to time")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        sys.path.insert(0, args.measure)
        print(json.dumps(measure(args.scale, args.seed)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    checkouts = [str(REPO)] + [str(Path(o).resolve()) for o in args.others]
    runs: dict[str, list[dict]] = {c: [] for c in checkouts}
    for c in checkouts + checkouts[::-1]:
        env = dict(os.environ, PYTHONPATH=c)
        res = subprocess.run(
            [sys.executable, __file__, "--measure", c, "--scale",
             str(args.scale), "--seed", str(args.seed)],
            capture_output=True, text=True, env=env, cwd=c)
        sys.stdout.write("".join(
            f"# {Path(c).name}: {ln}\n" for ln in res.stdout.splitlines()
            if ln.startswith("#")))
        if res.returncode != 0:
            print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs[c].append(got)
        print(json.dumps({"checkout": c, **got}), flush=True)
    table(runs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
