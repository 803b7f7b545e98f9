#!/usr/bin/env python3
"""K8 (the served answer's sparse pack) and the cohort merge's pack of
several checkouts of the port, timed in turn on one card.

    python3 scripts/torch_pack_ab.py [OTHER_CHECKOUT ...]

For this checkout and each named one (a directory holding another tree's
``readserver_tpu_torch``, e.g. unpacked by ``git archive``), each in its
own process (both packages are named ``readserver_tpu_torch``), in the
order A B ... then back again, on seeded inputs at the shapes
``chip_smoke.py`` phase 7 times, with the share of kept entries its
served requests showed:

* K8 on ``/reads`` 4096 x 2: W = 8192, NS = 1, SH = 64, 0.85 of the
  cells and 0.145 of the lanes kept;
* K8 on the cohort's ``/samples`` 4096 x 2: NS = 128, 0.018 of the cells;
* the merge on the cohort front's 4 partitions x [4096, 324] (``/reads``,
  0.005 of each partition's cells and 0.01 of its lanes) and x [4096, 132]
  (``/samples``).

16 distinct input sets a case, in turn: the wrapper's time (CUDA events,
median of 3 passes) and the device time of the pack's kernels (profiler,
every kernel whose name holds ``pack_``), the outputs equal to the plain
forms on every set.  Prints one JSON line per run and a table of medians.
Imports torch, never jax.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SETS = 16
CPQ = 16


def device_ms(fn, iters: int) -> float | None:
    """Device milliseconds a call of ``fn`` over the kernels whose name
    holds ``pack_`` (one profiler pass after ``iters`` untimed calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        with record_function("timed calls"):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events if e.name == "timed calls"
                and e.device_type == DeviceType.CPU)
    us = sum(e.self_device_time_total for e in events
             if e.device_type == DeviceType.CUDA and "pack_" in e.name
             and span.start <= e.time_range.start <= span.end)
    return us / iters / 1e3 if us else None


def wrapper_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def answer_sets(rng, W, NS, H, cells, lanes, dev):
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    out = []
    for _ in range(SETS):
        l = rng.integers(0, 1 << 27, W)
        u = l + rng.integers(0, 300, W)
        hist = np.where(rng.random((W, NS)) < cells,
                        rng.integers(1, 50, (W, NS)), 0)
        comp = torch.from_numpy(rng.random(W) < 0.99).to(dev)
        x = [t(l), t(u), comp, t(hist)]
        if H:
            rid = np.where(rng.random((W, H)) < lanes,
                           rng.integers(0, 1 << 20, (W, H)), -1)
            x += [t(rid), t(rng.integers(0, 100, (W, H))),
                  t(rng.integers(0, 128, (W, H)))]
        else:
            x += [None, None, None]
        out.append(x)
    return out


def merge_sets(rng, W, ns, H, hits, cells, lanes, dev):
    import torch

    out = []
    for _ in range(SETS):
        outs = []
        for n in ns:
            o = np.zeros((W, 4 + n + (3 * H if hits else 0)), np.int32)
            o[:, 2] = rng.integers(0, 200, W)
            o[:, 3] = rng.random(W) < 0.99
            o[:, 4:4 + n] = np.where(rng.random((W, n)) < cells,
                                     rng.integers(1, 20, (W, n)), 0)
            if hits:
                o[:, 4 + n:4 + n + H] = np.where(
                    rng.random((W, H)) < lanes,
                    rng.integers(0, 1 << 20, (W, H)), -1)
                o[:, 4 + n + H:] = rng.integers(0, 100, (W, 2 * H))
            outs.append(torch.from_numpy(o).to(dev))
        out.append(outs)
    return out


def child(checkout: str) -> dict:
    sys.path.insert(0, checkout)
    import itertools

    import torch
    from readserver_tpu_torch.ops import pack

    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    ns, bases = [128] * 4, [0, 600_000, 1_200_000, 1_800_000]
    cases = {}
    for name, sets in (
            ("K8 /reads", answer_sets(rng, 8192, 1, 64, 0.85, 0.145, dev)),
            ("K8 /samples", answer_sets(rng, 8192, 128, 0, 0.018, 0, dev))):
        cases[name] = (sets, lambda x: pack.pack_answer(
            *x, 8192, CPQ, bad, 64)[0], lambda x: pack.pack_answer_plain(
                *x, 8192, CPQ, bad, 64)[0])
    for name, hits in (("merge /reads", True), ("merge /samples", False)):
        sets = merge_sets(rng, 4096, ns, 64, hits, 0.005, 0.01, dev)
        cases[name] = (sets, lambda x, h=hits: pack.merge_pack(
            x, ns, bases, 128, 64, 4096, CPQ, bad, h)[0],
            lambda x, h=hits: pack.merge_pack_plain(
                x, ns, bases, 128, 64, 4096, CPQ, bad, h)[0])
    res = {"checkout": checkout, "card": torch.cuda.get_device_name(0)}
    for name, (sets, kern, plain) in cases.items():
        for x in sets:
            if not torch.equal(kern(x), plain(x)):
                raise SystemExit(f"{checkout}: {name} differs from its "
                                 "plain form")
        turn = itertools.cycle(sets)
        call = lambda: kern(next(turn))  # noqa: E731
        call()
        res[name] = dict(
            wrapper_ms=float(np.median([wrapper_ms(call, SETS)
                                        for _ in range(3)])),
            device_ms=device_ms(call, SETS))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="*", help="other checkouts' roots")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    roots = [str(REPO)] + [str(Path(o).resolve()) for o in args.others]
    runs = []
    for root in roots + roots[::-1]:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", root],
            capture_output=True, text=True, cwd=root)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line)
        runs.append(json.loads(line))
    print(f"# medians by checkout, device ms (wrapper ms) | {card}")
    for name in ("K8 /reads", "K8 /samples", "merge /reads",
                 "merge /samples"):
        cells = []
        for root in roots:
            mine = [r[name] for r in runs if r["checkout"] == root]
            dev = [m["device_ms"] for m in mine if m["device_ms"]]
            cells.append(
                f"{Path(root).name}: "
                f"{np.median(dev) if dev else float('nan'):.4f} "
                f"({np.median([m['wrapper_ms'] for m in mine]):.4f})")
        print(f"# {name}: " + " · ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
