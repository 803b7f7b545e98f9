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
every kernel whose name holds ``pack_``, in all and by kernel; a pass
where the profiler saw fewer launches than were made is taken again), the
outputs equal to the plain forms on every set; each pack kernel's launch
as the profiler's trace records it (grid, registers a thread, shared
memory: the library's own build, whose grid is the blocks its occupancy
query allows where the tiles are more); and an empty kernel's device
time on the grid of the two-launch design (a block a tile of 2048 cells
or lanes), the floor a launch costs, built alone into ``build/pack_ab/``.
Prints one JSON line per run and a table of medians.  Imports torch,
never jax.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SETS = 16
CPQ = 16


def device_ms(fn, iters: int, key: str = "pack_") -> dict:
    """Device milliseconds a call of ``fn`` by kernel, over the kernels
    whose name holds ``key`` (a profiler pass after ``iters`` untimed
    calls) → {kernel: ms}, with their sum under "total"; empty when the
    profiler saw none.  The profiler now and then misses launches: a pass
    where some kernel was seen fewer than ``iters`` times is taken again,
    up to 5 passes, and dropped (empty) if none saw them all."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(5):
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
        by, seen = {}, {}
        for e in events:
            if (e.device_type == DeviceType.CUDA and key in e.name
                    and span.start <= e.time_range.start <= span.end):
                name = re.search(r"(\w*" + key + r"\w*)", e.name).group(1)
                by[name] = by.get(name, 0.0) + e.self_device_time_total
                seen[name] = seen.get(name, 0) + 1
        if seen and all(n == iters for n in seen.values()):
            out = {k: v / iters / 1e3 for k, v in by.items()}
            out["total"] = sum(out.values())
            return out
    return {}


# the empty kernel, a unit of its own (the library holds only the
# entries a path launches)
FLOOR_SRC = r"""
#include <cuda_runtime.h>
__global__ void launch_floor_kernel() {}
extern "C" int rs_launch_floor(int grid, int threads, void* stream) {
  launch_floor_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def floor_ms(grid: int, iters: int) -> float | None:
    """Device ms of the empty kernel on ``grid`` blocks of 256 threads."""
    import torch
    from readserver_tpu_torch.kernels import build as kbuild

    so = REPO / "build" / "pack_ab" / "liblaunch_floor.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        unit = so.with_suffix(".cu")
        unit.write_text(FLOOR_SRC)
        subprocess.run([kbuild._nvcc(), *kbuild.ARCH_FLAGS, "-O3",
                        "-Xcompiler", "-fPIC", "-shared", str(unit), "-o",
                        str(so)], check=True)
    fn = ctypes.CDLL(str(so)).rs_launch_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call():
        rc = fn(grid, 256, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"rs_launch_floor: CUDA error {rc}")

    return device_ms(call, iters, "launch_floor").get("total")


def launches(fn, key: str = "pack_") -> dict:
    """Each kernel whose name holds ``key`` that one call of ``fn``
    launches, as the profiler's trace records it → {kernel: {grid, block,
    registers per thread, shared memory, ...}} (empty: none seen)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    keep = ("grid", "block", "registers per thread", "shared memory",
            "est. achieved occupancy %")
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
        out = {}
        for e in events:
            if e.get("cat") == "kernel" and key in e.get("name", ""):
                name = re.search(r"(\w*" + key + r"\w*)", e["name"]).group(1)
                out[name] = {k: v for k, v in e.get("args", {}).items()
                             if k in keep}
        if out:
            return out
    return {}


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
    for name, sets, grid in (
            ("K8 /reads", answer_sets(rng, 8192, 1, 64, 0.85, 0.145, dev),
             4 + 256),
            ("K8 /samples", answer_sets(rng, 8192, 128, 0, 0.018, 0, dev),
             512)):
        cases[name] = (sets, lambda x: pack.pack_answer(
            *x, 8192, CPQ, bad, 64)[0], lambda x: pack.pack_answer_plain(
                *x, 8192, CPQ, bad, 64)[0], grid)
    for name, hits in (("merge /reads", True), ("merge /samples", False)):
        sets = merge_sets(rng, 4096, ns, 64, hits, 0.005, 0.01, dev)
        cases[name] = (sets, lambda x, h=hits: pack.merge_pack(
            x, ns, bases, 128, 64, 4096, CPQ, bad, h)[0],
            lambda x, h=hits: pack.merge_pack_plain(
                x, ns, bases, 128, 64, 4096, CPQ, bad, h)[0],
            256 + (512 if hits else 0))
    res = {"checkout": checkout, "card": torch.cuda.get_device_name(0)}
    for name, (sets, kern, plain, grid) in cases.items():
        for x in sets:
            if not torch.equal(kern(x), plain(x)):
                raise SystemExit(f"{checkout}: {name} differs from its "
                                 "plain form")
        turn = itertools.cycle(sets)
        call = lambda: kern(next(turn))  # noqa: E731
        call()
        by_kernel = device_ms(call, SETS)
        res[name] = dict(
            wrapper_ms=float(np.median([wrapper_ms(call, SETS)
                                        for _ in range(3)])),
            device_ms=by_kernel.get("total"), by_kernel=by_kernel,
            launches=launches(call),
            floor_ms=floor_ms(grid, SETS), floor_grid=grid)
    # ptxas's lines for the pack kernels, where this process built the
    # library (its first run of a checkout)
    from readserver_tpu_torch.kernels.build import LIBRARY

    log = getattr(LIBRARY, "build_log", "").splitlines()
    res["ptxas"] = [" | ".join(x.strip() for x in log[i:i + 4])
                    for i, line in enumerate(log)
                    if "Compiling entry function" in line and "pack" in line]
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
            split = {k: np.median([m["by_kernel"].get(k, np.nan)
                                   for m in mine])
                     for k in mine[0]["by_kernel"] if k != "total"}
            floor = [m["floor_ms"] for m in mine if m["floor_ms"]]
            cells.append(
                f"{Path(root).name}: "
                f"{np.median(dev) if dev else float('nan'):.4f} "
                f"({np.median([m['wrapper_ms'] for m in mine]):.4f})"
                + "".join(f" {k} {v:.4f}" for k, v in split.items())
                + (f" empty launch on {mine[0]['floor_grid']} blocks "
                   f"{np.median(floor):.4f}" if floor else ""))
        print(f"# {name}: " + " · ".join(cells))
    for root in roots:
        mine = next(r for r in runs if r["checkout"] == root)
        print(f"# launches, {Path(root).name}: " + "; ".join(
            f"{name} {k} {v}" for name in ("K8 /reads", "K8 /samples",
                                           "merge /reads", "merge /samples")
            for k, v in mine[name]["launches"].items()))
        for line in mine["ptxas"]:
            print(f"# ptxas, {Path(root).name}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
