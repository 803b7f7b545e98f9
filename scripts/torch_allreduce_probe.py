#!/usr/bin/env python3
"""Which collectives two ranks sharing one card can use, and what an
all-reduce of the cross-rank program's widths costs there.

    python3 scripts/torch_allreduce_probe.py            # both ranks, one card

Starts two rank processes on the card (``--rank`` is the processes' own
flag) and has each:

1. join a gloo group of 2 and all-reduce a CUDA int64 tensor as it is: ok
   or the error;
2. time, over gloo, the all-reduce the port runs
   (``parallel/multihost.all_reduce`` of a CUDA tensor) at the widths and
   types of its steps: a search step (2 x 8192 int64 lanes), a walk step
   (8192 x 64 lanes, int64 as the ranks, int32 as the lookups and the
   LF walk's steps) and a LUT level (8 x 4^10 int64), each the median of
   ``--iters`` calls on the host clock, every call ended by a sync of the
   card;
3. join an NCCL group of 2 on the same device and all-reduce one int64:
   the outcome (ok, or the error NCCL raises) is reported, never retried.

Rank 0 prints one JSON line after 2 and one after 3.  Imports torch,
never jax.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

# name → (lanes, type)
WIDTHS = {"search step, 2 x 8192": (2 * 8192, "int64"),
          "walk step, 8192 x 64": (8192 * 64, "int64"),
          "walk step int32, 8192 x 64": (8192 * 64, "int32"),
          "LUT level, 8 x 4^10": (8 * 4**10, "int64")}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    out = {}
    # 1. gloo with a CUDA tensor as it is
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port2}",
                            world_size=2, rank=args.rank,
                            timeout=timedelta(seconds=120))
    try:
        t = torch.ones(4, dtype=torch.int64, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out["gloo_cuda_tensor"] = f"ok: {t.tolist()}"
    except Exception as e:
        out["gloo_cuda_tensor"] = f"{type(e).__name__}: {e}"[:400]
    # 2. the port's all-reduce over gloo
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from readserver_tpu_torch.parallel.multihost import all_reduce

    times = {}
    for name, (width, dtype) in WIDTHS.items():
        t = torch.ones(width, dtype=getattr(torch, dtype), device=dev)
        lat = []
        for it in range(args.iters + 3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce(t, dist.group.WORLD)
            torch.cuda.synchronize()
            if it >= 3:
                lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        times[name] = {"median_ms": lat[len(lat) // 2], "min_ms": lat[0],
                       "max_ms": lat[-1], dtype: width}
    out["gloo_all_reduce"] = times
    dist.destroy_process_group()
    if args.rank == 0:  # before NCCL, whatever it does
        print(json.dumps(out), flush=True)
    out = {}
    # 3. NCCL, two ranks on one device
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{args.port}",
                                world_size=2, rank=args.rank,
                                timeout=timedelta(seconds=60))
        t = torch.ones(1, dtype=torch.int64, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out["nccl_two_ranks_one_card"] = f"ok: {int(t.item())}"
    except Exception as e:  # the outcome is the finding
        out["nccl_two_ranks_one_card"] = f"{type(e).__name__}: {e}"[:400]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if args.rank == 0:
        print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, default=-1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--port2", type=int, default=0)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--timeout", type=float, default=240.0)
    args = ap.parse_args()
    if args.rank >= 0:
        return rank_main(args)
    port, port2 = _free_port(), _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--port", str(port), "--port2", str(port2),
         "--iters", str(args.iters)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (1, 0)]
    rc = 0
    try:
        for p in procs[::-1]:
            out, err = p.communicate(timeout=args.timeout)
            sys.stdout.write(out)
            if p.returncode:
                sys.stderr.write(err[-4000:])
                rc = p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                out, _ = p.communicate()
                if p is procs[1]:  # rank 0's lines so far
                    sys.stdout.write(out)
                rc = rc or 124
    return rc


if __name__ == "__main__":
    sys.exit(main())
