#!/usr/bin/env python3
"""K9's partial and K13 of several checkouts of the port, timed in turn on
one card, and where a cross-rank ``/reads`` batch spends its time in each.

    python3 scripts/torch_partial_ab.py OTHER_CHECKOUT [MORE ...]

For this checkout and each named one (a directory holding another commit's
``readserver_tpu_torch``, e.g. unpacked by ``git archive``), each in its own
process (both packages are named ``readserver_tpu_torch``), in the order
A B ... then back again:

1. E. coli (``chip_smoke.py``'s artifact cache under ``data/``, built here
   when missing) in 4 interval shards, placed by a world of one over NCCL
   with the per-step program, the p=12 LUT through K11's partial;
2. on 2 ranks' first run (as a rank of a 2-rank row places it), over
   distinct width-8192 batches in turn until together they need twice the
   L2 (``chip_smoke.partial_cases``: the partials' public functions, which
   every checkout with the cross-rank program has): K9's partial on a
   3-column search step and on the rank of the batch's 8192 x 64 hit
   lanes, K13's dsa, LF and symbol lookups of those lanes; each one's
   wrapper time (CUDA events),
   device time (profiler), plain time and bytes bound
   (``chip_smoke.time_cases``);
3. one ``/reads`` batch of 4096 x 2 queries (8192 searched, H = 64, the
   engine's row budget, early walk exit, the exact sweep) through the
   cross-rank program on the dsa, lf and slow routes, split by
   ``chip_smoke.cross_rank_split``: the all-reduces and the host time in
   them, the partial kernels' device time, the host time between steps;
4. then, in a process of its own once the card is free, the checkout's
   2-rank group (``cli serve --coordinator``, 2 interval shards a rank,
   both ranks on the card over gloo, as ``chip_smoke.py`` phase 13 starts
   it): one ``/batch`` of the same 4096 x 2 ``/reads`` to warm it, then
   ``--repeats`` more, each timed on the host clock; every checkout's
   answers must be the same.

Prints one JSON line per run and a table of medians (device and wrapper
ms; the split's ms a step; the group's ``/batch`` ms).  Imports torch,
never jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
KMER = 31
# the tiers a placed index drops for each route (chip_smoke.ROUTE_DROPS,
# on the sharded index's fields)
ROUTE_STRIP = {
    "dsa": {},
    "lf": dict(dsa_chunk=None, dsa_bits=0),
    "slow": dict(dsa_chunk=None, dsa_bits=0, lf_chunk=None, mark_table=None,
                 spairs_chunk=None, sstarts=None, slens=None, sample_rate=0),
}


def helpers():
    """This checkout's ``chip_smoke.py`` helpers, loaded by path: the
    package itself comes from the checkout first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def queries_4096(corpus, seed: int) -> np.ndarray:
    """Phase 13's 4096 queries of a ``/reads`` of 4096 x 2 (codes 1-4)."""
    from readserver_tpu_torch.corpus import simulate

    return simulate.sample_query_kmers_fast(
        corpus, 4096 + 256 + 1, KMER, seed=seed, miss_frac=0.15)[257:]


def measure(scale: float, seed: int) -> dict:
    """This process's package (first on sys.path): the partials' readings
    and each route's batch split."""
    import torch

    smoke = helpers()
    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index
    from readserver_tpu_torch.native import native_available
    from readserver_tpu_torch.ops.lut import default_lut_order
    from readserver_tpu_torch.parallel import (build_prefix_lut_sharded,
                                               build_sharded,
                                               make_sharded_query_fn,
                                               place_sharded)
    from readserver_tpu_torch.parallel import multihost as mh

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = smoke.card_line()
    corpus = simulate.simulate_config("ecoli", scale=scale)
    packed = smoke.load_or_build(
        corpus, REPO / "data" / "chip_smoke" / f"ecoli_s{scale:g}",
        build_index, artifact, native_available)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    mh.init_multihost(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    mesh = mh.make_global_mesh(4, device=dev, per_step=True)
    host = build_sharded(packed, 4)
    s = place_sharded(host, mesh)
    p = default_lut_order(packed.n)
    lut = build_prefix_lut_sharded(s, mesh, p)
    cfg = ServeConfig(batch_size=8192)
    H = cfg.max_hits
    # the batches: phase 13's /reads of 4096 x 2 (the queries and their
    # reverse complements, codes 1-4), then 8192-query ones
    q4096 = queries_4096(corpus, seed)
    codes = torch.from_numpy(np.concatenate(
        [q4096, 5 - q4096[:, ::-1]]).astype(np.int32)).to(dev)
    more = simulate.sample_query_kmers_fast(
        corpus, 32 * 8192, KMER, seed=seed + 2, miss_frac=0.1)
    codes_sets = [codes] + [torch.from_numpy(b.astype(np.int32)).to(dev)
                            for b in np.split(more, 32)]
    runs = smoke.run_views(s, 2, dev)
    out = {"card": card}
    cases = smoke.partial_cases(s, runs[0], codes_sets, lut, p, H)
    for name, (ms, plain_ms, device_ms, bnd, shape, _) in smoke.time_cases(
            cases, None, card).items():
        out[name] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                         bound_ms=bnd, shape=shape)
    lengths = torch.full((codes.shape[0],), KMER, dtype=torch.int32,
                         device=dev)
    budget = int(cfg.resolve_budget_frac * codes.shape[0] * H)
    for route, strip in ROUTE_STRIP.items():
        sr = dataclasses.replace(s, **strip)
        fn = make_sharded_query_fn(
            sr, mesh, max_hits=H, lut_p=p, kstep=3,
            exact_hist=cfg.exact_attribution,
            exact_max_rows=cfg.max_sweep_rows, resolve_budget=budget,
            walk_early_exit=True)
        out[f"split, {route} route"] = smoke.cross_rank_split(
            lambda fn=fn, sr=sr: fn(sr, lut, codes, lengths),
            f"/reads of 4096 x 2, {route} route, world of one (NCCL)", card)
    import torch.distributed as dist

    dist.destroy_process_group()
    return out


def group_batch(checkout: str, scale: float, seed: int,
                repeats: int) -> dict:
    """The 2-rank gloo group of ``checkout`` (its package first on
    sys.path) serving the artifact ``measure`` left: the ``/batch`` of 4096
    x 2 ``/reads``, once to warm the group, then ``repeats`` times, each
    timed on the host clock → the times, their median and a digest of the
    answers."""
    import time

    from readserver_tpu_torch.corpus import simulate

    smoke = helpers()
    corpus = simulate.simulate_config("ecoli", scale=scale)
    kms = smoke.decode_all(queries_4096(corpus, seed))
    cache = REPO / "data" / "chip_smoke" / f"ecoli_s{scale:g}"
    logs = REPO / "data" / "partial_ab_group" / Path(checkout).name
    rest = smoke.free_port()
    t0 = time.perf_counter()
    procs = smoke.start_rank_group(cache, rest, logs, repo=Path(checkout))
    try:
        smoke.wait_rest(procs, rest, logs)
        up_s = time.perf_counter() - t0
        smoke.post_batch(rest, kms, "reads", True)
        ms = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            got = smoke.post_batch(rest, kms, "reads", True)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        rcs = smoke.stop_rank_group(procs, logs, sig_first=True)
    smoke.check(rcs == [0, 0], f"the group did not stop cleanly: exit {rcs}")
    digest = hashlib.sha256(json.dumps(got, sort_keys=True).encode())
    return {"ms": ms, "median_ms": float(np.median(ms)), "up_s": up_s,
            "answers": digest.hexdigest()[:16]}


def table(runs: dict, card: str) -> None:
    """The medians of each checkout's runs, a reading a line."""
    checkouts = list(runs)
    names = list(dict.fromkeys(n for c in checkouts for r in runs[c]
                               for n in r if n != "card"))
    print(f"# median of 2 runs each ({card}): device ms (wrapper ms); "
          f"a batch's split a step; the group's /batch ms")
    print("# reading | " + " | ".join(Path(c).name for c in checkouts))
    for n in names:
        cells = []
        for c in checkouts:
            rs = [r[n] for r in runs[c] if n in r]
            if not rs:
                cells.append("not measured")
            elif n.startswith("group"):
                meds = [r["median_ms"] for r in rs]
                cells.append(f"{np.median(meds):.3f} ms (runs: "
                             + ", ".join(f"{m:.3f}" for m in meds) + ")")
            elif n.startswith("split"):
                cells.append(", ".join(
                    f"{k[:-len('_ms_a_step')]} {np.median([r[k] for r in rs]):.4f}"
                    for k in rs[0] if k.endswith("_ms_a_step")))
            else:
                dv = [r["device_ms"] for r in rs if r["device_ms"] is not None]
                cells.append(
                    (f"{np.median(dv):.4f}" if dv else "not measured")
                    + f" ({np.median([r['ms'] for r in rs]):.4f})")
        print(f"# {n} | " + " | ".join(cells))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="*", help="other checkouts to time")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed /batch requests of the 2-rank group")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--group", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        sys.path.insert(0, args.measure)
        print(json.dumps(measure(args.scale, args.seed)))
        return 0
    if args.group:
        sys.path.insert(0, args.group)
        print(json.dumps({"group /batch reads of 4096 x 2, 2 ranks (gloo)":
                          group_batch(args.group, args.scale, args.seed,
                                      args.repeats)}))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    checkouts = [str(REPO)] + [str(Path(o).resolve()) for o in args.others]
    runs: dict[str, list[dict]] = {c: [] for c in checkouts}
    for c in checkouts + checkouts[::-1]:
        env = dict(os.environ, PYTHONPATH=c)
        got = {}
        for mode in ("--measure", "--group"):
            res = subprocess.run(
                [sys.executable, __file__, mode, c, "--scale",
                 str(args.scale), "--seed", str(args.seed), "--repeats",
                 str(args.repeats)],
                capture_output=True, text=True, env=env, cwd=c)
            sys.stdout.write("".join(
                f"# {Path(c).name}: {ln}\n" for ln in res.stdout.splitlines()
                if ln.startswith("#")))
            if res.returncode != 0:
                print(res.stdout[-4000:] + res.stderr[-4000:],
                      file=sys.stderr)
                return 1
            got.update(json.loads(res.stdout.strip().splitlines()[-1]))
        runs[c].append(got)
        print(json.dumps({"checkout": c, **got}), flush=True)
    answers = {r[n]["answers"] for c in checkouts for r in runs[c]
               for n in r if n.startswith("group")}
    if len(answers) != 1:
        print(f"the checkouts' groups answered differently: {answers}",
              file=sys.stderr)
        return 1
    table(runs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
