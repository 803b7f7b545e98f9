#!/usr/bin/env python3
"""The search, walk and sharded kernels of several checkouts of the port,
timed in turn on one card.

    python3 scripts/torch_walk_ab.py OTHER_CHECKOUT [MORE ...] [--crossover]

Times the kernels of this checkout and of each named one (a directory
holding another commit's ``readserver_tpu_torch``, e.g. unpacked by ``git
archive``) at the shapes ``chip_smoke.py`` uses: K2 (the k-step search
from the p=12 LUT) at width 8192 and at 262,144, K5 on the served
batch's intervals, K6 on the fused E. coli engine's compacted rows at
width 8192 and at a full budget, and K7 through the dsa and the fused
walk at the cohort's width 8192 and at the cap-filling batch; where the
checkout has the rank walks' kernel (``resolve_walk``), the marks, lf and
slow walks on the same compacted rows and at a full budget, and K7
through each of them at width 8192 and at the cap-filling batch; where
it has the interval-sharded kernels (``ops/sharded.py``), E. coli in 4
shards: K11's p=12 LUT, the sharded search at width 8192, K10's resolve
of that batch's hit lanes (H = 64) on the dsa, lf and slow routes, and
K10's exact sweep of the cohort's width-8192 batch (4 shards, window
32,768) through each route.  Each checkout runs in its own process (both
packages are named ``readserver_tpu_torch``), in the order A B ... then
back again, so that two versions are compared on one card and in turns.
Every time is the profiler's device time of the kernel, the mean over 10
calls, taken only where the profiler saw every launch; t_row (the
``rs_chase`` yardstick, warm and cold) rides beside them.  The artifacts
come from ``chip_smoke.py``'s cache under ``data/`` (built here when
missing).  Prints one JSON line per run, each checkout's ptxas spills,
its sweep kernels' registers and the loops of their SASS (``--sass-dir``
keeps the dumps), and a table of medians.  ``--crossover`` then
sweeps this checkout's one/two-round limit of the marks and slow walks
(``rs_walk_one_round_max``): forced one or two rounds at 8-64 walks a
warp, the served width 8192 at limits around it, and K7 at the
cap-filling batch.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
KMER = 31


def measure(scale: float, seed: int, sass_dir: str | None = None) -> dict:
    """This process's package (first on sys.path): device ms per shape."""
    import dataclasses

    import torch

    # this checkout's chip_smoke.py helpers, loaded by path: the package
    # itself comes from the checkout first on sys.path
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    decode_all, fill_k = smoke.decode_all, smoke.fill_k
    kernel_device_ms, load_or_build = smoke.kernel_device_ms, smoke.load_or_build
    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index
    from readserver_tpu_torch.index.budget import plan_tiers
    from readserver_tpu_torch.native import native_available
    from readserver_tpu_torch.ops import DeviceIndex, resolve
    from readserver_tpu_torch.serve import QueryEngine

    from readserver_tpu_torch.kernels import build as kbuild

    # built in this process, so that its ptxas report is read below
    (kbuild._BUILD / f"libreadserver_kernels_{kbuild._source_hash()}.so"
     ).unlink(missing_ok=True)
    dev = torch.device("cuda:0")
    cache = REPO / "data" / "chip_smoke"
    corpus = simulate.simulate_config("ecoli", scale=scale)
    cohort = simulate.simulate_config("cohort", scale=scale)
    packed = load_or_build(corpus, cache / f"ecoli_s{scale:g}", build_index,
                           artifact, native_available)
    cpacked = load_or_build(cohort, cache / f"cohort_s{scale:g}", build_index,
                            artifact, native_available)
    cfg = ServeConfig(batch_size=8192, warmup_query_lengths=(KMER,))
    cfg_f = dataclasses.replace(cfg, drop_tiers=("dsa",))
    eng_f = QueryEngine(packed, cfg_f, device=dev)
    ceng = QueryEngine(cpacked, cfg, device=dev)
    ceng_f = QueryEngine(cpacked, cfg_f, device=dev)
    rank_walks = hasattr(resolve, "walk_kind")  # this checkout has them
    H = cfg.max_hits

    def intervals(eng, kms):
        ce, le, nq = eng._pad_encode(kms)
        return eng._search(*eng._to_device(ce, le), *eng._routes(ce, le, nq),
                           eng._new_bad())

    def compacted(kms):
        rows, valid, _ = resolve.expand_intervals(*intervals(eng_f, kms), H)
        return resolve.compact_rows(rows, valid, eng_f.row_budget)[:2]

    # the queries of chip_smoke.py's timing phase, from the same seeds
    q4096 = simulate.sample_query_kmers_fast(
        corpus, 4096 + 256 + 1, KMER, seed=seed, miss_frac=0.15)[257:]
    c4096 = simulate.sample_query_kmers_fast(
        cohort, 4096 + 256, KMER, seed=seed + 3, miss_frac=0.1)[256:]
    ten = simulate.sample_query_kmers_fast(
        corpus, 4096, fill_k(eng_f.index.n, 2 * H), seed=seed + 4,
        miss_frac=0.0)
    eight = simulate.sample_query_kmers_fast(
        cohort, 8192, fill_k(ceng.index.n, 256), seed=seed + 5,
        miss_frac=0.0)
    main_rows = compacted(eng_f._expand_rc(decode_all(q4096))[0])
    full_rows = compacted(eng_f._expand_rc(decode_all(ten))[0])
    cl, cu = intervals(ceng, ceng._expand_rc(decode_all(c4096))[0])
    kl, ku = intervals(ceng, decode_all(eight))
    win, cap = 8 * 8192, cfg.max_sweep_rows
    fused = eng_f.index
    cases = {
        "K6 width 8192": ("resolve_fused_kernel",
                          lambda: resolve.resolve_rows_fused(fused,
                                                             *main_rows)),
        "K6 full budget": ("resolve_fused_kernel",
                           lambda: resolve.resolve_rows_fused(fused,
                                                              *full_rows)),
    }
    for wname, idx in (("dsa", ceng.index), ("fused", ceng_f.index)):
        for shape, (hl, hu) in (("width 8192", (cl, cu)),
                                ("cap-filling", (kl, ku))):
            cases[f"K7 {shape}, {wname} walk"] = (
                "exact_histogram_kernel",
                lambda idx=idx, hl=hl, hu=hu: resolve.exact_sample_histogram(
                    idx, hl, hu, win, cap))
    if rank_walks:
        forms = {"marks": (("dsa", "fused", "lf"), resolve.resolve_rows_marked),
                 "lf": (("dsa", "fused"), resolve.resolve_rows_fast),
                 "slow": (("dsa", "fused", "marks", "lf"),
                          resolve.resolve_rows)}
        for kind, (drop, walk) in forms.items():
            widx = DeviceIndex.from_packed(packed, dev,
                                           tiers=plan_tiers(packed, None,
                                                            drop).keep)
            assert resolve.walk_kind(widx) == kind
            for shape, rows in (("width 8192", main_rows),
                                ("full budget", full_rows)):
                cases[f"{kind} walk {shape}"] = (
                    "resolve_walk_kernel",
                    lambda w=walk, x=widx, r=rows: w(x, *r))
        # K7 through the marks, lf and slow walks (the tiers of
        # tests/test_torch_kernels.HIST_TIERS)
        for kind, tiers in (("marks", {"marks"}), ("lf", {"marks", "lf"}),
                            ("slow", set())):
            cidx = DeviceIndex.from_packed(cpacked, dev, tiers=tiers)
            assert resolve.walk_kind(cidx) == kind
            for shape, (hl, hu) in (("width 8192", (cl, cu)),
                                    ("cap-filling", (kl, ku))):
                cases[f"K7 {shape}, {kind} walk"] = (
                    "exact_histogram_kernel",
                    lambda x=cidx, hl=hl, hu=hu:
                        resolve.exact_sample_histogram(x, hl, hu, win, cap))
    # K2 and K5 on the default E. coli engine's served batch, K2 also at
    # the timing width
    from readserver_tpu_torch.ops import search as search_ops
    eng = QueryEngine(packed, cfg, device=dev)
    served = eng._expand_rc(decode_all(q4096))[0]
    codes = eng._to_device(*eng._pad_encode(served)[:2])[0]
    wide = torch.from_numpy(simulate.sample_query_kmers_fast(
        corpus, 262_144, KMER, seed=seed + 6, miss_frac=0.15).astype(
            np.int32)).to(dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    for shape, q in (("width 8192", codes), ("262,144", wide)):
        cases[f"K2 {shape}"] = (
            "backward_search_kernel",
            lambda q=q: search_ops.backward_search_cuda(
                eng.index, q, None, eng.lut, eng.lut_p, True, bad=bad))
    sl, su = search_ops.backward_search_cuda(eng.index, codes, None, eng.lut,
                                             eng.lut_p, True)
    cases["K5 width 8192"] = (
        "resolve_dsa_kernel",
        lambda: resolve.resolve_dsa_hits(eng.index, sl, su, H))
    try:
        from readserver_tpu_torch import parallel as par
        from readserver_tpu_torch.ops import sharded as sops
    except ImportError:  # a checkout before the interval-sharded kernels
        sops = None
    if sops is not None:
        mesh = par.make_mesh(num_shards=4, device=dev)
        s = par.place_sharded(par.build_sharded(packed, 4), mesh)
        cs = par.place_sharded(par.build_sharded(cpacked, 4), mesh)
        p = eng.lut_p
        slut = par.build_prefix_lut_sharded(s, None, p)
        cases["K11 p=12 LUT"] = ("sharded_lut_level_kernel",
                                 lambda: par.build_prefix_lut_sharded(
                                     s, None, p))
        cases["sharded search width 8192"] = (
            "sharded_search_kernel",
            lambda: sops.search(s, codes, None, slut, p, 3, bad=bad))
        l, u = sops.search(s, codes, None, slut, p, 3)
        span = torch.arange(H, device=dev)
        rows = (l[:, None] + span).reshape(-1)
        valid = (span[None, :] < (u - l)[:, None]).reshape(-1)
        rows = torch.where(valid, rows, torch.zeros_like(rows))
        no_dsa = dict(dsa_chunk=None, dsa_bits=0)
        drops = {"dsa": {}, "lf": no_dsa,
                 "slow": dict(no_dsa, lf_chunk=None, sample_rate=0)}
        csl, csu = sops.search(
            cs, ceng._to_device(*ceng._pad_encode(
                ceng._expand_rc(decode_all(c4096))[0])[:2])[0],
            None, par.build_prefix_lut_sharded(cs, None, ceng.lut_p),
            ceng.lut_p, 3)
        for route, drop in drops.items():
            sr = dataclasses.replace(s, **drop)
            csr = dataclasses.replace(cs, **drop)
            assert sops.walk_kind(sr) == route == sops.walk_kind(csr)
            cases[f"K10 {route} width 8192"] = (
                "sharded_resolve_kernel",
                lambda sr=sr: sops.resolve(sr, rows, valid))
            cases[f"K10 sweep {route} cohort width 8192"] = (
                "sharded_sweep_kernel",
                lambda csr=csr: sops.sweep(csr, csl, csu, 32_768, cap))
    from readserver_tpu_torch.kernels import KERNELS, LIBRARY

    out = {}
    # t_row, one dependent 64-byte read's unloaded time (rs_chase): from
    # L2 (warm) and from the card's memory (cold), in microseconds
    rng = np.random.default_rng(seed)
    for temp in ("warm", "cold"):
        t = smoke.chase_t_row(fused.fused_rows, rng, dev, temp == "cold")
        out[f"t_row {temp} us"] = None if t is None else t[0] * 1e3
    for name, (kernel, fn) in cases.items():
        before = sum(k.launches for k in KERNELS.values())
        fn()
        torch.cuda.synchronize()
        per_call = sum(k.launches for k in KERNELS.values()) - before
        # None where the profiler saw fewer launches than were made
        out[name] = kernel_device_ms(fn, 10, kernel, launches=10 * per_call)
    spills, regs, entry = [], {}, None
    for line in LIBRARY.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line and " 0 bytes spill stores" not in line:
            spills.append(f"{kernel_label(entry)}: {line.strip()}")
        elif "Used" in line and "registers" in line and any(
                k in entry for k in SWEEP_KERNELS):
            regs[kernel_label(entry)] = int(line.split("Used")[1].split()[0])
    out["ptxas spills"] = spills
    out["ptxas sweep registers"] = regs
    out["sass"] = sass_loops(
        LIBRARY.path, None if sass_dir is None else
        Path(sass_dir) / f"{Path(os.environ['PYTHONPATH']).name}.sass")
    return out


# the kernels of walk.cuh's sweep, whose registers and SASS loops are shown
SWEEP_KERNELS = ("resolve_walk_kernel", "exact_histogram_kernel",
                 "resolve_fused_kernel", "sharded_resolve_kernel",
                 "sharded_sweep_kernel")


def kernel_label(mangled: str | None) -> str:
    """``name<template args>`` of a mangled kernel name (ints as given,
    ``i``/``x`` for int32/int64 rows)."""
    m = re.search(r"\d+([a-z_]+_kernel)(I(?:Li-?\d+E|[a-z])+E)?",
                  mangled or "")
    if m is None:
        return str(mangled)
    args = re.findall(r"Li(-?\d+)E|([a-z])", m.group(2) or "")
    return m.group(1) + (f"<{','.join(a or b for a, b in args)}>"
                         if args else "")


def sass_loops(so: Path, dump: Path | None) -> dict:
    """The SASS of the sweep kernels in the built library ``so``
    (``cuobjdump -sass``), written to the file ``dump`` when given;
    → label → [instructions, [[start, instructions, global loads, depth]
    for each loop]].  A loop runs from a backward branch's target to the
    branch; depth counts the loops around it.  A step of a design with
    one loop and a state dispatch is that loop; of rank_tiles, its hot
    loop (the innermost one that holds the step's global loads)."""
    from readserver_tpu_torch.kernels import build as kbuild

    tool = Path(kbuild._nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        return {"error": res.stderr.strip()[-300:]}
    kept, out = [], {}
    for body in res.stdout.split("Function : ")[1:]:
        name = body.split()[0]
        if not any(k in name for k in SWEEP_KERNELS):
            continue
        kept.append("Function : " + body)
        ins = [(int(a, 16), op.strip()) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        # the divergent-vote blocks (BRA.DIV targets) sit after the body
        # and branch back into it: no loop ends there
        cut = min([int(t, 16) for t in re.findall(
            r"BRA\.DIV\s+\S+\s+0x([0-9a-f]+)", body)] or [1 << 40])
        loops = []
        for a, op in ins:
            t = re.search(r"\bBRA(?:\.\S+)?\s+(?:`\()?0x([0-9a-f]+)", op)
            if t and int(t.group(1), 16) <= a < cut and "BRA.DIV" not in op:
                loops.append((int(t.group(1), 16), a))
        rows = []
        for lo, hi in sorted(set(loops)):
            body_ops = [op for x, op in ins if lo <= x <= hi]
            depth = sum(1 for l2, h2 in set(loops)
                        if (l2, h2) != (lo, hi) and l2 <= lo and hi <= h2)
            rows.append([hex(lo), len(body_ops),
                         sum("LDG" in op for op in body_ops), depth])
        out[kernel_label(name)] = [len(ins), rows]
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text("".join(kept))
    return out


def crossover(scale: float, seed: int) -> dict:
    """The marks and slow walks' step in one round and in two, forced by
    ``rs_walk_one_round_max``, at 8 to 64 walks a warp of the persistent
    grid (132 SMs x 8 blocks x 4 warps on the H100): the E. coli full
    budget's walks (4096 10-mers on both strands), each warp's tiles
    holding N of them; and K7 through both walks at the cap-filling batch
    → device ms."""
    import dataclasses

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index
    from readserver_tpu_torch.index.budget import plan_tiers
    from readserver_tpu_torch.kernels import LIBRARY
    from readserver_tpu_torch.native import native_available
    from readserver_tpu_torch.ops import DeviceIndex, resolve
    from readserver_tpu_torch.serve import QueryEngine

    dev = torch.device("cuda:0")
    corpus = simulate.simulate_config("ecoli", scale=scale)
    packed = smoke.load_or_build(
        corpus, REPO / "data" / "chip_smoke" / f"ecoli_s{scale:g}",
        build_index, artifact, native_available)
    cfg = ServeConfig(batch_size=8192, warmup_query_lengths=(KMER,),
                      drop_tiers=("dsa",))
    eng = QueryEngine(packed, cfg, device=dev)
    H = cfg.max_hits
    ten = simulate.sample_query_kmers_fast(
        corpus, 4096, smoke.fill_k(eng.index.n, 2 * H), seed=seed + 4,
        miss_frac=0.0)
    ce, le, nq = eng._pad_encode(eng._expand_rc(smoke.decode_all(ten))[0])
    l, u = eng._search(*eng._to_device(ce, le), *eng._routes(ce, le, nq),
                       eng._new_bad())
    rows, valid, _ = resolve.expand_intervals(l, u, H)
    src = rows[valid]
    warps = torch.cuda.get_device_properties(dev).multi_processor_count * 32
    knob = LIBRARY.get().rs_walk_one_round_max
    default = knob(-1)
    forms = {"marks": (("dsa", "fused", "lf"), resolve.resolve_rows_marked),
             "slow": (("dsa", "fused", "marks", "lf"), resolve.resolve_rows)}
    out = {}
    for n in (8, 16, 24, 28, 32, 48, 64):
        tiles = -(-n // 32)
        R = warps * 32 * tiles
        v = torch.arange(R, device=dev) % 32 < n // tiles
        pick = (torch.cumsum(v, 0) - 1) % src.numel()
        r = torch.where(v, src[pick], torch.zeros_like(src[pick]))
        for kind, (drop, walk) in forms.items():
            idx = DeviceIndex.from_packed(
                packed, dev, tiers=plan_tiers(packed, None, drop).keep)
            for rounds, limit in (("one", 1 << 30), ("two", 0)):
                knob(limit)
                out[f"{kind} {n} walks a warp, {rounds} round"] = (
                    smoke.kernel_device_ms(lambda: walk(idx, r, v), 10,
                                           "resolve_walk_kernel",
                                           launches=10))
    # the served shape: width 8192's compacted rows (4096 31-mers on both
    # strands), whose walks of one query sit side by side and share rows,
    # at one-round limits around the crossover
    q4096 = simulate.sample_query_kmers_fast(
        corpus, 4096 + 256 + 1, KMER, seed=seed, miss_frac=0.15)[257:]
    ce, le, nq = eng._pad_encode(eng._expand_rc(smoke.decode_all(q4096))[0])
    rows, valid, _ = resolve.expand_intervals(
        *eng._search(*eng._to_device(ce, le), *eng._routes(ce, le, nq),
                     eng._new_bad()), H)
    main = resolve.compact_rows(rows, valid, eng.row_budget)[:2]
    for kind, (drop, walk) in forms.items():
        idx = DeviceIndex.from_packed(
            packed, dev, tiers=plan_tiers(packed, None, drop).keep)
        for limit in (16, 24, 32, 48):
            knob(limit)
            out[f"{kind} width 8192, limit {limit}"] = smoke.kernel_device_ms(
                lambda: walk(idx, *main), 10, "resolve_walk_kernel",
                launches=10)
    # K7 through the marks and slow walks at the cap-filling batch (8192
    # cohort 8-mers, 1,048,576 of 3,237,474 rows): the cohort's tables
    # nearly fit the L2, so sectors cost less than on E. coli
    cohort = simulate.simulate_config("cohort", scale=scale)
    cpacked = smoke.load_or_build(
        cohort, REPO / "data" / "chip_smoke" / f"cohort_s{scale:g}",
        build_index, artifact, native_available)
    ceng = QueryEngine(cpacked, dataclasses.replace(cfg, drop_tiers=()),
                       device=dev)
    eight = simulate.sample_query_kmers_fast(
        cohort, 8192, smoke.fill_k(ceng.index.n, 256), seed=seed + 5,
        miss_frac=0.0)
    ce, le, nq = ceng._pad_encode(smoke.decode_all(eight))
    kl, ku = ceng._search(*ceng._to_device(ce, le), *ceng._routes(ce, le, nq),
                          ceng._new_bad())
    for kind, tiers in (("marks", {"marks"}), ("slow", set())):
        cidx = DeviceIndex.from_packed(cpacked, dev, tiers=tiers)
        for rounds, limit in (("one", 1 << 30), ("two", 0)):
            knob(limit)
            out[f"K7 cap-filling {kind}, {rounds} round"] = (
                smoke.kernel_device_ms(
                    lambda x=cidx: resolve.exact_sample_histogram(
                        x, kl, ku, 8 * 8192, cfg.max_sweep_rows),
                    10, "exact_histogram_kernel", launches=10))
    knob(default)
    out["default one-round limit"] = default
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="*", help="other checkouts to time")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crossover", action="store_true",
                    help="also sweep this checkout's one/two-round "
                         "crossover of the marks and slow walks")
    ap.add_argument("--sass-dir", help="write each checkout's SASS of the "
                    "sweep kernels to DIR/<checkout name>.sass")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--sweep", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure or args.sweep:
        sys.path.insert(0, args.measure or args.sweep)
        got = (measure(args.scale, args.seed, args.sass_dir) if args.measure
               else crossover(args.scale, args.seed))
        print(json.dumps(got))
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
             str(args.scale), "--seed", str(args.seed),
             *(["--sass-dir", str(Path(args.sass_dir).resolve())]
               if args.sass_dir else [])],
            capture_output=True, text=True, env=env, cwd=c)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs[c].append(got)
        print(json.dumps({"checkout": c, "device_ms": {
            k: v for k, v in got.items() if k != "sass"}}), flush=True)
    for c in checkouts:
        for key in ("ptxas spills", "ptxas sweep registers", "sass"):
            print(f"# {key}, {Path(c).name}: "
                  f"{json.dumps(runs[c][0].pop(key, None))}")
            for r in runs[c][1:]:
                r.pop(key, None)
    names = list(dict.fromkeys(n for c in checkouts for r in runs[c]
                               for n in r))
    print(f"# device ms, median of {2} runs each ({card})")
    print("# shape | " + " | ".join(Path(c).name for c in checkouts))
    for n in names:
        cells = []
        for c in checkouts:
            vals = [r[n] for r in runs[c] if r.get(n) is not None]
            cells.append(f"{np.median(vals):.4f}" if vals else "not measured")
        print(f"# {n} | " + " | ".join(cells))
    if args.crossover:
        env = dict(os.environ, PYTHONPATH=str(REPO))
        res = subprocess.run(
            [sys.executable, __file__, "--sweep", str(REPO), "--scale",
             str(args.scale), "--seed", str(args.seed)],
            capture_output=True, text=True, env=env, cwd=str(REPO))
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"# crossover, device ms ({card}): {json.dumps(got)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
