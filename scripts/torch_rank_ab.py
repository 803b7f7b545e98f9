#!/usr/bin/env python3
"""K1's generic entry (``rs_rank_occ``) and K9's generic entry
(``rs_shard_occ``) of several checkouts of the port, timed in turn on one
card, beside the card's own random-read and streaming rates.

    python3 scripts/torch_rank_ab.py [--quick] [OTHER_CHECKOUT ...]

For this checkout and each named one (a directory holding another commit's
``readserver_tpu_torch``, e.g. unpacked by ``git archive``):

1. once, in a process of this checkout: E. coli (``chip_smoke.py``'s
   artifact cache under ``data/``, built here when missing), its base rank
   table, the p = 12 LUT build's last level's ranks and the mark walk's
   first step's ranks (a marks engine's compacted rows, as phase 7 makes
   them) saved under ``data/rank_ab/``; then the probe
   (``scripts/rank_ab_probe.cu``, built into ``build/rank_ab/``) on that
   table: independent random reads of 16 and 32 bytes, 1 to 8 in flight
   a thread, at K1's and K9's counts, 16-byte reads confined to the
   table's first 4 to 48 MiB (the rate of reads that hit L2, and the span
   all SMs can share there), and the table streamed (read, and read and
   written);
2. each checkout in its own process (both packages are named
   ``readserver_tpu_torch``), in the order A B ... then back again, and
   the card's clocks (``nvidia-smi``) before and after each:
   K1 on the table at random ranks (33,554,432 of two draws; 16,777,216
   down to 1,048,576, either side of the bucketed design's switch;
   314,572, repeated and over distinct sets in turn), the mark walk's
   step and the LUT level's 33,554,432 ranks; K9 over E. coli's 4
   interval shards at 524,288 random ranks, 8 sets in turn, and equal to
   its plain form on every table (where the checkout has interval
   shards).  Each reading: wrapper ms (CUDA events, median of 3 passes),
   device ms by kernel (profiler: only the entry's events inside a marked
   range, and only when it saw one launch of its first kernel a call),
   the profiler's reading as ``chip_smoke.py`` took it before it counted
   launches (``key_averages`` of one unmarked pass) with the launches it
   saw, the bytes bound, and max |err| against the checkout's
   plain form, which must be 0.

``--quick``: random tables in E. coli's shape in place of the artifact
(K1's table, and K9's four shards with their prefix made from it), sorted
ranks in the LUT level's layout, no probe, no mark walk; 1M-4M ranks
left out.

Prints one JSON line per process and a table of medians, and each
bucketed reading by kernel.  Imports torch, never jax.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "data" / "rank_ab"
PROBE_SRC = REPO / "scripts" / "rank_ab_probe.cu"
PROBE_SO = REPO / "build" / "rank_ab" / "librank_ab_probe.so"
P_LUT = 12
RANDOM = (33_554_432, 16_777_216, 8_388_608, 4_194_304, 2_097_152,
          1_048_576)
MARK_STEP = 314_572  # the mark walk's first step on E. coli (chip_smoke.py)
KMER = 31
K9_RANKS = 524_288
K9_SHARDS = 4


def helpers():
    """This checkout's ``chip_smoke.py`` helpers, loaded by path: the
    package itself comes from the checkout first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_ms(fn, iters: int, kernel: str) -> dict:
    """The kernel's device ms a call of ``fn`` two ways: ``counted``, only
    its events inside a marked range after ``iters`` untimed calls, None
    unless the profiler saw ``iters`` launches there (chip_smoke.py's
    ``kernel_device_ms``); ``uncounted``, ``key_averages`` of one unmarked
    pass of ``iters`` calls over ``iters`` whatever it saw (how
    ``chip_smoke.py`` read it before it counted launches), with ``seen``
    the launches it saw."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    out = {"uncounted": sum(e.self_device_time_total for e in mine)
           / iters / 1e3,
           "seen": sum(e.count for e in mine), "counted": None}
    for _ in range(5):  # the profiler now and then records no device event
        with profile(activities=acts) as prof:
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
        got = [e for e in ev if e.device_type == DeviceType.CUDA
               and kernel in e.name
               and span.start <= e.time_range.start <= span.end]
        # one kernel name a launch, or several where the entry launches a
        # fixed sequence of kernels: the count of the first
        first = min((e for e in got), key=lambda e: e.time_range.start,
                    default=None)
        n = sum(1 for e in got if first is not None and e.name == first.name)
        if got and n == iters:
            out["counted"] = sum(e.self_device_time_total for e in got) \
                / iters / 1e3
            by = {}
            for e in got:
                k = re.search(r"(\w+)(?:<[^>]*>)?\(", e.name).group(1)
                by[k] = by.get(k, 0.0) + e.self_device_time_total / iters / 1e3
            out["kernels"] = {k: round(v, 5) for k, v in sorted(by.items())}
            break
    return out


# ------------------------------------------------------------- preparation


def build_probe() -> ctypes.CDLL:
    PROBE_SO.parent.mkdir(parents=True, exist_ok=True)
    if not PROBE_SO.exists():
        nvcc = os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin/nvcc"
        subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             str(PROBE_SRC), "-o", str(PROBE_SO)], check=True)
    lib = ctypes.CDLL(str(PROBE_SO))
    P, L, I, U = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_ulonglong)
    lib.rs_probe_random.argtypes = [P, L, I, I, L, U, P, P]
    lib.rs_probe_stream.argtypes = [P, L, P, P, I, P]
    return lib


def probe(table, smoke) -> dict:
    """The random-read and streaming rates over ``table``'s bytes."""
    import torch

    lib = build_probe()
    st = torch.cuda.current_stream().cuda_stream
    nbytes = table.numel() * 4
    out = {}
    sink = torch.empty(K9_RANKS * 64 + RANDOM[0], dtype=torch.int32,
                       device=table.device)
    for width in (16, 32):
        units = nbytes // width
        for per in (1, 2, 4, 8):
            for reads in (RANDOM[0], K9_RANKS, MARK_STEP):
                seeds = iter(range(1, 1 << 30))

                def fn():
                    rc = lib.rs_probe_random(table.data_ptr(), units, width,
                                             per, reads, next(seeds),
                                             sink.data_ptr(), st)
                    smoke.check(rc == 0, f"rs_probe_random: CUDA error {rc}")

                fn()
                torch.cuda.synchronize()
                iters = 10 if reads == RANDOM[0] else 50
                ms = float(np.median([smoke.time_cuda(fn, iters)
                                      for _ in range(3)]))
                dev = device_ms(fn, iters, "probe_random_kernel")["counted"]
                key = f"random {width} B x {reads}, {per} a thread"
                out[key] = dict(ms=ms, device_ms=dev,
                                reads_per_s=None if not dev else
                                reads / dev * 1e3)
                print(f"# probe {key}: events {ms:.4f} ms, device "
                      f"{smoke.fmt_ms(dev)} ms = "
                      + ("not measured" if not dev else
                         f"{reads / dev / 1e6:.3f} G reads/s, "
                         f"{reads * 32 / dev / 1e9:.3f} TB/s of sectors"),
                      flush=True)
    # random reads confined to the table's first few MiB: the rate of
    # reads that hit L2, and the span all SMs can share in it
    for mib in (4, 8, 16, 24, 32, 48):
        units = (mib << 20) // 16
        seeds = iter(range(1, 1 << 30))

        def fn():
            rc = lib.rs_probe_random(table.data_ptr(), units, 16, 4,
                                     RANDOM[0], next(seeds), sink.data_ptr(),
                                     st)
            smoke.check(rc == 0, f"rs_probe_random: CUDA error {rc}")

        fn()
        torch.cuda.synchronize()
        ms = float(np.median([smoke.time_cuda(fn, 10) for _ in range(3)]))
        dev = device_ms(fn, 10, "probe_random_kernel")["counted"]
        key = f"random 16 B x {RANDOM[0]} within {mib} MiB, 4 a thread"
        out[key] = dict(ms=ms, device_ms=dev, reads_per_s=None if not dev
                        else RANDOM[0] / dev * 1e3)
        print(f"# probe {key}: events {ms:.4f} ms, device "
              f"{smoke.fmt_ms(dev)} ms = "
              + ("not measured" if not dev else
                 f"{RANDOM[0] / dev / 1e6:.3f} G reads/s"), flush=True)
    copy = torch.empty_like(table)
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    for what, dst, moved in (("stream read", None, nbytes),
                             ("stream read + write", copy, 2 * nbytes)):
        def fn():
            rc = lib.rs_probe_stream(table.data_ptr(), nbytes // 16,
                                     None if dst is None else dst.data_ptr(),
                                     sink.data_ptr(), blocks, st)
            smoke.check(rc == 0, f"rs_probe_stream: CUDA error {rc}")

        fn()
        torch.cuda.synchronize()
        ms = float(np.median([smoke.time_cuda(fn, 20) for _ in range(3)]))
        dev = device_ms(fn, 20, "probe_stream_kernel")["counted"]
        out[what] = dict(ms=ms, device_ms=dev, bytes=moved,
                         tb_per_s=None if not dev else moved / dev / 1e9)
        print(f"# probe {what} of {nbytes} B: events {ms:.4f} ms, device "
              f"{smoke.fmt_ms(dev)} ms = "
              + ("not measured" if not dev else
                 f"{moved / dev / 1e9:.3f} TB/s"), flush=True)
    return out


ECOLI = dict(rows_per_symbol=2_177_814, log2_block=6, words_per_block=2,
             n=139_380_000)  # E. coli 30x's base table


def prepare_quick(seed: int) -> dict:
    """A table of random words in E. coli's shape, and sorted ranks in the
    LUT level's layout (four planes twice, each section's positions
    sorted), under ``data/rank_ab/``; no probe (the full run's is on the
    real table)."""
    rng = np.random.default_rng(seed)
    rows = 5 * ECOLI["rows_per_symbol"]
    t = rng.integers(0, 1 << 32, size=(rows, 4), dtype=np.uint32)
    t[:, 0] >>= 2  # checkpoints below 2^30
    DATA.mkdir(parents=True, exist_ok=True)
    np.save(DATA / "rank_rows.npy", t.view(np.int32))
    per = 4 ** (P_LUT - 1)
    np.save(DATA / "level_c.npy", np.tile(np.repeat(
        np.arange(1, 5, dtype=np.int32), per), 2))
    np.save(DATA / "level_i.npy", np.concatenate([
        np.sort(rng.integers(0, ECOLI["n"] + 1, size=per)).astype(np.int32)
        for _ in range(8)]))
    (DATA / "mark_c.npy").unlink(missing_ok=True)
    (DATA / "layout.json").write_text(json.dumps(ECOLI))
    return {"layout": ECOLI}


def prepare(scale: float) -> dict:
    """The E. coli table and the LUT level's ranks under ``data/rank_ab/``,
    then the probe on the table."""
    import torch

    smoke = helpers()
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index
    from readserver_tpu_torch.native import native_available
    from readserver_tpu_torch.ops import DeviceIndex
    from readserver_tpu_torch.ops import lut as lut_ops

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    corpus = simulate.simulate_config("ecoli", scale=scale)
    packed = smoke.load_or_build(
        corpus, REPO / "data" / "chip_smoke" / f"ecoli_s{scale:g}",
        build_index, artifact, native_available)
    idx = DeviceIndex.from_packed(packed, dev)
    DATA.mkdir(parents=True, exist_ok=True)
    np.save(DATA / "rank_rows.npy", idx.rank_rows.cpu().numpy())
    lvl = [(idx.C[1:5], idx.C[2:6])]
    for _ in range(P_LUT - 2):
        lvl.append(lut_ops.extend_level(idx, *lvl[-1]))
    l_last, u_last = lvl[-1]
    cc = torch.arange(1, 5, dtype=torch.int32, device=dev)
    cc = cc.repeat_interleave(l_last.numel())
    np.save(DATA / "level_c.npy", torch.cat([cc, cc]).cpu().numpy())
    np.save(DATA / "level_i.npy",
            torch.cat([l_last.repeat(4), u_last.repeat(4)]).cpu().numpy())
    lay = dict(rows_per_symbol=idx.rows_per_symbol,
               log2_block=idx.log2_block,
               words_per_block=idx.words_per_block, n=idx.n)
    (DATA / "layout.json").write_text(json.dumps(lay))
    mark_step(smoke, corpus, packed, dev)
    return {"layout": lay, "probe": probe(idx.rank_rows, smoke)}


def mark_step(smoke, corpus, packed, dev) -> None:
    """The ranks of the mark walk's first step as chip_smoke.py makes them
    (phase 7): a marks engine's compacted rows of 4096 31-mers on both
    strands (the query pool of seed 0), invalid slots at 0, and the BWT
    symbol at each, saved under ``data/rank_ab/``."""
    import dataclasses

    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.ops import rank as rank_ops
    from readserver_tpu_torch.ops import resolve
    from readserver_tpu_torch.serve import QueryEngine

    cfg = ServeConfig(batch_size=8192, warmup_query_lengths=(KMER,))
    eng = QueryEngine(packed, dataclasses.replace(
        cfg, drop_tiers=("dsa", "fused", "lf")), device=dev)
    pool = simulate.sample_query_kmers_fast(corpus, 4096 + 256 + 1, KMER,
                                            seed=0, miss_frac=0.15)
    kms = eng._expand_rc(smoke.decode_all(pool[257:]))[0]
    ml, mu = smoke.engine_intervals(eng, kms)
    rows, valid, _ = resolve.expand_intervals(ml, mu, cfg.max_hits)
    mrows, mvalid, _, _ = resolve.compact_rows(rows, valid, eng.row_budget)
    m_i = torch_where_zero(mvalid, mrows)
    m_c = rank_ops.read_symbol(eng.index, m_i)
    np.save(DATA / "mark_c.npy", m_c.cpu().numpy())
    np.save(DATA / "mark_i.npy", m_i.cpu().numpy())
    print(f"# the mark walk's first step: {m_i.numel()} ranks, "
          f"{int(mvalid.sum())} valid", flush=True)


def torch_where_zero(keep, x):
    import torch

    return torch.where(keep, x, torch.zeros_like(x))


# ---------------------------------------------------------------- readings


def k1_readings(smoke, seed: int, quick: bool) -> dict:
    import torch
    from readserver_tpu_torch.ops import rank as rank_ops

    dev = torch.device("cuda:0")
    lay = json.loads((DATA / "layout.json").read_text())
    n = lay.pop("n")
    table = torch.from_numpy(np.load(DATA / "rank_rows.npy")).to(dev)
    rng = np.random.default_rng(seed)

    def draw(B):
        return (torch.from_numpy(rng.integers(1, 5, size=B).astype(np.int32))
                .to(dev), torch.from_numpy(rng.integers(0, n + 1, size=B)
                                           .astype(np.int32)).to(dev))

    cases = [(f"random {RANDOM[0]}, draw 1", [draw(RANDOM[0])]),
             (f"random {RANDOM[0]}, draw 2", [draw(RANDOM[0])])]
    cases += [(f"random {B}", [draw(B)]) for B in RANDOM[1:]
              if not quick or B > RANDOM[-3]]
    cases.append((f"random {MARK_STEP}, repeated", [draw(MARK_STEP)]))
    n_sets = smoke.sets_past_l2(MARK_STEP * 12 + MARK_STEP * 16)
    cases.append((f"random {MARK_STEP}, {n_sets} sets in turn",
                  [draw(MARK_STEP) for _ in range(n_sets)]))
    if (DATA / "mark_c.npy").exists():
        cases.append((f"the mark walk's first step ({MARK_STEP})", [(
            torch.from_numpy(np.load(DATA / "mark_c.npy")).to(dev),
            torch.from_numpy(np.load(DATA / "mark_i.npy")).to(dev))]))
    cases.append((f"LUT level {P_LUT - 1} -> {P_LUT} ranks",
                  [(torch.from_numpy(np.load(DATA / "level_c.npy")).to(dev),
                    torch.from_numpy(np.load(DATA / "level_i.npy")).to(dev))]))
    out = {}
    for name, sets in cases:
        err = 0
        for c, i in sets:
            got = rank_ops.occ_rows_cuda(table, c, i, **lay)
            want = rank_ops.occ_rows_plain(table, c, i, **lay)
            err = max(err, int((got.long() - want.long()).abs().max()))
        smoke.check(err == 0, f"K1 disagrees with its plain form at {name}")
        turn = iter(sets * 100_000)
        call = lambda: rank_ops.occ_rows_cuda(table, *next(turn), **lay)  # noqa: E731,B023
        call()
        torch.cuda.synchronize()
        B = sets[0][0].numel()
        iters = max(len(sets), 10 if B >= RANDOM[-1] else 50)
        ms = float(np.median([smoke.time_cuda(call, iters)
                              for _ in range(3)]))
        d = device_ms(call, iters, "rank_occ")
        nb = int(np.mean([smoke.k1_bytes(table, c, i, lay) for c, i in sets]))
        out[name] = dict(ms=ms, device_ms=d["counted"],
                         uncounted_ms=d["uncounted"], seen=d["seen"],
                         iters=iters, kernels=d.get("kernels"),
                         bound_ms=smoke.bound_ms(nb), bytes=nb, err=err)
        print(f"# K1 {name}: wrapper {ms:.4f} ms, device "
              f"{smoke.fmt_ms(d['counted'])} ms ({d.get('kernels')}), "
              f"uncounted {d['uncounted']:.4f} ms ({d['seen']} of {iters} "
              f"launches seen), bound {smoke.bound_ms(nb):.4f} ms, "
              f"|err| {err}", flush=True)
    return out


def quick_shards(dev, seed: int):
    """E. coli's 4 interval shards in shape only: the small corpus placed
    in 4 shards, its base table, ranges, prefix and n replaced by random
    rows and E. coli's even layout (the other tiers dropped)."""
    import dataclasses

    import torch
    from readserver_tpu_torch import parallel
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import build_index
    from readserver_tpu_torch.ops import rank as rank_ops

    small = simulate.simulate_config("small")
    s = parallel.place_sharded(
        parallel.build_sharded(build_index(small.reads,
                                           sample_ids=small.sample_ids),
                               K9_SHARDS),
        parallel.make_mesh(num_shards=K9_SHARDS, device=dev))
    n, bs = ECOLI["n"], 1 << ECOLI["log2_block"]
    size = -(-n // K9_SHARDS)
    size = -(-size // bs) * bs
    starts = np.minimum(np.arange(K9_SHARDS) * size, n)
    lens = np.minimum(starts + size, n) - starts
    rps = size // bs + 1
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, size=(K9_SHARDS, 5 * rps, 4),
                        dtype=np.uint32)
    rows[:, :, 0] >>= 2
    rows[:, ::rps, 0] = 0  # occ(c, 0) = 0 in every shard's plane
    table = torch.from_numpy(rows.view(np.int32)).to(dev)
    # the prefix over shards of each shard's totals, as the owner form
    # needs (rank(c, i) = prefix[s][c] + occ_s(c, i - start_s))
    prefix = np.zeros((K9_SHARDS + 1, 5), dtype=np.int64)
    planes = torch.arange(5, dtype=torch.int32, device=dev)
    for k in range(K9_SHARDS):
        end = torch.full((5,), int(lens[k]), dtype=torch.int32, device=dev)
        prefix[k + 1] = prefix[k] + rank_ops.occ_rows_plain(
            table[k], planes, end, rows_per_symbol=rps,
            log2_block=ECOLI["log2_block"],
            words_per_block=ECOLI["words_per_block"]).cpu().numpy()

    def t64(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(
            dev)

    return dataclasses.replace(
        s, rank_rows=table, starts=t64(starts), lens=t64(lens),
        sym_prefix=t64(prefix), n=n,
        rows_per_symbol=rps, block_size=bs,
        words_per_block=ECOLI["words_per_block"], rank2_rows=None, C2=None,
        prefix2=None, rank3_rows=None, C3=None, prefix3=None,
        mark_table=None, mark_prefix=None, lf_chunk=None, spairs_chunk=None,
        sstarts=None, slens=None, dsa_chunk=None, dsa_bits=0, sample_rate=0)


def k9_readings(smoke, scale: float, seed: int, quick: bool) -> dict:
    import torch
    from readserver_tpu_torch import parallel
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index
    from readserver_tpu_torch.native import native_available
    from readserver_tpu_torch.ops import sharded as sops

    dev = torch.device("cuda:0")
    if quick:
        s = quick_shards(dev, seed)
    else:
        corpus = simulate.simulate_config("ecoli", scale=scale)
        packed = smoke.load_or_build(
            corpus, REPO / "data" / "chip_smoke" / f"ecoli_s{scale:g}",
            build_index, artifact, native_available)
        s = parallel.place_sharded(
            parallel.build_sharded(packed, K9_SHARDS),
            parallel.make_mesh(num_shards=K9_SHARDS, device=dev))
        del packed
    rng = np.random.default_rng(seed + 11)
    X = K9_RANKS

    def ranks(_):
        return (torch.from_numpy(rng.integers(0, 5, size=X).astype(np.int32))
                .to(dev), torch.from_numpy(rng.integers(0, s.n + 1, size=X))
                .to(dev))

    sets, nb, _ = smoke.in_turn(ranks, lambda c, i: (X * 20 + smoke.row_bytes(
        s, smoke.owner_rows(s, 5, s.rows_per_symbol, c, i)), None))
    out = {}
    for table, planes in (("rank", 5), ("rank2", 16), ("rank3", 64),
                          ("marks", 1)):
        if sops._table(s, table)[0] is None:
            continue
        err = 0
        for c, i in sets:
            c = c % planes
            err = max(err, int((sops.occ(s, table, c, i)
                                - sops.occ_plain(s, table, c, i)).abs().max()))
        smoke.check(err == 0, f"K9 disagrees with its plain form on {table}")
        if table != "rank":
            out[f"K9 {table} |err|"] = err
            continue
        turn = iter(sets * 100_000)
        call = lambda: sops.occ(s, "rank", *next(turn))  # noqa: E731
        call()
        torch.cuda.synchronize()
        ms = float(np.median([smoke.time_cuda(call, len(sets))
                              for _ in range(3)]))
        d = device_ms(call, len(sets), "shard_occ")
        name = f"K9 {X} random ranks, {K9_SHARDS} shards, {len(sets)} sets"
        out[name] = dict(ms=ms, device_ms=d["counted"],
                         uncounted_ms=d["uncounted"], seen=d["seen"],
                         iters=len(sets), kernels=d.get("kernels"),
                         bound_ms=smoke.bound_ms(nb), bytes=nb, err=err)
        print(f"# {name}: wrapper {ms:.4f} ms, device "
              f"{smoke.fmt_ms(d['counted'])} ms, bound "
              f"{smoke.bound_ms(nb):.4f} ms, |err| {err}", flush=True)
    return out


def measure(scale: float, seed: int, quick: bool) -> dict:
    """This process's package (first on sys.path): every reading."""
    import torch

    from readserver_tpu_torch.kernels import LIBRARY

    smoke = helpers()
    torch.cuda.set_device(0)
    out = {"clocks_before": clocks()}
    out.update(k1_readings(smoke, seed, quick))
    if importlib.util.find_spec("readserver_tpu_torch.parallel") is not None:
        out.update(k9_readings(smoke, scale, seed, quick))
    out["clocks_after"] = clocks()
    # ptxas's lines for the two entries' kernels, where this process built
    # the library
    log = LIBRARY.build_log.splitlines() if hasattr(LIBRARY, "build_log") \
        else []
    for k, ln in enumerate(log):
        if "Compiling entry function" in ln and ("rank_occ" in ln
                                                 or "shard_occ" in ln):
            for x in log[k:k + 4]:
                if "registers" in x or "spill" in x or "entry" in x:
                    print(f"# ptxas: {x.strip()[:160]}", flush=True)
    return out


def table(runs: dict, card: str) -> None:
    """The medians of each checkout's runs, a reading a line."""
    checkouts = list(runs)
    names = list(dict.fromkeys(n for c in checkouts for r in runs[c]
                               for n in r if isinstance(r[n], dict)))
    print(f"# median of each checkout's runs ({card}): device ms (wrapper "
          f"ms) [bound ms]")
    print("# reading | " + " | ".join(Path(c).name for c in checkouts))
    for n in names:
        cells = []
        for c in checkouts:
            rs = [r[n] for r in runs[c] if n in r]
            dv = [r["device_ms"] for r in rs if r["device_ms"]]
            cells.append("not measured" if not rs else
                         (f"{np.median(dv):.4f}" if dv else "not measured")
                         + f" ({np.median([r['ms'] for r in rs]):.4f}) "
                         f"[{rs[0]['bound_ms']:.4f}]")
        print(f"# {n} | " + " | ".join(cells))
    for c in checkouts:
        for n in names:
            ks = [r[n].get("kernels") for r in runs[c] if n in r]
            ks = [k for k in ks if isinstance(k, dict) and len(k) > 1]
            if ks:
                print(f"# {Path(c).name}, {n}, by kernel: "
                      + ", ".join(f"{k} {np.median([x.get(k, 0) for x in ks]):.4f}"
                                  for k in ks[0]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="*", help="other checkouts to time")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="random tables in E. coli's shape (no artifact to "
                    "build)")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--prepare", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.prepare:
        print(json.dumps(prepare_quick(args.seed) if args.quick
                         else prepare(args.scale)))
        return 0
    if args.measure:
        sys.path.insert(0, args.measure)
        print(json.dumps(measure(args.scale, args.seed, args.quick)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"# {card}", flush=True)
    checkouts = [str(REPO)] + [str(Path(o).resolve()) for o in args.others]
    runs: dict[str, list[dict]] = {c: [] for c in checkouts}
    jobs = [("prepare", str(REPO))] + [
        ("measure", c) for c in checkouts + checkouts[::-1]]
    for kind, c in jobs:
        env = dict(os.environ, PYTHONPATH=c)
        argv = [sys.executable, __file__, "--scale", str(args.scale),
                "--seed", str(args.seed)] + ["--quick"] * args.quick
        argv += ["--prepare"] if kind == "prepare" else ["--measure", c]
        res = subprocess.run(argv, capture_output=True, text=True, env=env,
                             cwd=c)
        sys.stdout.write("".join(
            f"# {Path(c).name}: {ln}\n" for ln in res.stdout.splitlines()
            if ln.startswith("#")))
        if res.returncode != 0:
            print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": c, "kind": kind, **got}), flush=True)
        if kind == "measure":
            runs[c].append(got)
    table(runs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
