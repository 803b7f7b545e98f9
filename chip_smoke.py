#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card, end to end.

    python3 chip_smoke.py              # E. coli 30x, 31-mers, one card
    python3 chip_smoke.py --scale 0.05 # a 5% genome, for a quick check

Phases, each printed with its seconds on a ``#`` line:

1. device: a CUDA card is required (no CPU path); its name and power limit;
2. kernels: build K1 (rank) and K2 (backward search) from
   ``readserver_tpu_torch/csrc`` with nvcc for sm_90a;
3. artifact: simulate and build the E. coli artifact with the port's
   builder (cached under ``data/``);
4. main path: with every kernel's launch count at 0, start a
   ``QueryEngine`` on the card (tier plan, ship, prefix LUT through K1,
   warmup) and send count requests (1, 256, and 4096 queries on both
   strands); both kernels must have launched;
5. oracle: the served counts of >= 256 queries against exact counts of all
   read windows (``oracle.naive.window_multiset_counts``);
6. kernel vs plain: each kernel against its plain torch form on the card,
   bit for bit, at the main path's shapes (the engine's prefix LUT against
   a plain-rank build, the engine's batches of width 256 and 8192) and at
   edge cases;
7. timing: searches/s and batch latency (p50, p90) at B=262,144 over 8
   distinct batches in turn, for the kernel and the plain path, and one
   batch repeated for the warm-L2 effect; K1 rows/s against the plain rank
   at the LUT's last level (outputs equal); and where a served
   both-strands request's time goes (host stages, device busy share from
   ``torch.profiler``).

The line before the last is the card's ``nvidia-smi`` name and power limit;
the one before it is the kernels' JSON summary.  The last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Imports torch and the port, never jax.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
B_TIME = 262_144        # timing batch (queries)
N_ROT = 8               # distinct timing batches, searched in turn
KMER = 31


class PhaseFailed(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    """Print a phase's start and its wall seconds, failed or not."""
    log(f"[{name}] start")
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        log(f"[{name}] FAILED ({type(e).__name__}) in "
            f"{time.perf_counter() - t0:.3f}s")
        raise
    log(f"[{name}] ok in {time.perf_counter() - t0:.3f}s")


def decode_all(mat: np.ndarray) -> list[str]:
    lut = np.frombuffer(b"$ACGT", dtype=np.uint8)
    return [row.tobytes().decode("ascii") for row in lut[mat]]


def time_cuda(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def latencies_ms(fn, iters: int) -> np.ndarray:
    """Host-clock milliseconds of ``iters`` calls, each ended by a sync."""
    import torch

    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(lat)


def kernel_device_ms(fn, iters: int, kernel: str) -> float | None:
    """Mean device milliseconds per call of the CUDA kernel named
    ``kernel`` over ``iters`` calls of ``fn`` (``torch.profiler``); None
    when the profiler saw none of its device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    return us / iters / 1e3 if us > 0 else None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def request_breakdown(engine, kms: list[str]) -> None:
    """Where one served both-strands request's time goes: host stages by
    wall clock, and the device's busy share from a profiler window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stages = {}
    t0 = time.perf_counter()
    exp, _ = engine._expand_rc(kms)
    stages["reverse complements"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes, lengths, nq = engine._pad_encode(exp)
    stages["pad + encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = engine._dispatch_single(codes, lengths, nq)
    torch.cuda.synchronize()
    stages["copy in + search"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out[:nq].cpu().numpy()
    stages["copy out"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.count_batch(kms, both_strands=True)
    whole = time.perf_counter() - t0
    stages["results (rest)"] = whole - sum(stages.values())
    log(f"request of {len(kms)} queries on both strands ({nq} searched): "
        f"{whole * 1e3:.3f} ms = " + ", ".join(
            f"{k} {v * 1e3:.3f}" for k, v in stages.items()))
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.count_batch(kms, both_strands=True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    log(f"profiler over {reps} such requests: device busy {busy_us:.1f} us "
        f"of {wall_us:.1f} us wall (idle share "
        f"{1 - busy_us / wall_us:.4f}); top device time: " + ", ".join(
            f"{e.key[:48]} {e.self_device_time_total:.1f} us x{e.count}"
            for e in top))


def run(args) -> dict:
    import torch

    # ---------------------------------------------------------- 1. device
    with phase("1 device"):
        check(torch.cuda.is_available(), "no CUDA device: this script "
              "runs on the card only")
        check((REPO / "readserver_tpu_torch" / "csrc").is_dir(),
              f"{REPO} is not a checkout of the repository")
        sys.path.insert(0, str(REPO))
        card = card_line()
        log(f"card: {card}")
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
            f"{torch.cuda.device_count()} visible")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    from readserver_tpu_torch.config import ServeConfig
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact, build_index
    from readserver_tpu_torch.kernels import KERNELS, LIBRARY
    from readserver_tpu_torch.native import native_available
    from readserver_tpu_torch.ops import encode_query_batch
    from readserver_tpu_torch.ops import lut as lut_ops
    from readserver_tpu_torch.ops import rank as rank_ops
    from readserver_tpu_torch.ops import search as search_ops
    from readserver_tpu_torch.oracle.naive import window_multiset_counts
    from readserver_tpu_torch.serve import QueryEngine

    # --------------------------------------------------------- 2. kernels
    with phase("2 kernels"):
        LIBRARY.get()
        built = (
            f"built in {LIBRARY.build_seconds:.3f}s (nvcc sm_90a)"
            if LIBRARY.build_seconds is not None
            else "already built for these sources"
        )
        log(f"library {LIBRARY.path.relative_to(REPO)} {built}")
        for line in LIBRARY.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")

    # -------------------------------------------------------- 3. artifact
    with phase("3 artifact"):
        cache = REPO / "data" / "chip_smoke" / f"ecoli_s{args.scale:g}"
        t0 = time.perf_counter()
        corpus = simulate.simulate_config("ecoli", scale=args.scale)
        log(f"simulated ecoli scale={args.scale:g}: {len(corpus.reads)} "
            f"reads in {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        if artifact.artifact_exists(cache):
            packed = artifact.load_artifact(cache, mmap=False)
            log(f"loaded cached artifact n={packed.n} in "
                f"{time.perf_counter() - t0:.3f}s")
        else:
            check(native_available(), "the native SA-IS (g++) did not build")
            packed = build_index(corpus.reads, sample_ids=corpus.sample_ids)
            log(f"built artifact n={packed.n} in "
                f"{time.perf_counter() - t0:.3f}s")
            t0 = time.perf_counter()
            artifact.save_artifact(packed, cache)
            log(f"saved to {cache.relative_to(REPO)} in "
                f"{time.perf_counter() - t0:.3f}s")
        check(packed.rank3_blocks is not None, "artifact has no triple tier")

    # ------------------------------------------------------ 4. main path
    rng = np.random.default_rng(args.seed)
    pool = simulate.sample_query_kmers_fast(
        corpus, 4096 + 256 + 1, KMER, seed=args.seed, miss_frac=0.15
    )
    q1, q256, q4096 = pool[:1], pool[1:257], pool[257:]
    with phase("4 main path"):
        for k in KERNELS.values():
            k.launches = 0
        cfg = ServeConfig(batch_size=8192, warmup_query_lengths=(KMER,))
        t0 = time.perf_counter()
        engine = QueryEngine(packed, cfg, device=dev)
        plan = engine.tier_plan
        log(f"engine up in {time.perf_counter() - t0:.3f}s: budget "
            f"{engine.budget_bytes} B ({engine.budget_bytes / 2**30:.2f} GiB, "
            f"0.92 of the card), tiers kept {sorted(plan.keep)}, dropped "
            f"{list(plan.dropped)}, {plan.total_bytes / 2**30:.3f} GiB "
            f"planned, {engine.index.device_bytes() / 2**30:.3f} GiB on card")
        log(f"ship {engine.startup_seconds['ship']:.3f}s, prefix LUT "
            f"p={engine.lut_p} ({engine.lut.nbytes} B) through K1 in "
            f"{engine.startup_seconds['lut']:.3f}s")
        t0 = time.perf_counter()
        engine.warmup()
        log(f"warmup (widths 256/8192, lengths {KMER}/32) in "
            f"{time.perf_counter() - t0:.3f}s")
        served = {}
        for name, qs, both in (("1", q1, False), ("256", q256, False),
                               ("4096x2", q4096, True)):
            kms = decode_all(qs)
            t0 = time.perf_counter()
            res = engine.count_batch(kms, both_strands=both)
            dt = time.perf_counter() - t0
            served[name] = np.array([r.count for r in res], dtype=np.int64)
            log(f"request of {name} queries: {dt * 1e3:.3f} ms, "
                f"{int((served[name] > 0).sum())} found")
        launches = {name: k.launches for name, k in KERNELS.items()}
        log(f"launches during the main path: {launches}")
        for name, n in launches.items():
            check(n > 0, f"kernel {name} was not launched on the main path")

    # ---------------------------------------------------------- 5. oracle
    with phase("5 oracle"):
        mat = np.stack(corpus.reads)
        rc = np.array([4, 3, 2, 1], dtype=np.uint8)
        rc_pool = rc[q4096[:256] - 1][:, ::-1]
        queries = np.concatenate([q1, q256, q4096[:256], rc_pool])
        t0 = time.perf_counter()
        want = window_multiset_counts(mat, queries)
        log(f"oracle counts for {len(queries)} windows in "
            f"{time.perf_counter() - t0:.3f}s")
        del mat
        pal = (rc_pool == q4096[:256]).all(axis=1)
        want_both = want[257:513] + np.where(pal, 0, want[513:])
        check(np.array_equal(served["1"], want[:1]), "1-query count parity")
        check(np.array_equal(served["256"], want[1:257]),
              "256-query count parity")
        check(np.array_equal(served["4096x2"][:256], want_both),
              "both-strands count parity")
        log(f"oracle parity: 513 queries exact "
            f"({int((want[:513] > 0).sum())} present)")

    # -------------------------------------------------- 6. kernel vs plain
    idx = engine.index
    lut, p = engine.lut, engine.lut_p
    summary = {}
    with phase("6 kernel vs plain"):
        lay = dict(rows_per_symbol=idx.rows_per_symbol,
                   log2_block=idx.log2_block,
                   words_per_block=idx.words_per_block)
        n, S = idx.n, idx.block_size
        k1_err = 0
        for tname, table, P in (("base", idx.rank_rows, 5),
                                ("rank2", idx.rank2_rows, 16),
                                ("rank3", idx.rank3_rows, 64)):
            nr = 1 << 20
            ii = rng.integers(0, n + 1, size=nr)
            blocks = rng.integers(0, n // S, size=4096)
            edges = np.concatenate([[0, n, n - 1, 1], blocks * S,
                                    blocks * S + S - 1])
            ii = np.concatenate([ii, edges]).astype(np.int32)
            cc = rng.integers(0, P, size=len(ii)).astype(np.int32)
            c_t = torch.from_numpy(cc).to(dev)
            i_t = torch.from_numpy(ii).to(dev)
            got = rank_ops.occ_rows_cuda(table, c_t, i_t, **lay)
            ref = rank_ops.occ_rows_plain(table, c_t, i_t, **lay)
            err = int((got.long() - ref.long()).abs().max())
            k1_err = max(k1_err, err)
            log(f"K1 {tname}: {len(ii)} ranks, max |err| {err}")
            check(err == 0, f"K1 disagrees with the plain rank on {tname}")
        # K1 at every shape the main path gave it: the engine's LUT (levels
        # of 8 * 4^l ranks through K1) against the same levels through the
        # plain rank on the card
        t0 = time.perf_counter()
        plain_lut = lut_ops.build_prefix_lut_plain(idx, p)
        torch.cuda.synchronize()
        err = int((plain_lut.long() - lut.long()).abs().max())
        k1_err = max(k1_err, err)
        log(f"K1 prefix LUT p={p}: engine's LUT ({lut.shape[0]} entries, "
            f"{p - 1} levels up to {8 * 4 ** (p - 1)} ranks) vs the plain-"
            f"rank build ({time.perf_counter() - t0:.3f}s): max |err| {err}")
        check(torch.equal(plain_lut, lut),
              "K1's prefix LUT disagrees with the plain-rank build")
        del plain_lut

        bq = simulate.sample_query_kmers_fast(
            corpus, B_TIME, KMER, seed=args.seed + 1, miss_frac=0.1
        ).astype(np.int32)
        codes = torch.from_numpy(bq).to(dev)
        full_len = torch.full((B_TIME,), KMER, dtype=torch.int32, device=dev)
        no3 = dataclasses.replace(idx, rank3_rows=None, C3=None)
        # mixed lengths 8..31: right-aligned suffixes of the same k-mers
        mlen = rng.integers(8, KMER + 1, size=B_TIME)
        mixed, mixed_len = encode_query_batch(
            [row[KMER - L:] for row, L in zip(bq.astype(np.uint8), mlen)], 32
        )
        mixed_t = torch.from_numpy(mixed).to(dev)
        mixed_len_t = torch.from_numpy(mixed_len).to(dev)
        lut_len = rng.integers(p, KMER + 1, size=B_TIME)
        mixed_lut, mixed_lut_len = encode_query_batch(
            [row[KMER - L:] for row, L in zip(bq.astype(np.uint8), lut_len)], 32
        )
        mixed_lut_t = torch.from_numpy(mixed_lut).to(dev)
        mixed_lut_len_t = torch.from_numpy(mixed_lut_len).to(dev)
        short = torch.from_numpy(bq[:1, KMER - 8:].copy()).to(dev)
        short_len = torch.full((1,), 8, dtype=torch.int32, device=dev)
        k2 = search_ops.backward_search_cuda
        cases = [
            ("LUT + triples", lambda: k2(idx, codes, lut=lut, p=p, kstep=True),
             lambda: search_ops.backward_search_pair_plain(idx, codes, lut, p)),
            ("LUT + pairs (no rank3)",
             lambda: k2(no3, codes, lut=lut, p=p, kstep=True),
             lambda: search_ops.backward_search_pair_plain(no3, codes, lut, p)),
            ("triples, no LUT", lambda: k2(idx, codes, kstep=True),
             lambda: search_ops.backward_search_pair_plain(idx, codes)),
            ("masked 1-step, lengths 8-31, no LUT",
             lambda: k2(idx, mixed_t, mixed_len_t),
             lambda: search_ops.backward_search_plain(idx, mixed_t,
                                                      mixed_len_t)),
            (f"masked 1-step + LUT, lengths {p}-31",
             lambda: k2(idx, mixed_lut_t, mixed_lut_len_t, lut=lut, p=p),
             lambda: search_ops.backward_search_lut_plain(
                 idx, lut, p, mixed_lut_t, mixed_lut_len_t)),
            ("masked 1-step, uniform 31, no LUT",
             lambda: k2(idx, codes, full_len),
             lambda: search_ops.backward_search_plain(idx, codes, full_len)),
            ("one query of length 8 < p, 1-step",
             lambda: k2(idx, short, short_len),
             lambda: search_ops.backward_search_plain(idx, short, short_len)),
            ("one query of length 8 < p, k-step",
             lambda: k2(idx, short, kstep=True),
             lambda: search_ops.backward_search_pair_plain(idx, short)),
        ]
        # K2 at the widths the engine serves: the main path's own batches,
        # padded and encoded by the engine and searched through its dispatch
        for kms, width in ((decode_all(q256), 256),
                           (engine._expand_rc(decode_all(q4096))[0], 8192)):
            ce, le, nq = engine._pad_encode(kms)
            check(ce.shape == (width, KMER) and int(le.min()) == KMER,
                  f"engine batch of {len(kms)} is not uniform [{width}, "
                  f"{KMER}]")
            cases.append((
                f"engine batch of width {width} ({nq} queries), LUT + triples",
                lambda ce=ce, le=le, nq=nq: engine._dispatch_single(
                    ce, le, nq)[:, :2].unbind(1),
                lambda ce=ce: search_ops.backward_search_pair_plain(
                    idx, torch.from_numpy(ce).to(dev), lut, p),
            ))
        k2_err = 0
        for name, kern, plain in cases:
            l1, u1 = kern()
            l2, u2 = plain()
            err = max(int((l1.long() - l2.long()).abs().max()),
                      int((u1.long() - u2.long()).abs().max()))
            k2_err = max(k2_err, err)
            found = int((u1 > l1).sum())
            log(f"K2 {name}: {l1.shape[0]} queries, {found} found, "
                f"max |err| {err}")
            check(err == 0, f"K2 disagrees with the plain search: {name}")
        summary["k1_err"], summary["k2_err"] = k1_err, k2_err

    # ---------------------------------------------------------- 7. timing
    with phase("7 timing"):
        log(f"card: {card}")
        # distinct batches in turn, as a bulk screen sends them: a batch
        # touches more rank and LUT sectors than the 50 MB L2 holds, and a
        # repeated batch finds part of them there (measured beside it)
        rot = [torch.from_numpy(b).to(dev) for b in np.split(
            simulate.sample_query_kmers_fast(
                corpus, N_ROT * B_TIME, KMER, seed=args.seed + 2,
                miss_frac=0.1).astype(np.int32), N_ROT)]
        turn = itertools.cycle(rot)
        search_k = lambda: search_ops.backward_search_cuda(  # noqa: E731
            idx, next(turn), lut=lut, p=p, kstep=True)
        search_p = lambda: search_ops.backward_search_pair_plain(  # noqa: E731
            idx, next(turn), lut, p)
        search_rep = lambda: search_ops.backward_search_cuda(  # noqa: E731
            idx, codes, lut=lut, p=p, kstep=True)
        search_k(), search_p(), search_rep()
        torch.cuda.synchronize()
        ms_k, ms_p, ms_rep = [], [], []
        for _ in range(5):  # interleaved: kernel, plain, repeated batch
            ms_k.append(time_cuda(search_k, 2 * N_ROT))
            ms_p.append(time_cuda(search_p, N_ROT))
            ms_rep.append(time_cuda(search_rep, 2 * N_ROT))
        lat_k = latencies_ms(search_k, 100)
        lat_p = latencies_ms(search_p, 24)
        dev_ms = kernel_device_ms(search_k, N_ROT, "backward_search_kernel")
        t_k, t_p, t_rep = (float(np.median(x)) for x in (ms_k, ms_p, ms_rep))
        log(f"K2 search B={B_TIME} LUT p={p} + triples over {N_ROT} distinct "
            f"batches in turn: kernel {t_k:.4f} ms/batch = "
            f"{B_TIME / t_k * 1e3:.0f} searches/s (median of 5 x "
            f"{2 * N_ROT} batches, wrapper with its input-guard wait), "
            f"kernel device time {fmt_ms(dev_ms)} ms/batch (profiler), batch "
            f"latency p50 {np.median(lat_k):.4f} ms p90 "
            f"{np.percentile(lat_k, 90):.4f} ms (n=100) | plain torch "
            f"{t_p:.4f} ms/batch = {B_TIME / t_p * 1e3:.0f} searches/s "
            f"(median of 5 x {N_ROT}), p50 {np.median(lat_p):.4f} ms (n=24) "
            f"| {card}")
        log(f"K2 one batch repeated (warm L2): {t_rep:.4f} ms/batch = "
            f"{B_TIME / t_rep * 1e3:.0f} searches/s, {t_k / t_rep:.4f}x "
            f"faster than distinct batches | {card}")
        # K1 at the last LUT level's shape: 2 ranks x 4 chars x 4^(p-1)
        nr = 8 * 4 ** (p - 1)
        cc = torch.from_numpy(
            rng.integers(1, 5, size=nr).astype(np.int32)).to(dev)
        ii = torch.from_numpy(
            rng.integers(0, idx.n + 1, size=nr).astype(np.int32)).to(dev)
        lay = dict(rows_per_symbol=idx.rows_per_symbol,
                   log2_block=idx.log2_block,
                   words_per_block=idx.words_per_block)
        rank_k = lambda: rank_ops.occ_rows_cuda(  # noqa: E731
            idx.rank_rows, cc, ii, **lay)
        rank_p = lambda: rank_ops.occ_rows_plain(  # noqa: E731
            idx.rank_rows, cc, ii, **lay)
        check(torch.equal(rank_k(), rank_p()),
              f"K1 disagrees with the plain rank at B={nr}")
        r_k, r_p = [], []
        for _ in range(3):
            r_k.append(time_cuda(rank_k, 10))
            r_p.append(time_cuda(rank_p, 3))
        r_t_k, r_t_p = float(np.median(r_k)), float(np.median(r_p))
        log(f"K1 rank B={nr} over the base table: kernel "
            f"{nr / r_t_k * 1e3:.0f} rows/s ({r_t_k:.4f} ms) | plain torch "
            f"{nr / r_t_p * 1e3:.0f} rows/s ({r_t_p:.4f} ms), outputs equal "
            f"| {card}")
        request_breakdown(engine, decode_all(q4096))
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
            f" GiB")
        summary.update(k1_ms=r_t_k, k1_plain_ms=r_t_p, k2_ms=t_k,
                       k2_plain_ms=t_p)

    kernels = [
        dict(name="rank_occ", route="cuda",
             source="readserver_tpu_torch/csrc/rank.cu",
             replaces="readserver_tpu/kernels/pallas_rank.py:144",
             launches=launches["rank_occ"], max_abs_err=summary["k1_err"],
             ms=summary["k1_ms"], plain_ms=summary["k1_plain_ms"]),
        dict(name="backward_search", route="cuda",
             source="readserver_tpu_torch/csrc/search.cu",
             replaces="readserver_tpu/ops/search.py:220",
             launches=launches["backward_search"],
             max_abs_err=summary["k2_err"],
             ms=summary["k2_ms"], plain_ms=summary["k2_plain_ms"]),
    ]
    return dict(kernels=kernels, card=card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="E. coli genome fraction (1.0 = 4.6 Mbp, 30x)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()
    try:
        out = run(args)
    except PhaseFailed as e:
        log(f"FAIL: {e}")
        return 1
    log(f"all phases passed in {time.perf_counter() - t0:.3f}s")
    import torch

    print(json.dumps({"kernels": out["kernels"]}))
    print(out["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
