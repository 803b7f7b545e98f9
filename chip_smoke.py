#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card, end to end.

    python3 chip_smoke.py              # E. coli 30x + the 128-sample cohort
    python3 chip_smoke.py --scale 0.05 # 5% of each, for a quick check

Phases, each printed with its seconds on a ``#`` line, run in the order
1-5, 8, 9, 9b, 10, 11, 12, 13, 14, 15, 6, 7, 11b, 13b (every main path is
driven before the kernel-vs-plain and timing phases, so each path's launch
counts are its own; no plain pack, K8's or the merge's torch ops, may run
on the card in phases 4 to 15):

1. device: a CUDA card is required (no CPU path); its name and power limit;
2. kernels: build K1 (rank and its LUT level entry), K2 (backward search),
   K5 (dsa resolve), K6 (fused-row walk), the rank walks (marks, lf, slow),
   K7 (exact histogram), the interval-sharded kernels (K9 rank, the
   sharded search, K11 LUT level, K10 lookups, walks and sweep), one
   rank's partials (K9's partial, K13, K11's partial, the LF and slow walk
   steps), K14 (the row-budget
   compaction and its gather back), K15 (the capped histogram), K8 (the
   served answer's sparse pack) and the cohort merge's pack from
   ``readserver_tpu_torch/csrc`` for sm_90a, one nvcc per source started
   together;
3. artifact: simulate and build the E. coli artifact with the port's
   builder (cached under ``data/``);
4. count path: with every kernel's launch count at 0, start a
   ``QueryEngine`` on the card (tier plan, ship, prefix LUT through K1's
   level entry, warmup) and send count requests (1, 256, and 4096 queries
   on both strands); the level entry and K2 must have launched;
5. oracle: the served counts of >= 256 queries against exact counts of all
   read windows (``oracle.naive.window_multiset_counts``);
8. reads: counts at 0, ``query_batch`` requests (1, 256, 4096 on both
   strands) on the dsa engine (K5), a ``drop_tiers=("dsa",)`` engine (K6
   after the row-budget compaction), and the rank walks' engines: marks
   (``drop_tiers=("dsa", "fused", "lf")``), lf (``("dsa", "fused")``) and
   slow (``("dsa", "fused", "marks", "lf")``); the engines' answers equal,
   hit sets against the windows equal to each query on >= 64 queries; K5,
   K6, the walk kernel and K8 must have launched, K1's generic entry not;
9. samples: the 128-sample cohort artifact (built or loaded), counts at 0,
   histogram-only and full ``query_batch`` on a dsa, a fused and a marks
   engine; histograms exact against per-sample oracle counts on >= 64
   queries (dsa and marks), and a capped engine's ``complete`` flags
   against the window-rounding rule; K7 must have launched through the
   three walks, K6 and the walk kernel on the full answers, K8 on both;
9b. cohort: the same corpus built by ``index.cohort.build_cohort`` into 4
   doc shards (cached under ``data/``); phase 9's monolithic engine answers
   the requests first, then, counts at 0, three ``MultiEngine`` fronts (4
   partitions on the card each, dsa, fused and marks plans, a quarter of
   the budget each) serve them at B = 4096 queries a batch and H = 64;
   ``/count``, ``/samples`` and ``/reads`` on both strands equal across the
   fronts, exact against the windows on >= 96 queries (hit sets by global
   read id) and equal to the monolithic engine's; the int64 merge of
   synthetic partition buffers whose counts sum past 2^31; the REST front
   over the cohort; every kernel but K1's generic entry and K8 must have
   launched in that window (the fronts pack through the merge kernel).  Then, counted no more, each front's kernels against
   their plain forms on one partition: the LUT (K1's level entry), K2 on
   the width-4096 batch the front serves, its resolve kernel (K5, K6 or
   the mark walk) on that batch's intervals and K7 at the engine's window;
10. REST: counts at 0, the port's ``RestServer`` over the card engines in
   this script's event loop; every endpoint's answer equals the engine's;
11. interval shards: phase 9's monolithic engine answers the cohort
   requests first; then counts at 0, E. coli in 4 BWT-interval shards on
   the card through ``QueryEngine(packed, ServeConfig(num_shards=4),
   make_mesh(num_shards=4, device=...))``, one engine per route: dsa, lf
   (``dsa`` dropped from the packed index) and slow (``dsa`` and the fast
   tier dropped): ``build_sharded`` host seconds, K11's LUT equal to the
   monolithic engine's, the counts of phases 4-5 and the ``/reads`` of
   phase 8 equal on each route, the 128-sample cohort in 4 shards with
   exact ``/samples`` equal to phase 9's monolithic engine, its capped
   ``/samples`` (``exact_attribution`` off) counting each query's hits by
   sample, ``/info`` and the query endpoints over REST; the sharded
   search, K11, K10, K14 (its int64 entry, the gather with the walk's
   samples) and K15 (its sample mode) must have launched, and neither
   K9's generic entry, nor any other single-device kernel, nor a plain
   form of ``ops`` (or ``compact_rows``) on a CUDA tensor;
12. ingest and maintenance (``serve_ingest``): the port's CLI, each
   command in a process of its own as a user runs it on the card's host,
   at full size: the cohort simulated to FASTA, written as FASTQ and BAM,
   built from each into 4 doc shards (byte-equal), served (``query`` on
   the card and a ``MultiEngine``) as phase 9b's front serves it;
   ``append`` of a 129th sample and ``compact`` to 2 shards, each served
   as a from-scratch build; ``upgrade --kstep 3`` of phase 3's E. coli
   artifact with seven tiers stripped (byte-equal to phase 3's, phases
   4, 5 and 8's answers); ``merge`` and ``import-bwt`` served as their
   sources; each step's host seconds; counts at 0 first, K1's level
   entry, K2, K5 and K7 must launch, K1's and K9's generic entries not,
   and no plain form of ``ops`` on a CUDA tensor;
13. interval shards across ranks (``serve_ranks``): two ``cli serve
   --coordinator`` ranks start on the card (gloo, 2 shards each); counts at
   0, this process joins an NCCL group of one and serves E. coli in 4
   shards through the cross-rank program forced per step, one engine per
   route: K11's partial LUT equal to phase 11's, the counts of phases 4-5
   and the ``/reads`` of phase 8 on each route, the cohort's exact
   ``/samples`` equal to phase 11's, exact and capped, a batch's
   all-reduces equal to ``query_psum_estimate`` on each route; only K9's
   partial, K13, K11's partial, the walk steps, K14 and K15 may launch,
   K14 and K15 must, and no plain form of ``ops`` on a CUDA tensor; each
   route's ``/reads`` batch of 4096 x 2 profiled once
   and split into the all-reduces, the step kernels' device time and the
   host time between steps (``cross_rank_split``), where on the lf and
   slow routes every two all-reduces must have one launch and no torch op
   between them but where a walk begins; then the two ranks' REST front
   answers ``/count``, ``/reads`` and ``/samples`` as phases 4, 8 and (a)
   did, and SIGINT on rank 0 stops both with exit 0;
14. doc shards (``serve_doc``): two ``cli serve --coordinator`` ranks
   start on the card on phase 9b's cohort directory (gloo, 2 doc shards
   each); phase 9b's front and phase 9's monolithic engine answer first;
   counts at 0, the doc-sharded ``QueryEngine`` over the 4 partitions in
   a world of one (phase 13's NCCL group of one), one engine per route:
   dsa with exact attribution (K5, K7), fused (dsa and lf dropped: K14,
   K6, K7), lf (dsa and fused dropped: K14, the lf walk, K7) and fused
   with capped attribution (K14, K6, K15); ``/reads`` and ``/count`` of
   256 and 4096 x 2 queries, each batch one all-reduce, equal across the
   routes, to the front and the monolithic engine, 96 queries against the
   windows; K14 and K15 must launch, K1's and the sharded kernels not, and
   no plain form of ops on a CUDA tensor; the merge's all-reduce timed;
   then the group's ``/batch`` equal to the dsa engine's, SIGINT stops
   both; and the doc program over two gloo worker ranks on the card
   (``bench/multihost_bench.py --doc-shards``) equal to the world of one,
   one all-reduce and one gather a batch on each rank, both timed;
6. kernel vs plain: each kernel against its plain torch form on the card,
   bit for bit, at the main paths' shapes (K1 at the mark walk's step, the
   engine's prefix LUT and a chunked build against the plain build, K2 in
   every mode and tier set at widths 256, 8192 and 262,144 and its
   deferred guard, K5-K7 at widths 256 and 8192, H = 64), at edge cases,
   K6 and the rank walks at a full budget (4096 10-mers on both strands:
   every one of the 314,572 budget slots walks), the rank walks with their
   marks cleared, with $ rows marked, at 0 valid rows and 1 slot, the slow
   walk below the longest read, and K7 through all five walks at width
   8192 and through dsa, fused and marks at a cap-filling batch (8192
   cohort 8-mers, whose worklist the 1,048,576-row cap cuts); K14 and K15
   on E. coli's 524,288 lanes under the 314,572-row budget (width 8192
   and the full budget) and on each of phase 14's cohort doc shards, K14
   also with the hit step's ``read_to_sample`` column and against the
   torch ops it replaced; K8 on E. coli's /reads and the cohort's
   /samples and /reads of 4096 x 2 and the merge kernel on the cohort
   front's /reads and /samples, at nq = W and nq < W, and on short k-mers
   whose kept entries pass the 16 slots a query (n = -1), the packed
   buffers and the dense fallbacks;
15. scaling (``serve_scaling``): ``bench/scaling_sim.py`` on the card,
   counts at 0: the interval-sharded program at every (dp, shard)
   factorisation of 8 in the one-device form and the cross-rank form
   over this rank alone (dsa and lf routes), answers equal across every
   width and form, each route's all-reduces equal to
   ``query_psum_estimate`` once a dp row;
7. timing: the chase yardstick (``rs_chase``, no kernel of a path): one
   warp's time per dependent 64-byte read (t_row) through both fused
   tables, cold and warm, and the rate at K6's 76,521 walks and at a full
   budget; K2 at B=262,144 and at width 8192 over 8 distinct batches
   (through the waiting wrapper, on the engine's no-wait path 16 batches
   back to back, plain); K1's level entry per level and for the whole
   build, the LUT start-up stage split;
   K1's generic entry at random positions, at the LUT's last level and at
   the mark walk's step; K5-K7 at width 8192, K6 at a full budget and K7
   at the cap-filling batch, the rank walks at width 8192 and at a full
   budget and K7 through them (CUDA events and the
   profiler's kernel time; each walk's plain form: torch and K1 a step),
   each kernel's bytes needed and bytes bound, and for K2 and the walks
   the chain bound (the longest chain's dependent reads x t_row, warm and
   at the E. coli table's cold t_row); K14 (and its gather's
   ``read_to_sample`` column) and K15 at
   width 8192 and at the full budget, over distinct input sets in turn
   until together they need twice the L2, with the plain forms and, over
   the same sets, the torch ops they replaced, and K14 beside the library
   yardstick ``torch.nonzero_static`` (``time_yardstick``); K8 on the
   ``/reads`` request of 4096 x 2 and the cohort's ``/samples`` of
   4096 x 2, and the merge kernel on the cohort front's ``/reads`` and
   ``/samples`` batches of 4096, over distinct sets in turn
   (``time_packs``), beside their torch ops and the yardstick; where a
   served count,
   ``/reads`` (dsa and mark-walk engines)
   and ``/samples`` request's time goes (host stages, device busy share,
   top device ops); the mark-walk engine's ``/reads`` requests through
   the walk kernel and through the plain walk, in turns; and the cohort
   front's ``/samples`` and ``/reads`` requests of 4096 queries on both
   strands, and
   ``query_batches`` / ``count_batches`` over 8 batches of 4096 against 8
   single-batch calls, in turns, with the spread;
11b. interval kernels: each sharded kernel against its plain form at
   phase 11's shapes, max |err| 0 (K9 on 2 x 262,144 random ranks, K11 at
   every level of the p = 12 build, the sharded search in every mode at
   width 8192, K10 on each route's engine at 8192 x 64 lanes and its
   exact sweep on the cohort's width-8192 batch at window 32,768, K14's
   int64 entry and its gather with the walk's samples and K15's sample
   mode on the hit lanes of 8192 searched under the 314,572-row budget),
   and on distinct input sets of those shapes, enough that together they
   need twice the 50 MB L2; then, the sets in turn, each one's wrapper,
   device and plain times, bytes bound (of the sets' mean bytes) and,
   for the search and the walks, chain bound; and the interval programs'
   compaction, scatter back and histogram as the torch ops they were
   against K14 + K15, outputs equal, over the same sets.

13b. cross-rank kernels (``check_rank_kernels``): K9's partial, K13, K11's
   partial and every step of the LF and slow walks (``walk_pair_err``)
   against their plain forms at phase 13's shapes on one rank's run of all
   shards and on 2 ranks' runs, max |err| 0 (edges of the runs, empty
   intervals, $ rows); on 2 ranks' first run, over distinct input sets in
   turn until together they need twice the L2 (``partial_cases``,
   ``walk_step_cases``, ``time_cases``): K9's partial on a search step of
   8192 queries and on the rank of 8192 x 64 lanes, K13's dsa, LF and
   symbol lookups of those lanes, every mode of the two walk steps on
   them, each one's wrapper, device and plain times, bytes bound and chain
   bound; the all-reduce of a search step's and a walk step's lanes,
   NCCL's in a group of one and gloo's between two ranks sharing the card
   (``scripts/torch_allreduce_probe.py``, which also records NCCL's
   refusal of two ranks on one card), against the step's kernel, and each
   route's all-reduces a batch.

The line before the last is the card's ``nvidia-smi`` name and power limit;
the one before it is the kernels' JSON summary (``launches`` summed over
the main-path phases 4, 8, 9, 9b, 10, 11, 13, 14 and 15, where every kernel
but K1's and K9's generic entries must have launched, ``cohort_launches`` those of
phase 9b, ``ingest_launches`` those of phase 12;
``max_abs_err`` the largest over every check, ``cohort_max_abs_err`` that
over phase 9b's partition checks;
``bound_ms`` the bytes bound, ``library_ms`` the yardstick's time where
there is one (``library_call`` names it: K14, K8, the merge),
``chain_ms`` the chain bound where there is
one and ``chain_cold_ms`` it at the cold t_row, ``held_by`` the larger of
the first two; ``resolve_walk`` also carries each walk's reading at width
8192 and at a full budget under ``walks``; K14's and K15's entries their
other readings under ``readings`` (the full budget, the gather's
``read_to_sample`` column, the interval index's int64 rows and sample
mode), and ``row_compact`` the interval programs' torch ops against K14 +
K15 under ``interval_ops`` and the doc merge's collectives under
``doc_collectives``; K8's and the merge's histogram tier under
``readings``; the cross-rank kernels
their other shapes and modes under ``readings``, and ``shard_occ_partial``
the cross-rank design readings, phase 13's request splits among them).
The last line is ``{"ok": true, "device": {...}}``, printed only when
every phase passed.
Imports torch and the port, never jax.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
L2_BYTES = 50 * 2**20   # the H100's L2 cache
KMER = 31
SHARDS = 4              # the cohort's doc shards (scripts/bench_cohort.py)


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


def kernel_device_ms(fn, iters: int, kernel: str,
                     launches: int | None = None) -> float | None:
    """Mean device milliseconds per call of the CUDA kernels whose name
    holds ``kernel`` over ``iters`` calls of ``fn`` (``torch.profiler``).
    The profiler can miss the first launches after it starts, so ``iters``
    untimed calls run first, and only device events that start inside the
    timed calls' range count.  None when it saw none of their device time,
    or, where ``launches`` (the kernel's launches in ``iters`` calls) is
    given, when it never saw that many there."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "timed calls"
    for _ in range(5):  # the profiler now and then records no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            with record_function(mark):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        span = next(e.time_range for e in events
                    if e.name == mark and e.device_type == DeviceType.CPU)
        mine = [e for e in events if e.device_type == DeviceType.CUDA
                and kernel in e.name and e.name != mark
                and span.start <= e.time_range.start <= span.end]
        us = sum(e.self_device_time_total for e in mine)
        ok = us > 0 and launches in (None, len(mine))
        if ok:
            break
    if not ok:
        log(f"profiler saw {len(mine)} launches of {kernel!r} in the timed "
            f"calls (expected {launches}) and {us:.1f} us")
    return us / iters / 1e3 if ok else None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def ratio(a: float | None, b: float | None) -> str:
    return "not measured" if a is None or not b else f"{a / b:.3f}"


def engine_stage(engine, tier: str):
    """A ``QueryEngine``'s device program for one padded batch of ``tier``
    (see :func:`request_breakdown`): (codes, lengths, nq) → the buffer its
    answer copies out."""
    if tier == "count":
        return engine._counted
    return lambda codes, lengths, nq: engine._served(
        *engine._to_device(codes, lengths), nq,
        *engine._routes(codes, lengths, nq), tier == "reads")[0]


def request_breakdown(engine, kms: list[str], tier: str, stage,
                      fetch=None) -> None:
    """Where one served both-strands request's time goes: host stages by
    wall clock, and the device's busy share from a profiler window.
    ``tier``: "count" (``count_batch``), "reads" (``query_batch``) or
    "samples" (``query_batch(include_hits=False)``).  ``stage(codes,
    lengths, nq)``: the engine's device program for the padded batch, the
    "copy in + device" stage (:func:`engine_stage` for a
    ``QueryEngine``); ``fetch(out)``: its copy out (the engine's
    ``_fetch`` by default)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if tier == "count":
        whole_fn = lambda: engine.count_batch(kms, both_strands=True)  # noqa: E731
    else:
        whole_fn = lambda: engine.query_batch(  # noqa: E731
            kms, both_strands=True, include_hits=tier == "reads")
    stages = {}
    t0 = time.perf_counter()
    exp, _ = engine._expand_rc(kms)
    stages["reverse complements"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes, lengths, nq = engine._pad_encode(exp)
    stages["pad + encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = stage(codes, lengths, nq)
    torch.cuda.synchronize()
    stages["copy in + device"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (fetch or engine._fetch)(out)
    stages["copy out"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole_fn()
    whole = time.perf_counter() - t0
    stages["results (rest)"] = whole - sum(stages.values())
    log(f"{type(engine).__name__} {tier} request of {len(kms)} queries on "
        f"both strands ({nq} searched): {whole * 1e3:.3f} ms = " + ", ".join(
            f"{k} {v * 1e3:.3f}" for k, v in stages.items()))
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            whole_fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"profiler over {reps} such {tier} requests: device busy "
        f"{busy_us:.1f} us of {wall_us:.1f} us wall (idle share "
        f"{1 - busy_us / wall_us:.4f}); top device time: " + ", ".join(
            f"{e.key[:48]} {e.self_device_time_total:.1f} us x{e.count}"
            for e in top))


def load_or_build(corpus, cache: Path, build_index, artifact,
                  native_available):
    """The corpus's artifact, loaded from ``cache`` or built and saved."""
    t0 = time.perf_counter()
    if artifact.artifact_exists(cache):
        packed = artifact.load_artifact(cache, mmap=False)
        log(f"loaded cached artifact n={packed.n} in "
            f"{time.perf_counter() - t0:.3f}s")
        return packed
    check(native_available(), "the native SA-IS (g++) did not build")
    packed = build_index(corpus.reads, sample_ids=corpus.sample_ids)
    log(f"built artifact n={packed.n} in {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    artifact.save_artifact(packed, cache)
    log(f"saved to {cache.relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.3f}s")
    return packed


def codes_2bit(queries: np.ndarray) -> np.ndarray:
    """uint8 [Q, k] base codes → the 2-bit window codes of
    ``oracle.naive.encode_windows_2bit``."""
    enc = np.zeros(queries.shape[0], dtype=np.uint64)
    for j in range(queries.shape[1]):
        enc |= (queries[:, j].astype(np.uint64) - 1) << np.uint64(2 * j)
    return enc


def hit_oracle(mat: np.ndarray, queries: np.ndarray) -> list[set]:
    """Every (read, offset) window equal to each query, by one scan of all
    read windows (``oracle.naive.encode_windows_2bit`` and ``np.nonzero``)."""
    from readserver_tpu_torch.oracle.naive import encode_windows_2bit

    win = encode_windows_2bit(mat, queries.shape[1])
    enc = codes_2bit(queries)
    r, o = np.nonzero(np.isin(win, enc))
    found: dict[int, set] = {int(c): set() for c in enc}
    for rr, oo, cc in zip(r.tolist(), o.tolist(), win[r, o].tolist()):
        found[cc].add((rr, oo))
    return [found[int(c)] for c in enc]


def check_hits(res, want: set, H: int, sample_ids, strand=None) -> None:
    """A served hit list against the oracle's set: equal when the count
    fits the cap H, a subset of H hits otherwise; samples by read."""
    got = {(h["read_id"], h["offset"]) for h in res.hits
           if strand is None or h["strand"] == strand}
    if len(want) <= H:
        check(got == want, f"{res.kmer} {strand}: hit set differs from the "
              f"oracle ({len(got)} vs {len(want)})")
    else:
        check(got <= want and len(got) == H,
              f"{res.kmer} {strand}: hits past the cap are not a subset")
    for h in res.hits:
        check(h["sample_id"] == int(sample_ids[h["read_id"]]),
              f"{res.kmer}: wrong sample for read {h['read_id']}")


def check_cohort_hits(res, want: set, H: int, sample_ids, strand) -> None:
    """A cohort front's hit list on one strand against the oracle's set:
    each partition resolves up to H of its own rows, so the union is the
    whole set when the count fits H, else a subset of at least H hits."""
    got = {(h["read_id"], h["offset"]) for h in res.hits
           if h["strand"] == strand}
    if len(want) <= H:
        check(got == want, f"{res.kmer} {strand}: cohort hit set differs "
              f"from the oracle ({len(got)} vs {len(want)})")
    else:
        check(got <= want and len(got) >= H, f"{res.kmer} {strand}: cohort "
              "hits past the cap are not a subset of H or more")
    for h in res.hits:
        check(h["sample_id"] == int(sample_ids[h["read_id"]]),
              f"{res.kmer}: wrong sample for read {h['read_id']}")


def rest_exchange(server_cls, dispatcher, requests):
    """Start a REST server over ``dispatcher`` on a free local port in this
    process's event loop, send ``requests`` ((method, path, body)) over one
    keep-alive connection, stop it → ([(status, body)], server)."""
    import asyncio
    import http.client

    async def go():
        server = server_cls(dispatcher, "127.0.0.1", 0)
        await server.start()
        port = server._server.sockets[0].getsockname()[1]

        def client():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            out = []
            for method, path, body in requests:
                conn.request(method, path,
                             body=None if body is None else json.dumps(body))
                r = conn.getresponse()
                out.append((r.status, json.loads(r.read())))
            conn.close()
            return out

        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, client), server
        finally:
            await server.stop()

    return asyncio.run(go())


def rest_check(engine, kms: list[str], server_cls, Dispatcher,
               read_sample) -> int:
    """Every endpoint through the port's REST front over ``engine``, each
    answer against what the engine gives directly, ``/read``'s sample
    against ``read_sample(read id)`` → requests sent."""
    km = kms[:4]
    batch = kms[:64]
    rid = next(h["read_id"] for r in engine.query_batch(kms[:16])
               for h in r.hits)
    reqs = [
        ("GET", f"/count?kmer={km[0]}", None),
        ("GET", f"/reads?kmer={km[1]}", None),
        ("GET", f"/reads?kmer={km[2]}&both_strands=1", None),
        ("GET", f"/samples?kmer={km[3]}", None),
        ("GET", f"/read?id={rid}", None),
        ("GET", "/health", None),
        ("POST", "/batch", {"kmers": batch, "mode": "count"}),
        ("POST", "/batch", {"kmers": batch, "mode": "reads"}),
        ("POST", "/batch", {"kmers": batch, "mode": "samples",
                            "both_strands": True}),
        ("GET", "/stats", None),
    ]
    got, server = rest_exchange(server_cls, Dispatcher(engine), reqs)
    pay = server._result_payload
    want = [
        pay(engine.count_batch([km[0]])[0], "count", False),
        pay(engine.query_batch([km[1]])[0], "reads", False),
        pay(engine.query_batch([km[2]], both_strands=True)[0], "reads",
            False),
        pay(engine.query_batch([km[3]], include_hits=False)[0], "samples",
            False),
        {"read_id": rid, "name": engine.read_name(rid),
         "sequence": engine.read_sequence(rid),
         "sample": read_sample(rid)},
        {"status": "ok"},
        {"results": [pay(r, "count", False)
                     for r in engine.count_batch(batch)]},
        {"results": [pay(r, "reads", False)
                     for r in engine.query_batch(batch)]},
        {"results": [pay(r, "samples", False) for r in engine.query_batch(
            batch, both_strands=True, include_hits=False)]},
    ]
    for (method, path, _), (status, body), w in zip(reqs, got, want):
        check(status == 200 and body == w,
              f"REST {method} {path}: {status}, differs from the engine")
    status, stats = got[-1]
    check(status == 200 and stats["queries"] > 0 and stats["errors"] == 0
          and stats["pack"]["batches"] > 0, f"REST /stats: {status} {stats}")
    log(f"REST over {type(engine).__name__} ({engine._ns} samples): "
        f"{len(reqs)} requests, every answer equal to the engine's; /stats "
        f"{stats['queries']} queries in {stats['batches']} batches, p50 "
        f"{stats['p50_latency_ms']} ms")
    return len(reqs)


def serve_cohort(args, cohort, cpacked, ceng, cfg, dev, c256, c4096,
                 zero_launches, read_launches):
    """Phase 9b: the 128-sample cohort in SHARDS doc shards, served by
    ``MultiEngine`` fronts on the card, checked against the windows,
    phase 9's monolithic engine ``ceng`` and the REST front, then each
    front's kernels against their plain forms on one partition → (the
    dsa front, which phase 7 times; the partition checks' max |err| by
    the summary's keys)."""
    import torch
    from readserver_tpu_torch.index.cohort import (
        build_cohort,
        is_cohort,
        load_cohort,
    )
    from readserver_tpu_torch.kernels import KERNELS
    from readserver_tpu_torch.native import native_available
    from readserver_tpu_torch.ops import lut as lut_ops
    from readserver_tpu_torch.ops import resolve
    from readserver_tpu_torch.ops import search as search_ops
    from readserver_tpu_torch.serve import Dispatcher, MultiEngine
    from readserver_tpu_torch.serve.engine import _copy_out
    from readserver_tpu_torch.serve.http import RestServer

    H = cfg.max_hits
    ckms = decode_all(c256)
    scache = (REPO / "data" / "chip_smoke"
              / f"cohort{SHARDS}_s{args.scale:g}")
    t0 = time.perf_counter()
    if not is_cohort(scache):
        check(native_available(), "the native SA-IS (g++) did not build")
        build_cohort(cohort.reads, cohort.sample_ids, SHARDS, scache)
        log(f"built the cohort in {SHARDS} doc shards in "
            f"{time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
    parts, _ = load_cohort(scache, mmap=False)
    log(f"loaded {len(parts)} shards (n = {[p.n for p in parts]}, "
        f"{sum(p.num_reads for p in parts)} reads) in "
        f"{time.perf_counter() - t0:.3f}s")
    check(len(parts) == SHARDS
          and sum(p.num_reads for p in parts) == len(cohort.reads)
          and sum(p.n for p in parts) == cpacked.n
          and all(p.num_samples == 128 for p in parts),
          "the cohort's shards do not cover the corpus")
    # phase 9's monolithic engine answers the same requests first, outside
    # the cohort path's counted window: 256 queries on both strands, and a
    # full batch of 4096 on one strand
    c4096_kms = decode_all(c4096)
    mono = (ceng.count_batch(ckms, both_strands=True),
            ceng.query_batch(ckms, both_strands=True, include_hits=False),
            ceng.query_batch(ckms, both_strands=True),
            ceng.query_batch(c4096_kms, include_hits=False))
    zero_launches()
    # B = 4096 queries a batch (scripts/bench_cohort.py), served at the
    # width 4096; a batch_size of 8192 lets a request of 4096 queries
    # on both strands in.  The partitions share the card: each plans
    # its tiers against a quarter of the budget
    share = ceng.budget_bytes / SHARDS / 2**30
    mcfg = dataclasses.replace(cfg, small_batch_sizes=(256, 4096),
                               hbm_budget_gb=share)
    multis = {}
    t0 = time.perf_counter()
    for wname, drop in (("dsa", ()), ("fused", ("dsa",)),
                        ("marks", ("dsa", "fused", "lf"))):
        m = MultiEngine(parts, dataclasses.replace(mcfg, drop_tiers=drop),
                        device=dev)
        m.warmup()
        check(all(resolve.walk_kind(e.index) == wname
                  for e in m.engines),
              f"the {wname} cohort front's partitions do not walk "
              f"{wname}")
        multis[wname] = m
    meng = multis["dsa"]
    log(f"cohort fronts (dsa, fused, marks; {SHARDS} partitions each) "
        f"up and warm in {time.perf_counter() - t0:.3f}s: "
        f"{share:.2f} GiB a partition, dsa partitions keep "
        f"{sorted(meng.engines[0].tier_plan.keep)}, LUT p="
        f"{[e.lut_p for e in meng.engines]}")
    answers_c = {}
    for ename, m in multis.items():
        t0 = time.perf_counter()
        got = (m.count_batch(ckms, both_strands=True),
               m.query_batch(ckms, both_strands=True, include_hits=False),
               m.query_batch(ckms, both_strands=True))
        took = time.perf_counter() - t0
        check(not answers_c or got == answers_c["dsa"],
              f"the dsa and {ename} cohort fronts disagree")
        answers_c[ename] = got
        log(f"cohort front ({ename}): /count, /samples and /reads of "
            f"256 queries on both strands in {took * 1e3:.3f} ms")
    ccount, csamples, creads = answers_c["dsa"]
    # 96 queries on both strands against every matching read window
    t0 = time.perf_counter()
    rcm = np.array([4, 3, 2, 1], dtype=np.uint8)
    c_rc = rcm[c256[:96] - 1][:, ::-1]
    cmat = np.stack(cohort.reads)
    want_w = hit_oracle(cmat, np.concatenate([c256[:96], c_rc]))
    del cmat
    names = parts[0].sample_names
    for i in range(96):
        wf, wr = want_w[i], want_w[96 + i]
        rids = np.fromiter((r for r, _ in [*wf, *wr]), dtype=np.int64)
        per = np.bincount(cohort.sample_ids[rids], minlength=128)
        want_hist = {names[j]: int(c) for j, c in enumerate(per) if c}
        n = len(wf) + len(wr)
        r = creads[i]
        check(ccount[i].count == csamples[i].count == r.count == n,
              f"{r.kmer}: cohort counts differ from the oracle ({n})")
        check(csamples[i].sample_hist == r.sample_hist == want_hist,
              f"{r.kmer}: cohort histogram differs from the oracle")
        check_cohort_hits(r, wf, H, cohort.sample_ids, "+")
        check_cohort_hits(r, wr, H, cohort.sample_ids, "-")
        check(r.hits_truncated == (r.count > len(r.hits)),
              f"{r.kmer}: hits_truncated is not count > len(hits)")
    log(f"oracle: 96 cohort queries on both strands, counts, "
        f"histograms and hit sets (global read ids) exact "
        f"({sum(len(w) for w in want_w)} windows) in "
        f"{time.perf_counter() - t0:.3f}s")
    # the monolithic engine's answers to the same requests
    hkey = lambda h: (h["read_id"], h["offset"], h["strand"],  # noqa: E731
                      h["sample_id"])
    same_hits = 0
    for a, b in zip(mono[2], creads):
        if not (a.hits_truncated or b.hits_truncated):
            check(sorted(map(hkey, a.hits)) == sorted(map(hkey, b.hits)),
                  f"{a.kmer}: monolithic and cohort hit sets differ")
            same_hits += 1
    akey = lambda r: (r.count, r.sample_hist)  # noqa: E731
    for a, b in zip(mono, (ccount, csamples, creads,
                           meng.query_batch(c4096_kms, include_hits=False))):
        check([akey(r) for r in a] == [akey(r) for r in b],
              "monolithic and cohort counts or histograms differ")
    check(meng.engines[0].last_width == 4096, "the batch of 4096 did "
          "not run at the width 4096")
    log(f"monolithic engine against the cohort front: counts and "
        f"histograms equal on 256 queries on both strands and 4096 on "
        f"one, hit sets equal on {same_hits} of 256 untruncated")
    # the int64 merge: synthetic partition buffers, counts 2^31 - 5
    big, w8 = 2**31 - 5, 8
    outs = []
    for e in meng.engines:
        o = torch.full((w8, 4 + e._ns + 3 * H), -1, dtype=torch.int32,
                       device=dev)
        o[:, :4 + e._ns] = 0
        o[:, 2], o[:, 3] = big, 1
        outs.append(o)
    want64 = big * SHARDS
    check(meng._merge_count(outs).tolist() == [want64] * w8,
          "the count tier's merge wraps past 2^31")
    for with_hits in (True, False):
        merged = meng._merge_full(outs, 3, with_hits, meng._new_bad())
        res = meng._assemble_merged(["A"] * 3, 3, with_hits,
                                    (_copy_out(merged[0]), *merged[1:]))
        check([r.count for r in res] == [want64] * 3,
              f"the merge wraps past 2^31 (hits {with_hits})")
    log(f"int64 merge on the card: {SHARDS} x (2^31 - 5) = {want64} on "
        f"the count, full and histogram tiers")
    # the JAX MultiEngine has no _sample_of: /read answers "sample": None
    n_req = rest_check(meng, ckms, RestServer, Dispatcher, lambda rid: None)
    launches = read_launches("cohort")
    # K14 compacts only where the row budget binds (past 314,572 lanes; the
    # fronts' widths here are 4096 and below) and K15 serves only capped
    # attribution (the fronts attribute exactly): phase 14 launches both.
    # The fronts pack every batch through the merge kernel, never K8
    for name in KERNELS:
        if (name not in ("rank_occ", "row_compact", "row_gather",
                         "capped_histogram", "sparse_pack")
                and not name.startswith(("shard", "walk"))):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the cohort path")
    check(launches["rank_occ"] == 0, "K1's generic entry launched on "
          "the cohort path: a walk ran its plain form")
    check(launches["sparse_pack"] == 0, "K8 launched on the cohort path: a "
          "front packed outside the merge kernel")
    log(f"{n_req} REST requests over the cohort front answered as it "
        f"answers")
    # each front's kernels against their plain forms on its first
    # partition, on the width-4096 batch the front serves (not counted)
    cerr = dict.fromkeys(("k1l_err", "k2_err", "k5_err", "k6_err", "kw_err",
                          "k7_err"), 0)
    resolve_err = {"dsa": "k5_err", "fused": "k6_err", "marks": "kw_err"}
    for wname, m in multis.items():
        e = m.engines[0]
        idx = e.index
        ce, le, nq = e._pad_encode(c4096_kms)
        check(ce.shape[0] == 4096, f"the {wname} partition's batch is not "
              "4096 wide")
        err = {"k1l_err": max_err([(e.lut, lut_ops.build_prefix_lut_plain(
            idx, e.lut_p))])}
        l, u = e._search(*e._to_device(ce, le), *e._routes(ce, le, nq),
                         e._new_bad())
        err["k2_err"] = max_err(zip(
            (l, u), search_ops.backward_search_pair_plain(
                idx, torch.from_numpy(ce).to(dev), e.lut, e.lut_p)))
        if wname == "dsa":
            rerr = max_err(zip(resolve.resolve_dsa_hits(idx, l, u, H),
                               resolve.resolve_dsa_hits_plain(idx, l, u, H)))
            shape = f"{l.shape[0]} x H={H}"
        else:
            rows, valid, _ = resolve.expand_intervals(l, u, H)
            if e.row_budget is not None and e.row_budget < rows.shape[0]:
                rows, valid, _, _ = resolve.compact_rows(rows, valid,
                                                         e.row_budget)
            rerr = max_err(zip(resolve.select_walk(idx)(rows, valid),
                               resolve.select_walk(idx, plain=True)(rows,
                                                                    valid)))
            shape = f"{rows.shape[0]} rows ({int(valid.sum())} valid)"
        err[resolve_err[wname]] = rerr
        window = e.cfg.sweep_window or min(ce.shape[0] * H, 8 * ce.shape[0])
        err["k7_err"] = max_err(zip(
            resolve.exact_sample_histogram(idx, l, u, window,
                                           e.cfg.max_sweep_rows),
            resolve.exact_sample_histogram_plain(idx, l, u, window,
                                                 e.cfg.max_sweep_rows)))
        log(f"{wname} front, partition 0 (n = {idx.n}): LUT p={e.lut_p}, K2 "
            f"on the batch of 4096, the {wname} resolve on {shape}, K7 at "
            f"window {window} against their plain forms: max |err| {err}")
        check(not any(err.values()), f"a kernel disagrees with its plain "
              f"form on the {wname} front's partition: {err}")
        for k, v in err.items():
            cerr[k] = max(cerr[k], v)
    return meng, cerr


def time_cohort(meng, cohort, c4096, seed: int, card: str) -> None:
    """Phase 7's cohort timing, on the dsa front ``meng``: where a
    /samples and a /reads request of 4096 queries on both strands go, and
    the pipelined bulk paths against one batch at a time, in turns, with
    the spread (the merge kernel: :func:`time_packs`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from readserver_tpu_torch.corpus import simulate

    t_start = time.perf_counter()
    for tier in ("samples", "reads"):
        request_breakdown(
            meng, decode_all(c4096), tier,
            lambda c, le, nq, h=tier == "reads": meng._served(c, le, nq,
                                                              h)[0])
    bulk = decode_all(simulate.sample_query_kmers_fast(
        cohort, 8 * 4096, KMER, seed=seed + 6, miss_frac=0.1))
    bb = [bulk[i : i + 4096] for i in range(0, len(bulk), 4096)]
    check(meng.query_batches(bb) == [meng.query_batch(b) for b in bb]
          and meng.count_batches(bb) == [meng.count_batch(b)
                                         for b in bb],
          "the pipelined bulk paths disagree with one batch at a time")
    runs = {
        "query_batches": lambda: meng.query_batches(bb),
        "8 x query_batch": lambda: [meng.query_batch(b) for b in bb],
        "count_batches": lambda: meng.count_batches(bb),
        "8 x count_batch": lambda: [meng.count_batch(b) for b in bb],
    }
    t = {name: [] for name in runs}
    order = list(runs)
    for rep in range(5):  # in turns whose order rotates
        for name in order[rep % 4:] + order[:rep % 4]:
            gc.collect()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            t[name].append((time.perf_counter() - t0) * 1e3)
    for name, v in t.items():
        med = float(np.median(v))
        log(f"cohort bulk, 8 batches of 4096 31-mers, {name}: median "
            f"{med:.3f} ms = {len(bulk) / med * 1e3:.0f} queries/s, min "
            f"{min(v):.3f}, max {max(v):.3f} (max/min "
            f"{max(v) / min(v):.3f}; runs "
            + ", ".join(f"{x:.3f}" for x in v) + f") | {card}")
    for name in ("query_batches", "8 x query_batch"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        log(f"cohort bulk, {name} under the profiler: device busy "
            f"{busy_us:.1f} us of {wall_us:.1f} us wall (idle share "
            f"{1 - busy_us / wall_us:.4f}) | {card}")
    log(f"cohort timing in {time.perf_counter() - t_start:.3f}s")



# ------------------------------------------------ K8 and the cohort merge


def pack_inputs(engine, kms, with_hits: bool):
    """What a ``QueryEngine`` hands K8 for the batch ``kms`` (``_served``):
    (l, u, complete, hist, rid, off, smp, nq) on the card."""
    ce, le, nq = engine._pad_encode(kms)
    l, u, hist, complete, rid, off, smp = engine._pieces(
        *engine._to_device(ce, le), *engine._routes(ce, le, nq), with_hits,
        engine._new_bad())
    return l, u, complete, hist, rid, off, smp, nq


def merge_inputs(meng, kms, with_hits: bool):
    """The partitions' dense buffers a ``MultiEngine`` merges for the
    batch ``kms`` → (outs, nq)."""
    ce, le, nq = meng._pad_encode(kms)
    bad = meng._new_bad()
    mode = "full" if with_hits else "hist"
    return [e._dispatch_single(ce, le, nq, mode, bad=bad)
            for e in meng.engines], nq


def pack_n(buf, W: int, R: int, head: int, hits: bool) -> tuple:
    """(n_hist, n_hits or None) of a packed buffer whose segments before
    n_hist are ``head`` words a query."""
    p = W * head
    return int(buf[p]), int(buf[p + 1 + 2 * R]) if hits else None


def check_pack_kernels(engine, ceng, meng, reads_kms, cohort_kms,
                       short_kms) -> dict:
    """Phase 6: K8 and the merge kernel against their plain forms, word
    for word (the packed buffer and the dense fallbacks), at the served
    shapes: K8 on E. coli's /reads 4096 x 2 (dsa engine) and the cohort's
    /samples and /reads 4096 x 2 (monolithic engine); the merge on the
    cohort front's 4 partitions, /reads and /samples; each at nq = W and
    nq < W, and on a batch of short k-mers whose kept entries pass the 16
    slots a query (n = -1) → {"k8_err", "merge_err"}."""
    from readserver_tpu_torch.ops import pack

    def err_of(got, want):
        pairs = [(got[0], want[0]), (pack.dense(got[1]), want[1])]
        if want[2] is not None:
            pairs.append((pack.dense(got[2]), want[2]))
        return max_err(pairs)

    err = {"k8_err": 0, "merge_err": 0}
    cpq = engine.COMPACT_PER_QUERY
    for what, e, kms, hits in (
            ("E. coli /reads", engine, reads_kms, True),
            ("cohort /samples", ceng, cohort_kms, False),
            ("cohort /reads", ceng, cohort_kms, True),
            ("E. coli short k-mers", engine, short_kms, True),
            ("cohort short k-mers /samples", ceng, short_kms, False)):
        l, u, comp, hist, rid, off, smp, nq = pack_inputs(e, kms, hits)
        W = l.shape[0]
        for n in (nq, nq // 2 + 1):
            a = (l, u, comp, hist, rid, off, smp, n, cpq, e._new_bad(), e.H)
            got = pack.pack_answer(*a)
            k = err_of(got, pack.pack_answer_plain(*a))
            err["k8_err"] = max(err["k8_err"], k)
            ns = pack_n(got[0], W, cpq * W, 4 + (not hits), hits)
            log(f"K8, {what}: W = {W}, NS = {hist.shape[1]}, SH = "
                f"{0 if rid is None else rid.shape[1]}, nq = {n}, n = {ns}: "
                f"max |err| {k}")
            check(k == 0, f"K8 disagrees with its plain form ({what}, "
                  f"nq = {n})")
    for what, kms, hits in (("/reads", cohort_kms, True),
                            ("/samples", cohort_kms, False),
                            ("short k-mers /reads", short_kms, True)):
        outs, nq = merge_inputs(meng, kms, hits)
        W = outs[0].shape[0]
        for n in (nq, nq // 2 + 1):
            a = (outs, [p._ns for p in meng.engines], meng._read_base,
                 meng._ns, meng.H, n, cpq, meng._new_bad(), hits)
            got = pack.merge_pack(*a)
            k = err_of(got, pack.merge_pack_plain(*a))
            err["merge_err"] = max(err["merge_err"], k)
            ns = pack_n(got[0], W, cpq * W, 3 + (not hits), hits)
            log(f"merge kernel, cohort front {what}: {len(outs)} partitions"
                f" x {list(outs[0].shape)}, nq = {n}, n = {ns}: max |err| "
                f"{k}")
            check(k == 0, f"the merge kernel disagrees with its plain form "
                  f"({what}, nq = {n})")
    return err


def time_yardstick(masks, size: int, what: str, card: str) -> tuple:
    """One PyTorch call that compacts as K8 and K14 do, over the masks in
    turn: ``torch.nonzero_static`` of a precomputed flat mask, its first
    ``size`` set positions, -1 after → (ms, the call's name)."""
    import torch

    turn = itertools.cycle(masks)
    call = lambda: torch.nonzero_static(  # noqa: E731
        next(turn), size=size, fill_value=-1)
    call()
    iters = max(len(masks), N_ROT)
    ms = float(np.median([time_cuda(call, iters) for _ in range(3)]))
    log(f"library yardstick, {what}: torch.nonzero_static of the "
        f"precomputed kept mask ({masks[0].numel()} positions, size {size}; "
        f"{len(masks)} distinct masks in turn): {ms:.4f} ms a call (CUDA "
        f"events) | {card}")
    return ms, "torch.nonzero_static"


def time_packs(engine, ceng, meng, reads_make, cohort_make, card):
    """Phase 7: K8 on the /reads request of 4096 x 2 (E. coli, dsa engine)
    and on the cohort's /samples of 4096 x 2 (the histogram tier), and the
    merge kernel on the cohort front's batches of 4096 (/reads and
    /samples), each over distinct input sets in turn until together they
    need twice the L2 (:func:`time_cases`: the kernel against its plain
    form on every set, wrapper ms, device ms of both launches, the plain
    form's ms, bytes bound); beside them the torch ops they replaced (the
    plain forms; for the merge also ``merge_dense`` alone) with their
    device time over every op, and the library yardstick (a
    ``nonzero_static`` of the kept mask) → (summary entries, {name: (ms,
    call)})."""
    import torch
    from readserver_tpu_torch.ops import pack

    cpq = engine.COMPACT_PER_QUERY
    out, library = {}, {}

    def words(x) -> int:
        return 0 if x is None else x.numel() * x.element_size()

    for name, e, make, hits in (
            ("sparse_pack", engine, reads_make, True),
            ("sparse_pack (samples)", ceng, cohort_make, False)):
        def answer(j, e=e, make=make, hits=hits):
            return pack_inputs(e, make(j), hits)

        def needs(l, u, comp, hist, rid, off, smp, nq, hits=hits):
            W = l.shape[0]
            kept = 0 if rid is None else min(int((rid[:nq] >= 0).sum()),
                                             cpq * W)
            packed = 4 * (W * (4 + (not hits)) + 2 + 2 * cpq * W
                          + (1 + 4 * cpq * W if hits else 0))
            return (words(l) + words(u) + words(comp) + words(hist)
                    + words(rid) + 8 * kept + 4 + packed, None)

        sets, nbytes, _ = in_turn(answer, needs)
        x = sets[0]
        W, SH = x[0].shape[0], 0 if x[4] is None else x[4].shape[1]
        # the packed buffers compared and timed (the dense fallbacks:
        # phase 6); the plain form also writes the dense hits' copy
        kern = lambda *x, e=e: pack.pack_answer(  # noqa: E731
            *x, cpq, e._new_bad(), e.H)[0]
        plain = lambda *x, e=e: pack.pack_answer_plain(  # noqa: E731
            *x, cpq, e._new_bad(), e.H)[0]
        what = (f"W = {W}, NS = {x[3].shape[1]}, SH = {SH}, R = {cpq * W}")
        got = time_cases([(name, ("pack_", 2), kern, plain, sets, what,
                           nbytes, None)], None, card)
        out.update(got)
        copy = 12 * W * SH  # the dense hits the torch pack also wrote
        log(f"{name}: bytes bound with the dense hits' copy the torch pack "
            f"wrote ({copy} B more): {bound_ms(nbytes + copy):.4f} ms | "
            f"{card}")
        time_ops(sets, lambda *x, p=plain: p(*x), f"K8's torch ops, {name}",
                 card, got[name][2])
        masks = [((s[4] >= 0) if hits else (s[3] > 0)).reshape(-1)
                 for s in sets]
        library[name] = time_yardstick(masks, cpq * W, name, card)
    for name, hits in (("merge_pack", True), ("merge_pack (samples)", False)):
        ns = [p._ns for p in meng.engines]

        def outs_of(j, hits=hits):  # the front's batches of 4096 queries
            return merge_inputs(meng, cohort_make(j)[:4096], hits)

        def needs(outs, nq, hits=hits):
            W = outs[0].shape[0]
            nb = 4 + 4 * (W * (3 + (not hits)) + 2 + 2 * cpq * W
                          + (1 + 4 * cpq * W if hits else 0))
            kept = 0
            for o, n in zip(outs, ns):
                nb += 4 * W * (2 + n + (meng.H if hits else 0))
                if hits:
                    kept += int((o[:nq, 4 + n:4 + n + meng.H] >= 0).sum())
            return nb + 8 * min(kept, cpq * W), None

        sets, nbytes, _ = in_turn(outs_of, needs)
        W = sets[0][0][0].shape[0]
        args = lambda outs, nq, h=hits: (  # noqa: E731
            outs, ns, meng._read_base, meng._ns, meng.H, nq, cpq,
            meng._new_bad(), h)
        kern = lambda outs, nq: pack.merge_pack(  # noqa: E731
            *args(outs, nq))[0]
        plain = lambda outs, nq: pack.merge_pack_plain(  # noqa: E731
            *args(outs, nq))[0]
        what = (f"{len(ns)} partitions x {list(sets[0][0][0].shape)} int32, "
                f"NS = {meng._ns}, R = {cpq * W}")
        got = time_cases([(name, ("pack_", 2), kern, plain, sets, what,
                           nbytes, None)], None, card)
        out.update(got)
        time_ops(sets, plain, f"the merge's torch ops (merge_dense + the "
                 f"pack), {name}", card, got[name][2])
        time_ops(sets, lambda outs, nq, h=hits: pack.merge_dense(
            outs, ns, meng._read_base, meng._ns, meng.H, h),
            f"merge_dense alone, {name}", card)
        masks = []
        for outs, nq in sets:
            m = (torch.cat([o[:, 4 + n:4 + n + meng.H] for o, n in
                            zip(outs, ns)], 1) >= 0 if hits else
                 pack.merge_dense(outs, ns, meng._read_base, meng._ns,
                                  meng.H, False)[2] > 0)
            masks.append(m.reshape(-1))
        library[name] = time_yardstick(masks, cpq * W, name, card)
    return out, library


# the modules of readserver_tpu_torch.ops whose plain forms may not run on
# the card on a path
PLAIN_MODULES = ("rank", "lut", "search", "resolve", "sharded", "pack")


@contextlib.contextmanager
def plain_calls_on_card(modules=PLAIN_MODULES):
    """Count the calls of the plain forms (every ``*_plain`` function of
    ``modules``, ``compact_rows``, and the walks' plain forms) that are
    handed a CUDA tensor (or a list of them) or an index on the card →
    {"n": count}."""
    import importlib

    import torch
    from readserver_tpu_torch.ops import resolve

    calls = {"n": 0}

    def on_card(a) -> bool:
        if isinstance(a, torch.Tensor):
            return a.is_cuda
        if isinstance(a, (list, tuple)):  # the merge's partition buffers
            return any(on_card(x) for x in a)
        t = getattr(a, "starts", None)          # a ShardedIndex
        if t is None:
            t = getattr(a, "rank_rows", None)   # a DeviceIndex
        return isinstance(t, torch.Tensor) and t.is_cuda

    def counted(fn):
        def inner(*args, **kw):
            if any(on_card(a) for a in (*args, *kw.values())):
                calls["n"] += 1
            return fn(*args, **kw)
        return inner

    saved = []
    for mod in (importlib.import_module(f"readserver_tpu_torch.ops.{m}")
                for m in modules):
        for name, fn in list(vars(mod).items()):
            if (name.endswith("_plain") or name == "compact_rows") \
                    and callable(fn):
                saved.append((mod, name, fn))
                setattr(mod, name, counted(fn))
    walks = dict(resolve._WALKS)
    if "resolve" in modules:
        for kind, (fn, plain) in walks.items():
            resolve._WALKS[kind] = (fn, counted(plain))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        resolve._WALKS.update(walks)


# the packed index as each route's deployment ships it: the lf route's
# artifact carries no dsa, the slow route's neither dsa nor the fast tier
ROUTE_DROPS = {
    "dsa": {},
    "lf": dict(dsa=None, dsa_bits=0),
    "slow": dict(dsa=None, dsa_bits=0, lf=None, mark_rank=None,
                 sample_pairs=None, sample_rate=0),
}


# K14's and K15's kernels, which the interval paths launch beside their own
COMPACT_KERNELS = ("row_compact", "row_gather", "capped_histogram")


def serve_capped(cpacked, scfg, mesh, dev, kms, want, what: str) -> list:
    """The cohort on an interval engine over ``mesh`` with capped
    attribution (``exact_attribution`` off: K14's compaction and its
    gather with the walk's samples, K15's sample mode): the ``/samples``
    of ``kms`` on one strand, hits included; each histogram must count the
    query's hits by sample and be complete iff no hit was cut, and the
    counts and hits must equal ``want``'s → the answers."""
    from collections import Counter

    from readserver_tpu_torch.serve import QueryEngine

    t0 = time.perf_counter()
    e = QueryEngine(cpacked, dataclasses.replace(scfg,
                                                 exact_attribution=False),
                    mesh, device=dev)
    up = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = e.query_batch(kms)
    dt = time.perf_counter() - t0
    names = e.sample_names
    for r in got:
        hist = Counter(names[h["sample_id"]] for h in r.hits)
        check(hist == Counter({k: v for k, v in r.sample_hist.items() if v}),
              f"{what}: the capped histogram of {r.kmer} is not its hits'")
        check(r.sample_hist_complete == (len(r.hits) == r.count),
              f"{what}: capped completeness of {r.kmer}")
    hkey = lambda r: (r.count, r.hits, r.hits_truncated)  # noqa: E731
    check([hkey(r) for r in got] == [hkey(r) for r in want],
          f"{what}: capped engine's counts and hits differ")
    counted = sum(sum(r.sample_hist.values()) for r in got)
    log(f"{what}, capped attribution: up in {up:.3f}s, /samples of "
        f"{len(kms)} cohort queries with hits in {dt * 1e3:.3f} ms, each "
        f"histogram its hits' by sample ({counted} counted, "
        f"{sum(not r.sample_hist_complete for r in got)} incomplete), "
        f"counts and hits equal to the reference's")
    return got


def serve_interval(packed, engine, cpacked, ceng, cfg, dev, qs, served,
                   reads_served, c256, c4096, zero_launches, read_launches):
    """Phase 11: E. coli in SHARDS interval shards on the card through
    ``QueryEngine(packed, ServeConfig(num_shards=SHARDS), make_mesh(...))``,
    one engine per route (dsa, lf, slow) from the packed index with the
    route's tiers dropped: start-up (build_sharded on the host, the
    placement, K11's LUT), counts and ``/reads`` against the monolithic
    engine's answers (phases 4 and 8, which the oracle checked), the
    128-sample cohort's exact ``/samples`` against phase 9's monolithic
    engine, and ``/info`` and the query endpoints over REST; no plain form
    of ops on a CUDA tensor, and no single-device kernel but K14 and K15;
    the cohort with capped attribution (:func:`serve_capped`) → (the
    E. coli sharded engines by route, the cohort's sharded engine, the
    capped engine's answers)."""
    import torch
    from readserver_tpu_torch.ops import sharded as sops
    from readserver_tpu_torch.parallel import make_mesh
    from readserver_tpu_torch.parallel.stats import query_psum_estimate
    from readserver_tpu_torch.serve import Dispatcher, QueryEngine
    from readserver_tpu_torch.serve.http import RestServer

    # phase 9's monolithic engine answers the cohort requests first, outside
    # the interval path's counted window
    ckms = {"256": (decode_all(c256), False),
            "4096x2": (decode_all(c4096), True)}
    mono = {name: ceng.query_batch(kms, both_strands=both, include_hits=False)
            for name, (kms, both) in ckms.items()}
    mono_reads = ceng.query_batch(ckms["256"][0])
    zero_launches()
    scfg = dataclasses.replace(cfg, num_shards=SHARDS)
    mesh = make_mesh(num_shards=SHARDS, device=dev)
    engines = {}
    with plain_calls_on_card() as plain:
        for route, drop in ROUTE_DROPS.items():
            t0 = time.perf_counter()
            e = QueryEngine(dataclasses.replace(packed, **drop), scfg, mesh,
                            device=dev)
            st = e.startup_seconds
            s = e.sidx
            log(f"interval engine, {route} route ({SHARDS} shards of "
                f"{s.lens.tolist()} positions) up in "
                f"{time.perf_counter() - t0:.3f}s: build_sharded (host) "
                f"{st['build_sharded']:.3f}s, placement {st['ship']:.3f}s, "
                f"prefix LUT p={e.lut_p} through K11 {st['lut']:.3f}s; "
                f"{sum(t.nbytes for t in vars(s).values() if isinstance(t, torch.Tensor)) / 2**30:.3f}"
                f" GiB on card")
            t0 = time.perf_counter()
            e.warmup()
            log(f"warmup in {time.perf_counter() - t0:.3f}s")
            check(sops.walk_kind(s) == route,
                  f"the {route} engine does not walk {route}")
            check(e.lut_p == engine.lut_p
                  and torch.equal(e.lut.cpu(), engine.lut.long().cpu()),
                  f"K11's sharded LUT ({route} engine) differs from the "
                  f"monolithic engine's")
            engines[route] = e
        eng = engines["dsa"]
        s = eng.sidx
        log(f"K11's LUT (4^{eng.lut_p} entries, int64) equals the monolithic"
            f" engine's (K1's level entry, int32), as integers, on every "
            f"route's engine")
        for name, q, both in qs:
            kms = decode_all(q)
            t0 = time.perf_counter()
            res = eng.count_batch(kms, both_strands=both)
            dt = time.perf_counter() - t0
            check(np.array_equal([r.count for r in res], served[name]),
                  f"interval counts of the request of {name} differ from "
                  f"the monolithic engine's")
            log(f"count request of {name} queries: {dt * 1e3:.3f} ms, equal "
                f"to the monolithic engine's (and so to the oracle's)")
        for route, e in engines.items():
            for name, q, both in qs:
                t0 = time.perf_counter()
                got = e.query_batch(decode_all(q), both_strands=both)
                dt = time.perf_counter() - t0
                check(got == reads_served[name], f"interval /reads of {name} "
                      f"on the {route} route differ from the monolithic "
                      f"engine's")
                log(f"/reads request of {name} queries, {route} route: "
                    f"{dt * 1e3:.3f} ms, {sum(len(r.hits) for r in got)} "
                    f"hits, equal to the monolithic engine's")
        t0 = time.perf_counter()
        ceng_s = QueryEngine(cpacked, scfg, mesh, device=dev)
        log(f"cohort interval engine ({ceng_s.sidx.num_samples} samples, "
            f"n={cpacked.n}) up in {time.perf_counter() - t0:.3f}s: "
            f"build_sharded (host) "
            f"{ceng_s.startup_seconds['build_sharded']:.3f}s")
        key = lambda r: (r.count, r.sample_hist, r.sample_hist_complete)  # noqa: E731
        for name, (kms, both) in ckms.items():
            t0 = time.perf_counter()
            got = ceng_s.query_batch(kms, both_strands=both,
                                     include_hits=False)
            dt = time.perf_counter() - t0
            check([key(r) for r in got] == [key(r) for r in mono[name]],
                  f"interval /samples of {name} differ from the monolithic "
                  f"engine's")
            log(f"/samples request of {name} cohort queries: {dt * 1e3:.3f} "
                f"ms, exact histograms equal to the monolithic engine's "
                f"({sum(not r.sample_hist_complete for r in got)} cut by the "
                f"sweep cap)")
        check(ceng_s.query_batch(ckms["256"][0]) == mono_reads,
              "interval cohort /reads differ from the monolithic engine's")
        capped = serve_capped(cpacked, scfg, mesh, dev, ckms["256"][0],
                              mono_reads, "cohort interval engine")
        # REST: /info and the query endpoints over the port's front
        km = decode_all(qs[1][1][:3])
        reqs = [("GET", "/info", None)] + [
            ("GET", f"{path}?kmer={k}&both_strands=1", None)
            for k in km for path in ("/count", "/reads", "/samples")]
        got, server = rest_exchange(RestServer, Dispatcher(eng), reqs)
        status, info = got[0]
        kstep = 3 if s.rank3_rows is not None else 2
        psums = query_psum_estimate(
            eng.K, lut_p=eng.lut_p or 0, kstep=kstep,
            sample_rate=s.sample_rate, fast_resolve=s.has_fast_resolve,
            max_read_len=s.max_read_len,
            direct_resolve=s.dsa_chunk is not None)
        check(status == 200 and info["sharding"] == "interval"
              and info["num_shards"] == SHARDS
              and info["psums_per_batch"] == psums,
              f"/info on the interval engine: {status} {info}")
        pay = server._result_payload
        for (_, path, _), (status, body) in zip(reqs[1:], got[1:]):
            mode = path[1:path.index("?")]
            k = path[path.index("=") + 1 : path.index("&")]
            r = (eng.count_batch([k], both_strands=True)[0] if mode == "count"
                 else eng.query_batch([k], both_strands=True)[0])
            check(status == 200 and body == pay(r, mode, False),
                  f"REST {path} on the interval engine differs")
        log(f"REST over the interval engine: /info (sharding interval, "
            f"{SHARDS} shards, psums_per_batch {info['psums_per_batch']}) "
            f"and {len(reqs) - 1} query requests answered as the engine "
            f"answers")
    launches = read_launches("interval")
    for name in ("sharded_search", "sharded_lut_level", "sharded_resolve",
                 *COMPACT_KERNELS):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the interval path")
    check(launches["shard_occ"] == 0, "K9's generic entry launched on the "
          "interval path")
    single = {n: c for n, c in launches.items()
              if not n.startswith("shard") and n not in COMPACT_KERNELS}
    check(not any(single.values()), f"single-device kernels launched on the "
          f"interval path: {single}")
    check(plain["n"] == 0, f"{plain['n']} plain forms of ops ran on the card "
          "on the interval path")
    log("no plain form of ops ran on a CUDA tensor on the interval path; "
        "launches of K14 and K15 there: "
        + ", ".join(f"{n} {launches[n]}" for n in COMPACT_KERNELS))
    return engines, ceng_s, capped


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def post_batch(port: int, kms: list[str], mode: str, both: bool) -> list:
    """One ``/batch`` request to a local REST front → its results."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/batch", method="POST",
        data=json.dumps({"kmers": kms, "mode": mode,
                         "both_strands": both}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())["results"]


def start_rank_group(cache: Path, port: int, logs: Path,
                     doc: bool = False, repo: Path = REPO) -> list:
    """Phase 13 (b)'s group: two ``cli serve --coordinator`` ranks sharing
    the card over gloo (NCCL refuses two ranks on one device), SHARDS
    interval shards over them, rank 0 fronting REST on ``port`` → the
    processes, their output in ``logs``.  ``doc``: phase 14 (b)'s, the
    cohort directory ``cache`` as doc shards, SHARDS // 2 a rank.  ``repo``:
    the checkout whose package the ranks run."""
    coord = free_port()
    argv = [sys.executable, "-m", "readserver_tpu_torch.cli", "serve",
            "--index", str(cache), "--port", str(port), "--batch", "8192",
            "--warmup-k", str(KMER),
            *([] if doc else ["--shards", str(SHARDS)]),
            "--device", "cuda:0", "--backend", "gloo",
            "--coordinator", f"127.0.0.1:{coord}", "--num-processes", "2"]
    logs.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(argv + ["--process-id", str(i)], cwd=repo,
                             stdout=open(logs / f"rank{i}.log", "w"),
                             stderr=subprocess.STDOUT)
            for i in (0, 1)]


def stop_rank_group(procs, logs: Path, sig_first: bool) -> list[int]:
    """SIGINT rank 0 (it stops its follower) and wait for both; kill what
    is left after 180 s → their exit codes."""
    import signal

    if sig_first and procs[0].poll() is None:
        procs[0].send_signal(signal.SIGINT)
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=180))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    for i in range(len(procs)):
        tail = (logs / f"rank{i}.log").read_text().strip().splitlines()[-3:]
        log(f"rank {i} exit {codes[i]}: {' | '.join(tail)[-600:]}")
    return codes


def serve_ranks(packed, cache, cpacked, cfg, dev, qs, served, reads_served,
                engines11, ceng_s, capped11, c256, c4096, zero_launches,
                read_launches, card):
    """Phase 13: interval shards across the ranks of a process group.
    (b)'s two ranks start first, in their own processes (loading and
    building beside (a)).  (a), counted from 0: this process joins an NCCL
    group of one and serves E. coli in SHARDS shards through the
    cross-rank program, forced per step (``make_global_mesh(...,
    per_step=True)``), one engine per route: K11's partial LUT equal to
    phase 11's, the counts of phases 4-5 and the ``/reads`` of phase 8 on
    each route, the cohort's exact ``/samples`` equal to phase 11's cohort
    engine, and a batch's all-reduces equal to ``query_psum_estimate`` on
    each route, and the cohort's capped ``/samples`` equal to phase 11's
    (:func:`serve_capped`); only K9's partial, K13, K11's partial, the walk
    steps, K14 and K15 may launch, and no plain form of ops on a CUDA
    tensor.  (b): the same answers over REST
    from the two ranks' rank 0, then a clean stop of the follower → (the
    (a) engines by route, the all-reduce counts)."""
    import torch
    from readserver_tpu_torch.ops import sharded as sops
    from readserver_tpu_torch.parallel import make_sharded_query_fn
    from readserver_tpu_torch.parallel import multihost as mh
    from readserver_tpu_torch.parallel.stats import query_psum_estimate
    from readserver_tpu_torch.serve import Dispatcher, QueryEngine
    from readserver_tpu_torch.serve.http import RestServer

    rest = free_port()
    logs = REPO / "data" / "chip_smoke" / "rank_logs"
    t_group = time.perf_counter()
    procs = start_rank_group(cache, rest, logs)
    try:
        # the references first, outside the counted window
        ckms = {"256": (decode_all(c256), False),
                "4096x2": (decode_all(c4096), True)}
        key = lambda r: (r.count, r.sample_hist, r.sample_hist_complete)  # noqa: E731
        cwant = {name: [key(r) for r in ceng_s.query_batch(
            kms, both_strands=both, include_hits=False)]
            for name, (kms, both) in ckms.items()}
        t0 = time.perf_counter()
        mh.init_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
        mesh = mh.make_global_mesh(SHARDS, device=dev, per_step=True)
        log(f"NCCL group of 1 up in {time.perf_counter() - t0:.3f}s; mesh "
            f"{mesh.shape}, ranks {mesh.ranks}, per step")
        zero_launches()
        scfg = dataclasses.replace(cfg, num_shards=SHARDS)
        engines = {}
        reduces = {}
        split = {}
        with plain_calls_on_card() as plain:
            for route, drop in ROUTE_DROPS.items():
                t0 = time.perf_counter()
                e = QueryEngine(dataclasses.replace(packed, **drop), scfg,
                                mesh, device=dev)
                st = e.startup_seconds
                log(f"cross-rank engine, {route} route, up in "
                    f"{time.perf_counter() - t0:.3f}s: build_sharded (host) "
                    f"{st['build_sharded']:.3f}s, placement {st['ship']:.3f}s"
                    f", prefix LUT p={e.lut_p} through K11's partial "
                    f"{st['lut']:.3f}s")
                check(torch.equal(e.lut, engines11[route].lut),
                      f"K11's partial LUT ({route}) differs from phase 11's")
                t0 = time.perf_counter()
                e.warmup()
                log(f"warmup in {time.perf_counter() - t0:.3f}s")
                engines[route] = e
                for name, q, both in qs:
                    kms = decode_all(q)
                    if route == "dsa":
                        t0 = time.perf_counter()
                        res = e.count_batch(kms, both_strands=both)
                        dt = time.perf_counter() - t0
                        check(np.array_equal([r.count for r in res],
                                             served[name]),
                              f"cross-rank counts of {name} differ")
                        log(f"count request of {name}: {dt * 1e3:.3f} ms, "
                            f"equal to phases 4-5's")
                    t0 = time.perf_counter()
                    got = e.query_batch(kms, both_strands=both)
                    dt = time.perf_counter() - t0
                    check(got == reads_served[name], f"cross-rank /reads of "
                          f"{name} on the {route} route differ")
                    log(f"/reads request of {name}, {route} route: "
                        f"{dt * 1e3:.3f} ms, equal to phase 8's")
                # a batch's all-reduces, early exits and sweep off, against
                # the JAX program's psums
                s = e.sidx
                ce, le, nq = e._pad_encode(decode_all(q256_of(qs)))
                codes, lengths = e._to_device(ce, le)
                fn = make_sharded_query_fn(s, mesh, max_hits=e.H,
                                           lut_p=e.lut_p, kstep=3)
                mh.COLLECTIVES["all_reduce"] = 0
                fn(s, e.lut, codes, lengths)
                n_red = mh.COLLECTIVES["all_reduce"]
                est = query_psum_estimate(
                    codes.shape[1], lut_p=e.lut_p, kstep=3,
                    sample_rate=s.sample_rate,
                    fast_resolve=s.has_fast_resolve,
                    max_read_len=s.max_read_len,
                    direct_resolve=s.dsa_chunk is not None)
                reduces[route] = dict(counted=n_red, estimate=est)
                check(n_red == est["total"], f"{route}: {n_red} all-reduces "
                      f"a batch, the estimate {est}")
                log(f"{route} route: {n_red} all-reduces a batch of "
                    f"{codes.shape[0]} ({codes.shape[1]}-mers, LUT p="
                    f"{e.lut_p}, k-step 3) = query_psum_estimate {est}")
            t0 = time.perf_counter()
            ce_r = QueryEngine(cpacked, scfg, mesh, device=dev)
            log(f"cross-rank cohort engine up in "
                f"{time.perf_counter() - t0:.3f}s")
            for name, (kms, both) in ckms.items():
                t0 = time.perf_counter()
                got = ce_r.query_batch(kms, both_strands=both,
                                       include_hits=False)
                dt = time.perf_counter() - t0
                check([key(r) for r in got] == cwant[name],
                      f"cross-rank /samples of {name} differ")
                log(f"/samples request of {name} cohort queries: "
                    f"{dt * 1e3:.3f} ms, exact histograms equal to phase "
                    f"11's")
            got = serve_capped(cpacked, scfg, mesh, dev, ckms["256"][0],
                               capped11, "cross-rank cohort engine")
            check(got == capped11, "cross-rank capped /samples differ from "
                  "phase 11's")
            # where a world-of-one /reads of 4096 x 2 spends its time, by
            # route, and every step of the lf and slow routes in the trace
            for route, e in engines.items():
                exp, _ = e._expand_rc(decode_all(qs[2][1]))
                ce, le, nq = e._pad_encode(exp)
                split[route] = cross_rank_split(
                    lambda e=e, ce=ce, le=le, nq=nq: e._sharded_program(
                        ce, le, nq, None),
                    f"/reads of 4096 x 2 ({nq} searched), {route} route, "
                    f"world of one (NCCL)", card,
                    check_steps=route != "dsa")
        launches = read_launches("ranks")
        for name in (*RANK_KERNELS, *COMPACT_KERNELS):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the cross-rank path")
        other = {n: c for n, c in launches.items()
                 if n not in RANK_KERNELS and n not in COMPACT_KERNELS}
        check(not any(other.values()), f"other kernels launched on the "
              f"cross-rank path: {other}")
        check(plain["n"] == 0, f"{plain['n']} plain forms of ops ran on "
              "the card on the cross-rank path")
        log("no single-device kernel but K14 and K15, no fused sharded "
            "kernel and no plain form of ops ran on the cross-rank path; "
            "launches of K14 and K15 there: "
            + ", ".join(f"{n} {launches[n]}" for n in COMPACT_KERNELS))
        pay = RestServer(Dispatcher(engines["dsa"]), "127.0.0.1", 0)
        pay = pay._result_payload
        samples_want = [pay(r, "samples", False) for r in engines[
            "dsa"].query_batch(decode_all(qs[1][1]), include_hits=False)]
        del ce_r
        # (b): the two ranks' REST front
        import urllib.request

        deadline = time.perf_counter() + 600
        up = False
        while not up and time.perf_counter() < deadline:
            check(all(p.poll() is None for p in procs),
                  "a rank of the group exited before serving: "
                  + (logs / "rank0.log").read_text()[-2000:]
                  + (logs / "rank1.log").read_text()[-2000:])
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{rest}/health", timeout=5) as r:
                    up = r.status == 200
            except OSError:
                time.sleep(1.0)
        check(up, "the group's REST front never came up")
        log(f"2-rank group (gloo, {SHARDS // 2} shards a rank, sharing the "
            f"card) serving after {time.perf_counter() - t_group:.3f}s")
        with urllib.request.urlopen(f"http://127.0.0.1:{rest}/info",
                                    timeout=60) as r:
            info = json.loads(r.read())
        check(info["sharding"] == "interval"
              and info["num_shards"] == SHARDS, f"/info: {info}")
        for name, q, both in qs:
            t0 = time.perf_counter()
            got = post_batch(rest, decode_all(q), "count", both)
            dt = time.perf_counter() - t0
            check([r["count"] for r in got] == served[name].tolist(),
                  f"the group's /count of {name} differs")
            log(f"group /batch count of {name}: {dt * 1e3:.3f} ms")
        for name, q, both in qs[:2]:
            t0 = time.perf_counter()
            got = post_batch(rest, decode_all(q), "reads", both)
            dt = time.perf_counter() - t0
            check(got == [json.loads(json.dumps(pay(r, "reads", False)))
                          for r in reads_served[name]],
                  f"the group's /reads of {name} differ")
            log(f"group /batch reads of {name}: {dt * 1e3:.3f} ms, equal "
                f"to phase 8's | {card}")
        t0 = time.perf_counter()
        got = post_batch(rest, decode_all(qs[1][1]), "samples", False)
        dt = time.perf_counter() - t0
        check(got == json.loads(json.dumps(samples_want)),
              "the group's /samples differ")
        log(f"group /batch samples of 256: {dt * 1e3:.3f} ms")
        t0 = time.perf_counter()
        got = post_batch(rest, decode_all(qs[2][1]), "reads", True)
        log(f"group /batch reads of 4096x2 (one tick of 8192): "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms | {card}")
    finally:
        rcs = stop_rank_group(procs, logs, sig_first=True)
    check(rcs == [0, 0], f"the group did not stop cleanly: exit {rcs}")
    log("SIGINT on rank 0 stopped its follower; both ranks exited 0")
    return engines, reduces, split


# the kernels of the cross-rank path (phase 13)
RANK_KERNELS = ("shard_occ_partial", "shard_lookup_partial",
                "sharded_lut_level_partial", "walk_lf_step", "walk_slow_step")
# their device functions' names, as the profiler shows them (this
# checkout's and those of earlier checkouts of the partials alike)
RANK_KERNEL_FUNCS = ("occ_partial_kernel", "lookup_partial_kernel",
                     "lut_level_partial_kernel", "lf_step_kernel",
                     "slow_step_kernel")


def cross_rank_split(program, what: str, card: str, check_steps: bool = False,
                     log_it: bool = True) -> dict:
    """Where one cross-rank batch ``program()`` spends its time, from the
    profiler's trace of one call after a warm one: the batch's wall time
    (host clock), its all-reduces and the host time inside them, the
    device time of the partial and walk-step kernels, of NCCL's and of
    torch's own kernels, the host's waits for the stream, and the host time
    between steps (wall less the all-reduces' host time), each also a step.
    With ``check_steps``, the trace check: every two all-reduces have
    exactly one kernel launch between them and no torch op, but where a
    walk begins (its lanes are set up in torch, then its first step
    launches) (read from the launch counters at each all-reduce and the
    profiler's ``aten::`` events between the all-reduces' spans) → the
    split."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from readserver_tpu_torch.kernels import KERNELS
    from readserver_tpu_torch.ops import sharded as sops
    from readserver_tpu_torch.parallel import sharded as psh

    orig, orig_state = psh.all_reduce, getattr(sops, "walk_state", None)
    counts, starts = [], set()

    def traced(t, group):
        counts.append({n: k.launches for n, k in KERNELS.items()})
        with record_function("rs_all_reduce"):
            return orig(t, group)

    def walk_state(*a, **kw):
        starts.add(len(counts) - 1)  # the window before the walk's first
        return orig_state(*a, **kw)

    program()
    torch.cuda.synchronize()
    psh.all_reduce = traced
    if orig_state is not None:
        sops.walk_state = walk_state
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("rs_batch"):
                program()
                torch.cuda.synchronize()
    finally:
        psh.all_reduce = orig
        if orig_state is not None:
            sops.walk_state = orig_state
    ev = prof.events()
    cpu = [e for e in ev if e.device_type == DeviceType.CPU]
    batch = next(e.time_range for e in cpu if e.name == "rs_batch")
    ars = sorted((e.time_range for e in cpu if e.name == "rs_all_reduce"),
                 key=lambda r: r.start)
    gpu = [e for e in ev if e.device_type == DeviceType.CUDA
           and batch.start <= e.time_range.start <= batch.end
           and e.name not in ("rs_batch", "rs_all_reduce")]  # annotations
    mine = [e for e in gpu if any(f in e.name for f in RANK_KERNEL_FUNCS)]
    nccl = [e for e in gpu if "nccl" in e.name.lower()]
    waits = [e for e in cpu if "Synchronize" in e.name
             and batch.start <= e.time_range.start <= batch.end]
    us = lambda es: sum(e.self_device_time_total for e in es)  # noqa: E731
    wall = (batch.end - batch.start) / 1e3
    ar_host = sum(r.end - r.start for r in ars) / 1e3
    n = max(len(ars), 1)
    out = dict(
        wall_ms=wall, all_reduces=len(ars), all_reduce_host_ms=ar_host,
        kernel_device_ms=us(mine) / 1e3, kernel_launches=len(mine),
        nccl_device_ms=us(nccl) / 1e3,
        torch_device_ms=(us(gpu) - us(mine) - us(nccl)) / 1e3,
        sync_wait_ms=sum(e.time_range.end - e.time_range.start
                         for e in waits) / 1e3,
        host_between_ms=wall - ar_host, walks=len(starts))
    by_name = {}
    for e in gpu:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.self_device_time_total / 1e3, c + 1)
    out["top_device"] = [(k[:60], round(t, 4), c) for k, (t, c) in sorted(
        by_name.items(), key=lambda kv: -kv[1][0])[:6]]
    for k in ("wall_ms", "all_reduce_host_ms", "kernel_device_ms",
              "host_between_ms", "sync_wait_ms"):
        out[k.replace("_ms", "_ms_a_step")] = out[k] / n
    if check_steps:
        aten = sorted(e.time_range.start for e in cpu
                      if e.name.startswith("aten::"))
        steps, bad = 0, []
        for i in range(len(ars) - 1):
            if i in starts:
                continue
            d = {k: counts[i + 1][k] - counts[i][k] for k in counts[i]}
            d = {k: v for k, v in d.items() if v}
            ops = sum(ars[i].end <= a <= ars[i + 1].start for a in aten)
            steps += 1
            if sum(d.values()) != 1 or ops:
                bad.append((i, d, ops))
        out["steps_checked"] = steps
        out["steps_bad"] = bad[:5]
        check(not bad and steps and starts, f"{what}: a step ran other than "
              f"one launch between two all-reduces: {bad[:5]}")
    if log_it:
        log(f"{what}: one batch in {wall:.3f} ms (host clock, profiled): "
            f"{len(ars)} all-reduces, {ar_host:.3f} ms of host time in them"
            f" ({out['all_reduce_host_ms_a_step']:.4f} a step); the partial"
            f" and walk-step kernels {out['kernel_device_ms']:.3f} ms on the"
            f" card ({len(mine)} launches seen, "
            f"{out['kernel_device_ms_a_step']:.4f} a step), NCCL "
            f"{out['nccl_device_ms']:.3f}, torch's kernels "
            f"{out['torch_device_ms']:.3f}; waits for the stream "
            f"{out['sync_wait_ms']:.3f} ms; host between the all-reduces "
            f"{out['host_between_ms']:.3f} ms "
            f"({out['host_between_ms_a_step']:.4f} a step)"
            + ("" if not check_steps else
               f"; {out['steps_checked']} steps (search and {len(starts)} "
               f"walks) each one launch and no torch op between two "
               f"all-reduces") + f"; top device time (ms, launches): "
            f"{out['top_device']} | {card}")
    return out


# phase 14's routes: the tiers stripped from the partitions (a route of
# bench/multihost_bench.DOC_STRIP, the JAX rules choosing the walk: lf
# outranks fused, and the mark table ships only with lf), whether the
# engine attributes exactly, and the walk the shards must take
DOC_ROUTES = {
    "dsa": ("dsa", True, "dsa"),
    "fused": ("fused", True, "fused"),
    "lf": ("lf", True, "lf"),
    "fused, capped": ("fused", False, "fused"),
}


def wait_rest(procs, rest: int, logs: Path) -> None:
    """Wait (at most 600 s) until a group's rank 0 answers ``/health``."""
    import urllib.request

    deadline = time.perf_counter() + 600
    while time.perf_counter() < deadline:
        check(all(p.poll() is None for p in procs),
              "a rank of the group exited before serving: "
              + (logs / "rank0.log").read_text()[-2000:]
              + (logs / "rank1.log").read_text()[-2000:])
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{rest}/health", timeout=5) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(1.0)
    check(False, "the group's REST front never came up")


def doc_collectives(args, scache: Path, e, card: str) -> dict:
    """Phase 14 (b): the doc program over two gloo ranks sharing the card
    (``bench/multihost_bench.py --doc-shards``, a process each, the
    cohort directory's shards, 2 a rank) on a batch of 8192 → its answers
    equal to the world of one's (``e``'s program on the same batch), one
    all-reduce and one gather a batch on each rank, and each collective's
    time and bytes at the served shapes."""
    import torch
    from readserver_tpu_torch.parallel import make_doc_query_fn

    out = REPO / "data" / "chip_smoke" / "doc_ranks"
    out.mkdir(parents=True, exist_ok=True)
    spec = "route=dsa,kstep=3,lut=0"
    coord = free_port()
    argv = [sys.executable, "-m", "readserver_tpu_torch.bench.multihost_bench",
            "--coordinator", f"127.0.0.1:{coord}", "--num-processes", "2",
            "--backend", "gloo", "--device", "cuda:0", "--config", "cohort",
            "--scale", f"{args.scale:g}", "--index", str(scache),
            "--doc-shards", str(SHARDS), "--batch", "8192", "--max-hits",
            str(e.H), "--heartbeat-timeout", "300", "--dump", str(out),
            "--case", spec]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv + ["--process-id", str(i)], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    check([p.returncode for p in procs] == [0, 0],
          f"the doc worker ranks failed: {[o[-2000:] for o in outs]}")
    name = "routedsa_kstep3_lut0_budget0_exact0"
    glob = dict(np.load(out / f"{name}_global.npz"))
    want = make_doc_query_fn(e.didx_plain, e.mesh, max_hits=e.H)(
        e.didx_plain, glob["codes"], glob["lengths"], kstep=e.has_pair)
    for k, v in want.items():
        check(np.array_equal(v.cpu().numpy(), glob[k]),
              f"2 gloo ranks' doc program differs from the world of one "
              f"on {k}")
    ranks = [dict(np.load(out / f"{name}_rank{i}.npz")) for i in (0, 1)]
    for i, r in enumerate(ranks):
        check(int(r["all_reduce"]) == 1 and int(r["gather"]) == 1
              and int(r["shards"]) == SHARDS // 2,
              f"rank {i}: {int(r['all_reduce'])} all-reduces and "
              f"{int(r['gather'])} gathers a batch, {int(r['shards'])} "
              f"shards")
    got = {k: float(np.median([float(r[k]) for r in ranks]))
           for k in ("gather_ms", "allreduce_ms")}
    got.update(gather_bytes=int(ranks[0]["gather_bytes"]),
               allreduce_bytes=int(ranks[0]["allreduce_bytes"]))
    log(f"2 gloo ranks on the card, {SHARDS // 2} doc shards each, a batch "
        f"of {glob['codes'].shape[0]} ({time.perf_counter() - t0:.3f}s "
        f"with start-up): answers equal to the world of one; one "
        f"all-reduce and one gather a batch on each rank; the hit-set "
        f"gather {got['gather_bytes']} B in {got['gather_ms']:.3f} ms, "
        f"the all-reduce of the partials {got['allreduce_bytes']} B in "
        f"{got['allreduce_ms']:.3f} ms (median of 10, host clock) | {card}")
    del torch
    return got


def serve_doc(args, cohort, meng, ceng, cfg, dev, c256, c4096, want_c,
              zero_launches, read_launches, card):
    """Phase 14: the cohort in SHARDS doc shards (phase 9b's partitions)
    through the doc-sharded ``QueryEngine``.  (b)'s group starts first, in
    its own processes.  References, before the counts are zeroed: phase
    9b's ``MultiEngine`` front and phase 9's monolithic engine.  (a), a
    world of one over the NCCL group of one of phase 13: one engine per
    route of ``DOC_ROUTES`` serves ``/reads`` and ``/count`` of 256 and
    4096 x 2 queries (width 8192, H = 64), each batch one all-reduce;
    answers equal across the routes, to the front (counts, hit lists,
    truncation; histograms and their completeness where exact) and to the
    monolithic engine (counts; histograms where exact), and 96 queries to
    the windows; K14 and K15 must launch with the other one-device
    kernels, and no plain form of ops. (b): two ``cli serve
    --coordinator`` ranks on the cohort directory answer ``/batch`` as
    (a)'s dsa engine, then stop on SIGINT; the doc program over two gloo
    worker ranks (``doc_collectives``). → (the engines by route, the
    collectives' readings)."""
    import torch
    from readserver_tpu_torch.bench.multihost_bench import strip_route
    from readserver_tpu_torch.ops import resolve
    from readserver_tpu_torch.parallel import multihost as mh
    from readserver_tpu_torch.serve import Dispatcher, QueryEngine
    from readserver_tpu_torch.serve.http import RestServer

    H = cfg.max_hits
    parts = meng.partitions
    scache = REPO / "data" / "chip_smoke" / f"cohort{SHARDS}_s{args.scale:g}"
    rest = free_port()
    logs = REPO / "data" / "chip_smoke" / "doc_logs"
    t_group = time.perf_counter()
    procs = start_rank_group(scache, rest, logs, doc=True)
    try:
        reqs = {"256": (decode_all(c256), False),
                "4096x2": (decode_all(c4096), True)}
        front = {n: meng.query_batch(k, both_strands=b)
                 for n, (k, b) in reqs.items()}
        mono = {n: ceng.query_batch(k, both_strands=b, include_hits=False)
                for n, (k, b) in reqs.items()}
        fwd96 = decode_all(c256[:96])
        mesh = mh.make_global_mesh(SHARDS, device=dev)
        check(mesh.ranks["shard"] == 1 and mesh.shard_group is not None,
              f"not a world of one over NCCL: {mesh}")
        zero_launches()
        engines, answers = {}, {}
        hkey = lambda r: (r.count, r.hits, r.hits_truncated)  # noqa: E731
        skey = lambda r: (r.sample_hist, r.sample_hist_complete)  # noqa: E731
        with plain_calls_on_card() as plain:
            for route, (strip, exact, kind) in DOC_ROUTES.items():
                t0 = time.perf_counter()
                e = QueryEngine(
                    strip_route(parts, strip),
                    dataclasses.replace(cfg, exact_attribution=exact), mesh,
                    device=dev)
                up = time.perf_counter() - t0
                e.warmup()
                check({resolve.walk_kind(x) for x in e.didx.shards}
                      == {kind}, f"the {route} route's shards do not walk "
                      f"{kind}")
                log(f"doc engine, {route} route: up in {up:.3f}s (shards "
                    f"and LUTs p={e.lut_p} through K1's level entry "
                    f"{e.startup_seconds['ship']:.3f}s), warm in "
                    f"{time.perf_counter() - t0 - up:.3f}s; walk {kind}, "
                    f"tiers {sorted(e.didx.tiers)}, row budget per shard "
                    f"{int(cfg.resolve_budget_frac * e.B * H)}")
                engines[route] = e
                for name, (kms, both) in reqs.items():
                    n0 = mh.COLLECTIVES["all_reduce"]
                    t0 = time.perf_counter()
                    got = e.query_batch(kms, both_strands=both)
                    dt = time.perf_counter() - t0
                    check(mh.COLLECTIVES["all_reduce"] == n0 + 1,
                          f"{route}: {mh.COLLECTIVES['all_reduce'] - n0} "
                          f"all-reduces for a batch")
                    counts = e.count_batch(kms, both_strands=both)
                    check([r.count for r in counts]
                          == [r.count for r in got], f"{route}: /count and "
                          f"/reads counts of {name} differ")
                    check([hkey(r) for r in got]
                          == [hkey(r) for r in front[name]],
                          f"{route}: the hits of {name} differ from the "
                          f"cohort front's")
                    check([r.count for r in got]
                          == [r.count for r in mono[name]],
                          f"{route}: the counts of {name} differ from the "
                          f"monolithic engine's")
                    if exact:
                        check([skey(r) for r in got]
                              == [skey(r) for r in front[name]]
                              and [r.sample_hist for r in got]
                              == [r.sample_hist for r in mono[name]],
                              f"{route}: the histograms of {name} differ")
                    elif not both:  # the strand fold drops the flag
                        check(all(r.sample_hist_complete == (r.count <= H)
                                  for r in got),
                              f"{route}: capped completeness of {name}")
                    answers[route, name] = got
                    log(f"/reads of {name} ({route}): {dt * 1e3:.3f} ms, one "
                        f"all-reduce, equal to the cohort front and the "
                        f"monolithic engine | {card}")
                res = e.query_batch(fwd96)
                for r, w in zip(res, want_c):
                    check(r.count == len(w), f"{r.kmer}: count against the "
                          f"windows")
                    if not r.hits_truncated:
                        check(sorted((h["read_id"], h["offset"])
                                     for h in r.hits) == sorted(w),
                              f"{r.kmer}: hit set against the windows")
                    if exact:
                        rids = np.fromiter((x for x, _ in w), np.int64)
                        per = np.bincount(cohort.sample_ids[rids],
                                          minlength=128)
                        check(r.sample_hist == {
                            e.sample_names[j]: int(c)
                            for j, c in enumerate(per) if c},
                            f"{r.kmer}: histogram against the windows")
            for route in DOC_ROUTES:
                for name in reqs:
                    check([hkey(r) for r in answers[route, name]]
                          == [hkey(r) for r in answers["dsa", name]],
                          f"the dsa and {route} routes disagree on {name}")
        launches = read_launches("doc")
        for name in ("lut_level", "backward_search", "resolve_dsa",
                     "resolve_fused", "resolve_walk", "exact_histogram",
                     "row_compact", "row_gather", "capped_histogram"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the doc path")
        other = {n: c for n, c in launches.items()
                 if n == "rank_occ" or n.startswith(("shard", "walk"))}
        check(not any(other.values()),
              f"kernels of no doc route launched: {other}")
        check(plain["n"] == 0, f"{plain['n']} plain forms of ops ran on "
              "the card on the doc path")
        log("96 queries against the windows on every route; K14, K15 and "
            "the one-device kernels launched, no plain form of ops ran on "
            "a CUDA tensor on the doc path")
        # the merge's all-reduce over NCCL in the group of one, at the
        # served shape: count | histogram | complete as int64
        e = engines["dsa"]
        part = torch.zeros(8192 * (e._ns + 2), dtype=torch.int64, device=dev)
        ar = lambda: mh.all_reduce(part, mesh.shard_group)  # noqa: E731
        ar()
        nccl_ms = float(np.median([time_cuda(ar, 20) for _ in range(3)]))
        log(f"the doc merge's all-reduce, NCCL group of one, {part.nbytes} B:"
            f" {nccl_ms:.4f} ms (CUDA events) | {card}")
        # (b) the two ranks' REST front over the cohort directory
        wait_rest(procs, rest, logs)
        log(f"2-rank doc group (gloo, {SHARDS // 2} doc shards a rank, "
            f"sharing the card) serving after "
            f"{time.perf_counter() - t_group:.3f}s")
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{rest}/info",
                                    timeout=60) as r:
            info = json.loads(r.read())
        check(info["sharding"] == "document"
              and info["num_reads"] == len(cohort.reads), f"/info: {info}")
        pay = RestServer(Dispatcher(e), "127.0.0.1", 0)._result_payload
        for name, (kms, both) in reqs.items():
            for mode in ("count", "reads", "samples"):
                t0 = time.perf_counter()
                got = post_batch(rest, kms, mode, both)
                dt = time.perf_counter() - t0
                want = answers["dsa", name]
                if mode == "count":
                    want = e.count_batch(kms, both_strands=both)
                check(got == [json.loads(json.dumps(pay(r, mode, False)))
                              for r in want],
                      f"the doc group's /{mode} of {name} differs from (a)")
                log(f"doc group /batch {mode} of {name}: {dt * 1e3:.3f} ms,"
                    f" equal to (a) | {card}")
    finally:
        rcs = stop_rank_group(procs, logs, sig_first=True)
    check(rcs == [0, 0], f"the doc group did not stop cleanly: exit {rcs}")
    log("SIGINT on rank 0 stopped its follower; both ranks exited 0")
    coll = doc_collectives(args, scache, engines["dsa"], card)
    coll["nccl_allreduce_ms"] = nccl_ms
    coll["nccl_allreduce_bytes"] = int(part.nbytes)
    return engines, coll


def interval_torch_ops(l, u, H: int, R: int, rid_c, off_c, smp_c, S: int):
    """The interval programs' compaction, scatter back and capped
    histogram as torch ops, as ``parallel/sharded.py`` ran them before K14
    and K15 served them (the JAX ``_query_body``, 902-942, op for op), on
    int64 intervals and the walk's answers → (read_id, offset, valid,
    hist)."""
    import torch
    from readserver_tpu_torch.ops import resolve

    B = l.shape[0]
    F = B * H
    dev = l.device
    span = torch.arange(H, dtype=torch.int64, device=dev)
    rows = (l[:, None] + span[None, :]).reshape(-1)
    valid = (span[None, :] < (u - l)[:, None]).reshape(-1)
    rows = torch.where(valid, rows, torch.zeros_like(rows))
    _, _, orig, keep = resolve.compact_rows(rows, valid, R)
    full = torch.full((F + 1,), -1, dtype=torch.int32, device=dev)
    read_id = full.scatter(0, orig, rid_c)[:F]
    offset = full.scatter(0, orig, off_c)[:F]
    sample = torch.zeros(F + 1, dtype=torch.int32, device=dev).scatter(
        0, orig, smp_c)[:F]
    valid_w = valid & keep
    seg = torch.arange(B, dtype=torch.int64, device=dev).repeat_interleave(
        H) * S + sample.to(torch.int64)
    hist = torch.zeros(B * S, dtype=torch.int32, device=dev)
    hist.index_add_(0, seg, valid_w.to(torch.int32))
    return (read_id.reshape(B, H), offset.reshape(B, H),
            valid_w.reshape(B, H), hist.reshape(B, S))


def interval_kernel_ops(l, u, H: int, R: int, rid_c, off_c, smp_c, S: int):
    """The same through K14's int64 entry with the walk's sample column
    and K15's sample mode (``parallel/sharded._hit_lanes``)."""
    from readserver_tpu_torch.ops import resolve

    _, _, prefix = resolve.compact_lanes(l, u, H, R)
    rid, off, smp, valid = resolve.gather_lanes(l, u, H, R, prefix, rid_c,
                                                off_c, smp_c=smp_c)
    return rid, off, valid, resolve.lane_histogram(smp, valid, S)


def time_ops(sets, fn, what: str, card: str, kernels_ms=None):
    """Torch ops ``fn(*x)`` over the input ``sets`` in turn: the call's
    time (CUDA events, median of 3 passes) and its device time over every
    op (profiler), logged beside ``kernels_ms``, the device time of the
    kernels that replace them → (ms, device ms)."""
    import torch

    turn = itertools.cycle(sets)
    call = lambda: fn(*next(turn))  # noqa: E731
    call()
    torch.cuda.synchronize()
    iters = max(len(sets), N_ROT)
    ms = float(np.median([time_cuda(call, iters) for _ in range(3)]))
    dev_ms = kernel_device_ms(call, iters, "")
    log(f"replaced torch ops, {what} ({len(sets)} distinct input sets in "
        f"turn): {ms:.4f} ms a call (CUDA events), device {fmt_ms(dev_ms)} "
        f"ms over its ops (profiler), against the kernels' "
        f"{fmt_ms(kernels_ms)} ms | {card}")
    return ms, dev_ms


def time_compaction(engine_f, intervals, makers, H: int, card: str,
                    library: dict) -> dict:
    """Phase 7: K14 (its compaction and its gather back, around K6's walk
    of the fused engine; the gather also with the hit step's
    ``read_to_sample`` column) and K15 (the capped histogram of the lanes
    it gives back) at width 8192 and at the full budget, each over
    distinct input sets in turn (``makers[what](j)``: the j-th batch of
    queries), as many as together need twice the L2
    (:func:`time_cases`): wrapper ms (CUDA events), device ms (profiler),
    the plain forms' ms, bytes bound (each input read once, each output
    written once, each ``read_to_sample`` entry once; K15 reads a lane's
    id or sample only where its flag is set, so its ids count on the
    walked slots alone); and, beside them
    over the same sets, the torch ops they replaced (``compact_rows`` and
    the scatters back; the hit step's clipped gather and ``torch.where``s;
    the gather and ``index_add_``), and at width 8192 the library
    yardstick of the compaction (a ``nonzero_static`` of the lanes' valid
    mask, into ``library["row_compact"]``) → summary entries by name
    (width 8192) and by name and " (full budget)" (the column's ", full
    budget")."""
    import torch
    from readserver_tpu_torch.ops import resolve

    out = {}
    idx = engine_f.index
    R = engine_f.row_budget
    S = max(idx.num_samples, 1)
    r2s, m = idx.read_to_sample, idx.num_reads
    for what, make in makers.items():
        def lanes(j):
            l, u = intervals(engine_f, make(j))
            rows_c, valid_c, prefix = resolve.compact_lanes(l, u, H, R)
            rid_c, off_c = resolve.resolve_rows_fused(idx, rows_c, valid_c)
            rid, _, kept = resolve.gather_lanes(l, u, H, R, prefix, rid_c,
                                                off_c)
            return l, u, prefix, rid_c, off_c, rid, kept

        sets, _, _ = in_turn(lanes, lambda *x: (
            8 * x[0].shape[0] + 4 * (x[0].shape[0] + 1) + 5 * R, None))
        B = sets[0][0].shape[0]
        F = B * H
        slots = int(np.mean([min(int(x[2][-1]), R) for x in sets]))
        hits = int(np.mean([distinct(x[5][x[6]]) for x in sets]))
        gather = lambda col: lambda l, u, p, rc, oc, *_: (  # noqa: E731
            resolve.gather_lanes(l, u, H, R, p, rc, oc, **col))
        gather_plain = lambda col: lambda l, u, p, rc, oc, *_: (  # noqa: E731
            resolve.gather_lanes_plain(l, u, H, R, p, rc, oc, **col))
        col = dict(read_to_sample=r2s, num_reads=m)
        shape = f"{what}: {F} lanes, budget {R}, {slots} slots walked (mean)"
        cases = [
            ("row_compact", "row_compact",
             lambda l, u, *_: resolve.compact_lanes(l, u, H, R),
             lambda l, u, *_: resolve.compact_lanes_plain(l, u, H, R), sets,
             shape, 8 * B + 4 * (B + 1) + 5 * R, None),
            ("row_gather", "row_gather", gather({}), gather_plain({}), sets,
             shape, 4 * (B + 1) + 8 * slots + 9 * F, None),
            ("row_gather (read_to_sample)", "row_gather", gather(col),
             gather_plain(col), sets, shape + ", the hit step's sample "
             "column", 4 * (B + 1) + 8 * slots + 4 * hits + 13 * F,
             None),
            ("capped_histogram", "capped_hist",
             lambda *x: resolve.sample_histogram(idx, x[5], x[6]),
             lambda *x: resolve.sample_histogram_plain(idx, x[5], x[6]),
             sets, shape + f", S = {S}", F + 4 * slots + 4 * hits
             + 4 * B * S, None),
        ]
        got = time_cases(cases, None, card)
        if what == "width 8192":
            masks = [resolve.expand_intervals(x[0], x[1], H)[1]
                     for x in sets]
            library["row_compact"] = time_yardstick(
                masks, R, f"row_compact ({what})", card)
            del masks
        for name, v in got.items():
            if what != "width 8192":  # "name (what)", "name (mode, what)"
                name = (name[:-1] + f", {what})" if name.endswith(")")
                        else f"{name} ({what})")
            out[name] = v

        def replaced(l, u, p, rid_c, off_c, *_):
            rows, valid, _ = resolve.expand_intervals(l, u, H)
            _, _, orig, keep = resolve.compact_rows(rows, valid, R)
            full = torch.full((F + 1,), -1, dtype=torch.int32,
                              device=rows.device)
            return (full.scatter(0, orig, rid_c)[:F],
                    full.scatter(0, orig, off_c)[:F], valid & keep)

        def hit_tail(l, u, p, rid_c, off_c, *_):
            rid, off, valid = resolve.gather_lanes(l, u, H, R, p, rid_c, off_c)
            smp = resolve._clip_take(r2s, rid, m)
            return (torch.where(valid, rid, -1), torch.where(valid, off, -1),
                    torch.where(valid, smp, -1), valid)

        dev = {k: got[k][2] or 0.0 for k in got}
        for name, fn, kms in (
                ("compact_rows and the scatters back", replaced,
                 dev["row_compact"] + dev["row_gather"]),
                ("the hit step's gather back, clipped read_to_sample gather "
                 "and torch.where", hit_tail,
                 dev["row_gather (read_to_sample)"]),
                ("read_to_sample gather and index_add_",
                 lambda *x: resolve.sample_histogram_plain(idx, x[5], x[6]),
                 dev["capped_histogram"])):
            time_ops(sets, fn, f"{name} ({what})", card, kms)
    return out


def run_views(s, R: int, dev):
    """R ranks' runs of a placed one-rank index, each placed from a host
    copy of it as a rank of an R-rank dp row places its own."""
    from readserver_tpu_torch.parallel import Mesh, place_sharded
    from readserver_tpu_torch.parallel.sharded import REPLICATED, STACKED

    host = dataclasses.replace(s, **{
        f: None if getattr(s, f) is None else getattr(s, f).cpu().numpy()
        for f in (*STACKED, *REPLICATED)})
    S = s.num_shards
    return [place_sharded(host, Mesh(
        shape={"dp": 1, "shard": S}, device=dev,
        ranks={"dp": 1, "shard": R}, coords={"dp": 0, "shard": r}))
        for r in range(R)]


def run_range(v):
    """(first, end) of a run's positions."""
    return int(v.starts[0]), int(v.starts[-1] + v.lens[-1])


def walk_lockstep(runs, rows, valid, kernel: bool):
    """A whole cross-rank walk of ``rows``/``valid`` on every run of
    ``runs`` (one rank's view each), the all-reduces summed here, each step
    launched (``kernel``) or its plain form run on the card: a generator
    that yields (mode, its arguments, the states) before each step and
    (None, (), the states) at the walk's end.  A step's buffers that no
    step has written yet hold the same values in every walk."""
    from readserver_tpu_torch.ops import sharded as sops

    kind = sops.walk_kind(runs[0])
    sts = [sops.walk_state(run, rows, valid, r == 0)
           for r, run in enumerate(runs)]
    fn = {("lf", True): sops.lf_walk_step, ("slow", True): sops.slow_walk_step,
          ("lf", False): sops.lf_walk_step_plain,
          ("slow", False): sops.slow_walk_step_plain}[kind, kernel]
    for st in sts:
        for f in WALK_FIELDS:
            if getattr(st, f) is not None:
                getattr(st, f).fill_(1 if f == "done" else -7)

    def reduce(f):
        total = sum(getattr(st, f) for st in sts).to(getattr(sts[0], f).dtype)
        for st in sts:
            getattr(st, f).copy_(total)

    if kind == "lf":
        n = max(runs[0].sample_rate, 1)
        plan = ([("first", ())] + [("step" if i < n - 1 else "last", ())
                                   for i in range(n)]
                + [("terminal", ()), ("finish", ())])
        reduces = ["step32"] * n + ["term64", "term32", "step32"]
    else:
        n = runs[0].max_read_len
        plan = [("first", ())] + [
            step for t in range(n)
            for step in (("rank", (t,)), ("step" if t < n - 1 else "last",
                                          (t,)))] + [("finish", ())]
        reduces = ["step32", "step64"] * n + ["term32", "step32"]
    for (mode, t), f in zip(plan, reduces):
        yield mode, t, sts
        for run, st in zip(runs, sts):
            fn(run, st, mode, *t)
        reduce(f)
    yield None, (), sts


# a walk state's tensors, as walk_lockstep snapshots them
WALK_FIELDS = ("cur", "done", "count", "step32", "step64", "term64",
               "term32", "read_id", "offset")


def walk_snapshot(st) -> list:
    return [None if getattr(st, f) is None else getattr(st, f).clone()
            for f in WALK_FIELDS]


def walk_restore(st, snap) -> None:
    for f, t in zip(WALK_FIELDS, snap):
        if t is not None:
            getattr(st, f).copy_(t)


def hit_lanes(s, codes, lut, p: int, H: int):
    """The served batch's hit lanes: (rows int64, valid bool) [B * H] of the
    k-step search of ``codes`` from the LUT on the whole index ``s``."""
    import torch
    from readserver_tpu_torch.ops import sharded as sops

    l, u = sops.search(s, codes, None, lut, p, 3)
    span = torch.arange(H, device=l.device)
    rows = (l[:, None] + span).reshape(-1)
    valid = (span[None, :] < (u - l)[:, None]).reshape(-1)
    return torch.where(valid, rows, torch.zeros_like(rows)).contiguous(), valid


def in_turn(make, needs):
    """Input sets make(0), make(1), ... until together they need twice the
    L2 → (sets, their mean bytes, their longest chain or None)."""
    sets = [make(0)]
    got = [needs(*sets[0])]
    for j in range(1, sets_past_l2(got[0][0])):
        sets.append(make(j))
        got.append(needs(*sets[-1]))
    chains = [g[1] for g in got if g[1] is not None]
    return (sets, int(np.mean([g[0] for g in got])),
            max(chains) if chains else None)


def partial_cases(s, v, codes_sets, lut, p: int, H: int):
    """Phase 13b's timing cases of K9's partial and K13 on ``v``, a rank's
    run of the whole index ``s``, at the cross-rank path's shapes, each over
    distinct input sets from the width-8192 batches ``codes_sets`` in turn
    (:func:`in_turn`): a 3-column search step (the first of the k-step
    schedule from the LUT), and over the 8192 x 64 hit lanes the dsa lookup
    (the dsa route's), the LF lookup (an LF walk step before the walk-step
    kernels), and the symbol lookup and the rank (a slow walk's two
    half-steps before them).  Only the partials' public functions, so a
    checkout with the cross-rank program runs them too
    (``scripts/torch_partial_ab.py``)
    → [(name, the kernel's device function, fn, plain, sets, shape, bytes,
    chain reads)]."""
    import torch
    from readserver_tpu_torch.ops import sharded as sops
    from readserver_tpu_torch.ops.search import kstep_schedule, prefix_ids

    lo, hi = run_range(v)
    B, K = codes_sets[0].shape
    j, k = kstep_schedule(K - p, 3)[0]
    plane = {3: 64, 2: 16, 1: 5}[k]
    steps, lanes = {}, {}

    def step_set(i):
        if i not in steps:
            q = codes_sets[i % len(codes_sets)]
            rows0 = lut.index_select(0, prefix_ids(q, p).long())
            steps[i] = (q, torch.cat([rows0[:, 0], rows0[:, 1]]).contiguous())
        return steps[i]

    def step_needs(q, lu):
        code = sops.step_code(q, j, k)
        act = lu[:B] < lu[B:]
        rows = [owner_rows(v, plane, v.rows_per_symbol, code[m], x[m])
                for x in (lu[:B], lu[B:]) for m in [act & (x > lo) & (x < hi)]]
        return B * (k * 4 + 32) + row_bytes(v, *rows), 2

    def lane_set(i):
        if i not in lanes:
            rows, valid = hit_lanes(s, codes_sets[i % len(codes_sets)], lut,
                                    p, H)
            lanes[i] = (rows, sops.sym_plain(s, rows))
        return lanes[i]

    def owned(x):
        return x[(x >= lo) & (x < hi)]

    def look_needs(x, _c, words=1):
        return x.numel() * 12 + distinct(owned(x) // words) * 4, 2

    def rank_needs(x, c):
        m = (x > lo) & (x < hi)
        return (x.numel() * 20
                + row_bytes(v, owner_rows(v, 5, v.rows_per_symbol, c[m],
                                          x[m])), 2)

    cases = []
    sets, nb, ch = in_turn(step_set, step_needs)
    cases.append(("shard_occ_partial", "occ_partial_kernel",
                  lambda q, lu: sops.step_partial(v, k, q, None, j, lu, True),
                  lambda q, lu: sops.step_partial_plain(v, k, q, None, j, lu,
                                                        True),
                  sets, f"a {k}-column search step over {B} queries, "
                  f"{v.starts.numel()} of {s.num_shards} shards", nb, ch))
    sets, nb, ch = in_turn(lane_set, rank_needs)
    cases.append(("shard_occ_partial (rank)", "occ_partial_kernel",
                  lambda x, c: sops.occ_partial(v, "rank", c, x),
                  lambda x, c: sops.occ_plain(v, "rank", c, x),
                  sets, f"the rank of {B} x {H} lanes (a slow half-step "
                  f"before the walk steps)", nb, ch))
    for what, words, shape in (
            ("dsa", 1, "the dsa lookup"),
            ("lf", 1, "the LF lookup (an LF walk step before the walk steps)"),
            ("sym", 8, "the symbol lookup (a slow half-step before the walk "
                       "steps)")):
        if what == "dsa" and s.dsa_chunk is None:
            continue
        sets, nb, ch = in_turn(
            lane_set, lambda x, c, words=words: look_needs(x, c, words))
        cases.append((
            "shard_lookup_partial" + ("" if what == "dsa" else f" ({what})"),
            "lookup_partial_kernel",
            lambda x, c, what=what: sops.lookup_partial(v, what, x),
            lambda x, c, what=what: sops.lookup_partial_plain(v, what, x),
            sets, f"{shape} of {B} x {H} lanes, {v.starts.numel()} of "
            f"{s.num_shards} shards", nb, ch))
    return cases


def walk_step_bytes(v, st, snap, mode: str, t, plain) -> int:
    """The bytes one walk step ``mode`` needs on the run ``v`` from the
    state ``snap`` before it, counted from what ``lf_step_kernel`` or
    ``slow_step_kernel`` touches in that mode: the flags every lane reads
    and the partial it writes; the input and state a live lane reads and
    the fields it writes (a lane that goes on its new cur, one that ends its
    end fields); and the distinct table words, entries or rank rows the
    run's own lookups read (from the plain step run on a copy of the
    state)."""
    import dataclasses as dc

    import torch

    cur0, done0, step0 = snap[0], snap[1], snap[3]
    R = cur0.numel()
    after = dc.replace(st, **{f: None if x is None else x.clone()
                              for f, x in zip(WALK_FIELDS, snap)})
    plain(v, after, mode, *t)
    lo, hi = run_range(v)
    live0, live1 = ~done0, ~after.done
    L = int(live0.sum())
    own = lambda x: (x >= lo) & (x < hi)  # noqa: E731
    lf = st.kind == "lf"

    def in_run(x, starts, lens):
        return x[(x >= int(starts[0])) & (x < int(starts[-1] + lens[-1]))]

    if mode == "first":
        # rows, valid in; cur, done, count, the end fields, the partial out
        words = after.cur[live1 & own(after.cur)]
        return (R * (8 + 1 + 8 + 1 + 4 + 4 + (16 if lf else 4))
                + distinct(words if lf else words >> 3) * 4)
    if mode == "rank":
        # done in, the rank partial out; a live lane's symbol and cur in
        m = live0 & (cur0 > lo) & (cur0 < hi)
        return R * (1 + 8) + L * 12 + row_bytes(v, owner_rows(
            v, 5, v.rows_per_symbol, snap[3][m], cur0[m]))
    # terminal and finish: valid in, done on a valid lane; an ended lane
    # (ok) reads its count and end fields
    ok = st.valid & after.done
    flags = R + int(st.valid.sum())
    n_ok = int(ok.sum())
    if mode == "finish" and not lf:
        # read id, offset, the sample partial out; an ended lane's step and
        # $-rank read id in
        rid = after.read_id.long().clamp(min=0)
        return (flags + R * 12 + n_ok * 8
                + distinct(in_run(rid, v.rstarts, v.rlens)) * 4)
    if mode in ("terminal", "finish"):
        raw = snap[5][:R].to(torch.int32)
        marked = ok & (raw < 0)
        n_m = int(marked.sum())
        if mode == "terminal":
            # the (read id, pair) triple out; an ended lane's raw value in,
            # a sampled one's mark rank too; the $-rank's read id or the pair
            d = (raw & 0x7FFFFFFF).long()[ok & (raw >= 0)]
            return (flags + R * 12 + n_ok * 8 + n_m * 8
                    + distinct(in_run(d, v.dstarts, v.dlens)) * 4
                    + distinct(in_run(snap[5][R:][marked], v.sstarts,
                                      v.slens)) * 8)
        # finish: read id, offset, the sample partial out; an ended lane's
        # count and raw value in, then its pair or its $-rank's read id
        rid = after.read_id.long().clamp(min=0)
        return (flags + R * 12 + n_ok * (4 + 8) + n_m * 8 + (n_ok - n_m) * 4
                + distinct(in_run(rid, v.rstarts, v.rlens)) * 4)
    # step and last: done in and (step) the next partial out on every lane;
    # a live lane reads its input(s); the lookups of the new cur (step)
    ended = live0 & after.done
    going = live0 & ~after.done
    E, G = int(ended.sum()), int(going.sum())
    nb = R * (1 + (4 if mode == "step" else 0))
    nxt = after.cur[live1 & own(after.cur)] if mode == "step" else cur0[:0]
    if lf:
        # a live lane reads cur and its raw LF; one that goes on writes cur
        # and reads and writes its count; one that ends writes done and its
        # raw value, a sampled end its mark rank (its row read) too
        sampled = ended & (step0 < 0)
        m = sampled & (cur0 > lo) & (cur0 < hi)
        return (nb + L * (8 + 4) + G * (8 + 4 + 4) + E * (1 + 8)
                + int(sampled.sum()) * 8 + distinct(nxt) * 4
                + row_bytes(v, owner_rows(
                    v, 1, v.mark_table.shape[1],
                    torch.zeros_like(cur0[m], dtype=torch.int32), cur0[m])))
    # slow: a live lane reads its symbol c and rank o; one that goes on
    # reads C[c] and writes cur; one that ends writes done, its step and the
    # read id of $-rank o (that entry read)
    o = snap[4][ended]
    return (nb + L * (4 + 8) + G * 8 + E * (1 + 4 + 4)
            + distinct(step0[going]) * 8 + distinct(nxt >> 3) * 4
            + distinct(in_run(o, v.dstarts, v.dlens)) * 4)


def walk_step_cases(s_routes, codes_sets, lut, p: int, H: int, dev):
    """Phase 13b's timing cases of the walk steps on 2 ranks' first run of
    the lf and slow route's index, over the 8192 x 64 hit lanes of distinct
    width-8192 batches: each mode of each walk, its state made ready by
    the lockstep walk of both runs up to it (:func:`walk_lockstep`), each
    call on a state restored to that point → [(name, kernel function,
    fn(st, snap), plain(st, snap), sets [(state, snapshot)], shape, bytes,
    chain reads)]."""
    import torch
    from readserver_tpu_torch.ops import sharded as sops

    cases = []
    for route, modes in (("lf", (("step", ()), ("first", ()),
                                 ("terminal", ()), ("finish", ()))),
                         ("slow", (("rank", (0,)), ("step", (0,)),
                                   ("first", ()), ("finish", ())))):
        s = s_routes[route]
        runs = run_views(s, 2, dev)
        v = runs[0]
        lo, hi = run_range(v)
        kname = "lf_step_kernel" if route == "lf" else "slow_step_kernel"
        kern = sops.lf_walk_step if route == "lf" else sops.slow_walk_step
        plain = (sops.lf_walk_step_plain if route == "lf"
                 else sops.slow_walk_step_plain)
        for mode, t in modes:
            def make(i, mode=mode, t=t):
                rows, valid = hit_lanes(s, codes_sets[i % len(codes_sets)],
                                        lut, p, H)
                for m, args, sts in walk_lockstep(runs, rows, valid, True):
                    if (m, args) == (mode, t):
                        return sts[0], walk_snapshot(sts[0])

            def needs(st, snap, mode=mode, t=t):
                return walk_step_bytes(v, st, snap, mode, t, plain), 2

            sets, nb, ch = in_turn(make, needs)
            cases.append((
                f"walk_{route}_step ({mode})", kname,
                lambda st, snap, mode=mode, t=t, f=kern, v=v: f(v, st, mode,
                                                                *t),
                lambda st, snap, mode=mode, t=t, f=plain, v=v: f(v, st, mode,
                                                                 *t),
                sets, f"{mode} over {codes_sets[0].shape[0]} x {H} lanes "
                f"({int(sets[0][0].valid.sum())} hits in the first set), "
                f"{route} route, 2 ranks' first run", nb, ch))
    return cases
def walk_pair_err(runs, rows, valid) -> int:
    """Every step of a whole cross-rank walk on ``runs``, launched and in
    plain form side by side (:func:`walk_lockstep`) → the largest |kernel -
    plain| over every rank's state after every step (the live reports must
    agree too), and over the one-run walk's answers against the one-device
    plain walk."""
    from readserver_tpu_torch.ops import sharded as sops

    err = 0
    last = None
    for (mode, _, ka), (_, _, pa) in zip(
            walk_lockstep(runs, rows, valid, True),
            walk_lockstep(runs, rows, valid, False)):
        for a, b in zip(ka, pa):
            err = max(err, max_err(
                (x, y) for x, y in zip(walk_snapshot(a), walk_snapshot(b))
                if x is not None))
            if last in ("first", "step"):
                err = max(err, int(sops.walk_live(runs[0], a) != b.live))
        last = mode
    if len(runs) == 1:
        rid, off = sops.walk_plain(runs[0], rows, valid)
        err = max(err, max_err([(ka[0].read_id, rid), (ka[0].offset, off)]))
    return err


def time_cases(cases, t_row, card) -> dict:
    """Each case's kernel against its plain form on every input set (max
    |err| 0), then, the sets in turn: the wrapper's time (CUDA events,
    median of 3 passes), the kernel's device time (profiler), the plain
    form's time, the bytes bound of the sets' mean bytes and the chain
    bound (chain reads x t_row).  A walk step's set is a state and its
    snapshot: every call starts from the snapshot, restored outside the
    wrapper's timed pass (inside the profiler's, whose reading counts the
    kernel alone) → {name: (ms, plain ms, device ms, bound ms, shape,
    chain ms)}.  A case's kernel name may be a pair (name, device kernels
    a launch) where one wrapper call launches several."""
    import torch
    from readserver_tpu_torch.kernels import KERNELS

    def outs(x):
        return x if isinstance(x, tuple) else (x,)

    def launched():
        return sum(k.launches for k in KERNELS.values())

    out = {}
    for name, kname, kern, plain, sets, what, nbytes, chain in cases:
        kname, per_launch = kname if isinstance(kname, tuple) else (kname, 1)
        walk = name.startswith("walk_")
        err = 0
        for x in sets:
            if walk:
                walk_restore(*x)
                kern(*x)
                got = walk_snapshot(x[0])
                walk_restore(*x)
                plain(*x)
                err = max(err, max_err((a, b) for a, b in zip(
                    got, walk_snapshot(x[0])) if a is not None))
            else:
                err = max(err, max_err(zip(outs(kern(*x)), outs(plain(*x)))))
        check(err == 0, f"{name} disagrees with its plain form ({what})")
        if walk:
            walk_restore(*sets[0])
        before = launched()
        kern(*sets[0])
        per_call = launched() - before
        k_turn = itertools.cycle(sets)
        iters = len(sets) if walk else max(len(sets), N_ROT)
        t_kern, t_plain = [], []
        for _ in range(3):  # interleaved: kernel, plain
            if walk:
                for x in sets:
                    walk_restore(*x)
            torch.cuda.synchronize()
            t_kern.append(time_cuda(lambda: kern(*next(k_turn)), iters))
            x = sets[0]
            if walk:
                walk_restore(*x)
                torch.cuda.synchronize()
            t_plain.append(time_cuda(lambda: plain(*x), 1))

        def restored():
            x = next(k_turn)
            if walk:
                walk_restore(*x)
            return kern(*x)

        dev_ms = kernel_device_ms(restored, iters, kname,
                                  launches=iters * per_call * per_launch)
        tk, tp = float(np.median(t_kern)), float(np.median(t_plain))
        bnd = bound_ms(nbytes)
        chain_ms = None if chain is None or t_row is None else chain * t_row
        log(f"{name} ({what}; {len(sets)} distinct input sets in turn): "
            f"wrapper {tk:.4f} ms, kernel device time {fmt_ms(dev_ms)} ms "
            f"(profiler) | plain torch {tp:.4f} ms (median of 3 x {iters} "
            f"and 3 x 1 calls, CUDA events), outputs equal on every set | "
            f"needs {nbytes} B a set (mean): bytes bound {bnd:.4f} ms, "
            f"device time at {ratio(bnd, dev_ms)} of it"
            + ("" if chain is None else
               f" | chain of {chain} dependent reads x t_row: chain bound "
               f"{fmt_ms(chain_ms)} ms, device time at "
               f"{ratio(chain_ms, dev_ms)} of it") + f" | {card}")
        out[name] = (tk, tp, dev_ms, bnd, what, chain_ms)
    return out


def check_rank_kernels(engines, batch, rot, reduces, split, t_row, card):
    """Phase 13b: K9's partial (a search step, a rank), K13 (every lookup),
    K11's partial (every level) and the walk steps (every step of the LF
    and slow walks) against their plain forms, max |err| 0, at phase 13
    (a)'s shapes on the whole index as one rank's run and on each of 2
    ranks' runs (the sums over the runs equal the one run's), with
    positions at each run's first and last rows and past them, empty
    intervals and $ rows among the keys; then, over distinct input sets in
    turn until together they need twice the L2 (:func:`in_turn`), each
    one's wrapper, device and plain time, bytes bound and chain bound on 2
    ranks' first run (:func:`partial_cases`, :func:`walk_step_cases`), and
    the all-reduce against a step's kernel: NCCL's of a group of one on the
    card, and gloo's between two ranks sharing the card
    (``scripts/torch_allreduce_probe.py``) → ({name: summary entry},
    {err key: max |err|}, the design readings)."""
    import torch
    import torch.distributed as dist
    from readserver_tpu_torch.ops import sharded as sops
    from readserver_tpu_torch.ops.search import (canonical_empty,
                                                 kstep_schedule, prefix_ids)

    e = engines["dsa"]
    s = e.sidx
    dev = s.starts.device
    p, H = e.lut_p, e.H
    rng = np.random.default_rng(13)
    runs = run_views(s, 2, dev)
    views = [(s, True)] + [(v, i == 0) for i, v in enumerate(runs)]
    ce, le, nq = e._pad_encode(batch)
    codes, lengths = e._to_device(ce, le)
    B, K = codes.shape
    # K9's partial along the served batch's k-step schedule from the LUT,
    # each step also written over its input as the search writes it
    rows0 = e.lut.index_select(0, prefix_ids(codes, p).long())
    lu = torch.cat([rows0[:, 0], rows0[:, 1]]).contiguous()
    k9_err = 0
    for j, k in kstep_schedule(K - p, 3):
        outs = []
        for v, lead in views:
            got = sops.step_partial(v, k, codes, None, j, lu, lead)
            want = sops.step_partial_plain(v, k, codes, None, j, lu, lead)
            over = lu.clone()
            sops.step_partial(v, k, codes, None, j, over, lead, out=over)
            k9_err = max(k9_err, max_err([(got, want), (over, want)]))
            outs.append(got)
        k9_err = max(k9_err, max_err([(outs[1] + outs[2], outs[0])]))
        lu = outs[0]
    l, u = canonical_empty(lu[:B], lu[B:])
    mlen = torch.from_numpy(rng.integers(1, K + 1, size=B).astype(
        np.int32)).to(dev)
    for v, lead in views:  # the masked 1-step scan's step, lengths mixed
        k9_err = max(k9_err, max_err([(
            sops.step_partial(v, 1, codes, mlen, K - p - 1, lu, lead),
            sops.step_partial_plain(v, 1, codes, mlen, K - p - 1, lu, lead))]))
    # the walks' lanes: the served batch's hits, then the runs' edges
    span = torch.arange(H, device=dev)
    rows = (l[:, None] + span).reshape(-1)
    valid = (span[None, :] < (u - l)[:, None]).reshape(-1)
    rows = torch.where(valid, rows, torch.zeros_like(rows))
    edges = [0, 1, s.n - 1, s.n, s.n + 3]
    for v in runs:
        a, b = run_range(v)
        edges += [a - 1, a, a + 1, b - 1, b, b + 1]
    keys = torch.cat([rows, torch.tensor(edges, device=dev)]).contiguous()
    sym = sops.sym_plain(s, keys)
    for table, c in (("rank", sym), ("marks", torch.zeros_like(sym))):
        for v, _ in views:
            k9_err = max(k9_err, max_err([(sops.occ_partial(v, table, c, keys),
                                           sops.occ_plain(v, table, c,
                                                          keys))]))
    n_dollar_rows = int((sym == 0).sum())
    # K13: every lookup, on the lanes, the $-ranks, read ids and slots
    m = s.num_reads
    marks = int(s.slens.sum())
    dr = torch.cat([torch.arange(-2, m + 2, device=dev),
                    torch.from_numpy(rng.integers(0, m, size=keys.numel()))
                    .to(dev)])[: keys.numel()].contiguous()
    slot = torch.from_numpy(rng.integers(-2, marks + 2, size=keys.numel())
                            ).to(dev).contiguous()
    k13_err = 0
    for what in ("sym", "dsa", "lf", "lf_mark", "dollar", "sample",
                 "dollar_pair"):
        x = dr if what in ("dollar", "sample", "dollar_pair") else keys
        y = slot if what == "dollar_pair" else None
        outs = []
        for v, _ in views:
            got = sops.lookup_partial(v, what, x, y)
            want = sops.lookup_partial_plain(v, what, x, y)
            k13_err = max(k13_err, max_err([(got, want)]),
                          int(got.dtype != want.dtype))
            outs.append(got)
        k13_err = max(k13_err, max_err([(outs[1] + outs[2], outs[0])]))
    # K11's partial at every level of the engine's build
    a_, b_ = s.C[1:5].contiguous(), s.C[2:6].contiguous()
    k11_err = 0
    for _ in range(p - 1):
        outs = []
        for v, lead in views:
            got = sops.lut_level_partial(v, a_, b_, lead)
            k11_err = max(k11_err, max_err([(
                got, sops.lut_level_partial_plain(v, a_, b_, lead))]))
            outs.append(got)
        k11_err = max(k11_err, max_err([(outs[1] + outs[2], outs[0])]))
        X = a_.numel()
        last = (a_, b_)
        a_, b_ = outs[0][: 4 * X], outs[0][4 * X :]
    # the walk steps: every step of each walk on the served batch's hit
    # lanes, on the whole index as one run and on 2 runs
    walk_err = {}
    for route in ("lf", "slow"):
        sr = engines[route].sidx
        wrows, wvalid = hit_lanes(sr, codes, engines[route].lut, p, H)
        walk_err[route] = max(walk_pair_err(r, wrows, wvalid)
                              for r in ([sr], run_views(sr, 2, dev)))
    log(f"K9's partial ({len(kstep_schedule(K - p, 3))} steps of the served "
        f"width-{B} batch, each also over its input, a masked 1-step, ranks "
        f"on the rank and mark tables at {keys.numel()} positions, "
        f"{n_dollar_rows} of them $ rows), K13 (7 lookups, each at its "
        f"psum's width), K11's partial ({p - 1} levels) and the LF and slow "
        f"walks' every step on the served batch's {B} x {H} lanes, on 1 and "
        f"2 ranks' runs: max |err| {k9_err}, {k13_err}, {k11_err}, "
        f"{walk_err['lf']}, {walk_err['slow']}")
    check(k9_err == 0 and k13_err == 0 and k11_err == 0
          and not any(walk_err.values()),
          "a partial kernel disagrees with its plain form")
    # timing on 2 ranks' first run (the (b) group's rank 0), over distinct
    # width-8192 batches: the served one, then slices of phase 7's
    codes_sets = [codes] + [b[i * B:(i + 1) * B] for b in rot
                            for i in range(b.shape[0] // B)]
    cases = partial_cases(s, runs[0], codes_sets, e.lut, p, H)
    cases += walk_step_cases({r: engines[r].sidx for r in ("lf", "slow")},
                             codes_sets, e.lut, p, H, dev)
    # K11's partial at the build's last level (its intervals alone pass the
    # L2 many times over: one set)
    v = runs[0]
    lo, hi = run_range(v)
    la, lb = last
    alive = la < lb
    lut_rows = [owner_rows(v, 5, v.rows_per_symbol,
                           torch.full_like(x, cc, dtype=torch.int32), x)
                for cc in range(1, 5)
                for x in (la[alive & (la > lo) & (la < hi)],
                          lb[alive & (lb > lo) & (lb < hi)])]
    cases.append((
        "sharded_lut_level_partial", "lut_level_partial_kernel",
        lambda a, b: sops.lut_level_partial(v, a, b, True),
        lambda a, b: sops.lut_level_partial_plain(v, a, b, True), [last],
        f"the last level of the p={p} build ({la.numel()} intervals), "
        f"{v.starts.numel()} of {s.num_shards} shards",
        la.numel() * 80 + row_bytes(v, *lut_rows), None))
    summary = time_cases(cases, t_row, card)
    # the all-reduce against a step's kernel
    design = {"card": card, "all_reduces_a_batch": reduces,
              "request_split": split}
    for what, width, dt in (("search step", 2 * B, torch.int64),
                            ("walk step", B * H, torch.int32)):
        t = torch.ones(width, dtype=dt, device=dev)
        dist.all_reduce(t)
        design[f"nccl_group_of_1_{what}_ms"] = time_cuda(
            lambda t=t: dist.all_reduce(t), 50)
        log(f"NCCL all-reduce, group of 1, {what} ({width} {dt}): "
            f"{design[f'nccl_group_of_1_{what}_ms']:.4f} ms | {card}")
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_allreduce_probe.py"),
         "--iters", "30"], cwd=REPO, capture_output=True, text=True,
        timeout=400)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            design.update(json.loads(line))
    log(f"two ranks sharing the card (exit {proc.returncode}): "
        f"{json.dumps({k: v for k, v in design.items() if k.startswith(('gloo', 'nccl_two'))})}")
    check(proc.returncode == 0 and "gloo_all_reduce" in design,
          f"the all-reduce probe failed: {proc.stderr[-2000:]}")
    for route, r in reduces.items():
        log(f"{route} route: {r['counted']} all-reduces a batch "
            f"(estimate {r['estimate']['total']}): at gloo's search-step "
            f"median {design['gloo_all_reduce']['search step, 2 x 8192']['median_ms']:.3f}"
            f" ms each, about "
            f"{r['counted'] * design['gloo_all_reduce']['search step, 2 x 8192']['median_ms']:.1f}"
            f" ms of collectives against the step kernel's "
            f"{fmt_ms(summary['shard_occ_partial'][2])} ms")
    errs = {"shard_occ_partial_err": k9_err, "shard_lookup_partial_err":
            k13_err, "sharded_lut_level_partial_err": k11_err,
            "walk_lf_step_err": walk_err["lf"],
            "walk_slow_step_err": walk_err["slow"]}
    return summary, errs, design


def q256_of(qs):
    return next(q for name, q, _ in qs if name == "256")


INGEST_DROP = ("rank3_blocks", "C3", "dsa", "lf", "mark_rank",
               "sample_pairs", "fused_rows")   # tests/test_upgrade.py:24-35


def cli_start(steps) -> list:
    """Start each ``(what, argv)`` of ``steps`` as ``python -m
    readserver_tpu_torch.cli argv`` from the checkout, each in its own
    process (a user's command on the card's host), all at once → their
    futures of (what, finished process, host seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(what, argv):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "readserver_tpu_torch.cli", *map(str, argv)],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        return what, proc, time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(steps))
    futures = [pool.submit(one, what, argv) for what, argv in steps]
    pool.shutdown(wait=False)
    return futures


def cli_wait(futures, card: str, beside: str = "") -> list[str]:
    """Wait for ``cli_start``'s commands; each must exit 0 → their
    standard outputs.  Logs each one's host seconds and its last line
    (``beside``: what ran at the same time)."""
    outs = []
    for fut in futures:
        what, proc, dt = fut.result()
        check(proc.returncode == 0, f"{what}: exit {proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        said = proc.stderr.strip().splitlines()
        log(f"{what}: {dt:.3f} s on the host"
            + (f" (beside {beside})" if beside else "")
            + (f" [{said[-1]}]" if said else "") + f" | {card}")
        outs.append(proc.stdout)
    return outs


def cli_steps(steps, card: str, beside: str = "") -> list[str]:
    return cli_wait(cli_start(steps), card, beside)


def tree_diff(a: Path, b: Path) -> list[str]:
    """The files of two artifact directories whose bytes differ (every
    file, both sides), or a note that their file sets differ."""
    import filecmp

    fa = sorted(str(f.relative_to(a)) for f in a.rglob("*") if f.is_file())
    fb = sorted(str(f.relative_to(b)) for f in b.rglob("*") if f.is_file())
    if fa != fb:
        return [f"file sets differ: {sorted(set(fa) ^ set(fb))[:8]}"]
    return [f for f in fa if not filecmp.cmp(a / f, b / f, shallow=False)]


def strip_tiers(path: Path, names) -> None:
    """Emulate an artifact from before ``names`` existed
    (tests/test_upgrade.py's ``_strip``): their files unlinked, the
    manifest (a real file, not a link) rewritten in place."""
    from readserver_tpu_torch.index import artifact

    manifest = json.loads((path / artifact.MANIFEST_NAME).read_text())
    for name in names:
        (path / f"{name}.npy").unlink()
    manifest["arrays"] = [a for a in manifest["arrays"] if a not in names]
    if "dsa" in names:
        manifest["dsa_bits"] = 0
    if "mark_rank" in names:
        manifest["sample_rate"] = 0
    (path / artifact.MANIFEST_NAME).write_text(json.dumps(manifest))


def hit_key(h) -> tuple:
    return (h["read_id"], h["offset"], h["strand"])


def same_answers(a, b, what: str, samples: bool) -> int:
    """Two fronts' answers to one request: counts, ``hits_truncated`` and,
    where neither is cut, hit sets by (read, offset, strand) and sample;
    with ``samples`` the histograms and their ``complete`` flags → hit
    sets compared."""
    n = 0
    for x, y in zip(a, b, strict=True):
        check(x.count == y.count, f"{what}: {x.kmer} counts {x.count} and "
              f"{y.count}")
        if samples:
            check((x.sample_hist, x.sample_hist_complete)
                  == (y.sample_hist, y.sample_hist_complete),
                  f"{what}: {x.kmer} histograms differ")
        if not (x.hits_truncated or y.hits_truncated):
            key = (lambda h: (*hit_key(h), h["sample_id"])) if samples \
                else hit_key
            check(sorted(map(key, x.hits)) == sorted(map(key, y.hits)),
                  f"{what}: {x.kmer} hit sets differ")
            n += 1
    return n


def serve_ingest(args, cohort, ecoli_cache, meng, cfg, dev, c256, qs, served,
                 reads_served, zero_launches, read_launches, card) -> dict:
    """Phase 12: ingest and index maintenance through the port's CLI on
    the card's host, each command in its own process, then the artifacts
    they write served on the card (nothing cut: the 128-sample cohort,
    n = 27,872,768 at scale 1, and E. coli 30x):

    * ingest: ``simulate --config cohort`` writes the reads as FASTA; a
      FASTQ of them (constant qualities) and a BAM (``corpus.bam``) are
      written beside it; ``build --doc-shards 4`` from each (at once, one
      process each; the FASTQ with ``--qual-trim 20``, which trims
      nothing) writes the same bytes; ``query`` in a process of its own on
      the card and a ``MultiEngine`` here answer ``/count`` and ``/reads``
      on both strands as phase 9b's front ``meng`` does (a FASTA carries
      no sample ids: hit sets by global read id, offset and strand), and
      exactly as the read windows on 64 queries;
    * ``append`` of a 129th sample's reads (FASTA), then ``compact
      --target-shards 2``: ``/count``, ``/reads`` and ``/samples`` (the new
      sample's column included) equal to a ``build_cohort`` of all the
      reads from scratch, each time;
    * ``upgrade --kstep 3 --sample-rate R`` of a copy of phase 3's E. coli
      artifact (the ``.npy`` files hard links, the manifest a real copy)
      with ``INGEST_DROP`` stripped: each restored array byte-equal to
      phase 3's, the manifest equal in rate, dsa bits and array set, and a
      ``QueryEngine`` on it gives phases 4-5's counts and phase 8's
      ``/reads``;
    * ``merge`` of two of the cohort's shard artifacts and ``import-bwt``
      of an RLE file (``index.rle``) of one shard's BWT: counts equal to
      the sources' engines', the import's ``/reads`` equal to its source's.

    Launch counts from 0 over the card's part here (this process); K1's
    level entry, K2, K5 and K7 must launch, K1's and K9's generic entries
    not, and no plain form of ``ops`` may run on a CUDA tensor → the
    launch counts."""
    import filecmp
    import os
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from readserver_tpu_torch import alphabet
    from readserver_tpu_torch.corpus import bam, io as cio, simulate
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.index.cohort import build_cohort, load_cohort
    from readserver_tpu_torch.index.packing import unpack_sym4
    from readserver_tpu_torch.index.rle import write_rle_bwt
    from readserver_tpu_torch.serve import MultiEngine, QueryEngine

    work = REPO / "data" / "chip_smoke" / f"ingest_s{args.scale:g}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckms = decode_all(c256)
    mcfg = meng.engines[0].cfg
    # phase 9b's front answers the requests first, outside the count
    want_count = meng.count_batch(ckms, both_strands=True)
    want_reads = meng.query_batch(ckms, both_strands=True)
    zero_launches()

    def front(path) -> MultiEngine:
        parts, _ = load_cohort(path, mmap=False)
        return MultiEngine(parts, mcfg, device=dev)

    def timed(fn, *a, **kw):
        t0 = time.perf_counter()
        return fn(*a, **kw), time.perf_counter() - t0

    with plain_calls_on_card() as plain:
        # the E. coli upgrade and the append's from-scratch oracle run
        # beside the cohort's ingest: each is independent of it
        upg = work / "ecoli_upgrade"
        upg.mkdir()
        t0 = time.perf_counter()
        for f in ecoli_cache.iterdir():
            if f.name == artifact.MANIFEST_NAME:
                shutil.copyfile(f, upg / f.name)
            else:
                os.link(f, upg / f.name)
        strip_tiers(upg, INGEST_DROP)
        src_manifest = json.loads(
            (ecoli_cache / artifact.MANIFEST_NAME).read_text())
        rate = int(src_manifest["sample_rate"])
        log(f"E. coli copy (hard links, the manifest copied) with "
            f"{len(INGEST_DROP)} tiers stripped in "
            f"{time.perf_counter() - t0:.3f} s; recorded sample rate {rate} "
            f"| {card}")
        upgrading = cli_start([("upgrade --kstep 3 (E. coli 30x)", [
            "upgrade", upg, "--kstep", 3, "--sample-rate", rate])])
        spec = cohort.spec
        extra = simulate.simulate_reads(
            cohort.genome, spec.coverage / spec.num_samples, spec.read_len,
            seed=spec.seed * 1000 + spec.num_samples,
            error_rate=spec.error_rate)
        base = len(cohort.reads)
        pool = ThreadPoolExecutor(1)
        scratching = pool.submit(
            timed, build_cohort, [*cohort.reads, *extra],
            np.repeat(np.int32([0, 1]), [base, len(extra)]), SHARDS,
            work / "scratch", sample_names=["sample_0", "donor_new"])
        pool.shutdown(wait=False)
        beside = "the E. coli upgrade and the from-scratch cohort build"

        # ------------------------------------------------ ingest by format
        fa = work / "reads.fa"
        cli_steps([("simulate --config cohort (FASTA)",
                    ["simulate", "--config", "cohort", "--scale",
                     args.scale, "--out", fa])], card, beside)
        t0 = time.perf_counter()
        recs = list(cio.read_fasta(fa))
        check(len(recs) == base and all(s == r for (_, s), r in zip(
            recs, decode_all(np.stack(cohort.reads)))),
            "the FASTA's reads are not the cohort's, in order")
        with open(work / "reads.fq", "w") as fh:
            for name, seq in recs:
                fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
        bam.write_bam(work / "reads.bam", ((n, sq, None) for n, sq in recs))
        log(f"read the FASTA back ({len(recs)} reads, the cohort's in "
            f"order) and wrote it as FASTQ (qualities all 40) and BAM in "
            f"{time.perf_counter() - t0:.3f} s | {card}")
        pops = {f: work / f"pop_{f}" for f in ("fasta", "fastq", "bam")}
        cli_steps([
            ("build --fasta --doc-shards 4",
             ["build", "--fasta", fa, "--doc-shards", SHARDS,
              "--out", pops["fasta"]]),
            ("build --fastq --qual-trim 20 --doc-shards 4",
             ["build", "--fastq", work / "reads.fq", "--qual-trim", 20,
              "--doc-shards", SHARDS, "--out", pops["fastq"]]),
            ("build --bam --doc-shards 4",
             ["build", "--bam", work / "reads.bam", "--doc-shards", SHARDS,
              "--out", pops["bam"]])], card,
            "each other, " + beside)
        for f in ("fastq", "bam"):
            diff = tree_diff(pops["fasta"], pops[f])
            check(not diff, f"the {f} build differs from the FASTA build: "
                  f"{diff[:8]}")
        nfiles = sum(1 for x in pops["fasta"].rglob("*") if x.is_file())
        log(f"the FASTA, FASTQ and BAM cohorts are byte-equal: {nfiles} "
            f"files (every .npy and manifest)")
        (stdout,) = cli_steps([("query --both-strands --hits (card)", [
            "query", "--index", pops["fasta"], "--hits", "--both-strands",
            "--device", "cuda", "--kmer", *ckms])], card, beside)
        lines = [json.loads(x) for x in stdout.splitlines()]
        check(len(lines) == len(ckms), "query printed a line a k-mer")
        for line, w in zip(lines, want_reads):
            check(line["kmer"] == w.kmer and line["count"] == w.count
                  and line["hits_truncated"] == w.hits_truncated
                  and sorted(map(hit_key, line["hits"]))
                  == sorted(map(hit_key, w.hits)),
                  f"query on the FASTA cohort: {w.kmer} differs from phase "
                  f"9b's front")
        log(f"CLI query on the card: {len(lines)} /reads answers on both "
            f"strands equal to phase 9b's front's")
        t0 = time.perf_counter()
        m = front(pops["fasta"])
        got_count = m.count_batch(ckms, both_strands=True)
        got_reads = m.query_batch(ckms, both_strands=True)
        check([r.count for r in got_count] == [r.count for r in want_count],
              "/count on the FASTA cohort differs from phase 9b's front")
        n = same_answers(got_reads, want_reads, "/reads on the FASTA cohort",
                         samples=False)
        check(n == sum(not r.hits_truncated for r in want_reads),
              "/reads on the FASTA cohort: truncation differs")
        rcm = np.array([4, 3, 2, 1], dtype=np.uint8)
        cmat = np.stack(cohort.reads)
        want_w = hit_oracle(cmat, np.concatenate(
            [c256[:64], rcm[c256[:64] - 1][:, ::-1]]))
        del cmat
        zeros = np.zeros(base, dtype=np.int32)
        for i, r in enumerate(got_reads[:64]):
            wf, wr = want_w[i], want_w[64 + i]
            check(r.count == len(wf) + len(wr), f"{r.kmer}: FASTA cohort "
                  "count differs from the windows")
            check_cohort_hits(r, wf, mcfg.max_hits, zeros, "+")
            check_cohort_hits(r, wr, mcfg.max_hits, zeros, "-")
        log(f"MultiEngine on the FASTA cohort ({len(m.engines)} partitions "
            f"on the card) up and answering in "
            f"{time.perf_counter() - t0:.3f} s: /count and /reads of 256 "
            f"queries on both strands equal to phase 9b's front ({n} hit "
            f"sets untruncated), 64 exact against "
            f"{sum(len(w) for w in want_w)} windows | {card}")
        del m

        # --------------------------------------------- append and compact
        cio.write_fasta(work / "extra.fa", (
            (f"read_{base + i}_s{spec.num_samples}", alphabet.decode(r))
            for i, r in enumerate(extra)))
        pop = pops["fasta"]
        cli_steps([("append --fasta (a 129th sample)", [
            "append", pop, "--fasta", work / "extra.fa",
            "--sample", "donor_new"])], card, "the E. coli upgrade")
        scratch, dt = scratching.result()
        log(f"build_cohort of all {base + len(extra)} reads from scratch "
            f"(the oracle, in this process): {dt:.3f} s on the host (beside "
            f"the ingest's commands) | {card}")
        akms = ckms + decode_all(np.stack(extra[:64])[:, :KMER])
        ref = front(scratch)
        want_a = (ref.count_batch(akms, both_strands=True),
                  ref.query_batch(akms, both_strands=True),
                  ref.query_batch(akms, both_strands=True,
                                  include_hits=False))
        del ref
        for stage in ("appended", "compacted"):
            if stage == "compacted":
                cli_steps([("compact --target-shards 2",
                            ["compact", pop, "--target-shards", 2])], card,
                          "the E. coli upgrade")
            t0 = time.perf_counter()
            m = front(pop)
            got = (m.count_batch(akms, both_strands=True),
                   m.query_batch(akms, both_strands=True),
                   m.query_batch(akms, both_strands=True,
                                 include_hits=False))
            check([r.count for r in got[0]] == [r.count for r in want_a[0]],
                  f"/count on the {stage} cohort differs")
            n = same_answers(got[1], want_a[1], f"/reads ({stage})", True)
            same_answers(got[2], want_a[2], f"/samples ({stage})", True)
            new_col = sum(r.sample_hist.get("donor_new", 0)
                          for r in got[2][256:])
            check(new_col > 0, f"the {stage} cohort's /samples have no "
                  "column of the new sample")
            log(f"{stage} cohort ({len(m.engines)} partitions) against the "
                f"from-scratch build on {len(akms)} queries on both strands "
                f"(64 from the new sample): /count, /reads ({n} hit sets "
                f"untruncated) and /samples equal, donor_new {new_col} hits; "
                f"{time.perf_counter() - t0:.3f} s | {card}")
            del m

        # ------------------------------------------- upgrade at E. coli 30x
        cli_wait(upgrading, card, "the cohort's ingest, append and compact")
        t0 = time.perf_counter()
        diff = [x for x in INGEST_DROP if not filecmp.cmp(
            ecoli_cache / f"{x}.npy", upg / f"{x}.npy", shallow=False)]
        check(not diff, f"upgraded arrays differ from phase 3's: {diff}")
        up_manifest = json.loads((upg / artifact.MANIFEST_NAME).read_text())
        for key in ("sample_rate", "dsa_bits"):
            check(up_manifest[key] == src_manifest[key],
                  f"the upgraded manifest's {key} differs")
        check(sorted(up_manifest["arrays"]) == sorted(src_manifest["arrays"])
              and "files" not in up_manifest,
              "the upgraded manifest's arrays differ")
        log(f"the {len(INGEST_DROP)} restored arrays byte-equal to phase "
            f"3's, the manifest's rate, dsa bits and arrays equal, in "
            f"{time.perf_counter() - t0:.3f} s | {card}")
        t0 = time.perf_counter()
        e = QueryEngine(artifact.load_artifact(upg, mmap=False), cfg,
                        device=dev)
        check(e.index.rank3_rows is not None and e.index.dsa is not None,
              "the upgraded engine ships no triple tier or no dsa")
        for name, q, both in qs:
            kms = decode_all(q)
            check(np.array_equal([r.count for r in e.count_batch(
                kms, both_strands=both)], served[name]),
                f"counts of {name} on the upgraded artifact differ")
            check(e.query_batch(kms, both_strands=both) == reads_served[name],
                  f"/reads of {name} on the upgraded artifact differ")
        log(f"QueryEngine on the upgraded artifact (tiers "
            f"{sorted(e.tier_plan.keep)}): the counts of phases 4-5 and the "
            f"/reads of phase 8 equal, in {time.perf_counter() - t0:.3f} s "
            f"| {card}")
        del e

        # -------------------------------------------- merge and import-bwt
        shards = sorted(d for d in pops["bam"].iterdir() if d.is_dir())
        t0 = time.perf_counter()
        src = artifact.load_artifact(shards[0], mmap=False)
        write_rle_bwt(work / "shard0.rlebwt", unpack_sym4(src.sym4, src.n),
                      src.num_reads)
        log(f"RLE-BWT of shard 0 (n = {src.n}) written in "
            f"{time.perf_counter() - t0:.3f} s | {card}")
        cli_steps([
            ("merge (interleave) of shards 0 and 1",
             ["merge", shards[0], shards[1], "--out", work / "merged"]),
            ("import-bwt of shard 0's RLE-BWT",
             ["import-bwt", "--bwt", work / "shard0.rlebwt",
              "--out", work / "imported"])], card, "each other")
        t0 = time.perf_counter()
        engs = {name: QueryEngine(artifact.load_artifact(path, mmap=False),
                                  cfg, device=dev)
                for name, path in (("merged", work / "merged"),
                                   ("imported", work / "imported"),
                                   ("s0", shards[0]), ("s1", shards[1]))}
        counts = {name: [r.count for r in e.count_batch(
            ckms, both_strands=True)] for name, e in engs.items()}
        check(counts["merged"] == [a + b for a, b in zip(counts["s0"],
                                                          counts["s1"])],
              "the merged artifact's counts are not its sources' sums")
        check(counts["imported"] == counts["s0"],
              "the imported artifact's counts differ from its source's")
        imp = engs["imported"].query_batch(ckms, both_strands=True)
        n = same_answers(imp, engs["s0"].query_batch(ckms, both_strands=True),
                         "/reads of the imported artifact", samples=False)
        log(f"merged (n = {engs['merged'].index.n}) counts = shard 0 + shard "
            f"1 on 256 queries on both strands; imported counts and /reads "
            f"({n} hit sets) equal to shard 0's, in "
            f"{time.perf_counter() - t0:.3f} s | {card}")
        del engs, src
        torch.cuda.empty_cache()
    launches = read_launches("ingest")
    for name in ("lut_level", "backward_search", "resolve_dsa",
                 "exact_histogram"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the ingest path")
    for name in ("rank_occ", "shard_occ"):
        check(launches[name] == 0,
              f"kernel {name} (a generic entry) launched on the ingest path")
    check(plain["n"] == 0, f"{plain['n']} plain forms of ops ran on the card "
          "on the ingest path")
    log("no plain form of ops ran on a CUDA tensor on the ingest path")
    shutil.rmtree(work, ignore_errors=True)
    return launches


def owner_rows(s, planes: int, rps: int, c, i):
    """The row each owner-form rank (c, i) reads, as one int64 id per
    lane (shard, plane, block), -1 where it reads none (i <= 0)."""
    import torch

    n = s.n
    sh = torch.searchsorted(s.starts, i.clamp(0, n - 1), right=True) - 1
    loc = torch.where(i >= n, s.lens.index_select(0, sh),
                      i - s.starts.index_select(0, sh))
    rows = (sh * planes + c.long()) * rps + (loc >> s.log2_block)
    return torch.where(i > 0, rows, torch.full_like(rows, -1))


def row_bytes(s, *row_sets) -> int:
    """Distinct rows of one table over id tensors (ids -1 read nothing),
    a row of row_words words each."""
    import torch

    sets = [r.reshape(-1) for r in row_sets if r.numel()]
    if not sets:
        return 0
    ids = torch.cat(sets)
    ids = ids[ids >= 0]
    return int(torch.unique(ids).numel()) * s.rank_rows.shape[2] * 4


def search_needs(s, codes, lut, p) -> tuple[int, int]:
    """→ (bytes, chain) of the sharded k-step search from the LUT: codes,
    each distinct LUT entry and owner row of the steps taken (the plain
    schedule's active lanes) read once, (l, u) int64 written; and the
    longest search's dependent reads (codes, LUT entry, a row pair a
    step)."""
    from readserver_tpu_torch.ops import search as so
    from readserver_tpu_torch.ops import sharded as sops

    B, K = codes.shape
    ids = so.prefix_ids(codes, p).long()
    lu = lut.index_select(0, ids)
    planes = {3: 64, 2: 16, 1: 5}
    rows, longest = [], [0]

    def step(k, code, l, u, act):
        longest[0] += int(bool(act.any()))
        for x in (l, u):
            rows.append(owner_rows(s, planes[k], s.rows_per_symbol, code,
                                   x)[act])
        return sops.step_plain(s, k, code, l, u, act)

    so.run_kstep(codes, lu[:, 0], lu[:, 1], K - p, 3, step)
    return (B * K * 4 + distinct(ids) * 16 + B * 16 + row_bytes(s, *rows),
            2 + longest[0])


def walk_needs(s, rows, valid) -> tuple[int, int]:
    """→ (bytes, chain) of K10's resolve of ``rows`` on the index's route:
    rows (8 B) and valid (1 B) in and three int32 out a lane, and the
    distinct words the walks read (dsa words; lf words, mark rows, pairs
    and dollar entries; sym4 words and rank rows), each once, plus each
    hit's sample entry; and the longest lane's dependent reads (one a
    step, its terminal reads, and the sample)."""
    import torch
    from readserver_tpu_torch.ops import sharded as sops

    kind = sops.walk_kind(s)
    lanes = rows.numel() * 21
    m = s.num_reads
    if kind == "dsa":
        rid, _ = sops.walk_plain(s, rows, valid)
        return (lanes + distinct(rows[valid]) * 4
                + distinct(rid[valid]) * 4, 2)
    cur, done = rows, ~valid
    reads = torch.zeros_like(rows)
    words, rank_rows, marks, pairs, dollars = [], [], [], [], []
    limit = max(s.sample_rate, 1) if kind == "lf" else s.max_read_len
    for t in range(limit):
        act = ~done
        if not bool(act.any()):
            break
        if kind == "lf":
            reads += act.long()
            words.append(cur[act])
            raw = sops._lookup_plain(s.lf_chunk, s.starts, s.lens, cur)
            val = (raw & 0x7FFFFFFF).long()
            term = (raw < 0) | (val < m)
            slot = sops.occ_plain(s, "marks", torch.zeros_like(raw), cur)
            marks.append(owner_rows(s, 1, s.mark_table.shape[1],
                                    torch.zeros_like(raw), cur)[act & (raw < 0)])
            pairs.append(slot[act & (raw < 0)])
            dollars.append(val[act & term & (raw >= 0)])
            reads += (act & term).long() * (1 + (raw < 0).long())
            cur = torch.where(act & ~term, val, cur)
            done = done | term
        else:
            reads += act.long()  # the kernel reads a step's rows in one round
            c = sops.sym_plain(s, cur)
            o = sops.occ_plain(s, "rank", c, cur)
            words.append((cur >> 3)[act])
            rank_rows.append(owner_rows(s, 5, s.rows_per_symbol, c, cur)[act])
            term = c == 0
            dollars.append(o[act & term])
            reads += (act & term).long()
            cur = torch.where(act & ~term, s.C.index_select(0, c.long()) + o,
                              cur)
            done = done | term
    rid, _ = sops.walk_plain(s, rows, valid)
    nbytes = (lanes + distinct(*words) * 4 + row_bytes(s, *rank_rows)
              + row_bytes(s, *marks)
              + distinct(*pairs) * 8 + distinct(*dollars) * 4
              + distinct(rid[rid >= 0]) * 4)
    return nbytes, int(reads.max()) + 1 if reads.numel() else 0


def sets_past_l2(nbytes: int) -> int:
    """How many distinct input sets of ``nbytes`` each to time in turn:
    N_ROT, or more (up to 64) where together they would not need twice
    the card's L2, so that no call finds its inputs left there by the
    calls before it."""
    return min(64, max(N_ROT, -(-2 * L2_BYTES // max(nbytes, 1))))


def sweep_needs(s, l, u, window: int, cap: int) -> tuple[int, int]:
    """→ (bytes, chain) of the exact sweep of intervals (l, u) on the
    index's route: the intervals in, the histograms written, and what the
    walks of the rows swept read (:func:`walk_needs`: each distinct dsa
    word, or lf or slow walk word and row, and each read's sample entry,
    once); the chain is the longest walk's."""
    import torch

    total = int((u - l).sum())
    limit = min(total, -(-cap // window) * window)
    wl = torch.repeat_interleave(l, (u - l))[:limit]
    first = torch.repeat_interleave(torch.cumsum(u - l, 0) - (u - l),
                                    u - l)[:limit]
    rows = wl + torch.arange(limit, device=l.device) - first
    walk, chain = walk_needs(s, rows, torch.ones_like(rows, dtype=torch.bool))
    # walk_needs counts each lane's row, valid flag and three outputs
    return (l.numel() * 16 + walk - rows.numel() * 21
            + l.numel() * s.num_samples * 4, chain)


def sharded_stage(engine):
    """An interval-sharded ``QueryEngine``'s device program for one padded
    batch, the "copy in + device" stage of :func:`request_breakdown`."""
    return lambda codes, lengths, nq: engine._sharded_program(
        codes, lengths, nq, engine._new_bad())


def doc_stage(engine):
    """A doc-sharded ``QueryEngine``'s device program for one padded batch
    (its shards, the merge's all-reduce and the hit sets' gather), the
    "copy in + device" stage of :func:`request_breakdown`."""
    return lambda codes, lengths, nq: engine._doc_program(
        codes, lengths, nq, engine._new_bad())


def sharded_fetch(out) -> dict:
    """The sharded program's outputs on the host (``_run_sharded``'s
    copies out)."""
    return {k: v.cpu().numpy() for k, v in out.items()}


def check_interval_kernels(engines, ceng_s, cpacked, batch, cbatch, rot,
                           cohort, q4096, c4096, seed: int, t_row, card):
    """Phase 11b: each sharded kernel against its plain form on the card,
    max |err| 0, at phase 11's shapes and on distinct input sets of those
    shapes, enough that together they need twice the L2 (K11's one build
    writes many times the L2); then, the sets taken in turn, its wrapper
    time (CUDA events), device time (profiler), plain time, bytes bound
    (of the sets' mean bytes) and, for the search and the walks, chain
    bound (the longest over the sets) → ({name: summary entry}, max |err|
    by kernel).  K10's entry also holds each route's reading under
    ``routes``: the resolve on the dsa, lf and slow engines, and the exact
    sweep on cohort engines of each route.  ``rot``: phase 7's distinct
    E. coli batches on the card.  Last, the served ``/reads`` of 4096 x 2
    on each route and the cohort's ``/samples``, split into host stages
    and the device's busy share (:func:`request_breakdown`)."""
    import torch
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.ops import sharded as sops
    from readserver_tpu_torch.parallel import build_prefix_lut_sharded
    from readserver_tpu_torch.serve import QueryEngine

    eng = engines["dsa"]
    s = eng.sidx
    dev = s.starts.device
    rng = np.random.default_rng(11)

    cases = []  # (name, kernel name, fn, plain, sets, what, bytes, chain)
    X = 2 * 262_144

    def ranks(_):
        return (torch.from_numpy(rng.integers(0, 5, size=X).astype(np.int32))
                .to(dev), torch.from_numpy(rng.integers(0, s.n + 1, size=X))
                .to(dev))

    sets, nb, _ = in_turn(ranks, lambda c, i: (X * 20 + row_bytes(
        s, owner_rows(s, 5, s.rows_per_symbol, c, i)), None))
    cases.append(("shard_occ", "shard_occ_kernel",
                  lambda c, i: sops.occ(s, "rank", c, i),
                  lambda c, i: sops.occ_plain(s, "rank", c, i), sets,
                  f"{X} random ranks over {SHARDS} shards", nb, None))
    # K11: every level against the plain level on the same inputs
    p = eng.lut_p
    l, u = s.C[1:5].contiguous(), s.C[2:6].contiguous()
    lut_err, lut_bytes = 0, 0
    for _ in range(p - 1):
        got = sops.lut_level(s, l, u)
        want = sops.lut_level_plain(s, l, u)
        lut_err = max(lut_err, max_err(zip(got, want)))
        alive = l < u
        rows = [owner_rows(s, 5, s.rows_per_symbol,
                           torch.full_like(x[alive], cc, dtype=torch.int32),
                           x[alive]) for cc in range(1, 5) for x in (l, u)]
        lut_bytes += l.numel() * 80 + row_bytes(s, *rows)
        l, u = got
    check(lut_err == 0, f"K11 disagrees with its plain level (|err| "
          f"{lut_err})")

    def plain_lut():
        a, b = s.C[1:5], s.C[2:6]
        for _ in range(p - 1):
            a, b = sops.lut_level_plain(s, a, b)
        empty = a >= b
        return torch.stack([torch.where(empty, 0, a),
                            torch.where(empty, 0, b)], dim=1)

    cases.append(("sharded_lut_level", "sharded_lut_level_kernel",
                  lambda: build_prefix_lut_sharded(s, None, p), plain_lut,
                  [()], f"the p={p} build, {p - 1} levels", lut_bytes, None))
    # the search on the served width-8192 batch, every mode checked; then
    # timed over it and width-8192 slices of phase 7's distinct batches
    ce, le, nq = eng._pad_encode(batch)
    codes, lengths = eng._to_device(ce, le)
    for kstep, lt, pp in ((3, eng.lut, p), (2, eng.lut, p), (1, eng.lut, p),
                          (1, None, 0), (3, None, 0)):
        got = sops.search(s, codes, lengths, lt, pp, kstep)
        want = sops.search_plain(s, codes, lengths, lt, pp, kstep)
        check(max_err(zip(got, want)) == 0,
              f"the sharded search (kstep {kstep}, LUT {lt is not None}) "
              f"disagrees with its plain form")
    W = codes.shape[0]
    slices = [codes] + [b[j * W:(j + 1) * W] for b in rot
                        for j in range(b.shape[0] // W)]
    sets, nb, chain = in_turn(lambda j: (slices[j],),
                              lambda q: search_needs(s, q, eng.lut, p))
    cases.append(("sharded_search", "sharded_search_kernel",
                  lambda q: sops.search(s, q, None, eng.lut, p, 3),
                  lambda q: sops.search_plain(s, q, None, eng.lut, p, 3),
                  sets, f"width {W}, {codes.shape[1]}-mers, k-step from the "
                  f"p={p} LUT", nb, chain))
    # K10 on each route's engine over those batches' hit lanes, H = 64
    H = eng.H
    lanes = {}

    def slice_lanes(j):
        if j not in lanes:
            lanes[j] = hit_lanes(s, slices[j], eng.lut, p, H)
        return lanes[j]

    for route, e in engines.items():
        sr = e.sidx
        sets, nb, chain = in_turn(
            slice_lanes, lambda rows, valid, sr=sr: walk_needs(sr, rows, valid))
        cases.append((
            f"sharded_resolve ({route})", "sharded_resolve_kernel",
            lambda rows, valid, sr=sr: sops.resolve(sr, rows, valid),
            lambda rows, valid, sr=sr: sops.resolve_plain(sr, rows, valid),
            sets, f"{W} x {H} lanes ({int(sets[0][1].sum())} hits in the "
            f"served batch), {route} route", nb, chain))
    # the exact sweep on the cohort's served width-8192 batch, then on
    # cohort batches of 8192 31-mers
    cs = ceng_s.sidx
    ce, le, nq = ceng_s._pad_encode(cbatch)
    cqs = [ceng_s._to_device(ce, le)[0]]

    def cohort_set(j):
        while len(cqs) <= j:
            q = simulate.sample_query_kmers_fast(
                cohort, W, KMER, seed=seed + 5 + len(cqs), miss_frac=0.1)
            cqs.append(torch.from_numpy(q.astype(np.int32)).to(dev))
        return sops.search(cs, cqs[j], None, ceng_s.lut, ceng_s.lut_p, 3)

    SW, cap = 32_768, ceng_s.cfg.max_sweep_rows
    # the cohort as each route's deployment ships it (phase 11's drops)
    croutes = {"dsa": cs}
    for route in ("lf", "slow"):
        t0 = time.perf_counter()
        e = QueryEngine(dataclasses.replace(cpacked, **ROUTE_DROPS[route]),
                        ceng_s.cfg, ceng_s.mesh, device=dev)
        check(sops.walk_kind(e.sidx) == route,
              f"the cohort's {route} engine does not walk {route}")
        croutes[route] = e.sidx
        log(f"cohort interval engine, {route} route, up in "
            f"{time.perf_counter() - t0:.3f}s")
    for route, cr in croutes.items():
        sets, nb, chain = in_turn(
            cohort_set,
            lambda cl, cu, cr=cr: sweep_needs(cr, cl, cu, SW, cap))
        rows0 = int((sets[0][1] - sets[0][0]).sum())
        cases.append((
            f"sharded_resolve (sweep, {route})", "sharded_sweep_kernel",
            lambda cl, cu, cr=cr: sops.sweep(cr, cl, cu, SW, cap),
            lambda cl, cu, cr=cr: sops.sweep_plain(cr, cl, cu, SW, cap), sets,
            f"exact sweep of {min(rows0, -(-cap // SW) * SW)} of {rows0} "
            f"rows in the served batch over 128 samples, window {SW}, "
            f"{route} route", nb, chain))

    # K14's int64 entry (with the walk's sample column) and K15's sample
    # mode at phase 11's shapes: the served batch and the slices, searched
    # on the interval index, compacted under the engine's budget and walked
    # by the dsa route; then the torch ops they replaced, over the same sets
    from readserver_tpu_torch.ops import resolve

    R = max(int(eng.cfg.resolve_budget_frac * W * H), 1)
    S1 = s.num_samples

    def interval_lanes(j):
        l, u = sops.search(s, slices[j], None, eng.lut, p, 3)
        rows_c, valid_c, prefix = resolve.compact_lanes(l, u, H, R)
        rid_c, off_c, smp_c = sops.resolve(s, rows_c, valid_c)
        _, _, smp, kept = resolve.gather_lanes(l, u, H, R, prefix, rid_c,
                                               off_c, smp_c=smp_c)
        return l, u, prefix, rid_c, off_c, smp_c, smp, kept

    isets, _, _ = in_turn(interval_lanes, lambda *x: (
        16 * W + 4 * (W + 1) + 9 * R, None))
    slots = int(np.mean([min(int(x[2][-1]), R) for x in isets]))
    F = W * H
    what = (f"width {W}, int64 intervals, {F} lanes, budget {R}, {slots} "
            f"slots walked (mean)")
    compact_cases = [
        ("row_compact (interval)", "row_compact",
         lambda l, u, *_: resolve.compact_lanes(l, u, H, R),
         lambda l, u, *_: resolve.compact_lanes_plain(l, u, H, R), isets,
         what, 16 * W + 4 * (W + 1) + 9 * R, None),
        ("row_gather (interval)", "row_gather",
         lambda l, u, pr, rc, oc, sc, *_: resolve.gather_lanes(
             l, u, H, R, pr, rc, oc, smp_c=sc),
         lambda l, u, pr, rc, oc, sc, *_: resolve.gather_lanes_plain(
             l, u, H, R, pr, rc, oc, smp_c=sc), isets,
         what + ", the walk's sample column",
         4 * (W + 1) + 12 * slots + 13 * F, None),
        ("capped_histogram (interval)", "capped_hist",
         lambda *x: resolve.lane_histogram(x[6], x[7], S1),
         lambda *x: resolve.lane_histogram_plain(x[6], x[7], S1), isets,
         what + f", sample mode, S = {S1}", F + 4 * slots + 4 * W * S1,
         None),
    ]
    compact_out = time_cases(compact_cases, None, card)
    ops = lambda fn: lambda l, u, pr, rc, oc, sc, *_: fn(  # noqa: E731
        l, u, H, R, rc, oc, sc, S1)
    for x in isets:
        check(max_err(zip(ops(interval_kernel_ops)(*x),
                          ops(interval_torch_ops)(*x))) == 0,
              "K14 + K15 differ from the interval program's torch ops")
    kdev = sum(compact_out[n][2] or 0.0 for n, *_ in compact_cases)
    t_ms, t_dev = time_ops(
        isets, ops(interval_torch_ops), "the interval programs' compaction, "
        "scatter back and index_add_ (JAX _query_body 902-942)", card, kdev)
    k_ms, k_dev = time_ops(
        isets, ops(interval_kernel_ops), "the same through K14 and K15 "
        "(parallel/sharded._hit_lanes), outputs equal", card, kdev)
    interval_ops = dict(torch_ms=t_ms, torch_device_ms=t_dev,
                        kernels_ms=k_ms, kernels_device_ms=k_dev,
                        kernels_sum_device_ms=kdev, sets=len(isets),
                        shape=what)

    errs = {"sharded_lut_level": lut_err}
    out, routes = {}, {}
    for name, got in time_cases(cases, t_row, card).items():
        key = name.split(" ")[0]
        errs.setdefault(key, 0)  # time_cases held each case equal
        out.setdefault(key, got)
        if key == "sharded_resolve":
            tk, tp, dev_ms, bnd, what, chain_ms = got
            held = max(bnd, chain_ms or 0.0)
            routes[name[name.index("(") + 1:-1]] = dict(
                device_ms=dev_ms, ms=tk, plain_ms=tp, bound_ms=bnd,
                chain_ms=chain_ms, share=None if not dev_ms else held / dev_ms,
                shape=what)
    out.update(compact_out)
    out["interval_ops"] = interval_ops
    # where a served interval request's time goes, by route
    for route, e in engines.items():
        log(f"served on the interval engine, {route} route:")
        request_breakdown(e, decode_all(q4096), "reads", sharded_stage(e),
                          fetch=sharded_fetch)
    log("served on the cohort's interval engine, dsa route:")
    request_breakdown(ceng_s, decode_all(c4096), "samples",
                      sharded_stage(ceng_s), fetch=sharded_fetch)
    return out, errs, routes


def max_err(pairs) -> int:
    """Largest |kernel - plain| over (kernel, plain) tensor pairs."""
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


# ------------------------------------------------------------------ bounds
# Each kernel's bytes bound is the bytes its work needs (each input byte
# read once, each output byte written once, table rows counted once each
# over the rows the work actually touches) over the card's memory rate;
# every kernel here does a few integer operations per byte, far below the
# card's operation rates, so of the two bounds the JSON line's `bound_ms`
# takes, bytes bind all of them.  The walks and the search are also held
# by a chain of dependent reads: their chain bound is the longest chain's
# reads (off the plain form's active masks) times t_row, one read's
# unloaded time on this card, measured by the rs_chase yardstick.

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3 (NVIDIA's data sheet)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def chase(fused, starts, steps: int, out=None):
    """One launch of the rs_chase yardstick: a chain of ``steps``
    dependent 64-byte reads through ``fused`` from each block in
    ``starts`` (int32 on the card), each next block a hash of the words
    just read.  Launched directly: it is no kernel of the port's paths."""
    import torch
    from readserver_tpu_torch.kernels import LIBRARY

    out = torch.empty_like(starts) if out is None else out
    rc = LIBRARY.get().rs_chase(
        fused.data_ptr(), fused.shape[1], fused.shape[0], starts.data_ptr(),
        starts.numel(), steps, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"rs_chase: CUDA error {rc} at launch")
    return out


def chase_t_row(fused, rng, dev, cold: bool):
    """One warp of chains (32), 32 and 64 steps → (t_row ms, the 32-step
    launch's device ms / 32), by the profiler's device time (the host
    cannot launch a kernel this short as fast as the card runs it), or
    None when the profiler saw none.  t_row is the difference of the two
    over 32 steps, so the launch's own time drops out.  ``cold``: new
    random starts per launch (rows from the card's memory); else the same
    starts each launch (rows from L2)."""
    import torch

    nb = fused.shape[0]
    t = {}
    for steps in (32, 64):
        # cold: starts drawn anew for each launch and each step count, so
        # no chain meets rows an earlier launch left in L2
        starts = [torch.from_numpy(rng.integers(0, nb, size=32)
                                   .astype(np.int32)).to(dev)
                  for _ in range(256 if cold else 1)]
        out = torch.empty_like(starts[0])
        turn = itertools.cycle(starts)
        fn = lambda: chase(fused, next(turn), steps, out)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        t[steps] = kernel_device_ms(fn, 32, "chase_kernel")
        if t[steps] is None:
            return None
    return (t[64] - t[32]) / 32, t[32] / 32


def distinct(*parts) -> int:
    """Distinct values over integer tensors (rows to read once)."""
    import torch

    parts = [t.reshape(-1).long() for t in parts if t.numel()]
    return int(torch.unique(torch.cat(parts)).numel()) if parts else 0


def k1_bytes(table, c, i, lay) -> int:
    """occ(c, i): c and i in, occ out, the distinct rows they touch."""
    rows = c.long() * lay["rows_per_symbol"] + (i >> lay["log2_block"]).long()
    return c.numel() * 12 + distinct(rows) * table.shape[1] * 4


def level_bytes(idx, l, u) -> int:
    """One level of the LUT build: (l, u) in, 4S (l, u) out, and the
    distinct rows of the alive intervals' ranks for c = 1..4."""
    alive = l < u
    sh, rps = idx.log2_block, idx.rows_per_symbol
    rows = [c * rps + (x[alive] >> sh).long() for c in range(1, 5)
            for x in (l, u)]
    return l.numel() * 40 + distinct(*rows) * idx.rank_rows.shape[1] * 4


def k2_needs(idx, codes, lut, p) -> tuple[int, int, int]:
    """→ (bytes, steps, chain) of K2's k-step search from the LUT on
    ``codes``: the codes, each distinct LUT entry and each distinct rank
    row of the steps taken (the plain schedule's active masks) read once,
    (l, u) written; the number of steps taken; and the longest chain of
    dependent reads: the code tile, the LUT entry, then one (l, u) row
    pair per step of the longest search."""
    import torch
    from readserver_tpu_torch.ops import search as so

    B, K = codes.shape
    ids = so.prefix_ids(codes, p).long()
    lu = lut.index_select(0, ids)
    tables = {3: (idx.rank3_rows, idx.C3), 2: (idx.rank2_rows, idx.C2),
              1: (idx.rank_rows, idx.C)}
    rows = {3: [], 2: [], 1: []}
    count = {"steps": 0, "longest": 0}

    def step(k, code, l, u, act):
        count["steps"] += int(act.sum())
        count["longest"] += int(bool(act.any()))
        base = code.long() * idx.rows_per_symbol
        rows[k] += [(base + (x >> idx.log2_block).long())[act] for x in (l, u)]
        return so._step_plain(idx, *tables[k], code, l, u, act)

    kstep = 3 if idx.rank3_rows is not None else 2
    so.run_kstep(codes, lu[:, 0].contiguous(), lu[:, 1].contiguous(), K - p,
                 kstep, step)
    nbytes = B * K * 4 + distinct(ids) * 8 + B * 8 + sum(
        distinct(*rows[k]) * tables[k][0].shape[1] * 4 for k in rows)
    return nbytes, count["steps"], 2 + count["longest"]


def fused_walk_needs(idx_f, rows, valid) -> tuple[int, int]:
    """→ (bytes, chain) of the walks of ``rows``: the distinct fused rows
    they visit (the plain walk's active lanes, terminal rows included) and
    their terminal lookups (a sampled pair or a dollar_map entry); and the
    longest walk's dependent reads, its rows and its terminal read."""
    import torch
    from readserver_tpu_torch.ops import resolve as rz

    cur = torch.where(valid, rows, torch.zeros_like(rows))
    done = ~valid
    seen = []
    reads = torch.zeros_like(rows)
    for _ in range(idx_f.sample_rate):
        seen.append((cur >> idx_f.log2_block)[~done])
        reads += (~done).to(reads.dtype)
        c, o, marked, _ = rz._fused_step_fields(idx_f, cur)
        is_term = marked | (c == 0)
        step_now = ~done & ~is_term
        cur = torch.where(step_now, rz._take(idx_f.C, c) + o, cur)
        done = done | is_term
    _, o, marked, slot = rz._fused_step_fields(idx_f, cur)
    end = valid & done
    reads += end.to(reads.dtype)
    return (distinct(*seen) * idx_f.fused_rows.shape[1] * 4
            + distinct(slot[end & marked]) * 8
            + distinct(o[end & ~marked]) * 4,
            int(reads.max()) if reads.numel() else 0)


def rank_walk_needs(idx, kind, rows, valid, max_steps=None):
    """→ (bytes, chain) of the marks, lf or slow walks of ``rows``: the
    distinct table words the plain walk reads on its active lanes (sym4
    words, the rank row of each symbol's plane and the mark rows; or the
    lf words), its terminal lookups (a mark row and a sampled pair, or a
    dollar_map entry); and the longest walk's dependent reads: one a step
    (the kernel reads a step's rows in one round), its terminal read, and
    for the lf walk's sampled rows the mark row before the pair."""
    import torch
    from readserver_tpu_torch.ops import rank as rank_ops
    from readserver_tpu_torch.ops import resolve as rz

    lg, rps = idx.log2_block, idx.rows_per_symbol
    kw = dict(log2_block=lg, words_per_block=idx.words_per_block)
    cur = torch.where(valid, rows, torch.zeros_like(rows))
    done = ~valid
    reads = torch.zeros_like(rows)
    seen = {"sym4": [], "rank": [], "marks": [], "lf": []}
    limit = (idx.sample_rate if kind != "slow"
             else max_steps or idx.max_read_len)
    o = torch.zeros_like(rows)
    for _ in range(limit):
        act = ~done
        reads += act.to(reads.dtype)
        if kind == "lf":
            raw = rz._take(idx.lf, cur)
            seen["lf"].append(cur[act])
            nxt = raw & 0x7FFFFFFF
            is_term = (raw < 0) | (nxt < idx.C[1])
            o = torch.where(act, nxt, o)
        else:
            c = rank_ops.read_symbol(idx, cur)
            occ = rank_ops.occ_rows_plain(idx.rank_rows, c, cur,
                                          rows_per_symbol=rps, **kw)
            seen["sym4"].append((cur >> 3)[act])
            seen["rank"].append((c.long() * rps + (cur >> lg).long())[act])
            is_term = c == 0
            if kind == "marks":
                _, marked = rank_ops.bit_rank_and_test(idx.mark_rank, cur, **kw)
                seen["marks"].append((cur >> lg)[act])
                is_term = is_term | marked
            nxt = rz._take(idx.C, c) + occ
            o = torch.where(act, occ, o)
        step = act & ~is_term
        cur = torch.where(step, nxt, cur)
        done = done | is_term
    end = valid & done
    if kind == "slow":
        marked = torch.zeros_like(end)
    elif kind == "lf":
        marked = rz._take(idx.lf, cur) < 0
    else:
        _, marked = rank_ops.bit_rank_and_test(idx.mark_rank, cur, **kw)
    slot = rank_ops.occ_rows_plain(idx.mark_rank, torch.zeros_like(cur), cur,
                                   rows_per_symbol=idx.mark_rank.shape[0],
                                   **kw) if kind != "slow" else cur
    if kind == "lf":
        seen["marks"].append((cur >> lg)[end & marked])
    reads += end.to(reads.dtype) + (end & marked).to(reads.dtype) * (
        kind == "lf")
    rw = idx.rank_rows.shape[1] * 4
    nbytes = (distinct(*seen["sym4"]) * 4 + distinct(*seen["rank"]) * rw
              + distinct(*seen["marks"]) * rw + distinct(*seen["lf"]) * 4
              + distinct(slot[end & marked]) * 8
              + distinct(o[end & ~marked]) * 4)
    return nbytes, int(reads.max()) if reads.numel() else 0


def walk_forms():
    """kind → (the rank walk, its plain form)."""
    from readserver_tpu_torch.ops import resolve as rz

    return {"marks": (rz.resolve_rows_marked, rz.resolve_rows_marked_plain),
            "lf": (rz.resolve_rows_fast, rz.resolve_rows_fast_plain),
            "slow": (rz.resolve_rows, rz.resolve_rows_plain)}


def fill_k(n: int, rows_per_query: int) -> int:
    """The longest k at which a k-mer's interval holds, on average, at
    least ``rows_per_query`` of ``n`` rows (10 for the E. coli index at
    2H = 128, 8 for the cohort at 256)."""
    return int(np.log(n / rows_per_query) / np.log(4))


def interval_rows(l, u):
    """Every row of every interval, in order (the sweep's worklist when
    no cap binds)."""
    import torch

    counts = (u - l).long()
    starts = torch.repeat_interleave(l.long(), counts)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    return (starts + torch.arange(starts.numel(), device=l.device)
            - first).int()


def serve_scaling(card: str) -> dict:
    """Phase 15: ``bench/scaling_sim.py`` on the card, as ``python -m
    readserver_tpu_torch.bench.scaling_sim`` runs it: the interval-sharded
    program at every (dp, shard) factorisation of 8, all shards on the
    card, in the one-device form and the cross-rank form over this rank
    alone on the dsa and the lf route; answers equal across every width
    and form, and each cross-rank route's all-reduces equal to
    ``query_psum_estimate`` once a dp row → the module's JSON object."""
    from readserver_tpu_torch.bench import scaling_sim

    t0 = time.perf_counter()
    try:
        res = scaling_sim.run(8, "cuda")
    except AssertionError as e:
        raise PhaseFailed(f"scaling_sim: {e}") from e
    for w in res["scaling_sim"]:
        check(w["parity"] == "exact" and all(
            a["counted"] == a["estimate"] for a in w["all_reduces"].values()),
            f"scaling_sim at dp={w['dp']}, shards={w['shards']}: {w}")
    log(f"scaling_sim on the card in {time.perf_counter() - t0:.3f}s, "
        f"parity exact at " + ", ".join(
            f"(dp {w['dp']}, shards {w['shards']})"
            for w in res["scaling_sim"])
        + "; all-reduces a batch equal to the estimate on both cross-rank "
        f"routes | {card}")
    log(f"scaling_sim: {json.dumps(res)}")
    return res


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
    from readserver_tpu_torch.ops import DeviceIndex, encode_query_batch
    from readserver_tpu_torch.ops import resolve
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
        packed = load_or_build(corpus, cache, build_index, artifact,
                               native_available)
        check(packed.rank3_blocks is not None, "artifact has no triple tier")

    # ------------------------------------------------------ 4. main path
    rng = np.random.default_rng(args.seed)
    pool = simulate.sample_query_kmers_fast(
        corpus, 4096 + 256 + 1, KMER, seed=args.seed, miss_frac=0.15
    )
    q1, q256, q4096 = pool[:1], pool[1:257], pool[257:]
    def zero_launches():
        for k in KERNELS.values():
            k.launches = 0

    def read_launches(path: str) -> dict:
        counts = {name: k.launches for name, k in KERNELS.items()}
        path_launches[path] = counts
        log(f"launches during the {path} path: {counts}")
        return counts

    path_launches: dict[str, dict] = {}
    # the plain packs (K8's and the merge's torch ops) may not run on the
    # card anywhere on the main paths (phases 4 to 15)
    main_paths = contextlib.ExitStack()
    plain_packs = main_paths.enter_context(plain_calls_on_card(("pack",)))
    with phase("4 main path"):
        zero_launches()
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
            f"p={engine.lut_p} ({engine.lut.nbytes} B) through K1's level "
            f"entry in {engine.startup_seconds['lut']:.3f}s")
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
        launches = read_launches("count")
        for name in ("lut_level", "backward_search"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the count path")

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

    # ----------------------------------------------------------- 8. reads
    H = cfg.max_hits
    with phase("8 reads"):
        zero_launches()
        cfg_f = dataclasses.replace(cfg, drop_tiers=("dsa",))
        t0 = time.perf_counter()
        engine_f = QueryEngine(packed, cfg_f, device=dev)
        engine_f.warmup()
        log(f"fused engine up and warm in {time.perf_counter() - t0:.3f}s: "
            f"tiers kept {sorted(engine_f.tier_plan.keep)}, row budget "
            f"{engine_f.row_budget} of {cfg.batch_size * H} lanes")
        # the rank walks: the mark walk (the smallest resolve tier), the lf
        # walk (artifacts that carry no dsa) and the slow walk (no sample
        # rate), each through the walk kernel
        walk_engines = {}
        for wname, drop in (("mark-walk", ("dsa", "fused", "lf")),
                            ("lf", ("dsa", "fused")),
                            ("slow", ("dsa", "fused", "marks", "lf"))):
            t0 = time.perf_counter()
            e = QueryEngine(packed, dataclasses.replace(cfg, drop_tiers=drop),
                            device=dev)
            e.warmup()
            walk_engines[wname] = e
            log(f"{wname} engine up and warm in "
                f"{time.perf_counter() - t0:.3f}s: tiers kept "
                f"{sorted(e.tier_plan.keep)}, walk "
                f"{resolve.walk_kind(e.index)}")
        engine_m = walk_engines["mark-walk"]
        check(engine.index.dsa is not None, "the default plan has no dsa")
        check(engine_f.index.dsa is None
              and engine_f.index.fused_rows is not None,
              "the drop_tiers=('dsa',) plan does not walk fused rows")
        for wname, kind in (("mark-walk", "marks"), ("lf", "lf"),
                            ("slow", "slow")):
            check(resolve.walk_kind(walk_engines[wname].index) == kind,
                  f"the {wname} engine's plan does not walk {kind}")
        reads_served = {}
        for name, qs, both in (("1", q1, False), ("256", q256, False),
                               ("4096x2", q4096, True)):
            kms = decode_all(qs)
            took = {}
            res = None
            for ename, e in (("dsa", engine), ("fused", engine_f),
                             *walk_engines.items()):
                t0 = time.perf_counter()
                got = e.query_batch(kms, both_strands=both)
                took[ename] = time.perf_counter() - t0
                if res is None:
                    res = got
                check(got == res, f"the dsa and {ename} engines disagree on "
                      f"the request of {name}")
            reads_served[name] = res
            log(f"/reads request of {name} queries: " + ", ".join(
                f"{ename} engine {dt * 1e3:.3f} ms"
                for ename, dt in took.items())
                + f", {sum(len(r.hits) for r in res)} hits, "
                f"{sum(r.hits_truncated for r in res)} truncated, answers "
                f"equal")
        launches = read_launches("reads")
        for name in ("resolve_dsa", "resolve_fused", "resolve_walk",
                     "sparse_pack"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the reads path")
        check(launches["rank_occ"] == 0, "K1's generic entry launched on "
              "the reads path: a walk ran its plain form")
        t0 = time.perf_counter()
        mat = np.stack(corpus.reads)
        fwd = np.concatenate([q1, q256[:63], q4096[:32]])
        want_hits = hit_oracle(mat, np.concatenate([fwd, rc_pool[:32]]))
        del mat
        served_q = ([reads_served["1"][0]] + reads_served["256"][:63]
                    + reads_served["4096x2"][:32])
        for i, res in enumerate(served_q):
            if i < 64:
                check_hits(res, want_hits[i], H, corpus.sample_ids)
                check(res.count == len(want_hits[i]), f"{res.kmer} count")
            else:
                w_rc = set() if pal[i - 64] else want_hits[i + 32]
                check_hits(res, want_hits[i], H, corpus.sample_ids, "+")
                check_hits(res, w_rc, H, corpus.sample_ids, "-")
                check(res.count == len(want_hits[i]) + len(w_rc),
                      f"{res.kmer} both-strands count")
            check(res.hits_truncated == (res.count > len(res.hits)),
                  f"{res.kmer}: hits_truncated is not count > len(hits)")
        log(f"oracle hit sets: {len(served_q)} queries (64 one strand, 32 "
            f"both) equal to the windows that match them, "
            f"{sum(len(w) for w in want_hits)} windows, "
            f"{sum(r.hits_truncated for r in served_q)} capped at H={H} "
            f"(subsets), in {time.perf_counter() - t0:.3f}s")

    # --------------------------------------------------------- 9. samples
    with phase("9 samples"):
        ccache = REPO / "data" / "chip_smoke" / f"cohort_s{args.scale:g}"
        t0 = time.perf_counter()
        cohort = simulate.simulate_config("cohort", scale=args.scale)
        log(f"simulated cohort scale={args.scale:g}: {len(cohort.reads)} "
            f"reads of {cohort.spec.num_samples} samples in "
            f"{time.perf_counter() - t0:.3f}s")
        cpacked = load_or_build(cohort, ccache, build_index, artifact,
                                native_available)
        check(cpacked.num_samples == 128, "the cohort has not 128 samples")
        zero_launches()
        t0 = time.perf_counter()
        ceng = QueryEngine(cpacked, cfg, device=dev)
        ceng.warmup()
        ceng_f = QueryEngine(cpacked, cfg_f, device=dev)
        ceng_f.warmup()
        ceng_m = QueryEngine(cpacked, dataclasses.replace(
            cfg, drop_tiers=("dsa", "fused", "lf")), device=dev)
        ceng_m.warmup()
        log(f"cohort engines (dsa: {sorted(ceng.tier_plan.keep)}; fused: "
            f"{sorted(ceng_f.tier_plan.keep)}; marks: "
            f"{sorted(ceng_m.tier_plan.keep)}) up and warm in "
            f"{time.perf_counter() - t0:.3f}s")
        check([resolve.walk_kind(e.index) for e in (ceng, ceng_f, ceng_m)]
              == ["dsa", "fused", "marks"],
              "the cohort engines do not walk dsa, fused and marks")
        cpool = simulate.sample_query_kmers_fast(
            cohort, 4096 + 256, KMER, seed=args.seed + 3, miss_frac=0.1)
        c256, c4096 = cpool[:256], cpool[256:]
        ckms = decode_all(c256)
        answers = {}
        for ename, eng in (("dsa", ceng), ("fused", ceng_f),
                           ("marks", ceng_m)):
            k7 = KERNELS["exact_histogram"].launches
            for tier, hits in (("hist", False), ("full", True)):
                t0 = time.perf_counter()
                answers[ename, tier] = eng.query_batch(ckms, include_hits=hits)
                log(f"/samples request of 256 queries ({tier}, {ename} "
                    f"walk): {(time.perf_counter() - t0) * 1e3:.3f} ms")
            check(KERNELS["exact_histogram"].launches > k7,
                  f"K7 did not launch through the {ename} walk")
        for ename in ("fused", "marks"):
            check(answers["dsa", "hist"] == answers[ename, "hist"]
                  and answers["dsa", "full"] == answers[ename, "full"],
                  f"the dsa and {ename} cohort engines disagree")
        key = lambda r: (r.count, r.sample_hist, r.sample_hist_complete)  # noqa: E731
        check([key(r) for r in answers["dsa", "hist"]]
              == [key(r) for r in answers["dsa", "full"]],
              "histogram-only and full answers disagree")
        launches = read_launches("samples")
        for name in ("exact_histogram", "resolve_fused", "resolve_walk",
                     "sparse_pack"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the samples path")
        check(launches["rank_occ"] == 0, "K1's generic entry launched on "
              "the samples path: a walk ran its plain form")
        t0 = time.perf_counter()
        cmat = np.stack(cohort.reads)
        want_c = hit_oracle(cmat, c256[:96])
        del cmat
        names = cpacked.sample_names
        for ename in ("dsa", "marks"):
            for res, w in zip(answers[ename, "hist"][:96], want_c):
                rids = np.fromiter((r for r, _ in w), dtype=np.int64)
                per = np.bincount(cohort.sample_ids[rids], minlength=128)
                want_hist = {names[i]: int(c) for i, c in enumerate(per) if c}
                check(res.count == len(w) and res.sample_hist == want_hist
                      and res.sample_hist_complete,
                      f"{res.kmer}: the {ename} engine's histogram differs "
                      f"from the oracle")
        log(f"oracle histograms: 96 cohort queries exact and complete on the "
            f"dsa and the marks engine "
            f"({sum(len(w) for w in want_c)} windows over "
            f"{len({s for r in answers['dsa', 'hist'][:96] for s in r.sample_hist})}"
            f" samples) in {time.perf_counter() - t0:.3f}s")
        # a capped engine: one window of half the batch's rows
        counts = np.array([r.count for r in answers["dsa", "hist"]])
        window = max(int(counts.sum()) // 2, 1)
        cap_eng = QueryEngine(cpacked, dataclasses.replace(
            cfg, max_sweep_rows=window, sweep_window=window), device=dev)
        capped = cap_eng.query_batch(ckms, include_hits=False)
        want_complete = np.cumsum(counts) <= window
        got_complete = np.array([r.sample_hist_complete for r in capped])
        check(np.array_equal(got_complete, want_complete)
              and want_complete.any() and not want_complete.all(),
              "the capped engine's complete flags break the window rule")
        for r, full in zip(capped, answers["dsa", "hist"]):
            if r.sample_hist_complete:
                check(r.sample_hist == full.sample_hist, f"{r.kmer}: capped "
                      "but complete histogram differs")
        log(f"capped engine (max_sweep_rows = sweep_window = {window} of "
            f"{int(counts.sum())} rows): {int(got_complete.sum())} of 256 "
            f"queries complete, exactly those with cum <= {window}")

    # ------------------------------------------------------ 9b. cohort
    with phase("9b cohort"):
        meng, cohort_err = serve_cohort(args, cohort, cpacked, ceng, cfg, dev,
                                        c256, c4096, zero_launches,
                                        read_launches)

    # ------------------------------------------------------------ 10. REST
    with phase("10 REST"):
        from readserver_tpu_torch.serve import Dispatcher
        from readserver_tpu_torch.serve.http import RestServer

        zero_launches()
        n_req = 0
        for e, kms in ((engine, decode_all(q256)), (ceng, ckms)):
            n_req += rest_check(
                e, kms, RestServer, Dispatcher,
                lambda rid, e=e: e.sample_names[e._sample_of(rid)])
        launches = read_launches("REST")
        for name in ("backward_search", "resolve_dsa", "exact_histogram",
                     "sparse_pack"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the REST path")
        log(f"{n_req} REST requests answered as the engines answer")

    # ------------------------------------------------- 11. interval shards
    with phase("11 interval shards"):
        shard_engines, ceng_s, capped = serve_interval(
            packed, engine, cpacked, ceng, cfg, dev,
            (("1", q1, False), ("256", q256, False), ("4096x2", q4096, True)),
            served, reads_served, c256, c4096, zero_launches, read_launches)

    # ------------------------------------------- 12. ingest and maintenance
    with phase("12 ingest"):
        ingest_launches = serve_ingest(
            args, cohort, cache, meng, cfg, dev, c256,
            (("1", q1, False), ("256", q256, False), ("4096x2", q4096, True)),
            served, reads_served, zero_launches, read_launches, card)

    # ------------------------------ 13. interval shards across ranks
    with phase("13 interval shards across ranks"):
        rank_engines, rank_reduces, rank_split = serve_ranks(
            packed, cache, cpacked, cfg, dev,
            (("1", q1, False), ("256", q256, False), ("4096x2", q4096, True)),
            served, reads_served, shard_engines, ceng_s, capped, c256,
            c4096, zero_launches, read_launches, card)

    # ------------------------------------------------- 14. doc shards
    with phase("14 doc shards"):
        doc_engines, doc_coll = serve_doc(
            args, cohort, meng, ceng, cfg, dev, c256, c4096, want_c,
            zero_launches, read_launches, card)

    # ---------------------------------- 15. scaling over the meshes of 8
    with phase("15 scaling"):
        zero_launches()
        serve_scaling(card)
        read_launches("scaling")
    main_paths.close()
    check(plain_packs["n"] == 0, f"{plain_packs['n']} plain packs ran on "
          "the card on the main paths")
    log("no plain pack (K8's or the merge's torch ops) ran on a CUDA tensor "
        "on the main paths (phases 4 to 15)")

    # -------------------------------------------------- 6. kernel vs plain
    idx = engine.index
    lut, p = engine.lut, engine.lut_p
    lay = dict(rows_per_symbol=idx.rows_per_symbol, log2_block=idx.log2_block,
               words_per_block=idx.words_per_block)
    k2 = search_ops.backward_search_cuda
    summary = {}

    def intervals(eng, kms):
        ce, le, nq = eng._pad_encode(kms)
        return eng._search(*eng._to_device(ce, le), *eng._routes(ce, le, nq),
                           eng._new_bad())

    batches = {256: decode_all(q256),
               8192: engine._expand_rc(decode_all(q4096))[0]}
    cbatches = {256: ckms, 8192: ceng._expand_rc(decode_all(c4096))[0]}
    WALK_FORMS = walk_forms()
    with phase("6 kernel vs plain"):
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
        # K1's generic entry at the shape the mark walk gave it until the
        # walk kernel took its ranks over: the first step of the mark walk
        # over the engine's 8192-wide batch (compacted rows)
        idx_m = engine_m.index
        ml, mu = intervals(engine_m, batches[8192])
        rows, valid, _ = resolve.expand_intervals(ml, mu, H)
        mrows, mvalid, _, _ = resolve.compact_rows(rows, valid,
                                                   engine_m.row_budget)
        m_i = torch.where(mvalid, mrows, torch.zeros_like(mrows))
        m_c = rank_ops.read_symbol(idx_m, m_i)
        err = max_err([(rank_ops.occ_rows_cuda(idx_m.rank_rows, m_c, m_i,
                                               **lay),
                        rank_ops.occ_rows_plain(idx_m.rank_rows, m_c, m_i,
                                                **lay))])
        k1_err = max(k1_err, err)
        log(f"K1 at the mark walk's first step (width 8192, {m_i.numel()} "
            f"rows, {int(mvalid.sum())} valid): max |err| {err}")
        check(err == 0, "K1 disagrees with the plain rank on the mark walk")
        # K1's level entry: the engine's LUT, and a build in ragged chunks,
        # against the plain build on the card
        t0 = time.perf_counter()
        plain_lut = lut_ops.build_prefix_lut_plain(idx, p)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        chunk = 4 ** (p - 1) // 4 + 3
        chunked = lut_ops.build_prefix_lut(idx, p, max_chunk=chunk)
        k1l_err = max_err([(lut, plain_lut), (chunked, plain_lut)])
        log(f"K1 level entry, prefix LUT p={p}: the engine's LUT "
            f"({lut.shape[0]} entries, {p - 1} levels) and a build in chunks "
            f"of {chunk} vs the plain build ({t_plain:.3f}s): max |err| "
            f"{k1l_err}")
        check(torch.equal(plain_lut, lut) and torch.equal(chunked, lut),
              "K1's level entry disagrees with the plain LUT build")
        del plain_lut, chunked

        # K2: every mode and tier set at widths 256, 8192 and B_TIME
        bq = simulate.sample_query_kmers_fast(
            corpus, B_TIME, KMER, seed=args.seed + 1, miss_frac=0.1
        ).astype(np.int32)
        no3 = dataclasses.replace(idx, rank3_rows=None, C3=None)
        mlen = rng.integers(8, KMER + 1, size=B_TIME)
        mixed, mixed_len = encode_query_batch(
            [row[KMER - L:] for row, L in zip(bq.astype(np.uint8), mlen)], 32
        )
        lut_len = rng.integers(p, KMER + 1, size=B_TIME)
        mixed_lut, mixed_lut_len = encode_query_batch(
            [row[KMER - L:] for row, L in zip(bq.astype(np.uint8), lut_len)],
            32)
        pair_plain = search_ops.backward_search_pair_plain
        k2_err = 0
        for W in (256, 8192, B_TIME):
            codes = torch.from_numpy(bq[:W]).to(dev)
            mx, mxl, lx, lxl = (torch.from_numpy(a[:W]).to(dev) for a in (
                mixed, mixed_len, mixed_lut, mixed_lut_len))
            full_len = torch.full((W,), KMER, dtype=torch.int32, device=dev)
            cases = [
                ("k-step + LUT, rank3+rank2",
                 k2(idx, codes, lut=lut, p=p, kstep=True),
                 pair_plain(idx, codes, lut, p)),
                ("k-step + LUT, rank2", k2(no3, codes, lut=lut, p=p,
                                           kstep=True),
                 pair_plain(no3, codes, lut, p)),
                ("k-step, rank3+rank2", k2(idx, codes, kstep=True),
                 pair_plain(idx, codes)),
                ("k-step, rank2", k2(no3, codes, kstep=True),
                 pair_plain(no3, codes)),
                ("1-step, lengths 8-31", k2(idx, mx, mxl),
                 search_ops.backward_search_plain(idx, mx, mxl)),
                (f"1-step + LUT, lengths {p}-31",
                 k2(idx, lx, lxl, lut=lut, p=p),
                 search_ops.backward_search_lut_plain(idx, lut, p, lx, lxl)),
                ("1-step, uniform 31", k2(idx, codes, full_len),
                 search_ops.backward_search_plain(idx, codes, full_len)),
            ]
            errs = {name: max_err(zip(got, want)) for name, got, want in cases}
            k2_err = max(k2_err, *errs.values())
            found = int((cases[0][1][1] > cases[0][1][0]).sum())
            log(f"K2 width {W}: {len(cases)} modes and tier sets "
                f"({', '.join(errs)}), {found} found by k-step + LUT, max "
                f"|err| {max(errs.values())}")
            check(max(errs.values()) == 0,
                  f"K2 disagrees with the plain search at width {W}: {errs}")
        short = torch.from_numpy(bq[:1, KMER - 8:].copy()).to(dev)
        short_len = torch.full((1,), 8, dtype=torch.int32, device=dev)
        err = max_err([*zip(k2(idx, short, short_len),
                            search_ops.backward_search_plain(idx, short,
                                                             short_len)),
                       *zip(k2(idx, short, kstep=True),
                            pair_plain(idx, short))])
        k2_err = max(k2_err, err)
        check(err == 0, "K2 disagrees on one query of length 8 < p")
        # the engine's own batches, padded, encoded and searched by it
        for width, kms in batches.items():
            ce, le, nq = engine._pad_encode(kms)
            check(ce.shape == (width, KMER) and int(le.min()) == KMER,
                  f"engine batch of {len(kms)} is not uniform [{width}, "
                  f"{KMER}]")
            got = engine._dispatch_single(
                ce, le, nq, bad=engine._new_bad())[:, :2].unbind(1)
            err = max_err(zip(got, pair_plain(
                idx, torch.from_numpy(ce).to(dev), lut, p)))
            k2_err = max(k2_err, err)
            log(f"K2 engine batch of width {width} ({nq} queries): max "
                f"|err| {err}")
            check(err == 0, f"K2 disagrees on the engine's batch of {width}")
        # the guard, deferred: refused queries counted on the card, (0, 0)
        codes = torch.from_numpy(bq[:8192]).to(dev)
        dirty = codes.clone()
        hit = torch.tensor([5, 77, 4000], device=dev)
        dirty[hit, torch.tensor([0, 13, 30], device=dev)] = torch.tensor(
            [0, 5, -1], dtype=torch.int32, device=dev)
        bad = torch.zeros(1, dtype=torch.int32, device=dev)
        l1, u1 = k2(idx, dirty, lut=lut, p=p, kstep=True, bad=bad)
        l2, u2 = pair_plain(idx, codes, lut, p)
        l2[hit], u2[hit] = 0, 0
        check(int(bad.item()) == 3 and torch.equal(l1, l2)
              and torch.equal(u1, u2), "K2's deferred guard miscounts")
        try:
            search_ops.backward_search_pair(idx, dirty, lut, p)
            check(False, "backward_search_pair took refused queries")
        except ValueError as e:
            log(f"K2 deferred guard: 3 refused queries counted on the card "
                f"and answered (0, 0), the rest equal; the public search "
                f"raises: {e}")
        summary["k1_err"], summary["k1l_err"] = k1_err, k1l_err
        summary["k2_err"] = k2_err

        # K5-K7 at the engines' own widths (256, 8192) and H = 64
        idx_f = engine_f.index
        k5_err = k6_err = k7_err = 0
        for width, kms in batches.items():
            l, u = (x.clone() for x in intervals(engine, kms))
            check(l.shape[0] == width, f"batch of width {l.shape[0]}")
            l[0], u[0] = 0, 0          # an empty interval
            l[1], u[1] = 1000, 1200    # count 200 > H
            err = max_err(zip(resolve.resolve_dsa_hits(idx, l, u, H),
                              resolve.resolve_dsa_hits_plain(idx, l, u, H)))
            rows, valid, _ = resolve.expand_intervals(l, u, H)
            err = max(err, max_err(zip(
                resolve.resolve_rows_dsa(idx, rows, valid),
                resolve.resolve_rows_dsa_plain(idx, rows, valid))))
            k5_err = max(k5_err, err)
            log(f"K5 width {width} x H={H} (an empty interval, a count of "
                f"200 > H): hits and rows max |err| {err}")
            check(err == 0, f"K5 disagrees with the plain form at {width}")
            if engine_f.row_budget < rows.shape[0]:
                rows, valid, _, _ = resolve.compact_rows(
                    rows, valid, engine_f.row_budget)
            err = max_err(zip(
                resolve.resolve_rows_fused(idx_f, rows, valid),
                resolve.resolve_rows_fused_plain(idx_f, rows, valid)))
            k6_err = max(k6_err, err)
            log(f"K6 width {width}: {rows.shape[0]} rows "
                f"({int(valid.sum())} valid), max |err| {err}")
            check(err == 0, f"K6 disagrees with the plain form at {width}")
        words = np.array([0xFFFFFFFF, 0x80000001, 0x7FFFFFFF, 5], np.uint32)
        syn = DeviceIndex.from_numpy(
            {"dsa": words, "read_to_sample": np.arange(4)},
            {"n": 4, "dsa_bits": 7, "num_reads": 4}, dev)
        sl = torch.tensor([0, 2], dtype=torch.int32, device=dev)
        got = resolve.resolve_dsa_hits(syn, sl, sl + 2, 3)
        err = max_err(zip(got, resolve.resolve_dsa_hits_plain(
            syn, sl, sl + 2, 3)))
        check(err == 0 and got[0].tolist() == [[0x1FFFFFF, 0x1000000, -1],
                                               [0xFFFFFF, 0, -1]],
              "K5 misreads dsa words with bit 31 set")
        log(f"K5 dsa words with bit 31 set: read ids "
            f"{got[0][0, :2].tolist()}, max |err| {err}")
        # K6 edge cases on every row of the first blocks and the batch
        # rows: marks cleared (a walk needing sample_rate steps gives -1)
        # and $ rows also marked (marked wins)
        W = idx_f.words_per_block
        nomark = idx_f.fused_rows.clone()
        nomark[:, 6 + 3 * W : 6 + 4 * W] = 0
        dmark = idx_f.fused_rows.clone()
        dmark[:, 6 + 3 * W : 6 + 4 * W] |= dmark[:, 6 : 6 + W]
        erows = torch.cat([torch.arange(1 << 20, dtype=torch.int32,
                                        device=dev), rows])
        evalid = torch.ones_like(erows, dtype=torch.bool)
        for name, fr in (("marks cleared", nomark), ("$ rows marked", dmark)):
            v = dataclasses.replace(idx_f, fused_rows=fr)
            got = resolve.resolve_rows_fused(v, erows, evalid)
            err = max_err(zip(got, resolve.resolve_rows_fused_plain(
                v, erows, evalid)))
            k6_err = max(k6_err, err)
            log(f"K6 {name}: {erows.shape[0]} rows, "
                f"{int((got[0] < 0).sum())} unterminated, "
                f"{int((got[1] == idx_f.sample_rate - 1).sum())} at "
                f"sample_rate - 1 steps, max |err| {err}")
            check(err == 0, f"K6 disagrees with the plain form: {name}")
            if name == "marks cleared":
                check(bool((got[0] < 0).any())
                      and bool((got[1] == idx_f.sample_rate - 1).any()),
                      "no walk reached the sample_rate bound")
        del nomark, dmark
        # K6 at a full budget: 4096 10-mers drawn from the reads, on both
        # strands; the intervals pass H, so every budget slot walks, more
        # walks than the card holds lanes at once
        kf = fill_k(idx_f.n, 2 * H)
        fb = engine_f._expand_rc(decode_all(simulate.sample_query_kmers_fast(
            corpus, 4096, kf, seed=args.seed + 4, miss_frac=0.0)))[0]
        frows, fvalid, _ = resolve.expand_intervals(*intervals(engine_f, fb),
                                                    H)
        frows, fvalid, _, _ = resolve.compact_rows(frows, fvalid,
                                                   engine_f.row_budget)
        check(bool(fvalid.all()), "the 10-mer batch does not fill the budget")
        err = max_err(zip(
            resolve.resolve_rows_fused(idx_f, frows, fvalid),
            resolve.resolve_rows_fused_plain(idx_f, frows, fvalid)))
        k6_err = max(k6_err, err)
        log(f"K6 full budget ({len(fb)} {kf}-mers): {frows.shape[0]} rows, "
            f"all walking, max |err| {err}")
        check(err == 0, "K6 disagrees with the plain form at a full budget")
        # the rank walks (marks, lf, slow) on the compacted rows of the
        # E. coli batch of 8192 (the engines' row budget), at a full budget,
        # with 0 valid rows and 1 slot; with the marks cleared (walks run
        # past sample_rate and give -1) and with $ rows also marked, on
        # every row of the first 2^20 and the batch's rows; the slow walk
        # bounded below the longest read
        walk_idx = {"marks": engine_m.index,
                    "lf": walk_engines["lf"].index,
                    "slow": walk_engines["slow"].index}
        wrows8, wvalid8 = mrows, mvalid  # K1's check's compacted rows
        erows = torch.cat([torch.arange(1 << 20, dtype=torch.int32,
                                        device=dev), wrows8])
        evalid = torch.ones_like(erows, dtype=torch.bool)
        kw_err = 0
        for kind, widx in walk_idx.items():
            walk, plain = WALK_FORMS[kind]
            W = widx.words_per_block
            cases = [("width 8192", widx, wrows8, wvalid8, {}),
                     ("full budget", widx, frows, fvalid, {}),
                     ("0 valid", widx, wrows8[:1000],
                      torch.zeros(1000, dtype=torch.bool, device=dev), {}),
                     ("1 slot", widx, frows[:1], fvalid[:1], {})]
            if kind == "slow":
                cases.append(("max_steps below the longest read", widx,
                              erows, evalid,
                              {"max_steps": widx.max_read_len // 2}))
            else:
                dm = widx.mark_rank.clone()
                dm[:, 1:1 + W] |= widx.rank_rows[:widx.rows_per_symbol,
                                                 1:1 + W]
                cleared = dict(mark_rank=torch.zeros_like(widx.mark_rank))
                dollar = dict(mark_rank=dm)
                if kind == "lf":
                    cleared["lf"] = widx.lf & 0x7FFFFFFF
                    dollar["lf"] = torch.where(
                        (widx.lf & 0x7FFFFFFF) < widx.C[1],
                        widx.lf | (-(1 << 31)), widx.lf)
                cases += [("marks cleared",
                           dataclasses.replace(widx, **cleared), erows,
                           evalid, {}),
                          ("$ rows marked",
                           dataclasses.replace(widx, **dollar), erows,
                           evalid, {})]
            for cname, v, r, vv, kw in cases:
                got = walk(v, r, vv, **kw)
                err = max_err(zip(got, plain(v, r, vv, **kw)))
                kw_err = max(kw_err, err)
                log(f"rank walk {kind}, {cname}: {r.shape[0]} rows "
                    f"({int(vv.sum())} valid), {int((got[0] < 0).sum())} "
                    f"give -1, max |err| {err}")
                check(err == 0, f"the {kind} walk kernel disagrees with its "
                      f"plain form: {cname}")
                if cname == "marks cleared":
                    check(bool((got[1] == widx.sample_rate - 1).any())
                          and bool((got[0][vv] < 0).any()),
                          f"no {kind} walk reached the sample_rate bound")
            del cases
        summary["kw_err"] = kw_err
        # K7 at a cap-filling batch: 8192 cohort 8-mers, whose worklist the
        # engine's max_sweep_rows cuts
        kc = fill_k(ceng.index.n, 256)
        cap_l, cap_u = intervals(ceng, decode_all(
            simulate.sample_query_kmers_fast(cohort, 8192, kc,
                                             seed=args.seed + 5,
                                             miss_frac=0.0)))
        cap_total = int((cap_u - cap_l).long().sum())
        check(cap_total > cfg.max_sweep_rows, f"the 8-mer batch's worklist "
              f"({cap_total}) does not pass the cap")
        hist_idx = {"dsa": ceng.index, "fused": ceng_f.index,
                    "marks": ceng_m.index,
                    "lf": DeviceIndex.from_packed(cpacked, dev,
                                                  tiers={"marks", "lf"}),
                    "slow": DeviceIndex.from_packed(cpacked, dev,
                                                    tiers=set())}
        check(all(resolve.walk_kind(x) == k for k, x in hist_idx.items()),
              "a cohort index does not walk its kind")
        for wname in ("dsa", "fused", "marks"):
            cidx = hist_idx[wname]
            got = resolve.exact_sample_histogram(cidx, cap_l, cap_u, 8 * 8192,
                                                 cfg.max_sweep_rows)
            err = max_err(zip(got, resolve.exact_sample_histogram_plain(
                cidx, cap_l, cap_u, 8 * 8192, cfg.max_sweep_rows)))
            k7_err = max(k7_err, err)
            log(f"K7 cap-filling batch, {wname} walk: 8192 {kc}-mers, worklist "
                f"{cap_total} rows, {int(got[0].sum())} counted under the cap "
                f"{cfg.max_sweep_rows}, max |err| {err}")
            check(err == 0, f"K7 disagrees with the plain form at the "
                  f"cap-filling batch ({wname})")
        for width, kms in cbatches.items():
            l, u = intervals(ceng, kms)
            for wname, cidx in hist_idx.items():
                for window, max_rows in ((8 * width, 1 << 20), (64, 100)):
                    got = resolve.exact_sample_histogram(cidx, l, u, window,
                                                         max_rows)
                    want = resolve.exact_sample_histogram_plain(
                        cidx, l, u, window, max_rows)
                    err = max_err(zip(got, want))
                    k7_err = max(k7_err, err)
                    log(f"K7 width {width} {wname} walk, window {window}, "
                        f"max_rows {max_rows}: {int(got[0].sum())} rows "
                        f"counted, {int((~got[1]).sum())} incomplete, max "
                        f"|err| {err}")
                    check(err == 0, f"K7 disagrees with the plain form "
                          f"({width}, {wname}, {window}, {max_rows})")
        gl = torch.zeros(3, dtype=torch.int32, device=dev)
        gu = torch.full((3,), 1_200_000_000, dtype=torch.int32, device=dev)
        got = resolve.exact_sample_histogram(ceng.index, gl, gu, 256, 1024)
        err = max_err(zip(got, resolve.exact_sample_histogram_plain(
            ceng.index, gl, gu, 256, 1024)))
        k7_err = max(k7_err, err)
        check(err == 0 and not bool(got[1].any())
              and int(got[0].sum()) == 1024,
              "K7 wraps worklist totals past 2^31")
        log(f"K7 totals of 3.6e9 rows (int64), cap 1024: max |err| {err}")
        summary.update(k5_err=k5_err, k6_err=k6_err, k7_err=k7_err)
        # K14 and K15 at the resolve's shapes: E. coli's 524,288 lanes
        # (width 8192, H = 64) under the fused engine's budget, at width
        # 8192 and at the full budget, and every doc shard of phase 14's
        # fused route on the cohort's batch of 8192; K14 also against the
        # torch ops it replaced (compact_rows and the scatters back)
        k14_err = k15_err = 0
        de = doc_engines["fused"]
        dce, dle, dnq = de._pad_encode(cbatches[8192])
        dcodes, dlens = de._to_device(dce, dle)
        kcases = [(f"E. coli {w}", idx_f, *intervals(engine_f, kms),
                   engine_f.row_budget)
                  for w, kms in (("width 8192", batches[8192]),
                                 ("full budget", fb))]
        for j, sh in enumerate(de.didx.shards):
            dl, du = search_ops.search_batch(
                sh, dcodes, dlens, de.didx.luts[j], de.lut_p,
                de.has_pair and int(dle.min()) == dce.shape[1])
            kcases.append((f"cohort doc shard {j}", sh, dl, du,
                           int(cfg.resolve_budget_frac * de.B * H)))
        for what, x, kl, ku, R in kcases:
            rows_c, valid_c, prefix = resolve.compact_lanes(kl, ku, H, R)
            err14 = max_err(zip((rows_c, valid_c, prefix),
                                resolve.compact_lanes_plain(kl, ku, H, R)))
            rid_c, off_c = resolve.select_walk(x)(rows_c, valid_c)
            got = resolve.gather_lanes(kl, ku, H, R, prefix, rid_c, off_c)
            err14 = max(err14, max_err(zip(got, resolve.gather_lanes_plain(
                kl, ku, H, R, prefix, rid_c, off_c))))
            # the hit step's read_to_sample column
            col = dict(read_to_sample=x.read_to_sample,
                       num_reads=x.num_reads)
            err14 = max(err14, max_err(zip(
                resolve.gather_lanes(kl, ku, H, R, prefix, rid_c, off_c,
                                     **col),
                resolve.gather_lanes_plain(kl, ku, H, R, prefix, rid_c,
                                           off_c, **col))))
            rows, valid, _ = resolve.expand_intervals(kl, ku, H)
            crow_r, cval_r, orig, keep = resolve.compact_rows(rows, valid, R)
            F = rows.numel()
            full = torch.full((F + 1,), -1, dtype=torch.int32, device=dev)
            err14 = max(err14, max_err([
                (rows_c, crow_r), (valid_c, cval_r),
                (got[0].reshape(-1), full.scatter(0, orig, rid_c)[:F]),
                (got[1].reshape(-1), full.scatter(0, orig, off_c)[:F]),
                (got[2].reshape(-1), valid & keep)]))
            err15 = max_err([(resolve.sample_histogram(x, got[0], got[2]),
                              resolve.sample_histogram_plain(x, got[0],
                                                             got[2]))])
            k14_err, k15_err = max(k14_err, err14), max(k15_err, err15)
            log(f"K14 and K15, {what}: {F} lanes, budget {R}, "
                f"{int(valid.sum())} valid, {int(valid_c.sum())} walked, "
                f"S = {max(x.num_samples, 1)}: max |err| {err14} (compaction"
                f", gather back with and without the read_to_sample column, "
                f"and against compact_rows + the scatters back) and {err15} "
                f"(histogram)")
            check(err14 == 0 and err15 == 0,
                  f"K14 or K15 disagrees with its plain form ({what})")
        summary.update(k14_err=k14_err, k15_err=k15_err)
        for k, v in cohort_err.items():
            summary[k] = max(summary[k], v)
        # K8 and the merge kernel at the served shapes, nq < W, and short
        # k-mers past the 16 slots a query
        short = ["".join(w) for w in rng.choice(list("ACGT"), (512, 8))]
        summary.update(check_pack_kernels(engine, ceng, meng, batches[8192],
                                          cbatches[8192], short))

    # ---------------------------------------------------------- 7. timing
    with phase("7 timing"):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        log(f"card: {card}")
        # the chase yardstick: one warp's time per dependent 64-byte read,
        # from the card's memory (cold: new random rows each launch) and
        # from L2 (warm: the same rows again), through both fused tables.
        # t_row is the smaller warm reading: every kernel below is timed on
        # repeated inputs, whose rows stay in the 50 MB L2
        warm = []
        t_row_cold = None  # E. coli's: the walks' tables lie past the L2
        for tname, fr in (("E. coli", idx_f.fused_rows),
                          ("cohort", ceng_f.index.fused_rows)):
            for cold in (True, False):
                got = chase_t_row(fr, rng, dev, cold)
                what = (f"chase, one warp of 32 chains through the {tname} "
                        f"fused table ({fr.shape[0]} rows of 64 B, "
                        f"{'cold' if cold else 'warm'})")
                if got is None:
                    log(f"{what}: not measured (the profiler saw no "
                        f"chase_kernel time)")
                    continue
                log(f"{what}: {got[0] * 1e3:.4f} us per dependent read (64 "
                    f"steps less 32; the 32-step launch's device time / "
                    f"32: {got[1] * 1e3:.4f} us) | {card}")
                if not cold:
                    warm.append(got[0])
                elif tname == "E. coli":
                    t_row_cold = got[0]
        t_row = min(warm) if warm else None  # None: no chain bounds
        # distinct batches in turn, as a bulk screen sends them: a batch
        # touches more rank and LUT sectors than the 50 MB L2 holds, and a
        # repeated batch finds part of them there (measured beside it)
        rot = [torch.from_numpy(b).to(dev) for b in np.split(
            simulate.sample_query_kmers_fast(
                corpus, N_ROT * B_TIME, KMER, seed=args.seed + 2,
                miss_frac=0.1).astype(np.int32), N_ROT)]
        widths = {B_TIME: rot, 8192: [b[:8192] for b in rot]}
        bad = torch.zeros(1, dtype=torch.int32, device=dev)

        def k2_turns(bs, **kw):
            turn = itertools.cycle(bs)
            return lambda: k2(idx, next(turn), lut=lut, p=p, kstep=True, **kw)

        # K2 through the public wrapper (which waits for its guard count),
        # on the engine's no-wait path (16 batches back to back, one wait),
        # the plain form, and the kernel's device time
        k2_t = {}
        for W, bs in widths.items():
            kern, nowait = k2_turns(bs), k2_turns(bs, bad=bad)
            turn = itertools.cycle(bs)
            plain = lambda: pair_plain(idx, next(turn), lut, p)  # noqa: E731
            kern(), plain(), nowait()
            torch.cuda.synchronize()
            ms_k, ms_p, burst = [], [], []
            for _ in range(5):  # interleaved: wrapper, plain, no-wait burst
                ms_k.append(time_cuda(kern, 2 * N_ROT))
                ms_p.append(time_cuda(plain, N_ROT))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(16):
                    nowait()
                torch.cuda.synchronize()
                burst.append((time.perf_counter() - t0) * 1e3 / 16)
            lat = latencies_ms(kern, 100)
            dev_ms = kernel_device_ms(nowait, N_ROT, "backward_search_kernel")
            needs = [k2_needs(idx, b, lut, p) for b in bs]
            nbytes = int(np.mean([x[0] for x in needs]))
            steps = int(np.mean([x[1] for x in needs]))
            chain = max(x[2] for x in needs)
            chain_ms = None if t_row is None else chain * t_row
            t_k, t_p, t_b = (float(np.median(x)) for x in (ms_k, ms_p, burst))
            k2_t[W] = (t_k, t_p, dev_ms, bound_ms(nbytes),
                       f"{W} 31-mers, LUT p={p} + triples", chain_ms)
            log(f"K2 width {W}: chain of {chain} dependent reads (the code "
                f"tile, the LUT entry, {chain - 2} steps) x t_row = chain "
                f"bound {fmt_ms(chain_ms)} ms, device time at "
                f"{ratio(chain_ms, dev_ms)} of it")
            log(f"K2 width {W}, LUT p={p} + triples, {N_ROT} distinct "
                f"batches in turn: wrapper {t_k:.4f} ms/batch = "
                f"{W / t_k * 1e3:.0f} searches/s (median of 5 x {2 * N_ROT},"
                f" with its wait), latency p50 {np.median(lat):.4f} ms p90 "
                f"{np.percentile(lat, 90):.4f} ms (n=100); kernel device "
                f"time {fmt_ms(dev_ms)} ms (profiler); no-wait path, 16 "
                f"batches back to back: {t_b:.4f} ms/batch = "
                f"{ratio(t_b, dev_ms)} x the device time; plain torch "
                f"{t_p:.4f} ms/batch | needs {nbytes} B ({steps} steps "
                f"taken): bound {bound_ms(nbytes):.4f} ms, device time at "
                f"{ratio(bound_ms(nbytes), dev_ms)} of the bound | {card}")
        check(int(bad.item()) == 0, "K2 refused a query of the timing batches")
        rep = k2_turns(rot[:1], bad=bad)
        ms_rep = float(np.median([time_cuda(rep, 2 * N_ROT)
                                  for _ in range(5)]))
        ms_dis = float(np.median([time_cuda(k2_turns(rot, bad=bad), 2 * N_ROT)
                                  for _ in range(5)]))
        log(f"K2 width {B_TIME}, no-wait path by CUDA events: one batch "
            f"repeated (warm L2) {ms_rep:.4f} ms/batch vs {N_ROT} distinct "
            f"batches {ms_dis:.4f} ms/batch | {card}")

        # K1's level entry: each level, the whole build, the start-up stage
        levels = [(idx.C[1:5], idx.C[2:6])]
        for _ in range(p - 2):
            levels.append(lut_ops.extend_level(idx, *levels[-1]))
        lvl_bound = [bound_ms(level_bytes(idx, l_, u_)) for l_, u_ in levels]
        build = lambda: lut_ops.build_prefix_lut(idx, p)  # noqa: E731
        for _ in range(5):  # the profiler now and then records no event
            # and can miss the first launches after it starts: a build
            # first, then the marked one read
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                build()
                torch.cuda.synchronize()
                with record_function("marked build"):
                    build()
                    torch.cuda.synchronize()
            evs = prof.events()
            span = next(e.time_range for e in evs
                        if e.name == "marked build"
                        and e.device_type == DeviceType.CPU)
            kev = sorted((e for e in evs
                          if e.device_type == DeviceType.CUDA
                          and "lut_level_kernel" in e.name
                          and span.start <= e.time_range.start <= span.end),
                         key=lambda e: e.time_range.start)
            if len(kev) == p - 1:
                break
        lvl_dev = [e.self_device_time_total / 1e3 for e in kev]
        check(len(lvl_dev) == p - 1, f"profiled {len(lvl_dev)} level launches")
        for k, (l_, u_) in enumerate(levels):
            last = k == len(levels) - 1
            ms = float(np.median([time_cuda(
                lambda: lut_ops.extend_level(idx, l_, u_, last=last), 5)
                for _ in range(3)]))
            log(f"K1 level entry, level {k + 1} -> {k + 2} ({l_.numel()} "
                f"intervals): wrapper {ms:.4f} ms, device {lvl_dev[k]:.4f} "
                f"ms, bound {lvl_bound[k]:.4f} ms, device time at "
                f"{ratio(lvl_bound[k], lvl_dev[k])} of the bound")
        b_k, b_p, wall = [], [], []
        for _ in range(3):  # interleaved: kernel build, plain build, wall
            b_k.append(time_cuda(build, 3))
            b_p.append(time_cuda(
                lambda: lut_ops.build_prefix_lut_plain(idx, p), 1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        t_b, t_bp, t_w = (float(np.median(x)) for x in (b_k, b_p, wall))
        b_dev, b_bound = sum(lvl_dev), sum(lvl_bound)
        summary["lut_level"] = (t_b, t_bp, b_dev, b_bound,
                                f"whole LUT p={p}, {p - 1} launches", None)
        log(f"K1 level entry, whole LUT p={p} ({p - 1} launches): wrapper "
            f"{t_b:.4f} ms, device {b_dev:.4f} ms, bound {b_bound:.4f} ms "
            f"(device time at {ratio(b_bound, b_dev)} of the bound) | plain "
            f"torch build {t_bp:.4f} ms (median of 3) | {card}")
        log(f"LUT start-up stage: engine starts took "
            + ", ".join(f"{name} {e.startup_seconds['lut'] * 1e3:.3f} ms"
                        for name, e in (("count (first)", engine),
                                        ("fused", engine_f),
                                        ("mark walk", engine_m),
                                        ("cohort", ceng)))
            + f"; a warm rebuild: wall {t_w:.4f} ms = kernel device "
            f"{b_dev:.4f} ms + the rest {t_w - b_dev:.4f} ms | {card}")

        # K1's generic entry: random positions, the LUT's last level's
        # ranks (the same work as the level entry's last launch), and the
        # mark walk's first step (the shape in the kernels line; no main
        # path launches K1 since the walk kernel ranks for the walks)
        l_last, u_last = levels[-1]
        cc = torch.arange(1, 5, dtype=torch.int32, device=dev)
        cc = cc.repeat_interleave(l_last.numel())
        lvl_c = torch.cat([cc, cc])
        lvl_i = torch.cat([l_last.repeat(4), u_last.repeat(4)])
        nr = lvl_c.numel()
        rnd_c = torch.from_numpy(
            rng.integers(1, 5, size=nr).astype(np.int32)).to(dev)
        rnd_i = torch.from_numpy(
            rng.integers(0, idx.n + 1, size=nr).astype(np.int32)).to(dev)
        for what, table, c_t, i_t, main in (
                (f"{nr} random positions", idx.rank_rows, rnd_c, rnd_i,
                 False),
                (f"the LUT's level {p - 1} -> {p} ranks ({nr})",
                 idx.rank_rows, lvl_c, lvl_i, False),
                (f"the mark walk's first step, {m_i.numel()} ranks",
                 idx_m.rank_rows, m_c, m_i, True)):
            kern = lambda: rank_ops.occ_rows_cuda(  # noqa: E731
                table, c_t, i_t, **lay)
            plain = lambda: rank_ops.occ_rows_plain(  # noqa: E731
                table, c_t, i_t, **lay)
            check(torch.equal(kern(), plain()),
                  f"K1 disagrees with the plain rank at {what}")
            iters = 10 if nr == c_t.numel() else 50
            r_k, r_p = [], []
            for _ in range(3):
                r_k.append(time_cuda(kern, iters))
                r_p.append(time_cuda(plain, 3))
            dev_ms = kernel_device_ms(kern, iters, "rank_occ_kernel")
            nb = k1_bytes(table, c_t, i_t, lay)
            tk, tp = float(np.median(r_k)), float(np.median(r_p))
            if main:
                summary["rank_occ"] = (tk, tp, dev_ms, bound_ms(nb), what,
                                       None)
            log(f"K1 generic entry at {what}: wrapper {tk:.4f} ms = "
                f"{c_t.numel() / tk * 1e3:.0f} ranks/s, device "
                f"{fmt_ms(dev_ms)} ms | plain torch {tp:.4f} ms | needs {nb} "
                f"B: bound {bound_ms(nb):.4f} ms, device time at "
                f"{ratio(bound_ms(nb), dev_ms)} of the bound | {card}")
            if table is idx.rank_rows and c_t is rnd_c:
                # the 32-byte sectors the random ranks touch, and the rate
                # of random sector reads: torch's index_select of one word
                # from each of the same sectors (a yardstick, no path's)
                rrow = (c_t.long() * lay["rows_per_symbol"]
                        + (i_t >> lay["log2_block"]).long())
                sec = rrow * table.shape[1] * 4 // 32
                n_sec = distinct(sec)
                words = (sec * 8).contiguous()
                flat = table.view(-1)
                yard = lambda: flat.index_select(0, words)  # noqa: E731
                yard()
                y_ms = kernel_device_ms(yard, iters, "")
                sb = c_t.numel() * 12 + n_sec * 32
                log(f"K1 generic entry at {what}: {n_sec} distinct 32-byte "
                    f"sectors ({n_sec / c_t.numel():.4f} a rank): sector "
                    f"bound {bound_ms(sb):.4f} ms, device time at "
                    f"{ratio(bound_ms(sb), dev_ms)} of it | random-sector "
                    f"yardstick (torch index_select, one word from each of "
                    f"the same {c_t.numel()} sectors) device "
                    f"{fmt_ms(y_ms)} ms, K1 at {ratio(y_ms, dev_ms)} of its "
                    f"rate | {card}")
        summary["backward_search"] = k2_t[B_TIME]

        # K5-K7 at width 8192: the E. coli 4096-on-both-strands batch (K5 on
        # the dsa engine, K6 on the fused engine's compacted rows) and the
        # cohort's (K7 through either walk, the engine's window and cap);
        # then K6 at a full budget and K7 at the cap-filling batch
        l, u = intervals(engine, batches[8192])
        rows, valid, _ = resolve.expand_intervals(l, u, H)
        crow, cval, _, _ = resolve.compact_rows(rows, valid,
                                                engine_f.row_budget)
        # the chase at K6's concurrency and at a full budget: the rate the
        # card reaches for dependent random rows, without the walks' sharing
        for what, start in (("K6's walks", crow[cval]),
                            ("a full budget", frows)):
            blocks = (start >> idx_f.log2_block).contiguous()
            out = torch.empty_like(blocks)
            fn = lambda: chase(idx_f.fused_rows, blocks, 32, out)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            ms = kernel_device_ms(fn, 10, "chase_kernel")
            nc = blocks.numel()
            if ms is None:
                log(f"chase at {what}: not measured (the profiler saw no "
                    f"chase_kernel time)")
                continue
            log(f"chase at {what}: {nc} chains x 32 dependent 64-B reads in "
                f"{ms:.4f} ms of device time = {ms / 32 * 1e3:.4f} us per "
                f"step, "
                f"{nc * 32 / ms / 1e6:.4f} G rows/s "
                f"({nc * 32 * 64 / ms / 1e6:.1f} GB/s of rows) | {card}")
        cl, cu = intervals(ceng, cbatches[8192])
        win = 8 * 8192
        wrows = interval_rows(cl, cu)
        check(wrows.numel() <= win, "the cohort batch's worklist passes "
              "one window")
        cap = cfg.max_sweep_rows
        caprows = interval_rows(cap_l, cap_u)[:cap]
        rid = resolve.resolve_dsa_hits_plain(idx, l, u, H)[0]
        hist_io = 8192 * (9 + 4 * ceng._ns)

        def hist_needs(wr, kinds):
            """K7's (bytes, chain) for the worklist rows ``wr`` through
            each walk of ``kinds``, each walk one more read for its
            sample."""
            wv = torch.ones_like(wr, dtype=torch.bool)
            rids = distinct(resolve.resolve_rows_dsa_plain(ceng.index, wr,
                                                           wv)[0]) * 4
            out = {"dsa": (hist_io + distinct(wr) * 4 + rids, 2)}
            for kind in kinds:
                if kind == "fused":
                    wb, wc = fused_walk_needs(ceng_f.index, wr, wv)
                else:
                    wb, wc = rank_walk_needs(hist_idx[kind], kind, wr, wv)
                out[kind] = (hist_io + rids + wb, wc + 1)
            return out

        k6b, k6c = fused_walk_needs(idx_f, crow, cval)
        fbb, fbc = fused_walk_needs(idx_f, frows, fvalid)
        hn = hist_needs(wrows, ("fused", "marks", "lf", "slow"))
        (h_b, h_c), (hf_b, hf_c) = hn["dsa"], hn["fused"]
        cn = hist_needs(caprows, ("fused", "marks", "lf", "slow"))
        (c_b, c_c), (cf_b, cf_c) = cn["dsa"], cn["fused"]
        walk_needs = {
            kind: rank_walk_needs(widx, kind, crow, cval)
            for kind, widx in walk_idx.items()}
        for kind, widx in walk_idx.items():
            walk_needs[f"{kind} full"] = rank_walk_needs(widx, kind, frows,
                                                         fvalid)
        needs = {  # name → (bytes, chain of dependent reads or None)
            "resolve_dsa": (8192 * 8 + distinct(rows[valid]) * 4
                            + distinct(rid[rid >= 0]) * 4 + 3 * 8192 * H * 4,
                            None),
            "resolve_fused": (crow.numel() * 13 + k6b, k6c),
            "exact_histogram": (h_b, h_c),
            "exact_histogram (fused walk)": (hf_b, hf_c),
            "resolve_fused (full budget)": (frows.numel() * 13 + fbb, fbc),
            "exact_histogram (cap-filling)": (c_b, c_c),
            "exact_histogram (cap-filling, fused walk)": (cf_b, cf_c),
            "resolve_walk": (crow.numel() * 13 + walk_needs["marks"][0],
                             walk_needs["marks"][1]),
            "resolve_walk (lf)": (crow.numel() * 13 + walk_needs["lf"][0],
                                  walk_needs["lf"][1]),
            "resolve_walk (slow)": (crow.numel() * 13
                                    + walk_needs["slow"][0],
                                    walk_needs["slow"][1]),
            **{f"resolve_walk ({kind}, full budget)": (
                frows.numel() * 13 + walk_needs[f"{kind} full"][0],
                walk_needs[f"{kind} full"][1]) for kind in walk_idx},
            "exact_histogram (marks walk)": hn["marks"],
            "exact_histogram (lf walk)": hn["lf"],
            "exact_histogram (slow walk)": hn["slow"],
            "exact_histogram (cap-filling, marks walk)": cn["marks"],
            "exact_histogram (cap-filling, lf walk)": cn["lf"],
            "exact_histogram (cap-filling, slow walk)": cn["slow"],
        }

        def k7_case(name, cidx, hl, hu, what):
            return (name, "exact_histogram_kernel",
                    lambda: resolve.exact_sample_histogram(cidx, hl, hu, win,
                                                           cap),
                    lambda: resolve.exact_sample_histogram_plain(
                        cidx, hl, hu, win, cap), what)

        cases = [
            ("resolve_dsa", "resolve_dsa_kernel",
             lambda: resolve.resolve_dsa_hits(idx, l, u, H),
             lambda: resolve.resolve_dsa_hits_plain(idx, l, u, H),
             f"width 8192, {8192 * H} lanes, {int(valid.sum())} hits"),
            ("resolve_fused", "resolve_fused_kernel",
             lambda: resolve.resolve_rows_fused(idx_f, crow, cval),
             lambda: resolve.resolve_rows_fused_plain(idx_f, crow, cval),
             f"width 8192, {crow.shape[0]} compacted rows, "
             f"{int(cval.sum())} valid"),
            k7_case("exact_histogram", ceng.index, cl, cu,
                    f"cohort width 8192, dsa walk, {wrows.numel()} worklist "
                    f"rows"),
            k7_case("exact_histogram (fused walk)", ceng_f.index, cl, cu,
                    "cohort width 8192, fused walk"),
            ("resolve_fused (full budget)", "resolve_fused_kernel",
             lambda: resolve.resolve_rows_fused(idx_f, frows, fvalid),
             lambda: resolve.resolve_rows_fused_plain(idx_f, frows, fvalid),
             f"{frows.shape[0]} rows, all walking"),
            k7_case("exact_histogram (cap-filling)", ceng.index, cap_l, cap_u,
                    f"8192 {kc}-mers, dsa walk, {caprows.numel()} of "
                    f"{cap_total} worklist rows"),
            k7_case("exact_histogram (cap-filling, fused walk)", ceng_f.index,
                    cap_l, cap_u, f"8192 {kc}-mers, fused walk"),
        ]
        # the rank walks on the same compacted rows as K6 (the mark walk's
        # is the main path's shape), the mark walk at a full budget, and K7
        # through each; their plain forms run torch and K1 a step on the card
        # (torch a step, K1 for its ranks)
        for kind, widx in walk_idx.items():
            walk, plain = WALK_FORMS[kind]
            name = "resolve_walk" + ("" if kind == "marks" else f" ({kind})")
            cases.append((name, "resolve_walk_kernel",
                          lambda w=walk, x=widx: w(x, crow, cval),
                          lambda p=plain, x=widx: p(x, crow, cval),
                          f"{kind} walk, width 8192, {crow.shape[0]} "
                          f"compacted rows, {int(cval.sum())} valid"))
        # the three at a full budget
        for kind, widx in walk_idx.items():
            walk, plain = WALK_FORMS[kind]
            cases.append((f"resolve_walk ({kind}, full budget)",
                          "resolve_walk_kernel",
                          lambda w=walk, x=widx: w(x, frows, fvalid),
                          lambda p=plain, x=widx: p(x, frows, fvalid),
                          f"{kind} walk, {frows.shape[0]} rows, all walking"))
        cases += [
            *(k7_case(f"exact_histogram ({kind} walk)", hist_idx[kind], cl,
                      cu, f"cohort width 8192, {kind} walk")
              for kind in ("marks", "lf", "slow")),
            k7_case("exact_histogram (cap-filling, marks walk)",
                    hist_idx["marks"], cap_l, cap_u,
                    f"8192 {kc}-mers, marks walk"),
            *(k7_case(f"exact_histogram (cap-filling, {kind} walk)",
                      hist_idx[kind], cap_l, cap_u,
                      f"8192 {kc}-mers, {kind} walk")
              for kind in ("lf", "slow")),
        ]
        for name, kname, kern, plain, what in cases:
            check(max_err(zip(kern(), plain())) == 0,
                  f"{name} disagrees with its plain form ({what})")
            torch.cuda.synchronize()
            t_kern, t_plain = [], []
            for _ in range(3):  # interleaved: kernel, plain
                t_kern.append(time_cuda(kern, 20))
                t_plain.append(time_cuda(plain, 3))
            dev_ms = kernel_device_ms(kern, 10, kname)
            tk, tp = float(np.median(t_kern)), float(np.median(t_plain))
            nbytes, chain = needs[name]
            bnd = bound_ms(nbytes)
            chain_ms = None if chain is None or t_row is None else chain * t_row
            cold_ms = (None if chain is None or t_row_cold is None
                       else chain * t_row_cold)
            log(f"{name} ({what}): wrapper {tk:.4f} ms, kernel device time "
                f"{fmt_ms(dev_ms)} ms (profiler) | plain torch {tp:.4f} ms "
                f"(median of 3 x 20 and 3 x 3 calls, CUDA events), outputs "
                f"equal | needs {nbytes} B: bytes bound {bnd:.4f} ms, device "
                f"time at {ratio(bnd, dev_ms)} of it"
                + ("" if chain is None else
                   f" | chain of {chain} dependent reads x t_row: chain bound "
                   f"{fmt_ms(chain_ms)} ms, device time at "
                   f"{ratio(chain_ms, dev_ms)} of it; at the cold t_row "
                   f"{fmt_ms(cold_ms)} ms") + f" | {card}")
            summary.setdefault(name, (tk, tp, dev_ms, bnd, what, chain_ms))
        # K14 (the row-budget compaction and its gather back) and K15 (the
        # capped sample histogram) beside the torch ops they replaced, at
        # width 8192 (the E. coli 4096 x 2 batch) and at the full budget
        # (4096 10-mers x 2)
        # distinct E. coli batches of width 8192 (the served batch, then
        # slices of the distinct timing batches) and of 4096 10-mers on
        # both strands (the full budget's batch, then more with other seeds)
        def width_8192(j):
            if j == 0:
                return batches[8192]
            b = rot[(j - 1) // (B_TIME // 8192) % N_ROT]
            k = (j - 1) % (B_TIME // 8192)
            return decode_all(b[k * 8192:(k + 1) * 8192].cpu().numpy())

        def full_budget(j):
            return fb if j == 0 else engine_f._expand_rc(decode_all(
                simulate.sample_query_kmers_fast(
                    corpus, 4096, kf, seed=args.seed + 100 + j,
                    miss_frac=0.0)))[0]

        library = {}
        summary.update(time_compaction(
            engine_f, intervals,
            {"width 8192": width_8192, "full budget": full_budget}, H, card,
            library))

        # K8 on the /reads request of 4096 x 2 and the cohort's /samples of
        # 4096 x 2, the merge kernel on the cohort front's batches of 4096,
        # over distinct batches (E. coli's as above; the cohort's from new
        # seeds), beside their torch ops and the library yardstick
        def cohort_8192(j):
            return cbatches[8192] if j == 0 else ceng._expand_rc(decode_all(
                simulate.sample_query_kmers_fast(
                    cohort, 4096, KMER, seed=args.seed + 200 + j,
                    miss_frac=0.1)))[0]

        pack_summary, pack_library = time_packs(engine, ceng, meng,
                                                width_8192, cohort_8192, card)
        summary.update(pack_summary)
        library.update(pack_library)
        for e, qs, tier in ((engine, q4096, "count"),
                            (engine, q4096, "reads"),
                            (engine_m, q4096, "reads"),
                            (ceng, c4096, "samples")):
            request_breakdown(e, decode_all(qs), tier, engine_stage(e, tier))
        # the doc engine's requests (phase 14's world of one): /reads on
        # the dsa and fused routes, /samples (exact) on the dsa route
        for route, tier in (("dsa", "reads"), ("fused", "reads"),
                            ("dsa", "samples")):
            e = doc_engines[route]
            log(f"doc engine, {route} route:")
            request_breakdown(e, decode_all(c4096), tier, doc_stage(e),
                              sharded_fetch)
        # the mark-walk engine's /reads requests through the walk kernel
        # and through the plain walk (torch and K1 a step), in turns whose
        # order rotates, beside the dsa engine's; the garbage collector runs
        # before each, so that no turn pays for another's hit objects
        marks_walks = resolve._WALKS["marks"]
        for name, qs, both in (("1", q1, False), ("256", q256, False),
                               ("4096x2", q4096, True)):
            kms = decode_all(qs)
            t = {"dsa": [], "kernel": [], "plain walk": []}
            order = list(t)
            for rep in range(6):
                for tname in order[rep % 3:] + order[:rep % 3]:
                    e = engine if tname == "dsa" else engine_m
                    gc.collect()
                    resolve._WALKS["marks"] = (
                        marks_walks[1] if tname == "plain walk"
                        else marks_walks[0], marks_walks[1])
                    try:
                        t0 = time.perf_counter()
                        got = e.query_batch(kms, both_strands=both)
                        t[tname].append((time.perf_counter() - t0) * 1e3)
                    finally:
                        resolve._WALKS["marks"] = marks_walks
                    check(got == reads_served[name], f"the {tname} path "
                          f"disagrees on the /reads request of {name}")
            log(f"/reads request of {name} queries, median of 6 in turns: "
                + ", ".join(f"{k} {float(np.median(v)):.3f} ms"
                            for k, v in t.items())
                + " (mark-walk engine: the walk kernel, and the plain walk,"
                f" torch and K1 a step) | {card}")
        time_cohort(meng, cohort, c4096, args.seed, card)
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
            f" GiB")

    # ------------------------------------- 11b. interval kernels vs plain
    with phase("11b interval kernels"):
        shard_summary, shard_err, shard_routes = check_interval_kernels(
            shard_engines, ceng_s, cpacked, batches[8192], cbatches[8192],
            rot, cohort, q4096, c4096, args.seed, t_row, card)
        summary.update(shard_summary)
        summary.update({f"{k}_err": v for k, v in shard_err.items()})

    # --------------------------------- 13b. cross-rank kernels vs plain
    with phase("13b cross-rank kernels"):
        import torch.distributed as dist

        rank_summary, rank_err, rank_design = check_rank_kernels(
            rank_engines, batches[8192], rot, rank_reduces, rank_split,
            t_row, card)
        # the walk steps' main readings: the LF walk's step and the slow
        # walk's rank half (the rest under the kernels line's readings)
        rank_summary["walk_lf_step"] = rank_summary["walk_lf_step (step)"]
        rank_summary["walk_slow_step"] = rank_summary["walk_slow_step (rank)"]
        summary.update(rank_summary)
        summary.update(rank_err)
        del rank_engines
        dist.destroy_process_group()

    # launches: summed over the main-path phases (count, reads, samples,
    # cohort, REST, interval, ranks), each counted from 0.  K1's and K9's generic
    # entries are on no main path: the walks that ranked through K1 run in
    # the walk kernel, and K9's rank runs inside the other sharded kernels;
    # both stay held against their plain forms and timed (phases 6, 7, 11b)
    total = {name: sum(c[name] for path, c in path_launches.items()
                       if path != "ingest")
             for name in KERNELS}
    check(all(n for name, n in total.items()
              if name not in ("rank_occ", "shard_occ")),
          f"a kernel never launched on a main path: {total}")
    where = {
        "rank_occ": ("rank.cu", "readserver_tpu/kernels/pallas_rank.py:144",
                     "k1_err"),
        "lut_level": ("rank.cu", "readserver_tpu/ops/lut.py:29", "k1l_err"),
        "backward_search": ("search.cu", "readserver_tpu/ops/search.py:220",
                            "k2_err"),
        "resolve_dsa": ("resolve.cu", "readserver_tpu/ops/resolve.py:222",
                        "k5_err"),
        "resolve_fused": ("resolve.cu", "readserver_tpu/ops/resolve.py:295",
                          "k6_err"),
        "resolve_walk": ("resolve.cu", "readserver_tpu/ops/resolve.py:165",
                         "kw_err"),
        "exact_histogram": ("resolve.cu",
                            "readserver_tpu/ops/resolve.py:426", "k7_err"),
        "shard_occ": ("sharded.cu", "readserver_tpu/parallel/sharded.py:395",
                      "shard_occ_err"),
        "sharded_search": ("sharded.cu",
                           "readserver_tpu/parallel/sharded.py:622",
                           "sharded_search_err"),
        "sharded_lut_level": ("sharded.cu",
                              "readserver_tpu/parallel/sharded.py:1075",
                              "sharded_lut_level_err"),
        "sharded_resolve": ("sharded.cu",
                            "readserver_tpu/parallel/sharded.py:834",
                            "sharded_resolve_err"),
        "shard_occ_partial": ("sharded_partial.cu",
                              "readserver_tpu/parallel/sharded.py:395",
                              "shard_occ_partial_err"),
        "shard_lookup_partial": ("sharded_partial.cu",
                                 "readserver_tpu/parallel/sharded.py:489",
                                 "shard_lookup_partial_err"),
        "sharded_lut_level_partial": ("sharded_partial.cu",
                                      "readserver_tpu/parallel/sharded.py:1075",
                                      "sharded_lut_level_partial_err"),
        "walk_lf_step": ("sharded_partial.cu",
                         "readserver_tpu/parallel/sharded.py:852",
                         "walk_lf_step_err"),
        "walk_slow_step": ("sharded_partial.cu",
                           "readserver_tpu/parallel/sharded.py:885",
                           "walk_slow_step_err"),
        "row_compact": ("compact.cu", "readserver_tpu/ops/resolve.py:383",
                        "k14_err"),
        "row_gather": ("compact.cu", "readserver_tpu/ops/resolve.py:383",
                       "k14_err"),
        "capped_histogram": ("compact.cu",
                             "readserver_tpu/ops/resolve.py:502", "k15_err"),
        "sparse_pack": ("pack.cu", "readserver_tpu/serve/engine.py:127",
                        "k8_err"),
        "merge_pack": ("pack.cu", "readserver_tpu/serve/engine.py:1139",
                       "merge_err"),
    }

    def cold(chain_ms):
        """The chain bound at the cold t_row (the E. coli tables lie past
        the L2), or None."""
        return (None if None in (chain_ms, t_row, t_row_cold)
                else chain_ms * t_row_cold / t_row)

    kernels = []
    for name, (src, rep_at, err) in where.items():
        ms, plain_ms, device_ms, bnd, shape, chain_ms = summary[name]
        # bound_ms and bound_by are the bytes-or-operations bound; a walk's
        # or the search's chain bound rides beside them, and held_by names
        # the larger of the two
        kernels.append(dict(
            name=name, route="cuda",
            source=f"readserver_tpu_torch/csrc/{src}", replaces=rep_at,
            launches=total[name],
            cohort_launches=path_launches["cohort"][name],
            ingest_launches=ingest_launches[name],
            max_abs_err=summary[err], cohort_max_abs_err=cohort_err.get(err),
            ms=ms,
            device_ms=device_ms, plain_ms=plain_ms, bound_ms=bnd,
            bound_by="bytes", library_ms=library.get(name, (None,))[0],
            library_call=library.get(name, (None, None))[1], shape=shape,
            chain_ms=chain_ms, chain_cold_ms=cold(chain_ms),
            held_by="chain" if chain_ms is not None and chain_ms > bnd
            else "bytes"))
    # the rank walks' reading on each walk and shape
    walks = {}
    for name in summary:
        if name.startswith("resolve_walk"):
            ms, plain_ms, device_ms, bnd, shape, chain_ms = summary[name]
            walks[name] = dict(
                ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bnd,
                chain_ms=chain_ms, chain_cold_ms=cold(chain_ms),
                share=(max(bnd, chain_ms or 0.0) / device_ms
                       if device_ms else None), shape=shape)
    next(k for k in kernels if k["name"] == "resolve_walk")["walks"] = walks
    # K10's reading on each route: the resolve (dsa, lf, slow) and the
    # exact sweep through each
    next(k for k in kernels if k["name"] == "sharded_resolve")["routes"] = \
        shard_routes
    # the cross-rank design readings: all-reduces a batch by route, and the
    # all-reduce's time against a step's kernel
    next(k for k in kernels if k["name"] == "shard_occ_partial")["design"] = \
        rank_design
    # the cross-rank kernels' other readings: K9's partial's rank, K13's LF
    # and symbol lookups (the walks' steps before the walk-step kernels),
    # and every mode of the walk steps
    for k in kernels:
        if k["name"] in RANK_KERNELS:
            k["readings"] = {}
            for name in summary:
                if name.startswith(k["name"] + " ("):
                    ms, plain_ms, device_ms, bnd, shape, chain_ms = \
                        summary[name]
                    k["readings"][name[len(k["name"]) + 2:-1]] = dict(
                        ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                        bound_ms=bnd, chain_ms=chain_ms,
                        chain_cold_ms=cold(chain_ms), shape=shape)
    # K14's and K15's other readings (phase 7 at the full budget and the
    # gather's read_to_sample column, phase 11b on the interval index), the
    # interval programs' torch ops against K14 + K15 (phase 11b), and the
    # doc merge's collectives (phase 14: NCCL in the group of one; gloo
    # between two ranks on the card)
    for k in kernels:
        if k["name"] in COMPACT_KERNELS:
            k["readings"] = {}
            for name in summary:
                if name.startswith(k["name"] + " ("):
                    ms, plain_ms, device_ms, bnd, shape, _ = summary[name]
                    k["readings"][name[len(k["name"]) + 2:-1]] = dict(
                        ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                        bound_ms=bnd, shape=shape)
    # K8's and the merge's histogram-tier readings (the /samples shapes)
    for k in kernels:
        if k["name"] in ("sparse_pack", "merge_pack"):
            ms, plain_ms, device_ms, bnd, shape, _ = summary[
                k["name"] + " (samples)"]
            lib = library.get(k["name"] + " (samples)", (None, None))
            k["readings"] = {"samples": dict(
                ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bnd,
                library_ms=lib[0], library_call=lib[1], shape=shape)}
    row_compact = next(k for k in kernels if k["name"] == "row_compact")
    row_compact["interval_ops"] = summary["interval_ops"]
    row_compact["doc_collectives"] = doc_coll
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
