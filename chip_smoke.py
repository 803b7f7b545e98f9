#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card, end to end.

    python3 chip_smoke.py              # E. coli 30x + the 128-sample cohort
    python3 chip_smoke.py --scale 0.05 # 5% of each, for a quick check

Phases, each printed with its seconds on a ``#`` line, run in the order
1-5, 8-10, 6, 7 (every main path is driven before the kernel-vs-plain and
timing phases, so each path's launch counts are its own):

1. device: a CUDA card is required (no CPU path); its name and power limit;
2. kernels: build K1 (rank), K2 (backward search), K5 (dsa resolve), K6
   (fused-row walk) and K7 (exact histogram) from
   ``readserver_tpu_torch/csrc`` in one nvcc call for sm_90a;
3. artifact: simulate and build the E. coli artifact with the port's
   builder (cached under ``data/``);
4. count path: with every kernel's launch count at 0, start a
   ``QueryEngine`` on the card (tier plan, ship, prefix LUT through K1,
   warmup) and send count requests (1, 256, and 4096 queries on both
   strands); K1 and K2 must have launched;
5. oracle: the served counts of >= 256 queries against exact counts of all
   read windows (``oracle.naive.window_multiset_counts``);
8. reads: counts at 0, ``query_batch`` requests (1, 256, 4096 on both
   strands) on the dsa engine (K5) and on a ``drop_tiers=("dsa",)`` engine
   (K6 after the row-budget compaction); the two engines' answers equal,
   hit sets against the windows equal to each query on >= 64 queries; K5
   and K6 must have launched;
9. samples: the 128-sample cohort artifact (built or loaded), counts at 0,
   histogram-only and full ``query_batch`` on a dsa and a fused engine;
   histograms exact against per-sample oracle counts on >= 64 queries, and
   a capped engine's ``complete`` flags against the window-rounding rule;
   K7 must have launched through both walks;
10. REST: counts at 0, the port's ``RestServer`` over the card engines in
   this script's event loop; every endpoint's answer equals the engine's;
6. kernel vs plain: each kernel against its plain torch form on the card,
   bit for bit, at the main paths' shapes (the engine's prefix LUT against
   a plain-rank build, batches of width 256 and 8192, H = 64) and at edge
   cases;
7. timing: K2 searches/s and batch latency at B=262,144 over 8 distinct
   batches, K1 rows/s at the LUT's last level, K5-K7 against their plain
   forms at width 8192 (CUDA events and the profiler's kernel time), and
   where a served count, ``/reads`` and ``/samples`` request's time goes
   (host stages, device busy share, top device ops).

The line before the last is the card's ``nvidia-smi`` name and power limit;
the one before it is the kernels' JSON summary (``launches`` summed over
the main-path phases 4, 8, 9 and 10).  The last line is
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
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in events if kernel in e.key)
    if us <= 0:
        log(f"profiler saw no device time for {kernel}; its device events: "
            + ", ".join(f"{e.key[:60]} {e.self_device_time_total:.1f} us"
                        for e in events[:4]))
    return us / iters / 1e3 if us > 0 else None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def request_breakdown(engine, kms: list[str], tier: str) -> None:
    """Where one served both-strands request's time goes: host stages by
    wall clock, and the device's busy share from a profiler window.
    ``tier``: "count" (``count_batch``), "reads" (``query_batch``) or
    "samples" (``query_batch(include_hits=False)``)."""
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
    if tier == "count":
        out = engine._dispatch_single(codes, lengths, nq)[:nq]
    else:
        use_lut, use_pair = engine._routes(codes, lengths, nq)
        out = engine._served(*engine._to_device(codes, lengths), nq, use_lut,
                             use_pair, tier == "reads")[0]
    torch.cuda.synchronize()
    stages["copy in + device"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.cpu().numpy()
    stages["copy out"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole_fn()
    whole = time.perf_counter() - t0
    stages["results (rest)"] = whole - sum(stages.values())
    log(f"{tier} request of {len(kms)} queries on both strands ({nq} "
        f"searched): {whole * 1e3:.3f} ms = " + ", ".join(
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


def rest_check(engine, kms: list[str], server_cls, Dispatcher) -> int:
    """Every endpoint through the port's REST front over ``engine``, each
    answer against what the engine gives directly → requests sent."""
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
         "sample": engine.sample_names[engine._sample_of(rid)]},
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


def max_err(pairs) -> int:
    """Largest |kernel - plain| over (kernel, plain) tensor pairs."""
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


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
        launches = read_launches("count")
        for name in ("rank_occ", "backward_search"):
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
        check(engine.index.dsa is not None, "the default plan has no dsa")
        check(engine_f.index.dsa is None
              and engine_f.index.fused_rows is not None,
              "the drop_tiers=('dsa',) plan does not walk fused rows")
        reads_served = {}
        for name, qs, both in (("1", q1, False), ("256", q256, False),
                               ("4096x2", q4096, True)):
            kms = decode_all(qs)
            t0 = time.perf_counter()
            res = engine.query_batch(kms, both_strands=both)
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            res_f = engine_f.query_batch(kms, both_strands=both)
            dt_f = time.perf_counter() - t0
            check(res == res_f, f"the dsa and fused engines disagree on the "
                  f"request of {name}")
            reads_served[name] = res
            log(f"/reads request of {name} queries: dsa engine "
                f"{dt * 1e3:.3f} ms, fused engine {dt_f * 1e3:.3f} ms, "
                f"{sum(len(r.hits) for r in res)} hits, "
                f"{sum(r.hits_truncated for r in res)} truncated, answers "
                f"equal")
        launches = read_launches("reads")
        for name in ("resolve_dsa", "resolve_fused"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the reads path")
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
        log(f"cohort engines (dsa: {sorted(ceng.tier_plan.keep)}; fused: "
            f"{sorted(ceng_f.tier_plan.keep)}) up and warm in "
            f"{time.perf_counter() - t0:.3f}s")
        check(ceng.index.dsa is not None and ceng_f.index.dsa is None
              and ceng_f.index.fused_rows is not None,
              "the cohort engines do not walk dsa and fused")
        cpool = simulate.sample_query_kmers_fast(
            cohort, 4096 + 256, KMER, seed=args.seed + 3, miss_frac=0.1)
        c256, c4096 = cpool[:256], cpool[256:]
        ckms = decode_all(c256)
        answers = {}
        for ename, eng in (("dsa", ceng), ("fused", ceng_f)):
            k7 = KERNELS["exact_histogram"].launches
            for tier, hits in (("hist", False), ("full", True)):
                t0 = time.perf_counter()
                answers[ename, tier] = eng.query_batch(ckms, include_hits=hits)
                log(f"/samples request of 256 queries ({tier}, {ename} "
                    f"walk): {(time.perf_counter() - t0) * 1e3:.3f} ms")
            check(KERNELS["exact_histogram"].launches > k7,
                  f"K7 did not launch through the {ename} walk")
        check(answers["dsa", "hist"] == answers["fused", "hist"]
              and answers["dsa", "full"] == answers["fused", "full"],
              "the dsa and fused cohort engines disagree")
        key = lambda r: (r.count, r.sample_hist, r.sample_hist_complete)  # noqa: E731
        check([key(r) for r in answers["dsa", "hist"]]
              == [key(r) for r in answers["dsa", "full"]],
              "histogram-only and full answers disagree")
        launches = read_launches("samples")
        check(launches["exact_histogram"] > 0,
              "kernel exact_histogram was not launched on the samples path")
        t0 = time.perf_counter()
        cmat = np.stack(cohort.reads)
        want_c = hit_oracle(cmat, c256[:96])
        del cmat
        names = cpacked.sample_names
        for res, w in zip(answers["dsa", "hist"][:96], want_c):
            rids = np.fromiter((r for r, _ in w), dtype=np.int64)
            per = np.bincount(cohort.sample_ids[rids], minlength=128)
            want_hist = {names[i]: int(c) for i, c in enumerate(per) if c}
            check(res.count == len(w) and res.sample_hist == want_hist
                  and res.sample_hist_complete,
                  f"{res.kmer}: histogram differs from the oracle")
        log(f"oracle histograms: 96 cohort queries exact and complete "
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

    # ------------------------------------------------------------ 10. REST
    with phase("10 REST"):
        from readserver_tpu_torch.serve import Dispatcher
        from readserver_tpu_torch.serve.http import RestServer

        zero_launches()
        n_req = rest_check(engine, decode_all(q256), RestServer, Dispatcher)
        n_req += rest_check(ceng, ckms, RestServer, Dispatcher)
        launches = read_launches("REST")
        for name in ("backward_search", "resolve_dsa", "exact_histogram"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the REST path")
        log(f"{n_req} REST requests answered as the engines answer")

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

        # K5-K7 at the engines' own widths (256, 8192) and H = 64
        idx_f = engine_f.index

        def intervals(eng, kms):
            ce, le, nq = eng._pad_encode(kms)
            return eng._search(*eng._to_device(ce, le), *eng._routes(ce, le, nq))

        batches = {256: decode_all(q256),
                   8192: engine._expand_rc(decode_all(q4096))[0]}
        cbatches = {256: ckms, 8192: ceng._expand_rc(decode_all(c4096))[0]}
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
        for width, kms in cbatches.items():
            l, u = intervals(ceng, kms)
            for wname, cidx in (("dsa", ceng.index), ("fused", ceng_f.index)):
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
        summary.update(k1_ms=r_t_k, k1_plain_ms=r_t_p, k2_ms=t_k,
                       k2_plain_ms=t_p)
        # K5-K7 at width 8192: the E. coli 4096-on-both-strands batch (K5 on
        # the dsa engine, K6 on the fused engine's compacted rows) and the
        # cohort's (K7 through either walk, the engine's window and cap)
        l, u = intervals(engine, batches[8192])
        rows, valid, _ = resolve.expand_intervals(l, u, H)
        crow, cval, _, _ = resolve.compact_rows(rows, valid,
                                                engine_f.row_budget)
        cl, cu = intervals(ceng, cbatches[8192])
        win = 8 * 8192
        cases = [
            ("resolve_dsa", "resolve_dsa_kernel",
             lambda: resolve.resolve_dsa_hits(idx, l, u, H),
             lambda: resolve.resolve_dsa_hits_plain(idx, l, u, H),
             f"{8192 * H} lanes, {int(valid.sum())} hits"),
            ("resolve_fused", "resolve_fused_kernel",
             lambda: resolve.resolve_rows_fused(idx_f, crow, cval),
             lambda: resolve.resolve_rows_fused_plain(idx_f, crow, cval),
             f"{crow.shape[0]} compacted rows, {int(cval.sum())} valid"),
            ("exact_histogram", "exact_histogram_kernel",
             lambda: resolve.exact_sample_histogram(
                 ceng.index, cl, cu, win, 1 << 20),
             lambda: resolve.exact_sample_histogram_plain(
                 ceng.index, cl, cu, win, 1 << 20),
             f"dsa walk, {int((cu - cl).sum())} worklist rows"),
            ("exact_histogram (fused walk)", "exact_histogram_kernel",
             lambda: resolve.exact_sample_histogram(
                 ceng_f.index, cl, cu, win, 1 << 20),
             lambda: resolve.exact_sample_histogram_plain(
                 ceng_f.index, cl, cu, win, 1 << 20),
             "fused walk"),
        ]
        for name, kname, kern, plain, what in cases:
            check(max_err(zip(kern(), plain())) == 0,
                  f"{name} disagrees with its plain form at width 8192")
            torch.cuda.synchronize()
            t_kern, t_plain = [], []
            for _ in range(3):  # interleaved: kernel, plain
                t_kern.append(time_cuda(kern, 20))
                t_plain.append(time_cuda(plain, 3))
            dev_ms = kernel_device_ms(kern, 10, kname)
            tk, tp = float(np.median(t_kern)), float(np.median(t_plain))
            log(f"{name} width 8192 ({what}): wrapper {tk:.4f} ms, kernel "
                f"device time {fmt_ms(dev_ms)} ms (profiler) | plain torch "
                f"{tp:.4f} ms (median of 3 x 20 and 3 x 3 calls, CUDA "
                f"events), outputs equal | {card}")
            summary.setdefault(name, (tk, tp, dev_ms))
        request_breakdown(engine, decode_all(q4096), "count")
        request_breakdown(engine, decode_all(q4096), "reads")
        request_breakdown(ceng, decode_all(c4096), "samples")
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
            f" GiB")

    # launches: summed over the main-path phases (count, reads, samples,
    # REST), each counted from 0
    total = {name: sum(c[name] for c in path_launches.values())
             for name in KERNELS}
    timed = {"rank_occ": (summary["k1_ms"], summary["k1_plain_ms"]),
             "backward_search": (summary["k2_ms"], summary["k2_plain_ms"])}
    for name in ("resolve_dsa", "resolve_fused", "exact_histogram"):
        timed[name] = summary[name][:2]
    where = {
        "rank_occ": ("rank.cu", "readserver_tpu/kernels/pallas_rank.py:144",
                     "k1_err"),
        "backward_search": ("search.cu", "readserver_tpu/ops/search.py:220",
                            "k2_err"),
        "resolve_dsa": ("resolve.cu", "readserver_tpu/ops/resolve.py:222",
                        "k5_err"),
        "resolve_fused": ("resolve.cu", "readserver_tpu/ops/resolve.py:295",
                          "k6_err"),
        "exact_histogram": ("resolve.cu",
                            "readserver_tpu/ops/resolve.py:426", "k7_err"),
    }
    kernels = [
        dict(name=name, route="cuda",
             source=f"readserver_tpu_torch/csrc/{src}", replaces=rep,
             launches=total[name], max_abs_err=summary[err],
             ms=timed[name][0], plain_ms=timed[name][1])
        for name, (src, rep, err) in where.items()
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
