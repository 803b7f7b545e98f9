#!/usr/bin/env python
"""Config-4 (wg) cohort build: whole-genome scale fraction, doc shards.

BASELINE.json:10 pins whole-human 30x as the multi-host rung.  At any
scale past the int32 position range (n > 2^31 ≈ 2.1e9 symbols) a single
DeviceIndex is architecturally impossible in this framework
(index/builder.concat_with_sentinels refuses; ops positions are int32),
and the full tier set is several times one chip's HBM — sharding stops
being an optimization and becomes the only correct deployment.  This
script builds that shape: N doc shards, each an independent in-core
build, orchestrated across worker processes (SA-IS is single-threaded;
two workers saturate this host).

    python scripts/build_wg.py --scale 0.05 --shards 5 --workers 2
    python scripts/build_wg.py ... --worker-id 0   # (internal) build my shards

Resumable: complete shard artifacts are skipped (manifest-last).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def wg_cache(scale: float, shards: int) -> Path:
    return REPO / "data" / f"bench_wg_s{scale:g}_d{shards}"


def shard_spans(scale: float, shards: int):
    from readserver_tpu_torch.corpus import simulate

    spec = simulate.CONFIGS["wg"]
    glen = max(1000, int(spec.genome_len * scale))
    num = max(1, int(round(spec.coverage * glen / spec.read_len)))
    # contiguous equal-count read spans (equal-length reads)
    edges = [num * s // shards for s in range(shards + 1)]
    return spec, glen, num, list(zip(edges[:-1], edges[1:]))


def build_my_shards(args) -> int:
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.index.builder import build_index

    out = wg_cache(args.scale, args.shards)
    spec, glen, num, spans = shard_spans(args.scale, args.shards)
    todo = [
        s for s in range(args.shards)
        if s % args.workers == args.worker_id
        and not artifact.artifact_exists(out / f"shard_{s:04d}")
    ]
    if not todo:
        return 0
    t0 = time.time()
    corpus = simulate.simulate_config("wg", scale=args.scale)
    # keep only the backing [num, L] matrix: 47M row-view objects cost
    # ~5 GB of pure Python overhead this 2-worker host can't spare
    mat = corpus.reads[0].base
    assert mat.shape[0] == num
    corpus.reads.clear()
    del corpus
    print(
        f"[w{args.worker_id}] simulated {num} reads "
        f"({time.time()-t0:.0f}s)",
        flush=True,
    )
    for s in todo:
        lo, hi = spans[s]
        sub = list(mat[lo:hi])
        t1 = time.time()
        packed = build_index(
            sub,
            sample_ids=np.zeros(len(sub), dtype=np.int32),
            sample_names=["wg"],
            sample_rate=16,
        )
        packed.num_samples = 1
        artifact.save_artifact(packed, out / f"shard_{s:04d}")
        print(
            f"[w{args.worker_id}] shard {s}: n={packed.n} "
            f"reads={packed.num_reads} built in {time.time()-t1:.0f}s",
            flush=True,
        )
    return 0


PARITY_POOL = 32768  # cached query pool size (all with oracle counts)


def write_parity_cache(scale: float, shards: int) -> Path:
    """One-time oracle pass, saved next to the cohort: a fixed query pool
    + exact counts for EVERY pool entry (sorted window multiset, one sort
    + two binary searches per query).  bench_wg then needs neither the
    22M-read re-simulation nor the multi-minute multiset sort per run
    (VERDICT r3 #2/#6)."""
    from readserver_tpu_torch import alphabet  # noqa: F401  (env check)
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.oracle.naive import window_multiset_counts

    out = wg_cache(scale, shards)
    t0 = time.time()
    corpus = simulate.simulate_config("wg", scale=scale)
    mat = corpus.reads[0].base
    corpus.reads.clear()
    del corpus
    spec = simulate.CONFIGS["wg"]
    k = spec.kmer_len
    rng = np.random.default_rng(41)
    rows = rng.integers(0, mat.shape[0], size=PARITY_POOL)
    offs = rng.integers(0, mat.shape[1] - k + 1, size=PARITY_POOL)
    pool = mat[rows[:, None], offs[:, None] + np.arange(k)[None, :]]
    miss = rng.random(PARITY_POOL) < 0.1
    pool[miss] = rng.integers(
        1, 5, size=(int(miss.sum()), k), dtype=pool.dtype
    )
    print(f"# pool sampled ({time.time()-t0:.0f}s); counting...",
          flush=True)
    counts = window_multiset_counts(mat, pool.astype(np.uint8))
    tmp = out / "parity_cache.npz.tmp.npz"
    np.savez(tmp, queries=pool.astype(np.uint8), counts=counts)
    tmp.rename(out / "parity_cache.npz")
    print(
        f"# parity cache: {PARITY_POOL} queries "
        f"(present: {(counts > 0).sum()}) in {time.time()-t0:.0f}s "
        f"→ {out / 'parity_cache.npz'}",
        flush=True,
    )
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--shards", type=int, default=5)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--worker-id", type=int, default=-1)
    ap.add_argument("--parity-only", action="store_true",
                    help="(re)generate just the parity cache for an "
                         "already-built cohort")
    args = ap.parse_args()

    if args.parity_only:
        write_parity_cache(args.scale, args.shards)
        return 0
    if args.worker_id >= 0:
        return build_my_shards(args)

    out = wg_cache(args.scale, args.shards)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = [
        subprocess.Popen(
            [
                sys.executable, __file__,
                "--scale", str(args.scale),
                "--shards", str(args.shards),
                "--workers", str(args.workers),
                "--worker-id", str(w),
            ],
            cwd=REPO,
        )
        for w in range(args.workers)
    ]
    rc = max(p.wait() for p in procs)
    if rc:
        return rc
    # manifest last (cohort contract: presence == complete)
    from readserver_tpu_torch.index.cohort import COHORT_MANIFEST

    spec, glen, num, spans = shard_spans(args.scale, args.shards)
    manifest = {
        "kind": "cohort",
        "format_version": 1,
        "num_shards": args.shards,
        "shards": [f"shard_{s:04d}" for s in range(args.shards)],
        "num_reads": num,
        "num_samples": 1,
        "sample_names": ["wg"],
        "genome_len": glen,
        "scale": args.scale,
    }
    tmp = out / (COHORT_MANIFEST + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    tmp.rename(out / COHORT_MANIFEST)
    print(f"wg cohort complete in {time.time()-t0:.0f}s at {out}")
    write_parity_cache(args.scale, args.shards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
