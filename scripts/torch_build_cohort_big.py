#!/usr/bin/env python
"""Config-5 at config-5 scale: 128 samples x >=1e9 symbols in ONE cohort.

BASELINE.json:11 pins "multi-sample cohort (UK10K-style, 100+ samples):
population-scale k-mer presence queries with per-sample hit attribution".
The recorded cohort rung (r4) had 128 samples at only n=27.9M; the
at-scale wg rung had num_samples=1 — no artifact combined both axes
(VERDICT r4 missing #1).  This script builds the artifact that does:

    cohort_big: 34 Mb genome, 128 samples at 0.234x each (30x pooled),
    10.2M reads -> n = 1.030e9 symbols, 4 doc shards (each one sample
    span), served time-multiplexed on one chip (MultiEngine).

    python scripts/build_cohort_big.py [--shards 4] [--workers 2]

Worker-parallel (SA-IS is single-threaded; 2 workers saturate this
host), resumable (complete shard artifacts are skipped, manifest-last).
Each shard covers a contiguous run of samples, so a worker simulates
only its own samples (seeded per sample — simulate_config parity).

After the shards, writes ``parity_cache.npz``: a 32k-query pool with
exact window-multiset counts for every entry PLUS exact 128-wide
per-sample attribution histograms for a fixed subset — so the bench
(scripts/bench_cohort.py --config cohort_big) never re-simulates the
10.2M-read corpus or re-sorts the 720M-window multiset.

kstep is pinned to 2: per-shard n=2.6e8 is under TRIPLE_TIER_MAX_N, but
four 16 B/sym triple planes can neither fit one chip's HBM alongside the
rest of the ladder nor the host's free disk; pair planes are the
deployment shape (same as the wg cohort's shards).
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

CONFIG_NAME = "cohort_big"
PARITY_POOL = 32768
HIST_QUERIES = 64

import os

SMOKE = bool(os.environ.get("READSERVER_COHORT_BIG_SMOKE"))
if SMOKE:  # tiny stand-in spec: same shape, minutes not hours
    from readserver_tpu_torch.corpus import simulate as _sim

    _sim.CONFIGS[CONFIG_NAME] = _sim.CorpusSpec(
        CONFIG_NAME, 20_000, 30.0, 100, num_samples=128, kmer_len=31,
        seed=106,
    )


def cache_dir(shards: int) -> Path:
    tag = "_smoke" if SMOKE else ""
    return REPO / "data" / f"bench_{CONFIG_NAME}{tag}_d{shards}"


def sample_matrix(spec, genome: np.ndarray, s: int) -> np.ndarray:
    """Sample ``s``'s read matrix, bit-identical to simulate_config's
    per-sample loop (corpus/simulate.py::simulate_config seeds each
    sample ``spec.seed * 1000 + s`` at coverage/num_samples)."""
    from readserver_tpu_torch.corpus import simulate

    rs = simulate.simulate_reads(
        genome,
        spec.coverage / spec.num_samples,
        spec.read_len,
        seed=spec.seed * 1000 + s,
        error_rate=spec.error_rate,
    )
    mat = rs[0].base
    assert mat.shape[0] == len(rs)
    return mat


def shard_sample_spans(num_samples: int, shards: int):
    edges = [num_samples * s // shards for s in range(shards + 1)]
    return list(zip(edges[:-1], edges[1:]))


def build_my_shards(args) -> int:
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index import artifact
    from readserver_tpu_torch.index.builder import build_index

    out = cache_dir(args.shards)
    spec = simulate.CONFIGS[CONFIG_NAME]
    spans = shard_sample_spans(spec.num_samples, args.shards)
    todo = [
        s for s in range(args.shards)
        if s % args.workers == args.worker_id
        and not artifact.artifact_exists(out / f"shard_{s:04d}")
    ]
    if not todo:
        return 0
    genome = simulate.random_genome(spec.genome_len, spec.seed)
    names = [f"s{i:03d}" for i in range(spec.num_samples)]
    for s in todo:
        lo, hi = spans[s]
        t0 = time.time()
        mats = [sample_matrix(spec, genome, i) for i in range(lo, hi)]
        sids = np.concatenate(
            [np.full(m.shape[0], i, np.int32) for i, m in zip(range(lo, hi), mats)]
        )
        mat = np.concatenate(mats)
        del mats
        print(
            f"[w{args.worker_id}] shard {s}: samples {lo}..{hi - 1}, "
            f"{mat.shape[0]} reads simulated ({time.time() - t0:.0f}s)",
            flush=True,
        )
        t1 = time.time()
        packed = build_index(
            list(mat),
            sample_ids=sids,
            sample_names=names,
            kstep=2,  # see module docstring
        )
        packed.num_samples = spec.num_samples
        artifact.save_artifact(packed, out / f"shard_{s:04d}")
        print(
            f"[w{args.worker_id}] shard {s}: n={packed.n} "
            f"reads={packed.num_reads} built in {time.time() - t1:.0f}s",
            flush=True,
        )
    return 0


def full_matrix(spec):
    """The whole 10.2M x 100 corpus matrix + global sample ids (1.06 GB)."""
    from readserver_tpu_torch.corpus import simulate

    genome = simulate.random_genome(spec.genome_len, spec.seed)
    mats = [sample_matrix(spec, genome, s) for s in range(spec.num_samples)]
    sids = np.concatenate(
        [np.full(m.shape[0], i, np.int32) for i, m in enumerate(mats)]
    )
    return np.concatenate(mats), sids


def write_parity_cache(shards: int) -> Path:
    """One-time oracle pass: pool counts via the sorted window multiset,
    exact per-sample histograms for HIST_QUERIES pool entries via the
    UNsorted per-read window matrix (match-count per read -> bincount by
    sample) — both from a single window encode."""
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.oracle.naive import encode_windows_2bit

    out = cache_dir(shards)
    spec = simulate.CONFIGS[CONFIG_NAME]
    k = spec.kmer_len
    t0 = time.time()
    mat, sids = full_matrix(spec)
    print(f"# corpus matrix {mat.shape} ({time.time() - t0:.0f}s)", flush=True)

    rng = np.random.default_rng(41)
    rows = rng.integers(0, mat.shape[0], size=PARITY_POOL)
    offs = rng.integers(0, mat.shape[1] - k + 1, size=PARITY_POOL)
    pool = mat[rows[:, None], offs[:, None] + np.arange(k)[None, :]]
    miss = rng.random(PARITY_POOL) < 0.1
    pool[miss] = rng.integers(1, 5, size=(int(miss.sum()), k), dtype=pool.dtype)
    enc_q = np.zeros(PARITY_POOL, dtype=np.uint64)
    for j in range(k):
        enc_q |= (pool[:, j].astype(np.uint64) - 1) << np.uint64(2 * j)

    win = encode_windows_2bit(mat, k)  # [m, L-k+1] uint64, ~5.8 GB
    del mat
    print(f"# windows encoded {win.shape} ({time.time() - t0:.0f}s)", flush=True)

    # exact per-sample histograms while the window matrix is still per-read
    hist_idx = rng.choice(PARITY_POOL, HIST_QUERIES, replace=False).astype(np.int32)
    hists = np.zeros((HIST_QUERIES, spec.num_samples), dtype=np.int64)
    for hq, qi in enumerate(hist_idx):
        per_read = (win == enc_q[qi]).sum(axis=1)
        hists[hq] = np.bincount(
            sids, weights=per_read, minlength=spec.num_samples
        ).astype(np.int64)
    print(f"# {HIST_QUERIES} exact histograms ({time.time() - t0:.0f}s)", flush=True)

    flat = win.ravel()
    del win
    flat.sort()
    lo = np.searchsorted(flat, enc_q, side="left")
    hi = np.searchsorted(flat, enc_q, side="right")
    counts = (hi - lo).astype(np.int64)
    # histograms must sum to the multiset count — one oracle cross-check
    assert np.array_equal(hists.sum(axis=1), counts[hist_idx])
    del flat

    tmp = out / "parity_cache.npz.tmp.npz"
    np.savez(
        tmp, queries=pool.astype(np.uint8), counts=counts,
        hist_idx=hist_idx, hists=hists,
    )
    tmp.rename(out / "parity_cache.npz")
    print(
        f"# parity cache: {PARITY_POOL} counts (present: {(counts > 0).sum()}), "
        f"{HIST_QUERIES} exact 128-wide histograms in {time.time() - t0:.0f}s",
        flush=True,
    )
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--worker-id", type=int, default=-1)
    ap.add_argument("--parity-only", action="store_true")
    args = ap.parse_args()

    if args.parity_only:
        write_parity_cache(args.shards)
        return 0
    if args.worker_id >= 0:
        return build_my_shards(args)

    from readserver_tpu_torch.config import IndexConfig
    from readserver_tpu_torch.corpus import simulate
    from readserver_tpu_torch.index.cohort import _write_cohort_manifest

    out = cache_dir(args.shards)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = [
        subprocess.Popen(
            [
                sys.executable, __file__,
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
    spec = simulate.CONFIGS[CONFIG_NAME]
    per_sample = max(
        1,
        int(round(spec.coverage / spec.num_samples * spec.genome_len / spec.read_len)),
    )
    num_reads = per_sample * spec.num_samples
    _write_cohort_manifest(
        out,
        [f"shard_{s:04d}" for s in range(args.shards)],
        num_reads,
        spec.num_samples,
        [f"s{i:03d}" for i in range(spec.num_samples)],
        IndexConfig(),
    )
    print(f"cohort_big shards complete in {time.time() - t0:.0f}s at {out}")
    if not (out / "parity_cache.npz").exists():
        write_parity_cache(args.shards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
