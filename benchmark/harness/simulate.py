"""Frozen copy of the read and query generators the deployments use.

A configuration's corpus is a seeded simulation at the published genome
size, coverage and read length.  These are the generators of
``readserver_tpu_torch/corpus/simulate.py`` (``random_genome``,
``simulate_reads``, the per-sample loop of ``simulate_config`` and
``sample_query_kmers_fast``), copied so that the benchmark makes the same
reads from the same seeds whatever later changes the program's copy.
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

BASES = "ACGT"
# $ -> $, A <-> T, C <-> G on the codes 0..4 ($ A C G T)
COMPLEMENT = np.array([0, 4, 3, 2, 1], dtype=np.uint8)
DECODE = np.frombuffer(b"$ACGT", dtype=np.uint8)


def random_genome(length: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, size=length, dtype=np.uint8)


def simulate_reads(genome: np.ndarray, coverage: float, read_len: int,
                   seed: int, error_rate: float = 0.0) -> np.ndarray:
    """Uniform shotgun reads off both strands → uint8 [m, read_len]."""
    g = len(genome)
    num = max(1, int(round(coverage * g / read_len)))
    if g < read_len:
        raise ValueError("genome shorter than read length")
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, g - read_len + 1, size=num)
    mat = genome[starts[:, None] + np.arange(read_len)[None, :]]
    rev = rng.integers(0, 2, size=num).astype(bool)
    mat[rev] = COMPLEMENT[mat[rev]][:, ::-1]
    if error_rate > 0.0:
        errs = rng.random(mat.shape) < error_rate
        shift = rng.integers(1, 4, size=int(errs.sum())).astype(np.uint8)
        mat[errs] = ((mat[errs] - 1 + shift) % 4 + 1).astype(np.uint8)
    return mat


def simulate_corpus(corpus: dict) -> tuple[np.ndarray, np.ndarray]:
    """A configuration's ``corpus`` block → (reads uint8 [m, L], sample ids
    int32 [m]): one genome, then each sample's reads at its share of the
    coverage, sample after sample."""
    genome = random_genome(int(corpus["genome_len"]), int(corpus["seed"]))
    ns = int(corpus.get("num_samples", 1))
    cov = float(corpus["coverage"]) / ns if ns > 1 else float(corpus["coverage"])
    reads, sids = [], []
    for s in range(ns):
        rs = simulate_reads(genome, cov, int(corpus["read_len"]),
                            seed=int(corpus["seed"]) * 1000 + s,
                            error_rate=float(corpus.get("error_rate", 0.0)))
        reads.append(rs)
        sids.append(np.full(len(rs), s, dtype=np.int32))
    return np.concatenate(reads), np.concatenate(sids)


def sample_query_kmers(reads: np.ndarray, num: int, k: int, seed: int,
                       miss_frac: float) -> np.ndarray:
    """Query k-mers → uint8 [num, k]: windows of random reads, a
    ``miss_frac`` share replaced by random bases (mostly absent)."""
    rng = np.random.default_rng(seed)
    m, L = reads.shape
    if k > L:
        raise ValueError("k longer than read length")
    ridx = rng.integers(0, m, size=num)
    offs = rng.integers(0, L - k + 1, size=num)
    out = reads[ridx[:, None], offs[:, None] + np.arange(k)[None, :]]
    miss = rng.random(num) < miss_frac
    nmiss = int(miss.sum())
    if nmiss:
        out[miss] = rng.integers(1, 5, size=(nmiss, k), dtype=np.uint8)
    return out.astype(np.uint8)


def decode_rows(codes: np.ndarray) -> list[str]:
    """uint8 [n, k] codes 1..4 → n ASCII strings."""
    n, k = codes.shape
    raw = DECODE[codes].tobytes().decode("ascii")
    return [raw[i * k:(i + 1) * k] for i in range(n)]
