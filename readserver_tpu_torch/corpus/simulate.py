"""Deterministic read simulators for the five benchmark configs.

BASELINE.json pins a five-config measurement ladder (lambda phage → E. coli →
human chr20 → whole human multi-host → multi-sample cohort).  The reference
corpus data (CRAM from real cohorts) is not available in this environment, so
each config is a seeded simulation at the pinned genome size / coverage /
read length; parity tests compare the device engine against the NumPy oracle
on the same simulated reads, which is the strongest available stand-in for
"the reference server's answers on its test corpus".
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class CorpusSpec:
    name: str
    genome_len: int
    coverage: float
    read_len: int
    num_samples: int = 1
    error_rate: float = 0.0  # per-base substitution rate
    kmer_len: int = 31
    seed: int = 0


# The measurement ladder (BASELINE.json:7-11). chr20 ≈ 64 Mbp, whole human
# ≈ 3.1 Gbp; "wg" is the sharding config and is sized down automatically by
# the sharded bench when HBM is short — the spec records the true target.
CONFIGS: dict[str, CorpusSpec] = {
    "lambda": CorpusSpec("lambda", 48_000, 30.0, 100, kmer_len=21, seed=101),
    "ecoli": CorpusSpec("ecoli", 4_600_000, 30.0, 100, kmer_len=31, seed=102),
    "chr20": CorpusSpec("chr20", 64_000_000, 30.0, 100, kmer_len=31, seed=103),
    "wg": CorpusSpec("wg", 3_100_000_000, 30.0, 100, kmer_len=31, seed=104),
    "cohort": CorpusSpec(
        "cohort", 4_600_000, 6.0, 100, num_samples=128, kmer_len=31, seed=105
    ),
    # population-scale config-5 rung: 128 samples AND >=1e9 symbols in the
    # same artifact (BASELINE.json:11 "population-scale ... per-sample hit
    # attribution").  30x pooled over 128 samples = 0.234x per sample, the
    # UK10K-style low-coverage population pool; n = 10.2M reads x 101 =
    # 1.030e9 symbols.  Sized to just clear the 1e9 bar: the artifact
    # (~16 GB) plus the existing caches must fit this host's 53 GB free.
    "cohort_big": CorpusSpec(
        "cohort_big", 34_000_000, 30.0, 100, num_samples=128, kmer_len=31,
        seed=106,
    ),
    # tiny configs for unit tests / smoke
    "tiny": CorpusSpec("tiny", 2_000, 10.0, 50, kmer_len=11, seed=7),
    "small": CorpusSpec("small", 20_000, 15.0, 80, kmer_len=15, seed=11),
}


@dataclass
class SimulatedCorpus:
    spec: CorpusSpec
    genome: np.ndarray                       # uint8 codes 1..4
    reads: list[np.ndarray] = field(default_factory=list)
    sample_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    @property
    def num_reads(self) -> int:
        return len(self.reads)


def random_genome(length: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, size=length, dtype=np.uint8)


def simulate_reads(
    genome: np.ndarray,
    coverage: float,
    read_len: int,
    seed: int,
    error_rate: float = 0.0,
) -> list[np.ndarray]:
    """Uniform shotgun reads off both strands, optional substitution errors.

    Fully vectorized (population-scale corpora are millions of reads)."""
    from readserver_tpu_torch import alphabet

    g = len(genome)
    num = max(1, int(round(coverage * g / read_len)))
    if g < read_len:
        raise ValueError("genome shorter than read length")
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, g - read_len + 1, size=num)
    mat = genome[starts[:, None] + np.arange(read_len)[None, :]]
    rev = rng.integers(0, 2, size=num).astype(bool)
    mat[rev] = alphabet._COMPLEMENT[mat[rev]][:, ::-1]
    if error_rate > 0.0:
        errs = rng.random(mat.shape) < error_rate
        shift = rng.integers(1, 4, size=int(errs.sum())).astype(np.uint8)
        mat[errs] = ((mat[errs] - 1 + shift) % 4 + 1).astype(np.uint8)
    return list(mat)


def simulate_config(name: str, scale: float = 1.0) -> SimulatedCorpus:
    """Build the corpus for a named config; ``scale`` shrinks genome_len
    (used by tests and by hardware-limited benches — recorded in results)."""
    spec = CONFIGS[name]
    glen = max(1000, int(spec.genome_len * scale))
    genome = random_genome(glen, spec.seed)
    reads: list[np.ndarray] = []
    sample_ids: list[int] = []
    for s in range(spec.num_samples):
        rs = simulate_reads(
            genome,
            spec.coverage / spec.num_samples if spec.num_samples > 1 else spec.coverage,
            spec.read_len,
            seed=spec.seed * 1000 + s,
            error_rate=spec.error_rate,
        )
        reads.extend(rs)
        sample_ids.extend([s] * len(rs))
    return SimulatedCorpus(
        spec=spec,
        genome=genome,
        reads=reads,
        sample_ids=np.asarray(sample_ids, dtype=np.int32),
    )


def sample_query_kmers_fast(
    corpus: SimulatedCorpus, num: int, k: int, seed: int = 0, miss_frac: float = 0.1
) -> np.ndarray:
    """Vectorized query sampler → uint8 [num, k]; requires equal-length
    reads (bench-scale workloads; the list-based sampler below is general).
    """
    rng = np.random.default_rng(seed)
    reads = np.stack(corpus.reads)  # [m, L]
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


def sample_query_kmers(
    corpus: SimulatedCorpus, num: int, k: int, seed: int = 0, miss_frac: float = 0.1
) -> list[np.ndarray]:
    """Query workload: mostly k-mers drawn from reads, a fraction random
    (mostly absent) — the property-test and bench mix (SURVEY.md §4.2)."""
    rng = np.random.default_rng(seed)
    out: list[np.ndarray] = []
    nr = len(corpus.reads)
    for _ in range(num):
        if rng.random() < miss_frac or nr == 0:
            out.append(rng.integers(1, 5, size=k, dtype=np.uint8))
        else:
            r = corpus.reads[int(rng.integers(0, nr))]
            if len(r) < k:
                out.append(rng.integers(1, 5, size=k, dtype=np.uint8))
            else:
                s = int(rng.integers(0, len(r) - k + 1))
                out.append(r[s : s + k].copy())
    return out
