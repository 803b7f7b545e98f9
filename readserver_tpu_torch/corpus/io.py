"""FASTA/FASTQ ingest + read normalization (reference L0 analog).

The reference's Perl preprocessing extracts reads, quality-trims, and
drops/splits on ``N`` (SURVEY.md §2.1 "Read preprocessing"). The normalizer
here implements the same contract: emit only ACGT segments, splitting reads
at ambiguous bases and dropping segments shorter than ``min_len``.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from readserver_tpu_torch import alphabet


def _open(path: str | Path):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_fasta(path: str | Path) -> Iterator[tuple[str, str]]:
    """Yield ``(name, sequence)`` records."""
    name, chunks = None, []
    with _open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name, chunks = line[1:].split()[0], []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def read_fastq(path: str | Path) -> Iterator[tuple[str, str]]:
    """Yield ``(name, sequence)`` records (qualities discarded)."""
    for name, seq, _ in read_fastq_quals(path):
        yield name, seq


def read_fastq_quals(path: str | Path) -> Iterator[tuple[str, str, str]]:
    """Yield ``(name, sequence, quality-string)`` records."""
    with _open(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            seq = fh.readline().strip()
            fh.readline()  # '+'
            quals = fh.readline().strip()
            yield header.strip()[1:].split()[0], seq, quals


def mott_trim_len(
    quals: str | np.ndarray, threshold: int = 20, offset: int = 33
) -> int:
    """Kept-prefix length under Mott-style 3' quality trimming (the
    reference pipeline's quality-trim stage, SURVEY.md §2.1 "Read
    preprocessing"): choose the suffix maximizing ``Σ (threshold − q_i)``
    and cut it; returns the full length when no suffix has positive
    penalty.  ``quals`` is a phred string (ASCII − ``offset``) or an
    int array of phred scores."""
    if isinstance(quals, str):
        q = (
            np.frombuffer(quals.encode("ascii"), dtype=np.uint8).astype(
                np.int32
            )
            - offset
        )
    else:
        q = np.asarray(quals, dtype=np.int32)
    if q.size == 0:
        return 0
    pen = np.cumsum((threshold - q)[::-1])
    best = int(np.argmax(pen))
    if pen[best] <= 0:
        return int(q.size)
    return int(q.size) - best - 1


def write_fasta(path: str | Path, records: Iterable[tuple[str, str]]) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")


def rlo_order(reads: list[np.ndarray]) -> np.ndarray:
    """Reverse-lexicographic permutation of a read set (int64 [m]) —
    callers apply it to reads AND every parallel per-read column
    (sample ids, names, metadata)."""
    m = len(reads)
    maxlen = max(len(r) for r in reads)
    # pad with 0 ($ sorts first — shorter reversed reads order first, the
    # same tie-break the sentinel ordering gives)
    mat = np.zeros((m, maxlen), dtype=np.uint8)
    for i, r in enumerate(reads):
        mat[i, : len(r)] = r[::-1]
    return np.lexsort(mat.T[::-1])


def rlo_sort(
    reads: list[np.ndarray], sample_ids: np.ndarray | None = None
) -> tuple[list[np.ndarray], np.ndarray | None]:
    """Reverse-lexicographic-order sort of a read set (+ matching
    sample-id permutation).

    RLO ordering maximizes run lengths in the multi-string BWT — the
    central compression lever of the reference pipeline (ropebwt2 ``-R``;
    SURVEY.md §2.1 "Read preprocessing").  The device index is bit-packed
    rather than run-length encoded, so this mainly shrinks the RLE
    interchange artifact (index/rle.py) and improves rank-block cache
    locality; it changes read ids, hence the returned permutation is
    applied to sample_ids here rather than left to the caller.
    """
    m = len(reads)
    if m == 0:
        return reads, sample_ids
    order = rlo_order(reads)
    out = [reads[i] for i in order]
    sid = sample_ids[order] if sample_ids is not None else None
    return out, sid


def normalize_read(seq: str, min_len: int = 20) -> list[np.ndarray]:
    """Split a raw read at non-ACGT bases; return code arrays ≥ ``min_len``."""
    out: list[np.ndarray] = []
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    codes = alphabet._ENCODE_LUT[raw]
    if codes.size == 0:
        return out
    boundaries = np.flatnonzero(codes == 0)
    segments = np.split(codes, boundaries)
    for seg in segments:
        seg = seg[seg != 0]
        if len(seg) >= min_len:
            out.append(np.ascontiguousarray(seg))
    return out
