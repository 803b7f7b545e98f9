"""Exact multi-string FM-index in pure NumPy.

Semantics (locked here first, per SURVEY.md §7 "Exact $ semantics"):

* Each read ``R_i`` is its own string terminated by a distinct sentinel
  ``$_i`` with ``$_0 < $_1 < ... < $_{m-1} < A < C < G < T`` — the
  BCR / ropebwt2 / SGA multi-string convention (SURVEY.md §2.1).  K-mers
  never match across read boundaries because comparisons stop at sentinels.
* Construction uses the concatenation trick: assign sentinel ``i`` the
  integer ``i`` and base ``b`` the integer ``m - 1 + b``; the plain suffix
  array of the concatenation then induces exactly the generalized suffix
  array (distinct sentinels terminate every comparison), and its BWT —
  with all sentinel values collapsed back to code 0 — equals the
  generalized multi-string BWT.
* Rows ``0..m-1`` of the suffix array are the pure-sentinel suffixes in read
  order: row ``i`` ↔ read ``i``'s terminator.
* ``occ(c, i)`` counts occurrences of ``c`` in ``BWT[0:i]`` (exclusive), and
  intervals are half-open ``[l, u)`` — so the backward-search update is
  ``l' = C[c] + occ(c, l)``, ``u' = C[c] + occ(c, u)`` with no ±1 edge
  cases.  (The reference's SGA convention is inclusive bounds; counts and
  hit sets — the externally visible answers — are identical.)
* ``dollar_map[j] = i`` where the ``j``-th ``$`` in BWT order terminates the
  LF-walk of read ``i`` — the read-ID resolution table that replaces the
  reference's ``$``-rank → RocksDB lookup (SURVEY.md §3.3).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from readserver_tpu_torch import alphabet


def suffix_array_ints(text: np.ndarray) -> np.ndarray:
    """Suffix array of an integer sequence via prefix doubling (O(n log² n)).

    Handles arbitrary integer alphabets (needed for the distinct-sentinel
    construction).  NumPy ``lexsort`` does the heavy lifting; adequate up to
    ~10M symbols, which covers every oracle-scale corpus.
    """
    text = np.asarray(text)
    n = len(text)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = np.unique(text, return_inverse=True)[1].astype(np.int64)
    sa = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        sa = np.lexsort((key2, rank))
        # new ranks: increment where the (rank, key2) pair differs from prev
        r_sorted = rank[sa]
        k_sorted = key2[sa]
        changed = np.ones(n, dtype=np.int64)
        changed[1:] = (r_sorted[1:] != r_sorted[:-1]) | (
            k_sorted[1:] != k_sorted[:-1]
        )
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[sa] = np.cumsum(changed) - 1
        rank = new_rank
        if rank[sa[-1]] == n - 1:
            return sa.astype(np.int64)
        k *= 2


def build_concat_text(reads: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Reads (uint8 codes 1..4) → int64 concat text with distinct sentinels.

    Returns ``(text, read_starts)`` where sentinel of read ``i`` has value
    ``i`` and base ``b`` has value ``m - 1 + b`` (so all sentinels sort below
    all bases and by read order among themselves).
    """
    m = len(reads)
    lengths = np.fromiter((len(r) for r in reads), dtype=np.int64, count=m)
    total = int(lengths.sum()) + m
    text = np.empty(total, dtype=np.int64)
    read_starts = np.empty(m, dtype=np.int64)
    pos = 0
    for i, r in enumerate(reads):
        read_starts[i] = pos
        L = len(r)
        text[pos : pos + L] = np.asarray(r, dtype=np.int64) + (m - 1)
        text[pos + L] = i
        pos += L + 1
    return text, read_starts


class OracleFMIndex:
    """Reference-exact FM-index over a set of reads (NumPy, small corpora)."""

    def __init__(self, reads: Sequence[np.ndarray | str | bytes]):
        self.reads: list[np.ndarray] = [
            r if isinstance(r, np.ndarray) else alphabet.encode(r) for r in reads
        ]
        for r in self.reads:
            if len(r) == 0:
                raise ValueError("empty read")
        m = len(self.reads)
        self.num_reads = m
        text, read_starts = build_concat_text(self.reads)
        self.text = text
        self.read_starts = read_starts
        self.read_lengths = np.fromiter(
            (len(r) for r in self.reads), dtype=np.int64, count=m
        )
        sa = suffix_array_ints(text)
        self.sa = sa
        n = len(text)
        self.n = n

        # BWT with collapsed sentinels: char preceding each suffix; the
        # suffix at global position 0 is preceded (cyclically) by the final
        # sentinel, which also collapses to $ — matching the generalized BWT.
        prev = np.where(sa > 0, sa - 1, n - 1)
        bwt_raw = text[prev]
        self.bwt = np.where(bwt_raw < m, 0, bwt_raw - (m - 1)).astype(np.uint8)

        # C[c] = number of symbols with code < c in the BWT ($ counts m).
        counts = np.bincount(self.bwt, minlength=alphabet.NUM_SYMBOLS).astype(
            np.int64
        )
        self.symbol_counts = counts
        self.C = np.zeros(alphabet.NUM_SYMBOLS + 1, dtype=np.int64)
        self.C[1:] = np.cumsum(counts)

        # occ table: occ_table[i, c] = # of c in BWT[0:i]  (exclusive)
        onehot = np.zeros((n + 1, alphabet.NUM_SYMBOLS), dtype=np.int64)
        onehot[1:] = np.eye(alphabet.NUM_SYMBOLS, dtype=np.int64)[self.bwt]
        self.occ_table = np.cumsum(onehot, axis=0)

        # dollar_map[j] = read whose position-0 suffix sits at the row of the
        # j-th $ in BWT order: that row's suffix starts at a read start.
        dollar_rows = np.flatnonzero(self.bwt == alphabet.SENTINEL)
        starts_of_rows = sa[dollar_rows]
        self.dollar_map = np.searchsorted(read_starts, starts_of_rows).astype(
            np.int64
        )
        assert np.array_equal(
            read_starts[self.dollar_map], starts_of_rows
        ), "every $-row must correspond to a read start"

    # ---------------------------------------------------------------- query

    def occ(self, c: int, i: int) -> int:
        """# of occurrences of code ``c`` in ``BWT[0:i]`` (exclusive)."""
        return int(self.occ_table[i, c])

    def backward_search(self, kmer: np.ndarray | str) -> tuple[int, int]:
        """k-mer (codes 1..4) → half-open SA interval ``[l, u)``."""
        codes = kmer if isinstance(kmer, np.ndarray) else alphabet.encode(kmer)
        l, u = 0, self.n
        for c in codes[::-1]:
            c = int(c)
            l = int(self.C[c]) + self.occ(c, l)
            u = int(self.C[c]) + self.occ(c, u)
            if l >= u:
                # canonical empty interval: (0, 0).  Interval bounds are
                # part of the parity contract (BASELINE.json:5) but an
                # empty interval's frozen bounds depend on step
                # granularity (1/2/3-char tiers freeze at different
                # points), so every search path normalizes empties.
                return 0, 0
        return l, u

    def count(self, kmer: np.ndarray | str) -> int:
        l, u = self.backward_search(kmer)
        return u - l

    def resolve_row(self, row: int) -> tuple[int, int]:
        """SA row → ``(read_id, offset)`` via LF-walk to the read's ``$``.

        ``offset`` is the position within the read of the suffix at ``row``
        (= number of LF steps taken), mirroring the reference's per-row walk
        (SURVEY.md §3.3).
        """
        steps = 0
        i = row
        while True:
            c = int(self.bwt[i])
            if c == alphabet.SENTINEL:
                read_id = int(self.dollar_map[self.occ(alphabet.SENTINEL, i)])
                return read_id, steps
            i = int(self.C[c]) + self.occ(c, i)
            steps += 1

    def find_reads(self, kmer: np.ndarray | str) -> list[tuple[int, int]]:
        """All ``(read_id, offset)`` hits for a k-mer, sorted."""
        l, u = self.backward_search(kmer)
        return sorted(self.resolve_row(r) for r in range(l, u))

    def extract_read(self, read_id: int) -> np.ndarray:
        """Recover read ``read_id``'s base codes from the stored corpus."""
        s = int(self.read_starts[read_id])
        L = int(self.read_lengths[read_id])
        return (self.text[s : s + L] - (self.num_reads - 1)).astype(np.uint8)
