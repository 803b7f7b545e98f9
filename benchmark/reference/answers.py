"""Expected answers of the count, hit and histogram routes, on both strands.

Semantics, as the served routes state them for a corpus of reads each
ended by its own terminator, indexed in ``partitions`` contiguous runs of
reads (one run for a single artifact):

* a query's count on one strand is the number of read windows equal to
  it; on both strands the counts of the k-mer and of its reverse
  complement add (k is odd, so no k-mer is its own reverse complement);
* a strand's hits are (read id, sample id, offset) of its windows, at
  most ``max_hits`` in each partition: the first ones in that
  partition's suffix order (the suffix from the window to the read's
  end, the terminator lowest, ties by read id);
* ``hits_truncated`` is whether a strand lost hits to that cap (full
  route), or whether some partition's count on a strand passes
  ``max_hits`` (histogram route);
* the per-sample histogram counts every window of both strands by the
  read's sample, zero cells left out, and is exact.

``key_bits`` below 64 matches windows by a hash of that many bits
instead of by their whole code: the control, which breaks exactness.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

COMPLEMENT = np.array([0, 4, 3, 2, 1], dtype=np.uint8)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_FILTER_BITS = 24
_CHUNK_READS = 1 << 16


def revcomp(codes: np.ndarray) -> np.ndarray:
    """uint8 [n, k] codes 1..4 → their reverse complements."""
    return COMPLEMENT[codes][:, ::-1]


def kmer_keys(codes: np.ndarray, key_bits: int = 64) -> np.ndarray:
    """uint8 [..., k] codes 1..4 (k ≤ 31) → uint64 keys: two bits a base,
    the first base most significant; hashed to ``key_bits`` bits when
    that is below 64."""
    c = codes.astype(np.uint64) - np.uint64(1)
    key = np.zeros(c.shape[:-1], dtype=np.uint64)
    for t in range(c.shape[-1]):
        key = (key << np.uint64(2)) | c[..., t]
    return _hashed(key, key_bits)


def _hashed(key: np.ndarray, key_bits: int) -> np.ndarray:
    if key_bits >= 64:
        return key
    with np.errstate(over="ignore"):
        return (key * _GOLDEN) >> np.uint64(64 - key_bits)


def _window_keys(reads: np.ndarray, k: int) -> np.ndarray:
    """uint8 [m, L] → uint64 [L - k + 1, m]: the key of the window at each
    offset of each read, rolled along the read one base at a time."""
    m, L = reads.shape
    cols = np.ascontiguousarray(reads.T).astype(np.uint64) - np.uint64(1)
    mask = np.uint64((1 << (2 * k)) - 1)
    out = np.empty((L - k + 1, m), dtype=np.uint64)
    key = np.zeros(m, dtype=np.uint64)
    for t in range(k):
        key = (key << np.uint64(2)) | cols[t]
    out[0] = key
    for w in range(1, L - k + 1):
        key = ((key << np.uint64(2)) & mask) | cols[w + k - 1]
        out[w] = key
    return out


def find_windows(reads: np.ndarray, keys: np.ndarray, k: int,
                 key_bits: int = 64):
    """Every read window whose key is in ``keys`` (sorted, unique) →
    (index into ``keys``, read, offset), int64 arrays."""
    filt = np.zeros(1 << _FILTER_BITS, dtype=bool)
    low = np.uint64((1 << _FILTER_BITS) - 1)
    filt[(keys & low).astype(np.int64)] = True
    out_q, out_r, out_o = [], [], []
    for lo in range(0, reads.shape[0], _CHUNK_READS):
        wk = _hashed(_window_keys(reads[lo:lo + _CHUNK_READS], k), key_bits)
        oo, rr = np.nonzero(filt[(wk & low).astype(np.int64)])
        cand = wk[oo, rr]
        pos = np.searchsorted(keys, cand)
        pos_c = np.minimum(pos, len(keys) - 1)
        hit = keys[pos_c] == cand
        out_q.append(pos_c[hit])
        out_r.append(rr[hit].astype(np.int64) + lo)
        out_o.append(oo[hit].astype(np.int64))
    cat = (lambda xs: np.concatenate(xs) if xs
           else np.zeros(0, dtype=np.int64))
    return cat(out_q), cat(out_r), cat(out_o)


@dataclass
class Expected:
    """Expected both-strand answers of n queries."""

    count: np.ndarray            # int64 [n]
    hits: list                   # n sorted lists of (read, sample, offset, strand)
    hits_truncated: np.ndarray   # bool [n], full route
    hist_truncated: np.ndarray   # bool [n], histogram route
    hist: list                   # n dicts sample name → count


def partition_of(num_reads: int, read_len: int, partitions: int) -> np.ndarray:
    """The first read of each of ``partitions`` contiguous runs of reads of
    near-equal total bases (every read ``read_len`` long) → int64
    [partitions + 1], the last entry ``num_reads``."""
    cum = np.arange(num_reads + 1, dtype=np.int64) * read_len
    total = int(cum[-1])
    bounds, lo = [0], 0
    for s in range(partitions):
        hi = int(np.searchsorted(cum, total * (s + 1) // partitions,
                                 side="left"))
        hi = min(max(hi, lo + 1), num_reads - (partitions - 1 - s))
        bounds.append(hi)
        lo = hi
    bounds[-1] = num_reads
    return np.asarray(bounds, dtype=np.int64)


def _suffix_order(reads: np.ndarray, rows: np.ndarray, offs: np.ndarray,
                  k: int) -> np.ndarray:
    """Order of windows that share their first k bases in suffix order:
    the rest of the read, its terminator lowest, then the read id."""
    keys = [tuple(reads[r, o + k:].tolist()) + (0, int(r))
            for r, o in zip(rows.tolist(), offs.tolist())]
    return np.asarray(sorted(range(len(keys)), key=keys.__getitem__),
                      dtype=np.int64)


def expected_answers(reads: np.ndarray, sample_ids: np.ndarray,
                     sample_names: list[str], queries: np.ndarray,
                     max_hits: int, partitions: int = 1,
                     key_bits: int = 64, detail: bool = True) -> Expected:
    """Both-strand answers of ``queries`` (uint8 [n, k]) over ``reads``;
    counts alone unless ``detail`` (then also hits, flags, histograms)."""
    n, k = queries.shape
    strands = (queries, revcomp(queries))
    qkeys = np.concatenate([kmer_keys(s, key_bits) for s in strands])
    keys, inv = np.unique(qkeys, return_inverse=True)
    kq, kr, ko = find_windows(reads, keys, k, key_bits)
    bounds = partition_of(reads.shape[0], reads.shape[1], partitions)
    # windows grouped by key
    order = np.argsort(kq, kind="stable")
    kq, kr, ko = kq[order], kr[order], ko[order]
    starts = np.searchsorted(kq, np.arange(len(keys) + 1))
    per_key = np.diff(starts)
    count = per_key[inv[:n]] + per_key[inv[n:]]
    hits: list = [[] for _ in range(n)]
    trunc = np.zeros(n, dtype=bool)
    htrunc = np.zeros(n, dtype=bool)
    hist: list = [dict() for _ in range(n)]
    for s, sign in enumerate("+-" if detail else ""):
        for i in range(n):
            key = inv[s * n + i]
            a, b = starts[key], starts[key + 1]
            if a == b:
                continue
            rows, offs = kr[a:b], ko[a:b]
            for r in rows.tolist():
                name = sample_names[int(sample_ids[r])]
                hist[i][name] = hist[i].get(name, 0) + 1
            part = np.searchsorted(bounds, rows, side="right") - 1
            for p in np.unique(part).tolist():
                sel = part == p
                pr, po = rows[sel], offs[sel]
                if len(pr) > max_hits:
                    trunc[i] = htrunc[i] = True
                    keep = _suffix_order(reads, pr, po, k)[:max_hits]
                    pr, po = pr[keep], po[keep]
                hits[i].extend(
                    (int(r), int(sample_ids[r]), int(o), sign)
                    for r, o in zip(pr.tolist(), po.tolist()))
    for h in hits:
        h.sort()
    return Expected(count, hits, trunc, htrunc, hist)
