"""Build a ``PackedIndex`` directly from a multi-string BWT — no suffix sort.

Two producers need this path:

* **interleave merge** (``index/merge.py``): the merged BWT comes out of
  ``csrc/merge.cpp`` without re-sorting (the reference's ``bwt-merge``
  stage, SURVEY.md §2.1 "BWT merge" / §3.4), so the device index must be
  packable from the BWT plus carried-over read metadata;
* **BWT import** (``cli.py import-bwt``): an RLE-BWT built by
  reference-stack tools arrives with no corpus attached — read lengths,
  the ``$``-map, and the 2-bit cold store are all reconstructed here by
  BWT inversion.

Invariant used throughout (holds for any multi-string BWT under the
distinct-``$``, ``$``-ordered-by-read-index convention the whole package
uses — see ``index/builder.py``): **row ``j < m`` is the sentinel-only
suffix of read ``j``**, so LF-walking from row ``j`` enumerates read
``j``'s suffix rows right-to-left (offset ``L-1`` down to ``0``).
"""

from __future__ import annotations

import numpy as np

from readserver_tpu_torch import alphabet
from readserver_tpu_torch.config import IndexConfig
from readserver_tpu_torch.index import packing
from readserver_tpu_torch.index.builder import PackedIndex


def plain_lf(bwt: np.ndarray, C: np.ndarray) -> np.ndarray:
    """LF array without fast-resolve mark bits (native pass if available)."""
    try:
        from readserver_tpu_torch.native import compute_lf_native

        return compute_lf_native(bwt, C)
    except Exception:
        return packing.compute_lf(bwt, C)


def invert_bwt(
    bwt: np.ndarray, lf: np.ndarray | None = None
) -> tuple[list[np.ndarray], np.ndarray, np.ndarray]:
    """Multi-string BWT → ``(reads, dollar_map, read_lengths)``.

    Classic FM inversion, vectorized across all ``m`` reads at once: one
    lockstep LF step per character position (the host-side mirror of the
    device resolve walk, SURVEY.md §3.3).  Read ``r``'s walk starts at its
    sentinel row ``r`` and ends at its offset-0 row, whose ``$``-rank
    keys ``dollar_map``.
    """
    bwt = np.asarray(bwt, dtype=np.uint8)
    n = len(bwt)
    if n and bwt.max() >= alphabet.NUM_SYMBOLS:
        raise ValueError("BWT symbol codes must be in [0, 5)")
    counts = np.bincount(bwt, minlength=alphabet.NUM_SYMBOLS).astype(np.int64)
    m = int(counts[0])
    if m == 0:
        raise ValueError("BWT has no sentinel symbols")
    C = np.zeros(alphabet.NUM_SYMBOLS + 1, dtype=np.int64)
    np.cumsum(counts, out=C[1:])
    if lf is None:
        lf = plain_lf(bwt, C)

    pos = np.arange(m, dtype=np.int64)
    alive = np.ones(m, dtype=bool)
    dollar_map = np.zeros(m, dtype=np.uint32)
    read_lengths = np.zeros(m, dtype=np.int32)
    cols: list[np.ndarray] = []
    steps = 0
    while True:
        c = bwt[pos]
        term = (c == alphabet.SENTINEL) & alive
        if term.any():
            # terminal row's lf value == its $-rank (lf = C[$]=0 + occ)
            dollar_map[lf[pos[term]]] = np.flatnonzero(term).astype(np.uint32)
            read_lengths[term] = steps
            alive &= ~term
        if not alive.any():
            break
        cols.append(np.where(alive, c, 0).astype(np.uint8))
        pos = np.where(alive, lf[pos], pos)
        steps += 1
        if steps > n:
            raise ValueError("LF walk did not terminate; BWT is corrupt")
    if read_lengths.min() < 1:
        raise ValueError("BWT encodes an empty read; not importable")
    mat = np.stack(cols, axis=0) if cols else np.zeros((0, m), dtype=np.uint8)
    reads = [
        mat[: int(L), r][::-1].copy() for r, L in enumerate(read_lengths)
    ]
    return reads, dollar_map, read_lengths


def rows_from_lf(
    lf: np.ndarray, read_lengths: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-SA-row ``(read_of, offsets)`` attribution WITHOUT a suffix
    array: the m-lane lockstep LF walk visits every row exactly once
    (rows partition into per-read suffix chains), so read ``r``'s walk
    labels its row at step ``t`` with offset ``L_r − t``.  O(n) total
    gathers — the host-side inverse of the device resolve walk.

    Sentinel rows ``r < m`` get ``offset == L_r`` (the sentinel-position
    suffix), matching the SA-derived convention in ``index/builder.py``.
    """
    m = len(read_lengths)
    n = len(lf)
    L = read_lengths.astype(np.int64)
    read_of = np.empty(n, dtype=np.int32)
    offsets = np.empty(n, dtype=np.int64)
    ids = np.arange(m, dtype=np.int32)
    pos = np.arange(m, dtype=np.int64)
    read_of[pos] = ids
    offsets[pos] = L
    max_len = int(L.max()) if m else 0
    for t in range(1, max_len + 1):
        active = t <= L
        if not active.any():
            break
        pos = np.where(active, lf[pos].astype(np.int64), pos)
        rows = pos[active]
        read_of[rows] = ids[active]
        offsets[rows] = (L - t)[active]
    return read_of, offsets


def pack_from_bwt(
    bwt: np.ndarray,
    *,
    dollar_map: np.ndarray,
    read_to_sample: np.ndarray,
    read_lengths: np.ndarray,
    corpus_packed: np.ndarray,
    read_offsets: np.ndarray,
    sample_names: list[str] | None = None,
    config: IndexConfig | None = None,
    fast_resolve: bool = True,
    sample_rate: int = 32,
    pair_rank: bool = True,
    kstep: int | None = None,
) -> PackedIndex:
    """Pack device arrays from a BWT plus explicit read metadata."""
    config = config or IndexConfig()
    bwt = np.asarray(bwt, dtype=np.uint8)
    m = len(read_lengths)
    rank_blocks, C, counts = packing.pack_rank_blocks(bwt, config)
    if int(counts[0]) != m:
        raise ValueError(
            f"BWT has {int(counts[0])} sentinels but metadata has {m} reads"
        )
    sym4 = packing.pack_sym4(bwt)
    read_to_sample = np.asarray(read_to_sample, dtype=np.int32)
    num_samples = int(read_to_sample.max()) + 1 if m else 0

    from readserver_tpu_torch.index.builder import TRIPLE_TIER_MAX_N

    if kstep is None:
        kstep = 3 if (pair_rank and len(bwt) <= TRIPLE_TIER_MAX_N) else 2
    if not pair_rank:
        kstep = 1
    lf = mark_rank = sample_pairs = None
    rank2_blocks = C2 = rank3_blocks = C3 = None
    dsa = fused_rows = None
    dsa_bits = 0
    srate = 0
    lf0 = plain_lf(bwt, C) if (fast_resolve or kstep >= 2) else None
    if kstep >= 2:
        pair = packing.pair_codes_from_lf(bwt, lf0)
        rank2_blocks, _ = packing.pack_plane_blocks(pair, 16, config)
        C2 = packing.pair_C2(rank_blocks, C, config)
        del pair
    if kstep >= 3:
        triple = packing.triple_codes_from_lf(bwt, lf0)
        rank3_blocks, _ = packing.pack_plane_blocks(triple, 64, config)
        C3 = packing.kgram_starts(rank_blocks, C, config, 3)
        del triple
    if fast_resolve:
        # full per-row attribution from the LF walk → the SAME tier set
        # the suffix-sort builder produces (incl. dsa + fused), so merged
        # and imported indexes serve through the same resolve ladder
        from readserver_tpu_torch.index.builder import resolve_tiers_from_rows

        read_of, offsets = rows_from_lf(lf0, np.asarray(read_lengths))
        tiers = resolve_tiers_from_rows(
            read_of,
            offsets,
            np.asarray(read_lengths),
            lf0,
            bwt,
            config,
            sample_rate,
        )
        lf = tiers["lf"]
        mark_rank = tiers["mark_rank"]
        sample_pairs = tiers["sample_pairs"]
        dsa, dsa_bits = tiers["dsa"], tiers["dsa_bits"]
        fused_rows = tiers["fused_rows"]
        srate = sample_rate
        del read_of, offsets, tiers

    return PackedIndex(
        config=config,
        n=len(bwt),
        num_reads=m,
        num_samples=num_samples,
        C=C,
        symbol_counts=counts,
        rank_blocks=rank_blocks,
        sym4=sym4,
        dollar_map=np.asarray(dollar_map, dtype=np.uint32),
        read_to_sample=read_to_sample,
        read_lengths=np.asarray(read_lengths, dtype=np.int32),
        corpus_packed=np.asarray(corpus_packed, dtype=np.uint8),
        read_offsets=np.asarray(read_offsets, dtype=np.int64),
        sample_names=list(sample_names)
        if sample_names is not None
        else [f"sample_{i}" for i in range(num_samples)],
        lf=lf,
        mark_rank=mark_rank,
        sample_pairs=sample_pairs,
        sample_rate=srate,
        dsa=dsa,
        dsa_bits=dsa_bits,
        fused_rows=fused_rows,
        rank2_blocks=rank2_blocks,
        C2=C2,
        rank3_blocks=rank3_blocks,
        C3=C3,
    )


def index_from_bwt(
    bwt: np.ndarray,
    sample_ids: np.ndarray | None = None,
    sample_names: list[str] | None = None,
    config: IndexConfig | None = None,
    fast_resolve: bool = True,
    sample_rate: int = 32,
) -> PackedIndex:
    """Import path: a bare multi-string BWT → full index.

    Reads are numbered by sentinel-row order (the only self-consistent
    numbering a bare BWT carries); the corpus cold store is reconstructed
    by inversion, so ``extract_read`` and hit attribution work exactly as
    on a corpus-built index.
    """
    bwt = np.asarray(bwt, dtype=np.uint8)
    reads, dollar_map, read_lengths = invert_bwt(bwt)
    m = len(reads)
    if sample_ids is None:
        sample_ids = np.zeros(m, dtype=np.int32)
    all_bases = (
        np.concatenate(reads) if reads else np.zeros(0, dtype=np.uint8)
    )
    read_offsets = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(read_lengths.astype(np.int64), out=read_offsets[1:])
    return pack_from_bwt(
        bwt,
        dollar_map=dollar_map,
        read_to_sample=np.asarray(sample_ids, dtype=np.int32),
        read_lengths=read_lengths,
        corpus_packed=alphabet.pack_2bit(all_bases),
        read_offsets=read_offsets,
        sample_names=sample_names,
        config=config,
        fast_resolve=fast_resolve,
        sample_rate=sample_rate,
    )
