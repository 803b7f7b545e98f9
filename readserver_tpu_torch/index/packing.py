"""Bit-packing the BWT into the fused rank-block layout (NumPy, build time).

Replaces SGA's RLE-BWT + LargeMark/SmallMark checkpoint scheme
(SURVEY.md §2.1 "RLE-BWT storage format" / "Occ/rank structure") with a
gather-friendly HBM layout:

    rank_blocks[c, b, :] = [occ_ckpt(c, b*S), w0..w{W-1}, 0-padding]

one aligned uint32 row per (symbol, block).  ``occ(c, i)`` = one row gather
+ masked popcount of the in-block bitplane words — a single 64B HBM
transaction per rank instead of the reference's pointer-chasing run scan.
An extra final block row carries the total counts so ``i == n`` needs no
special case.
"""

from __future__ import annotations

import numpy as np

from readserver_tpu_torch import alphabet
from readserver_tpu_torch.config import IndexConfig


def pack_plane_blocks(
    codes: np.ndarray, num_planes: int, config: IndexConfig
) -> tuple[np.ndarray, np.ndarray]:
    """Symbol codes → fused rank-block table over ``num_planes`` planes.

    Codes ≥ ``num_planes`` are counted in no plane (used for the pair
    tier's "invalid" code).  Returns (table uint32 [P, NB+1, row_words],
    counts int64 [P]).
    """
    codes = np.asarray(codes)
    n = len(codes)
    S, W, R = config.block_size, config.words_per_block, config.row_words
    nb = max(1, -(-n // S))  # ceil, ≥1 so empty inputs still have a row
    padded = np.full(nb * S, num_planes, dtype=codes.dtype)
    padded[:n] = codes

    table = np.zeros((num_planes, nb + 1, R), dtype=np.uint32)
    counts = np.zeros(num_planes, dtype=np.int64)
    for c in range(num_planes):
        bits = padded == c
        words = np.packbits(bits, bitorder="little")
        words = words.view("<u4").reshape(nb, W)
        table[c, :nb, 1 : 1 + W] = words
        per_block = bits.reshape(nb, S).sum(axis=1, dtype=np.int64)
        counts[c] = int(per_block.sum())
        ckpt = np.zeros(nb + 1, dtype=np.int64)
        np.cumsum(per_block, out=ckpt[1:])
        if ckpt[-1] >= 1 << 32:
            raise ValueError(
                "per-shard occ checkpoint exceeds uint32; shard the index"
            )
        table[c, :, 0] = ckpt.astype(np.uint32)
    return table, counts


def pack_rank_blocks(
    bwt: np.ndarray, config: IndexConfig
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BWT codes uint8[n] → ``(rank_blocks, C, symbol_counts)``.

    rank_blocks: uint32 [NUM_SYMBOLS, NB+1, row_words]
    C:           int64  [NUM_SYMBOLS+1]  (C[c] = # symbols with code < c)
    counts:      int64  [NUM_SYMBOLS]
    """
    bwt = np.asarray(bwt, dtype=np.uint8)
    rank_blocks, counts = pack_plane_blocks(
        bwt, alphabet.NUM_SYMBOLS, config
    )
    C = np.zeros(alphabet.NUM_SYMBOLS + 1, dtype=np.int64)
    np.cumsum(counts, out=C[1:])
    return rank_blocks, C, counts


def pack_sym4(bwt: np.ndarray) -> np.ndarray:
    """BWT codes → 4-bit packed uint32 words (8 symbols/word, LSB first).

    The resolve path's symbol readout (``BWT[i]`` inside the LF-walk,
    SURVEY.md §3.3) is one word gather + shift/mask.
    """
    bwt = np.asarray(bwt, dtype=np.uint8)
    n = len(bwt)
    pad = (-n) % 8
    if pad:
        bwt = np.concatenate([bwt, np.zeros(pad, dtype=np.uint8)])
    g = bwt.reshape(-1, 8).astype(np.uint32)
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, :]
    return np.bitwise_or.reduce(g << shifts, axis=1).astype(np.uint32)


def unpack_sym4(sym4: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_sym4` (testing/debug)."""
    w = np.asarray(sym4, dtype=np.uint32)[:, None]
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, :]
    return ((w >> shifts) & 0xF).astype(np.uint8).reshape(-1)[:n]


def pack_bit_rank(bits: np.ndarray, config: IndexConfig) -> np.ndarray:
    """Single bitvector → rank-block table [NB+1, row_words] (same row
    layout as one symbol plane of :func:`pack_rank_blocks`; queried with the
    same device kernel at symbol index 0).  Used for the sampled-row mark
    rank of the fast resolve path."""
    bits = np.asarray(bits, dtype=bool)
    n = len(bits)
    S, W, R = config.block_size, config.words_per_block, config.row_words
    nb = max(1, -(-n // S))
    padded = np.zeros(nb * S, dtype=bool)
    padded[:n] = bits
    table = np.zeros((nb + 1, R), dtype=np.uint32)
    words = np.packbits(padded, bitorder="little").view("<u4").reshape(nb, W)
    table[:nb, 1 : 1 + W] = words
    per_block = padded.reshape(nb, S).sum(axis=1, dtype=np.int64)
    ckpt = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(per_block, out=ckpt[1:])
    if ckpt[-1] >= 1 << 32:
        raise ValueError("mark rank checkpoint exceeds uint32")
    table[:, 0] = ckpt.astype(np.uint32)
    return table


def pack_dsa(
    read_of: np.ndarray, offsets: np.ndarray, num_reads: int, max_len: int
) -> tuple[np.ndarray | None, int]:
    """Direct-resolve tier: per-SA-row ``(read_id, offset)`` in ONE uint32.

    The reference answers "which read / where" by LF-walking each hit row
    to its ``$`` then a RocksDB lookup (SURVEY.md §3.3); the sampled-mark
    walks bound that to ``sample_rate`` dependent gathers.  This tier
    removes the walk entirely: HBM affords 4 B/sym at small/mid scale, so
    ``dsa[row] = read_id << bits | offset`` makes resolution a single
    gather — the same cost as one backward-search step.  Returns
    ``(None, 0)`` when ``num_reads << bits`` overflows uint32 (then the
    walk tiers serve instead).
    """
    bits = int(max(int(max_len), 1)).bit_length()
    if (int(num_reads) << bits) > (1 << 32):
        return None, 0
    packed = (
        np.asarray(read_of, dtype=np.int64) << bits
    ) | np.asarray(offsets, dtype=np.int64)
    return packed.astype(np.uint32), bits


def fused_row_words(config: IndexConfig) -> int:
    """uint32 words per fused resolve row: 6 scalar words (5 occ
    checkpoints + mark-rank checkpoint) + 4 bitplanes (dollar, base-low,
    base-high, mark) of ``words_per_block`` each, padded to a 16-byte
    multiple."""
    w = 6 + 4 * config.words_per_block
    return -(-w // 4) * 4


def pack_fused_rows(
    bwt: np.ndarray,
    marked: np.ndarray,
    config: IndexConfig,
    chunk_blocks: int = 1 << 18,
) -> np.ndarray:
    """Fused resolve rows: ONE row gather per LF-walk step (uint32 [NB, R]).

    The mark-walk resolve (``ops/resolve.resolve_rows_marked``) pays three
    gathers per step: symbol (sym4), rank row, and mark row.  At chr20+
    scale, where the 4 B/sym tiers (lf / dsa) don't fit next to the 2-step
    search tier, this 1 B/sym layout packs everything one walk step needs
    into a single 64-byte row per 64-symbol block:

        [occ_ckpt(c=0..4), mark_ckpt, dollar plane, base-low plane,
         base-high plane, mark plane, pad]

    so the step becomes: gather row → decode symbol from the planes →
    ``occ(c, i)`` by masked popcount of the XNOR-matched planes →
    terminal test from the mark plane — one HBM transaction per step.
    """
    bwt = np.asarray(bwt, dtype=np.uint8)
    marked = np.asarray(marked, dtype=bool)
    n = len(bwt)
    S, W = config.block_size, config.words_per_block
    R = fused_row_words(config)
    nb = max(1, -(-n // S))
    out = np.zeros((nb, R), dtype=np.uint32)
    run = np.zeros(6, dtype=np.int64)  # 5 symbol ckpts + mark ckpt
    for b0 in range(0, nb, chunk_blocks):
        b1 = min(b0 + chunk_blocks, nb)
        s0, s1 = b0 * S, min(b1 * S, n)
        nbk = b1 - b0
        sub = np.zeros(nbk * S, dtype=np.int16)
        sub[: s1 - s0] = bwt[s0:s1]
        sub[s1 - s0 :] = -1  # pad positions match no plane
        mk = np.zeros(nbk * S, dtype=bool)
        mk[: s1 - s0] = marked[s0:s1]
        planes = [
            sub == 0,                         # dollar
            (sub > 0) & ((sub - 1) & 1 > 0),  # base low bit
            (sub > 0) & ((sub - 1) & 2 > 0),  # base high bit
            mk,                               # mark
        ]
        counts = np.empty((6, nbk), dtype=np.int64)
        for c in range(5):
            counts[c] = (sub == c).reshape(nbk, S).sum(axis=1)
        counts[5] = mk.reshape(nbk, S).sum(axis=1)
        for j, bits in enumerate(planes):
            words = np.packbits(bits, bitorder="little").view("<u4")
            out[b0:b1, 6 + j * W : 6 + (j + 1) * W] = words.reshape(nbk, W)
        for c in range(6):
            ck = run[c] + np.concatenate(
                [[0], np.cumsum(counts[c][:-1])]
            )
            if counts[c].sum() + run[c] >= 1 << 32:
                raise ValueError("fused checkpoint exceeds uint32; shard")
            out[b0:b1, c] = ck.astype(np.uint32)
            run[c] += counts[c].sum()
    return out


def compute_lf(bwt: np.ndarray, C: np.ndarray, chunk: int = 1 << 24) -> np.ndarray:
    """LF-mapping array: LF[i] = C[BWT[i]] + occ(BWT[i], i), int32 [n].

    One precomputed gather replaces the (symbol readout + rank) pair in
    every LF-walk step (SURVEY.md §3.3) — the classic FM LF/psi array,
    affordable here because HBM is the budget, not cache.  For ``$`` rows
    LF[i] < num_reads and equals the row's ``$``-rank, which doubles as the
    walk-terminal detector and the dollar_map key.
    """
    n = len(bwt)
    lf = np.empty(n, dtype=np.int32)
    running = np.asarray(C[:5], dtype=np.int64).copy()
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        sub = bwt[a:b]
        for c in range(5):
            mask = sub == c
            cnt = int(mask.sum())
            if not cnt:
                continue
            cs = np.cumsum(mask) - 1  # occ within chunk at each masked pos
            vals = running[c] + cs[mask]
            if vals[-1] >= 1 << 31:
                raise ValueError("LF overflows int32; shard the index")
            lf[a:b][mask] = vals.astype(np.int32)
            running[c] += cnt
    return lf


PAIR_INVALID = 16    # pair code for rows whose 2-char context crosses a $
TRIPLE_INVALID = 64  # 3-mer code for rows whose 3-char context crosses a $


def pair_codes_from_lf(bwt: np.ndarray, lf: np.ndarray) -> np.ndarray:
    """Per-row pair code for the 2-step rank tier (uint8 [n]).

    Row ``j``'s pair is the two characters preceding suffix ``j`` in its
    read: ``c2 = BWT[j]`` and ``c1 = BWT[LF(j)]`` (LF moves one position
    earlier in the text).  Code ``(c1-1)*4 + (c2-1)`` ∈ 0..15 when both
    are bases; :data:`PAIR_INVALID` when either is ``$`` (suffix offset
    < 2 — nothing can prepend two characters there).  ``lf`` must be the
    plain LF array (no fast-resolve mark bits).
    """
    c2 = np.asarray(bwt, dtype=np.int32)
    c1 = c2[np.asarray(lf, dtype=np.int64)]
    valid = (c1 > 0) & (c2 > 0)
    pair = (c1 - 1) * 4 + (c2 - 1)
    return np.where(valid, pair, PAIR_INVALID).astype(np.uint8)


def triple_codes_from_lf(bwt: np.ndarray, lf: np.ndarray) -> np.ndarray:
    """Per-row 3-mer code for the 3-step rank tier (uint8 [n]).

    Same construction as :func:`pair_codes_from_lf` one LF deeper:
    ``c3 = BWT[j], c2 = BWT[LF(j)], c1 = BWT[LF²(j))``; code
    ``(c1-1)*16 + (c2-1)*4 + (c3-1)`` ∈ 0..63, or :data:`TRIPLE_INVALID`
    when any of the three crosses a ``$`` (suffix offset < 3).
    """
    lf = np.asarray(lf, dtype=np.int64)
    c3 = np.asarray(bwt, dtype=np.int32)
    c2 = c3[lf]
    c1 = c3[lf[lf]]
    valid = (c1 > 0) & (c2 > 0) & (c3 > 0)
    code = (c1 - 1) * 16 + (c2 - 1) * 4 + (c3 - 1)
    return np.where(valid, code, TRIPLE_INVALID).astype(np.uint8)


def kgram_starts(
    rank_blocks: np.ndarray, C: np.ndarray, config: IndexConfig, k: int
) -> np.ndarray:
    """int64 [4^k]: SA row where each k-mer bucket starts (first char most
    significant).

    ``start(s) = `` the interval start a 1-step backward search of ``s``
    reaches, so a k-char step ``l' = Ck[s] + occk(s, l)`` lands exactly
    where k single steps would.  (k=2 → C2 for the pair tier, k=3 → C3.)
    """
    out = np.zeros(4**k, dtype=np.int64)
    for code in range(4**k):
        chars = [((code >> (2 * (k - 1 - d))) & 3) + 1 for d in range(k)]
        l = int(C[chars[-1]])
        for c in reversed(chars[:-1]):
            l = int(C[c]) + occ_scalar(rank_blocks, config, c, l)
        out[code] = l
    return out


def pair_C2(
    rank_blocks: np.ndarray, C: np.ndarray, config: IndexConfig
) -> np.ndarray:
    """int64 [16]: SA row where the 2-mer bucket ``(c1,c2)`` starts."""
    return kgram_starts(rank_blocks, C, config, 2)


def occ_scalar(
    rank_blocks: np.ndarray, config: IndexConfig, c: int, i: int
) -> int:
    """NumPy scalar rank on the packed layout (kernel unit-test reference,
    SURVEY.md §4.3)."""
    S, W = config.block_size, config.words_per_block
    b, within = divmod(i, S)
    row = rank_blocks[c, b]
    total = int(row[0])
    for j in range(W):
        covered = min(max(within - 32 * j, 0), 32)
        if covered == 0:
            break
        word = int(row[1 + j])
        if covered < 32:
            word &= (1 << covered) - 1
        total += bin(word).count("1")
    return total
