"""Host index builder: reads → suffix array → BWT → packed device arrays.

This is the TPU-native replacement for the reference's build pipeline
(``ropebwt2`` per-sample BWT + ``bwt-merge`` + RocksDB metadata load,
SURVEY.md §3.4): a single pass that produces a bit-packed, rank-indexed
artifact plus dense payload arrays (the RocksDB tier becomes
``dollar_map`` / ``read_to_sample`` / read-offset arrays — keys are dense
integers, so no KV store is needed; SURVEY.md §2.2 item 4).

Suffix sorting uses the native C++ SAIS (``csrc/sais.cpp``) when available,
falling back to the NumPy doubling sorter for small corpora.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from readserver_tpu_torch import alphabet
from readserver_tpu_torch.config import IndexConfig
from readserver_tpu_torch.index import packing

# auto-enable the 64-plane (16 B/sym) 3-step tier below this index size
TRIPLE_TIER_MAX_N = 300_000_000


@dataclass
class PackedIndex:
    """Everything the device engine / artifact needs, as NumPy arrays."""

    config: IndexConfig
    n: int                      # BWT length = total bases + num_reads
    num_reads: int
    num_samples: int
    C: np.ndarray               # int64 [6]
    symbol_counts: np.ndarray   # int64 [5]
    rank_blocks: np.ndarray     # uint32 [5, NB+1, row_words]
    sym4: np.ndarray            # uint32 [ceil(n/8)]
    dollar_map: np.ndarray      # uint32 [num_reads]: $-rank → read id
    read_to_sample: np.ndarray  # int32 [num_reads]
    read_lengths: np.ndarray    # int32 [num_reads]
    # host-side cold store: 2-bit packed concatenated read bases + offsets
    corpus_packed: np.ndarray   # uint8
    read_offsets: np.ndarray    # int64 [num_reads+1] (base offsets)
    sample_names: list[str] = field(default_factory=list)
    # read-name / per-read-metadata payload (the rest of the reference's
    # RocksDB value, SURVEY.md §2.1 "Payload store": name + metadata per
    # read): concatenated byte blobs + offsets, keyed by dense read id —
    # host cold store like corpus_packed, never shipped to HBM
    name_blob: np.ndarray | None = None     # uint8
    name_offsets: np.ndarray | None = None  # int64 [num_reads+1]
    meta_blob: np.ndarray | None = None     # uint8 (opaque bytes per read)
    meta_offsets: np.ndarray | None = None  # int64 [num_reads+1]
    # fast-resolve tier (optional): precomputed LF array with sampled
    # (read_id, offset) pairs — one gather per walk step, walk bound =
    # sample_rate instead of max read length
    lf: np.ndarray | None = None            # int32 [n]; sign bit = sampled
    mark_rank: np.ndarray | None = None     # uint32 [NB+1, row_words]
    sample_pairs: np.ndarray | None = None  # int32 [n_marked, 2]
    sample_rate: int = 0                    # 0 = fast resolve absent
    # direct-resolve tier (optional, 4 B/sym): per-SA-row (read_id <<
    # dsa_bits | offset) — resolution in ONE gather, no walk at all
    dsa: np.ndarray | None = None           # uint32 [n]
    dsa_bits: int = 0
    # fused resolve rows (optional, 1 B/sym): one 64-byte row per block
    # carrying occ checkpoints + symbol/mark bitplanes — the walk tier for
    # scales where 4 B/sym doesn't fit next to the search tiers
    fused_rows: np.ndarray | None = None    # uint32 [NB, fused_row_words]
    # k-step search tiers (optional): rank blocks over the 16 base-pair /
    # 64 base-triple planes + k-mer bucket starts — one rank advances the
    # backward search k characters, dividing the dependent-gather chain
    # (the hot path's latency bound on v5e) by k.  The triple tier costs
    # 16 B/sym of HBM, so it is auto-enabled only for smaller indexes.
    rank2_blocks: np.ndarray | None = None  # uint32 [16, NB+1, row_words]
    C2: np.ndarray | None = None            # int64 [16]
    rank3_blocks: np.ndarray | None = None  # uint32 [64, NB+1, row_words]
    C3: np.ndarray | None = None            # int64 [64]

    @property
    def num_blocks(self) -> int:
        return self.rank_blocks.shape[1] - 1

    def extract_read(self, read_id: int) -> np.ndarray:
        """Read text by id from the cold store (replaces RocksDB ``Get``).

        Decodes only the packed byte range covering the read — O(read_len)
        per call, not O(corpus) (a chr20-scale corpus is ~2 GB unpacked)."""
        if read_id < 0 or read_id >= self.num_reads:
            raise IndexError(f"read id {read_id} out of range")
        s = int(self.read_offsets[read_id])
        e = int(self.read_offsets[read_id + 1])
        chunk = self.corpus_packed[s // 4 : (e + 3) // 4]
        bases = alphabet.unpack_2bit(chunk, e - (s // 4) * 4)
        return bases[s % 4 :]

    def read_name(self, read_id: int) -> str | None:
        """Stored read name (None when built without names)."""
        if self.name_blob is None:
            return None
        return bytes(
            blob_item(self.name_blob, self.name_offsets, read_id)
        ).decode("utf-8", errors="replace")

    def read_meta(self, read_id: int) -> bytes | None:
        """Opaque per-read metadata bytes (None when absent)."""
        if self.meta_blob is None:
            return None
        return bytes(blob_item(self.meta_blob, self.meta_offsets, read_id))

    def memory_bytes(self) -> dict[str, int]:
        return {
            "rank_blocks": self.rank_blocks.nbytes,
            "sym4": self.sym4.nbytes,
            "dollar_map": self.dollar_map.nbytes,
            "read_to_sample": self.read_to_sample.nbytes,
            "corpus_packed": self.corpus_packed.nbytes,
        }


def pack_blob_column(items: Sequence[str | bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Variable-length per-read values → (blob uint8, offsets int64 [m+1]).

    Dense-integer-keyed replacement for a KV column: ``blob[off[i]:off[i+1]]``
    is item i.  Strings are stored utf-8."""
    enc = [v.encode() if isinstance(v, str) else bytes(v) for v in items]
    offsets = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in enc], out=offsets[1:])
    blob = np.frombuffer(b"".join(enc), dtype=np.uint8).copy()
    return blob, offsets


def blob_item(blob: np.ndarray, offsets: np.ndarray, i: int) -> np.ndarray:
    return blob[int(offsets[i]) : int(offsets[i + 1])]


def concat_with_sentinels(
    reads: Sequence[np.ndarray],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reads → int32 concat text with distinct increasing sentinels.

    Sentinel of read ``i`` gets value ``i``; base code ``b`` becomes
    ``m - 1 + b``.  The plain suffix array of this text induces the
    generalized (per-read, distinct-``$``) suffix order — see
    ``oracle/fm.py`` for the argument.  Returns (text, read_starts, lengths).
    """
    m = len(reads)
    if m == 0:
        raise ValueError("no reads")
    lengths = np.fromiter((len(r) for r in reads), dtype=np.int64, count=m)
    if lengths.min() < 1:
        raise ValueError("empty read")
    n = int(lengths.sum()) + m
    if n >= (1 << 31) - 1:
        raise ValueError(
            f"corpus of {n} symbols exceeds int32 build range; "
            "build per-shard indexes instead (parallel/sharded.py)"
        )
    starts = np.zeros(m, dtype=np.int64)
    np.cumsum(lengths[:-1] + 1, out=starts[1:])
    sentinel_pos = starts + lengths
    text = np.empty(n, dtype=np.int32)
    mask = np.ones(n, dtype=bool)
    mask[sentinel_pos] = False
    text[~mask] = np.arange(m, dtype=np.int32)
    text[mask] = np.concatenate(reads).astype(np.int32) + (m - 1)
    return text, starts, lengths


def suffix_array(text: np.ndarray, alphabet_size: int) -> np.ndarray:
    """Int text → suffix array. Native SAIS if built, else NumPy doubling."""
    try:
        from readserver_tpu_torch.native import sais_int32

        return sais_int32(np.asarray(text, dtype=np.int32), alphabet_size)
    except Exception:
        from readserver_tpu_torch.oracle.fm import suffix_array_ints

        return suffix_array_ints(text).astype(np.int32)


def resolve_tiers_from_rows(
    read_of: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    lf0: np.ndarray,
    bwt: np.ndarray,
    config: IndexConfig,
    sample_rate: int,
) -> dict:
    """Resolve-tier arrays from per-SA-row ``(read, offset)`` attribution.

    Shared by the suffix-sort builder (rows come from the SA), the
    BWT-import/merge packer and the artifact upgrader (rows come from the
    lockstep LF walk, ``from_bwt.rows_from_lf``) — one predicate, one
    layout, so every producer yields bit-identical tiers.

    Returns ``lf`` (mark sign bits set), ``mark_rank``, ``sample_pairs``,
    ``dsa``/``dsa_bits`` and ``fused_rows``.
    """
    m = len(lengths)
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    # mark rows whose suffix offset is a positive multiple of sample_rate
    # (offset-0 rows are $-terminal already); the walk then ends within
    # < sample_rate steps.  Sentinel-position rows (offset == read length)
    # are unreachable by LF walks and stay unmarked.
    marked = (
        (offsets % sample_rate == 0)
        & (offsets > 0)
        & (offsets < lengths[read_of])
    )
    mark_rank = packing.pack_bit_rank(marked, config)
    sample_pairs = np.stack(
        [read_of[marked].astype(np.int32), offsets[marked].astype(np.int32)],
        axis=1,
    )
    if sample_pairs.shape[0] == 0:  # all reads shorter than sample_rate
        sample_pairs = np.zeros((1, 2), dtype=np.int32)
    lf = np.where(marked, lf0 | np.int32(-(1 << 31)), lf0).astype(np.int32)
    dsa, dsa_bits = packing.pack_dsa(
        read_of, offsets, m, int(lengths.max()) if m else 0
    )
    fused_rows = packing.pack_fused_rows(bwt, marked, config)
    return dict(
        lf=lf,
        mark_rank=mark_rank,
        sample_pairs=sample_pairs,
        dsa=dsa,
        dsa_bits=dsa_bits,
        fused_rows=fused_rows,
    )


def build_index(
    reads: Sequence[np.ndarray | str | bytes],
    sample_ids: np.ndarray | Sequence[int] | None = None,
    config: IndexConfig | None = None,
    sample_names: Sequence[str] | None = None,
    fast_resolve: bool = True,
    sample_rate: int = 32,
    pair_rank: bool = True,
    kstep: int | None = None,
    read_names: Sequence[str] | None = None,
    read_meta: Sequence[bytes] | None = None,
) -> PackedIndex:
    """``kstep`` picks the deepest k-step search tier to build (1, 2, or
    3); None auto-selects 3 below :data:`TRIPLE_TIER_MAX_N` (the 64-plane
    table is 16 B/sym), else 2.  ``pair_rank=False`` forces 1."""
    config = config or IndexConfig()
    codes = [
        r if isinstance(r, np.ndarray) else alphabet.encode(r) for r in reads
    ]
    m = len(codes)
    text, starts, lengths = concat_with_sentinels(codes)
    n = len(text)
    sa = suffix_array(text, alphabet_size=m + 4)

    # BWT with collapsed sentinels (wraps at position 0; the wrap char is the
    # final sentinel, which also collapses to $ — generalized-BWT-exact).
    prev = np.where(sa > 0, sa - 1, n - 1)
    bwt_raw = text[prev]
    bwt = np.where(bwt_raw < m, 0, bwt_raw - (m - 1)).astype(np.uint8)
    del bwt_raw, prev

    # dollar_map: j-th $ in BWT order → the read whose position-0 suffix
    # sits at that row (SURVEY.md §3.3 "$-rank = lexicographic read index").
    dollar_rows = np.flatnonzero(bwt == alphabet.SENTINEL)
    starts_of_rows = sa[dollar_rows].astype(np.int64)
    dollar_map = np.searchsorted(starts, starts_of_rows).astype(np.uint32)
    if not np.array_equal(starts[dollar_map], starts_of_rows):
        raise AssertionError("BWT $-rows must align with read starts")
    del dollar_rows, starts_of_rows

    rank_blocks, C, counts = packing.pack_rank_blocks(bwt, config)
    sym4 = packing.pack_sym4(bwt)

    if kstep is None:
        kstep = 3 if (pair_rank and n <= TRIPLE_TIER_MAX_N) else 2
    if not pair_rank:
        kstep = 1
    lf = mark_rank = sample_pairs = None
    rank2_blocks = C2 = rank3_blocks = C3 = None
    dsa = fused_rows = None
    dsa_bits = 0
    srate = 0
    if fast_resolve or kstep >= 2:
        try:
            from readserver_tpu_torch.native import compute_lf_native

            lf = compute_lf_native(bwt, C)
        except Exception:
            lf = packing.compute_lf(bwt, C)
    if kstep >= 2:
        pair = packing.pair_codes_from_lf(bwt, lf)
        rank2_blocks, _ = packing.pack_plane_blocks(pair, 16, config)
        C2 = packing.pair_C2(rank_blocks, C, config)
        del pair
    if kstep >= 3:
        triple = packing.triple_codes_from_lf(bwt, lf)
        rank3_blocks, _ = packing.pack_plane_blocks(triple, 64, config)
        C3 = packing.kgram_starts(rank_blocks, C, config, 3)
        del triple
    if fast_resolve:
        # per-SA-row (read, offset) attribution straight from the SA
        read_of = np.searchsorted(starts, sa, side="right") - 1
        offsets = sa.astype(np.int64) - starts[read_of]
        tiers = resolve_tiers_from_rows(
            read_of, offsets, lengths, lf, bwt, config, sample_rate
        )
        lf = tiers["lf"]
        mark_rank = tiers["mark_rank"]
        sample_pairs = tiers["sample_pairs"]
        dsa, dsa_bits = tiers["dsa"], tiers["dsa_bits"]
        fused_rows = tiers["fused_rows"]
        srate = sample_rate
        del read_of, offsets, tiers
    else:
        lf = None  # computed only for the pair tier; don't ship it
    del sa, text

    if sample_ids is None:
        sample_ids_arr = np.zeros(m, dtype=np.int32)
    else:
        sample_ids_arr = np.asarray(sample_ids, dtype=np.int32)
        if sample_ids_arr.shape != (m,):
            raise ValueError("sample_ids must have one entry per read")
    num_samples = int(sample_ids_arr.max()) + 1 if m else 0

    all_bases = np.concatenate(codes)
    read_offsets = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(lengths, out=read_offsets[1:])

    name_blob = name_offsets = meta_blob = meta_offsets = None
    if read_names is not None:
        if len(read_names) != m:
            raise ValueError("read_names must have one entry per read")
        name_blob, name_offsets = pack_blob_column(read_names)
    if read_meta is not None:
        if len(read_meta) != m:
            raise ValueError("read_meta must have one entry per read")
        meta_blob, meta_offsets = pack_blob_column(read_meta)

    return PackedIndex(
        config=config,
        n=n,
        num_reads=m,
        num_samples=num_samples,
        C=C,
        symbol_counts=counts,
        rank_blocks=rank_blocks,
        sym4=sym4,
        dollar_map=dollar_map,
        read_to_sample=sample_ids_arr,
        read_lengths=lengths.astype(np.int32),
        corpus_packed=alphabet.pack_2bit(all_bases),
        read_offsets=read_offsets,
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
        name_blob=name_blob,
        name_offsets=name_offsets,
        meta_blob=meta_blob,
        meta_offsets=meta_offsets,
    )
