"""Multi-sample index merge (the reference's ``bwt-merge`` stage).

Two implementations of the same stage, bit-identical by construction:

* :func:`merge_indexes` — read-level concatenation (preserving per-sample
  read order, offsetting sample ids) + linear-time native SA-IS rebuild.
  Simplest and fastest while the merged corpus fits one in-core suffix
  sort (the multi-string BWT is a pure function of the ordered read list).
* :func:`merge_indexes_interleave` — true interleave-vector merge
  (Holt–McMillan iterated counting sort, ``csrc/merge.cpp`` with a NumPy
  fallback), the reference's actual ``bwt-merge`` mechanism (SURVEY.md
  §2.1 "BWT merge", §3.4): merges BWTs *without re-sorting*, O(n) memory
  beyond the inputs, so it composes indexes whose union exceeds the
  int32 single-shot SA-IS range.

Whole-cohort scales beyond host memory shard by document instead
(parallel/doc_sharded.py) and never materialize one merged BWT.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from readserver_tpu_torch import alphabet
from readserver_tpu_torch.config import IndexConfig
from readserver_tpu_torch.index import packing
from readserver_tpu_torch.index.builder import PackedIndex, build_index
from readserver_tpu_torch.index.from_bwt import pack_from_bwt


def _dedupe_names(names: list[str]) -> list[str]:
    """Distinct post-merge sample names: inputs built with default names
    would otherwise collide ('sample_0' twice) and collapse the per-sample
    histogram dict keys downstream; duplicates get a '.2', '.3'… suffix."""
    seen: dict[str, int] = {}
    out = []
    for nm in names:
        k = seen.get(nm, 0) + 1
        seen[nm] = k
        out.append(nm if k == 1 else f"{nm}.{k}")
    return out


def _reads_of(index: PackedIndex) -> list[np.ndarray]:
    total = int(index.read_offsets[-1])
    allb = alphabet.unpack_2bit(np.asarray(index.corpus_packed), total)
    return [
        allb[int(index.read_offsets[i]) : int(index.read_offsets[i + 1])]
        for i in range(index.num_reads)
    ]


def _concat_blobs(
    indexes: Sequence[PackedIndex], blob_attr: str, off_attr: str
) -> tuple[np.ndarray | None, np.ndarray | None]:
    """Concatenate per-read blob columns (names/metadata) in merge read
    order; None when any input lacks the column."""
    if any(getattr(i, blob_attr) is None for i in indexes):
        return None, None
    parts: list[np.ndarray] = []
    total_reads = sum(i.num_reads for i in indexes)
    out_off = np.zeros(total_reads + 1, dtype=np.int64)
    pos, base = 0, 0
    for idx in indexes:
        b = np.asarray(getattr(idx, blob_attr), dtype=np.uint8)
        o = np.asarray(getattr(idx, off_attr), dtype=np.int64)
        m = len(o) - 1
        out_off[pos + 1 : pos + 1 + m] = base + o[1:]
        parts.append(b[: int(o[-1])])
        pos += m
        base += int(o[-1])
    blob = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    return blob, out_off


def _carry_payload(merged: PackedIndex, indexes: Sequence[PackedIndex]) -> PackedIndex:
    """Attach concatenated read-name/metadata columns to a merged index."""
    merged.name_blob, merged.name_offsets = _concat_blobs(
        indexes, "name_blob", "name_offsets"
    )
    merged.meta_blob, merged.meta_offsets = _concat_blobs(
        indexes, "meta_blob", "meta_offsets"
    )
    return merged


def merge_indexes(
    indexes: Sequence[PackedIndex],
    config: IndexConfig | None = None,
    fast_resolve: bool = True,
) -> PackedIndex:
    """Merge per-sample (or per-batch) indexes into one population index.

    Read order is index order then within-index order (matching the
    reference's sample-then-read `$` ordering); sample ids are offset so
    every input keeps distinct samples.
    """
    if not indexes:
        raise ValueError("nothing to merge")
    reads: list[np.ndarray] = []
    sample_ids: list[np.ndarray] = []
    sample_names: list[str] = []
    offset = 0
    for idx in indexes:
        reads.extend(_reads_of(idx))
        sample_ids.append(np.asarray(idx.read_to_sample, dtype=np.int32) + offset)
        ns = max(idx.num_samples, 1)
        names = list(idx.sample_names) or [f"sample_{offset}"]
        sample_names.extend(names[:ns] + [f"sample_{offset + i}" for i in range(len(names), ns)])
        offset += ns
    merged = build_index(
        reads,
        sample_ids=np.concatenate(sample_ids),
        config=config or indexes[0].config,
        sample_names=_dedupe_names(sample_names),
        fast_resolve=fast_resolve,
        sample_rate=indexes[0].sample_rate or 32,
    )
    return _carry_payload(merged, indexes)


def merge_bwts(
    b1: np.ndarray, m1: int, b2: np.ndarray, m2: int, max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Interleave-merge two multi-string BWTs → ``(merged, interleave)``.

    ``interleave[p]`` is 1 where merged row ``p`` came from ``b2``.  Native
    C++ pass when available; the NumPy fallback runs the identical iterated
    stable counting sort with ``argsort(kind='stable')``.
    """
    b1 = np.asarray(b1, dtype=np.uint8)
    b2 = np.asarray(b2, dtype=np.uint8)
    max_passes = int(max_len) + 2
    try:
        from readserver_tpu_torch.native import bwt_merge2_native

        merged, interleave, _ = bwt_merge2_native(b1, m1, b2, m2, max_passes)
        return merged, interleave
    except Exception:
        pass
    n = len(b1) + len(b2)
    I = np.concatenate(
        [np.zeros(len(b1), dtype=bool), np.ones(len(b2), dtype=bool)]
    )
    S = np.empty(n, dtype=np.uint8)
    for _ in range(max_passes):
        S[~I] = b1
        S[I] = b2
        # $ bucket split by source (fixed A-before-B read numbering);
        # bases shifted past the two $ keys
        key = np.where(S == 0, I.astype(np.uint8), S + 1)
        J = I[np.argsort(key, kind="stable")]
        if np.array_equal(J, I):
            S[~I] = b1
            S[I] = b2
            return S, I.astype(np.uint8)
        I = J
    raise RuntimeError("interleave merge did not converge (corrupt BWT?)")


def merge_indexes_interleave(
    indexes: Sequence[PackedIndex],
    config: IndexConfig | None = None,
    fast_resolve: bool = True,
    shared_samples: bool = False,
) -> PackedIndex:
    """Merge indexes by BWT interleaving — no suffix re-sort.

    Same read numbering and sample-id offsetting as :func:`merge_indexes`;
    the results are bit-identical.  ``dollar_map`` merges positionally:
    within a source the ``$``-rank order is preserved by the interleave, so
    the merged map is a masked scatter of the (read-offset) source maps.

    ``shared_samples=True`` treats every input as already living in ONE
    global sample-id space (the cohort-shard convention — every shard
    carries the full global name list): sample ids pass through unchanged
    and the name lists union elementwise.  The default (offsetting) is
    the per-sample-BWT merge the reference's bwt-merge stage performs.
    """
    if not indexes:
        raise ValueError("nothing to merge")
    config = config or indexes[0].config
    sample_rate = indexes[0].sample_rate or 32

    def bwt_of(idx: PackedIndex) -> np.ndarray:
        return packing.unpack_sym4(np.asarray(idx.sym4), idx.n)

    acc_bwt = bwt_of(indexes[0])
    acc_dollar = np.asarray(indexes[0].dollar_map, dtype=np.uint32)
    acc_reads = indexes[0].num_reads
    acc_maxlen = int(np.max(indexes[0].read_lengths))

    sample_ids: list[np.ndarray] = []
    sample_names: list[str] = []
    lengths: list[np.ndarray] = []
    bases: list[np.ndarray] = []
    offset = 0
    ns_shared = max(max(idx.num_samples, 1) for idx in indexes)
    shared_names: list[str | None] = [None] * ns_shared
    for idx in indexes:
        sid = np.asarray(idx.read_to_sample, dtype=np.int32)
        ns = max(idx.num_samples, 1)
        names = list(idx.sample_names) or [f"sample_{offset}"]
        if shared_samples:
            sample_ids.append(sid)
            for i, nm in enumerate(names[:ns_shared]):
                if shared_names[i] is None:
                    shared_names[i] = nm
        else:
            sample_ids.append(sid + offset)
            sample_names.extend(
                names[:ns]
                + [f"sample_{offset + i}" for i in range(len(names), ns)]
            )
        offset += ns
        lengths.append(np.asarray(idx.read_lengths, dtype=np.int64))
        total = int(idx.read_offsets[-1])
        bases.append(alphabet.unpack_2bit(np.asarray(idx.corpus_packed), total))
    if shared_samples:
        sample_names = [
            nm if nm is not None else f"sample_{i}"
            for i, nm in enumerate(shared_names)
        ]

    for idx in indexes[1:]:
        nxt_bwt = bwt_of(idx)
        nxt_maxlen = int(np.max(idx.read_lengths))
        merged, interleave = merge_bwts(
            acc_bwt, acc_reads, nxt_bwt, idx.num_reads,
            max(acc_maxlen, nxt_maxlen),
        )
        src_at_dollar = interleave[merged == alphabet.SENTINEL].astype(bool)
        dollar = np.empty(acc_reads + idx.num_reads, dtype=np.uint32)
        dollar[~src_at_dollar] = acc_dollar
        dollar[src_at_dollar] = (
            np.asarray(idx.dollar_map, dtype=np.uint32) + np.uint32(acc_reads)
        )
        acc_bwt, acc_dollar = merged, dollar
        acc_reads += idx.num_reads
        acc_maxlen = max(acc_maxlen, nxt_maxlen)

    read_lengths = np.concatenate(lengths)
    read_offsets = np.zeros(acc_reads + 1, dtype=np.int64)
    np.cumsum(read_lengths, out=read_offsets[1:])
    merged = pack_from_bwt(
        acc_bwt,
        dollar_map=acc_dollar,
        read_to_sample=np.concatenate(sample_ids),
        read_lengths=read_lengths.astype(np.int32),
        corpus_packed=alphabet.pack_2bit(np.concatenate(bases)),
        read_offsets=read_offsets,
        sample_names=(
            sample_names if shared_samples else _dedupe_names(sample_names)
        ),
        config=config,
        fast_resolve=fast_resolve,
        sample_rate=sample_rate,
    )
    if shared_samples:
        merged.num_samples = ns_shared
    return _carry_payload(merged, indexes)
