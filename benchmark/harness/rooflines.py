"""Frozen rules of the kernels' rooflines, in NumPy.

A kernel's share of its roofline is the least time the card could take
for the work divided by the kernel's device time.  Every kernel counted
here does a few integer operations a byte, far below the card's
operation rates, so of the compute and memory limits bytes bind: the
bytes the work needs over the HBM rate.  Each input byte is counted once
and each output byte once: a table row read by many queries of one
launch counts once.  K2 is also held by its chain of dependent reads
(each step's rank row is found from the last step's interval), so its
least time is the larger of the bytes' time and the longest chain's
reads times ``T_ROW_S``.  The rules count the work
from the queries and the artifact's own arrays, never from the program's
device state, so they read the same work whatever kernel does it:

* K2, the backward search from the prefix LUT by the k-step schedule: the
  codes, each distinct LUT entry and each distinct rank row of the steps
  taken (only intervals still open take a step), (l, u) written;
* K5, the dsa decode of a full route's hits: (l, u) in, each distinct
  dsa row of the valid lanes and each distinct read's sample, the three
  hit columns written;
* K8, the sparse pack of that answer: its dense inputs, the kept hits'
  offset and sample, the packed buffer written.

The search intervals come from a NumPy backward search over the artifact's
rank tables (the same table layout the program ships: per symbol or
plane, a row per block of [checkpoint, bit words..., pad]).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, HBM3 (NVIDIA's data sheet)
# one dependent 64-byte read of a warp, from L2: the rs_chase yardstick's
# warm reading on an NVIDIA H100 80GB HBM3 at 700 W (a read from HBM takes
# 0.52-0.61 us); the smaller reading, so the chain bound is a least time
T_ROW_S = 0.2415e-6

_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def _popcount32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    return (_POP8[x & 0xFF] + _POP8[(x >> 8) & 0xFF]
            + _POP8[(x >> 16) & 0xFF] + _POP8[x >> 24])


def occ(table: np.ndarray, c: np.ndarray, i: np.ndarray,
        log2_block: int) -> np.ndarray:
    """Rank of plane ``c`` before position ``i`` in ``table`` (uint32
    [planes, blocks + 1, row_words]): the block's checkpoint plus the set
    bits of its bit words below ``i``, least significant bit first."""
    blk = i >> log2_block
    within = (i - (blk << log2_block)).astype(np.int64)
    rows = table[c, blk]
    words = (1 << log2_block) // 32
    total = rows[:, 0].astype(np.int64)
    for w in range(words):
        bits = np.clip(within - 32 * w, 0, 32)
        mask = np.where(bits >= 32, np.uint64(0xFFFFFFFF),
                        (np.uint64(1) << bits.astype(np.uint64)) - np.uint64(1))
        total += _popcount32(rows[:, 1 + w].astype(np.uint64) & mask)
    return total


def kstep_schedule(last_col: int, kstep: int) -> list[tuple[int, int]]:
    """(first column, width) of each step over columns [0, last_col):
    triples from the right, then pairs, then one single column at 0."""
    ntriples = last_col // 3 if kstep >= 3 else 0
    rem = last_col - 3 * ntriples
    return ([(j, 3) for j in range(last_col - 3, rem - 1, -3)]
            + [(j, 2) for j in range(rem - 2, rem % 2 - 1, -2)]
            + ([(0, 1)] if rem % 2 else []))


def kstep_of(tiers) -> int:
    """The k-step search the engine runs, from the tiers it shipped."""
    return 3 if "rank3" in tiers else 2 if "rank2" in tiers else 1


def _step_code(codes: np.ndarray, j: int, k: int) -> np.ndarray:
    if k == 1:
        return codes[:, j].astype(np.int64)
    code = codes[:, j].astype(np.int64) - 1
    for t in range(1, k):
        code = code * 4 + (codes[:, j + t].astype(np.int64) - 1)
    return code


class Search:
    """K2's work on one batch: the final intervals, the bytes needed and
    the longest chain of dependent reads (the code tile, the LUT entry,
    then a row pair per step in which some interval is still open)."""

    def __init__(self, packed, codes: np.ndarray, p: int, kstep: int):
        lg = int(packed.config.block_size).bit_length() - 1
        W, K = codes.shape
        C = np.asarray(packed.C, dtype=np.int64)
        base = packed.rank_blocks
        # the LUT's entry: the interval of the last p characters
        c = codes[:, K - 1].astype(np.int64)
        l, u = C[c], C[c + 1]
        for j in range(K - 2, K - p - 1, -1):
            c = codes[:, j].astype(np.int64)
            act = l < u
            l = np.where(act, C[c] + occ(base, c, l, lg), l)
            u = np.where(act, C[c] + occ(base, c, u, lg), u)
        tail = codes[:, K - p:].astype(np.int64) - 1
        ids = (tail * (4 ** np.arange(p - 1, -1, -1, dtype=np.int64))).sum(1)
        tables = {1: (base, C),
                  2: (packed.rank2_blocks, np.asarray(packed.C2, np.int64)),
                  3: (packed.rank3_blocks, np.asarray(packed.C3, np.int64))}
        rows: dict[int, list] = {1: [], 2: [], 3: []}
        self.chain = 2
        for j, k in kstep_schedule(K - p, kstep):
            table, starts = tables[k]
            code = _step_code(codes, j, k)
            act = l < u
            self.chain += bool(act.any())
            rps = table.shape[1]
            rows[k] += [(code * rps + (x >> lg))[act] for x in (l, u)]
            l = np.where(act, starts[code] + occ(table, code, l, lg), l)
            u = np.where(act, starts[code] + occ(table, code, u, lg), u)
        self.l, self.u = l, u
        self.bytes = (W * K * 4 + len(np.unique(ids)) * 8 + W * 8 + sum(
            len(np.unique(np.concatenate(r))) * tables[k][0].shape[2] * 4
            for k, r in rows.items() if r))

    def least_seconds(self) -> float:
        """The launch's roofline time: bytes or the chain, whichever binds."""
        return max(self.bytes / HBM_BYTES_PER_S, self.chain * T_ROW_S)


def resolve_bytes(packed, search: Search, nq: int, max_hits: int,
                  per_query: int, num_samples: int) -> int:
    """K5's and K8's bytes for the full route on one batch (one device,
    the dsa tier), from the batch's intervals."""
    l, u = search.l, search.u
    W = len(l)
    take = np.minimum(u - l, max_hits)
    rows = np.repeat(l, take) + (np.arange(take.sum())
                                 - np.repeat(np.cumsum(take) - take, take))
    rows = np.unique(rows)
    rids = np.unique(np.asarray(packed.dsa)[rows] >> np.uint32(packed.dsa_bits))
    k5 = W * 8 + len(rows) * 4 + len(rids) * 4 + 3 * W * max_hits * 4
    kept = min(int(take[:nq].sum()), per_query * W)
    R = per_query * W
    packed_words = W * 4 + 2 + 2 * R + 1 + 4 * R
    k8 = (W * 8 + W + 4 * W * num_samples + 4 * W * max_hits
          + 8 * kept + 4 + 4 * packed_words)
    return k5 + k8
