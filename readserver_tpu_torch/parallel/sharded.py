"""BWT-interval sharding on one device: the sharded index and its query
program.

The JAX package's ``parallel/sharded.py``: the global BWT is cut into S
contiguous, block-aligned position ranges, each re-packed with its own
checkpoints, and for any global position ``i``

    occ_global(c, i) = Σ_shards occ_local_s(c, clamp(i - start_s, 0, len_s))

which the JAX program takes as one ``psum`` over the ``'shard'`` mesh axis.
The payload tables ($-rank → read id, read id → sample, the sampled pairs)
shard the same way over their own key ranges.  Global positions and
intervals are int64; local ranks stay int32.

A rank of a process group holds a contiguous run of the S shards on its
device (``parallel/mesh.py``; all S on a mesh of one rank).  The host part
(:func:`build_sharded`) is the JAX package's, array for array;
:func:`place_sharded` moves the rank's run to its device and adds the
exclusive prefixes over the run's shards that the owner form of the
kernels reads.  The query program (:func:`make_sharded_query_fn`) has two
forms:

* every shard on one rank: the whole program in a few launches of kernels
  K9-K11 (``csrc/sharded.cu``), each position read at its owner shard;
* the shards spread over the ranks of a dp row (or ``per_step``): the JAX
  ``_query_body`` step for step, each step one launch of a rank's partial
  over its run (K9's partial, K13, K11's partial or a walk step,
  ``csrc/sharded_partial.cu``) and one all-reduce over the row's ranks,
  whose output the next launch reads.

Both compact the hit lanes under the resolve budget and gather the walk's
answers back with K14, and count the capped histogram with K15
(``csrc/compact.cu``, through ``ops/resolve.py``).  Each runs the plain
torch forms of ``ops/sharded.py`` and ``ops/resolve.py`` for CPU tensors
and the kernels for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from readserver_tpu_torch import alphabet
from readserver_tpu_torch.index import packing
from readserver_tpu_torch.ops import sharded as sops
from readserver_tpu_torch.ops.resolve import (
    compact_lanes,
    gather_lanes,
    lane_histogram,
)
from readserver_tpu_torch.ops.search import (
    _refused,
    canonical_empty,
    kstep_schedule,
    prefix_ids,
    raise_if_refused,
)
from readserver_tpu_torch.parallel.multihost import all_reduce

Array = Any  # numpy before place_sharded, torch after


@dataclass(frozen=True)
class ShardedIndex:
    """Per-shard arrays stacked on a leading shard axis (size S); the JAX
    package's fields, uint32 tables held as int32 bits once placed."""

    rank_rows: Array     # uint32 [S, 5*nbl_max, row_words]
    sym4: Array          # uint32 [S, W4max]
    dollar_chunk: Array  # int32  [S, DMAX] ($-rank range → read id)
    sample_chunk: Array  # int32  [S, RMAX] (read-id range → sample id)
    starts: Array        # int64  [S] global BWT position of shard start
    lens: Array          # int64  [S]
    dstarts: Array       # int64  [S] global $-rank at shard start
    dlens: Array         # int64  [S]
    rstarts: Array       # int64  [S] read-id chunk start
    rlens: Array         # int64  [S]
    C: Array             # int64  [6]
    # fast-resolve tier: lf by position range, mark rank re-packed per
    # shard, sample pairs by global mark-rank range
    lf_chunk: Array | None = None      # int32 [S, maxlen]
    mark_table: Array | None = None    # uint32 [S, nbl_max+1, row_words]
    spairs_chunk: Array | None = None  # int32 [S, smax, 2]
    sstarts: Array | None = None       # int64 [S]
    slens: Array | None = None         # int64 [S]
    # direct-resolve tier: per-row (read_id << dsa_bits | offset)
    dsa_chunk: Array | None = None     # uint32 [S, maxlen]
    # k-step search tiers, shard-local slices of the global plane tables
    rank2_rows: Array | None = None    # uint32 [S, 16*nbl_max, row_words]
    C2: Array | None = None            # int64 [16]
    rank3_rows: Array | None = None    # uint32 [S, 64*nbl_max, row_words]
    C3: Array | None = None            # int64 [64]
    # per-shard symbol/k-gram totals
    sym_totals: Array | None = None    # int64 [S, NUM_SYMBOLS]
    totals2: Array | None = None       # int64 [S, 16]
    totals3: Array | None = None       # int64 [S, 64]
    # the owner form's exclusive prefixes over shards (place_sharded)
    sym_prefix: Array | None = None    # int64 [S+1, NUM_SYMBOLS]
    prefix2: Array | None = None       # int64 [S+1, 16]
    prefix3: Array | None = None       # int64 [S+1, 64]
    mark_prefix: Array | None = None   # int64 [S+1]
    # static; num_shards counts the whole index's shards (a rank's run
    # stacks starts.shape[0] of them)
    num_shards: int = 1
    n: int = 0
    num_reads: int = 0
    num_samples: int = 1
    rows_per_symbol: int = 1
    block_size: int = 256
    words_per_block: int = 8
    max_read_len: int = 256
    sample_rate: int = 0
    dsa_bits: int = 0
    # what ops/sharded.py builds once for the kernels of a placed index
    # (its checked view); a replaced index starts with none
    kernel_cache: dict = field(default_factory=dict, init=False, repr=False,
                               compare=False)

    @property
    def log2_block(self) -> int:
        return self.block_size.bit_length() - 1

    @property
    def has_fast_resolve(self) -> bool:
        return self.sample_rate > 0 and self.lf_chunk is not None


# the JAX package's stacked and replicated fields
STACKED = (
    "rank_rows", "sym4", "dollar_chunk", "sample_chunk",
    "starts", "lens", "dstarts", "dlens", "rstarts", "rlens",
    "lf_chunk", "mark_table", "spairs_chunk", "sstarts", "slens",
    "dsa_chunk",
    "rank2_rows", "rank3_rows", "sym_totals", "totals2", "totals3",
)
REPLICATED = ("C", "C2", "C3")


def build_sharded(packed, num_shards: int) -> ShardedIndex:
    """Host-side: slice the global BWT into S block-aligned ranges and
    re-pack each range with shard-local checkpoints (NumPy arrays, the
    JAX package's ``build_sharded`` field by field)."""
    cfg = packed.config
    S = num_shards
    n, m = packed.n, packed.num_reads
    bs = cfg.block_size
    bwt = packing.unpack_sym4(np.asarray(packed.sym4), n)

    # block-aligned contiguous ranges
    target = -(-n // S)
    target = -(-target // bs) * bs
    starts = np.minimum(np.arange(S, dtype=np.int64) * target, n)
    ends = np.minimum(starts + target, n)
    lens = ends - starts

    rank_stack, sym_stack, dlens = [], [], []
    sym_totals = np.zeros((S, alphabet.NUM_SYMBOLS), dtype=np.int64)
    for s in range(S):
        local = bwt[starts[s] : ends[s]]
        rb, _, counts = packing.pack_rank_blocks(local, cfg)
        rank_stack.append(rb)  # [5, nbl_s+1, R]
        sym_stack.append(packing.pack_sym4(local))
        sym_totals[s] = counts
        dlens.append(int(counts[alphabet.SENTINEL]))
    dlens = np.asarray(dlens, dtype=np.int64)
    dstarts = np.zeros(S, dtype=np.int64)
    np.cumsum(dlens[:-1], out=dstarts[1:])
    assert dstarts[-1] + dlens[-1] == m

    nbl_max = max(rb.shape[1] for rb in rank_stack)
    R = cfg.row_words
    rank_rows = np.zeros(
        (S, alphabet.NUM_SYMBOLS * nbl_max, R), dtype=np.uint32
    )
    for s, rb in enumerate(rank_stack):
        pad = np.zeros((alphabet.NUM_SYMBOLS, nbl_max, R), dtype=np.uint32)
        pad[:, : rb.shape[1]] = rb
        rank_rows[s] = pad.reshape(-1, R)

    w4max = max(x.shape[0] for x in sym_stack)
    sym4 = np.zeros((S, max(w4max, 1)), dtype=np.uint32)
    for s, x in enumerate(sym_stack):
        sym4[s, : x.shape[0]] = x

    dmax = max(1, int(dlens.max()))
    dollar_chunk = np.zeros((S, dmax), dtype=np.int32)
    dm = np.asarray(packed.dollar_map, dtype=np.int32)
    for s in range(S):
        dollar_chunk[s, : dlens[s]] = dm[dstarts[s] : dstarts[s] + dlens[s]]

    rchunk = -(-m // S)
    rstarts = np.minimum(np.arange(S, dtype=np.int64) * rchunk, m)
    rends = np.minimum(rstarts + rchunk, m)
    rlens = rends - rstarts
    sample_chunk = np.zeros((S, max(rchunk, 1)), dtype=np.int32)
    rts = np.asarray(packed.read_to_sample, dtype=np.int32)
    for s in range(S):
        sample_chunk[s, : rlens[s]] = rts[rstarts[s] : rends[s]]

    # direct-resolve tier, sharded by the same position ranges
    dsa_chunk = None
    dsa_bits = 0
    if packed.dsa is not None and packed.dsa_bits > 0:
        dsa_bits = int(packed.dsa_bits)
        dsa_all = np.asarray(packed.dsa, dtype=np.uint32)
        maxlen = int(lens.max())
        dsa_chunk = np.zeros((S, max(maxlen, 1)), dtype=np.uint32)
        for s in range(S):
            dsa_chunk[s, : lens[s]] = dsa_all[starts[s] : ends[s]]

    # fast-resolve tier, sharded the same three ways
    lf_chunk = mark_table = spairs_chunk = sstarts = slens = None
    srate = 0
    if packed.lf is not None and packed.sample_rate > 0:
        srate = int(packed.sample_rate)
        lf_all = np.asarray(packed.lf, dtype=np.int32)
        maxlen = int(lens.max())
        lf_chunk = np.zeros((S, max(maxlen, 1)), dtype=np.int32)
        mark_stack = []
        slens_list = []
        for s in range(S):
            piece = lf_all[starts[s] : ends[s]]
            lf_chunk[s, : lens[s]] = piece
            marked = piece < 0
            mark_stack.append(packing.pack_bit_rank(marked, cfg))
            slens_list.append(int(marked.sum()))
        slens = np.asarray(slens_list, dtype=np.int64)
        sstarts = np.zeros(S, dtype=np.int64)
        np.cumsum(slens[:-1], out=sstarts[1:])
        mb_max = max(t.shape[0] for t in mark_stack)
        mark_table = np.zeros((S, mb_max, cfg.row_words), dtype=np.uint32)
        for s, t in enumerate(mark_stack):
            mark_table[s, : t.shape[0]] = t
        smax = max(1, int(slens.max()))
        spairs_chunk = np.zeros((S, smax, 2), dtype=np.int32)
        pairs = np.asarray(packed.sample_pairs, dtype=np.int32)
        total_marked = int(slens.sum())
        assert total_marked <= pairs.shape[0] or total_marked == 0
        for s in range(S):
            spairs_chunk[s, : slens[s]] = pairs[
                sstarts[s] : sstarts[s] + slens[s]
            ]

    # k-step tiers: shard boundaries are block-aligned, so each shard's
    # pair/triple plane table is a SLICE of the global one with the
    # checkpoint column rebased to the shard start
    rank2_rows = C2 = rank3_rows = C3 = totals2 = totals3 = None
    if packed.rank2_blocks is not None and packed.C2 is not None:
        rank2_rows = _slice_plane_tiers(
            packed.rank2_blocks, starts, ends, bs, nbl_max
        )
        C2 = np.asarray(packed.C2, dtype=np.int64)
        totals2 = _plane_totals(packed.rank2_blocks, starts, ends, bs)
    if packed.rank3_blocks is not None and packed.C3 is not None:
        rank3_rows = _slice_plane_tiers(
            packed.rank3_blocks, starts, ends, bs, nbl_max
        )
        C3 = np.asarray(packed.C3, dtype=np.int64)
        totals3 = _plane_totals(packed.rank3_blocks, starts, ends, bs)

    return ShardedIndex(
        rank_rows=rank_rows,
        sym4=sym4,
        dollar_chunk=dollar_chunk,
        sample_chunk=sample_chunk,
        starts=starts,
        lens=lens,
        dstarts=dstarts,
        dlens=dlens,
        rstarts=rstarts,
        rlens=rlens,
        C=np.asarray(packed.C, dtype=np.int64),
        rank2_rows=rank2_rows,
        C2=C2,
        rank3_rows=rank3_rows,
        C3=C3,
        sym_totals=sym_totals,
        totals2=totals2,
        totals3=totals3,
        lf_chunk=lf_chunk,
        mark_table=mark_table,
        spairs_chunk=spairs_chunk,
        sstarts=sstarts,
        slens=slens,
        dsa_chunk=dsa_chunk,
        dsa_bits=dsa_bits,
        sample_rate=srate,
        num_shards=S,
        n=n,
        num_reads=m,
        num_samples=max(packed.num_samples, 1),
        rows_per_symbol=nbl_max,
        block_size=cfg.block_size,
        words_per_block=cfg.words_per_block,
        max_read_len=int(packed.read_lengths.max()) if m else 1,
    )


def _plane_totals(
    table: np.ndarray, starts: np.ndarray, ends: np.ndarray, bs: int
) -> np.ndarray:
    """Per-shard plane totals int64 [S, P]: a checkpoint difference on the
    GLOBAL table (shard ranges are block-aligned).  A shard of length 0
    that starts at an unaligned n gets the last partial block's count
    here, as in the JAX package; the owner form never reads it."""
    S = len(starts)
    out = np.zeros((S, table.shape[0]), dtype=np.int64)
    for s in range(S):
        b0 = int(starts[s]) // bs
        b1 = -(-int(ends[s]) // bs)
        out[s] = table[:, b1, 0].astype(np.int64) - table[:, b0, 0].astype(
            np.int64
        )
    return out


def _slice_plane_tiers(
    table: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    bs: int,
    nbl_max: int,
) -> np.ndarray:
    """Global plane table [P, NB+1, R] → per-shard stacked
    [S, P*nbl_max, R] with rebased checkpoints."""
    S = len(starts)
    P_, _, R = table.shape
    out = np.zeros((S, P_ * nbl_max, R), dtype=np.uint32)
    for s in range(S):
        b0 = int(starts[s]) // bs
        b1 = -(-int(ends[s]) // bs)  # ceil
        sl = np.array(table[:, b0 : b1 + 1], dtype=np.uint32)
        sl[:, :, 0] -= sl[:, :1, 0]
        pad = np.zeros((P_, nbl_max, R), dtype=np.uint32)
        pad[:, : sl.shape[1]] = sl
        out[s] = pad.reshape(-1, R)
    return out


def _exclusive_prefix(totals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """int64 [S, P] per-shard totals → [S+1, P]: row s sums shards < s, an
    empty shard counting 0 (its plane totals may hold a partial block's)."""
    totals = np.where((np.asarray(lens) > 0).reshape(-1, *[1] * (totals.ndim - 1)),
                      totals, 0)
    out = np.zeros((totals.shape[0] + 1, *totals.shape[1:]), dtype=np.int64)
    np.cumsum(totals, axis=0, out=out[1:])
    return out


def _to_tensor(a, device) -> torch.Tensor:
    """uint32 → int32 bits; int64 and int32 kept; contiguous, on device."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype not in (np.int32, np.int64):
        raise TypeError(f"no tensor form for {a.dtype}")
    return torch.from_numpy(a.copy() if not a.flags.writeable else a).to(
        device
    )


def place_sharded(sidx: ShardedIndex, mesh) -> ShardedIndex:
    """This rank's run of a :func:`build_sharded` index (all S shards on a
    mesh of one rank) → tensors on the mesh's device (uint32 tables as
    int32 bits), the run's shards keeping their global starts, plus the
    exclusive prefixes over the run's shards of ``sym_totals``,
    ``totals2``, ``totals3`` and the shards' mark counts (``slens``)."""
    if int(mesh.shape["shard"]) != sidx.num_shards:
        raise ValueError(
            f"mesh has {mesh.shape['shard']} shards, the index "
            f"{sidx.num_shards}"
        )
    a, k = mesh.first_shard, mesh.shards_per_rank
    run = {f: None if getattr(sidx, f) is None
           else np.asarray(getattr(sidx, f))[a : a + k] for f in STACKED}
    dev = mesh.device
    placed = {f: None if v is None else _to_tensor(v, dev)
              for f, v in run.items()}
    for f in REPLICATED:
        v = getattr(sidx, f)
        placed[f] = None if v is None else _to_tensor(v, dev)
    pre = {
        "sym_prefix": run["sym_totals"],
        "prefix2": run["totals2"],
        "prefix3": run["totals3"],
        "mark_prefix": run["slens"],
    }
    for f, totals in pre.items():
        placed[f] = (
            None if totals is None
            else _to_tensor(_exclusive_prefix(np.asarray(totals, np.int64),
                                              run["lens"]), dev)
        )
    return dataclasses.replace(sidx, **placed)


# --------------------------------------------------------- the query program


def _hit_lanes(l, u, H: int, budget: int | None, walk):
    """The JAX ``_query_body``'s hit lanes (902-929) over int64 intervals,
    ``walk(rows int64 [R], valid bool [R]) → (read_id, offset, sample)``
    int32 [R] → ``(read_id, offset, valid, sample, fit)``: [B, H] each, -1
    (sample 0) on lanes that hold no hit or were dropped, and ``fit`` bool
    [B], the interval fit the cap and no lane of it was dropped.  Under a
    budget that cuts, K14 compacts the first ``budget`` valid lanes in
    flat order (the rest drop and surface as hits_truncated) and gathers
    the walk's answers and samples back; else the [B * H] expansion
    walks."""
    B = l.shape[0]
    if budget is not None and budget < B * H:
        rows_c, valid_c, prefix = compact_lanes(l, u, H, budget)
        rid_c, off_c, smp_c = walk(rows_c, valid_c)
        read_id, offset, sample, valid = gather_lanes(
            l, u, H, budget, prefix, rid_c, off_c, smp_c=smp_c)
        # a query keeps every lane iff its lanes end inside the budget
        dropped = (u > l) & (prefix[1:] > budget)
        return read_id, offset, valid, sample, ((u - l) <= H) & ~dropped
    span = torch.arange(H, dtype=torch.int64, device=l.device)
    rows = (l[:, None] + span[None, :]).reshape(-1)
    valid = (span[None, :] < (u - l)[:, None]).reshape(-1)
    rows = torch.where(valid, rows, torch.zeros_like(rows))
    read_id, offset, sample = walk(rows, valid)
    return (read_id.reshape(B, H), offset.reshape(B, H), valid.reshape(B, H),
            sample.reshape(B, H), (u - l) <= H)


def _query(
    sidx, lut, kmers, lengths, *,
    max_hits: int, lut_p: int, kstep: int = 1, early_exit: bool = False,
    exact_hist: bool = False, exact_max_rows: int | None = None,
    resolve_budget: int | None = None, walk_early_exit: bool = False,
    bad=None,
):
    """Search + resolve + attribution, as the JAX ``_query_body`` on one
    device (see :func:`make_sharded_query_fn`)."""
    B = kmers.shape[0]
    # the k-step schedule over the planes the index has, else the masked
    # 1-step scan
    if kstep >= 2 and sidx.rank2_rows is not None:
        kstep = 3 if kstep >= 3 and sidx.rank3_rows is not None else 2
    else:
        kstep = 1
    l, u = sops.search(sidx, kmers, lengths, lut if lut_p else None, lut_p,
                       kstep, early_exit=early_exit, bad=bad)

    H = max_hits
    read_id, offset, valid, sample, fit = _hit_lanes(
        l, u, H, resolve_budget,
        lambda r, v: sops.resolve(sidx, r, v,
                                  walk_early_exit=walk_early_exit))
    if exact_hist:
        hist, hist_complete = sops.sweep(
            sidx, l, u, B * H, exact_max_rows,
            walk_early_exit=walk_early_exit,
        )
    else:
        hist = lane_histogram(sample, valid, sidx.num_samples)
        hist_complete = fit
    return dict(
        l=l,
        u=u,
        count=u - l,
        read_id=read_id,
        offset=offset,
        valid=valid,
        sample_hist=hist,
        hist_complete=hist_complete,
    )


# ------------------------------------------------ the cross-rank program


class _Run:
    """One rank's run of the shards and its dp row's shard subgroup: each
    collective of the JAX program is this rank's partial over its run
    (K9's partial, K13, K11's partial, a walk step) and one all-reduce over
    the row's ranks.  Every rank of the row holds the row's queries and
    sees the same reduced values, so each takes the same branches and trip
    counts; the dp rows never meet inside the program, so a row's loops
    stop on their own where the JAX program makes the trip count
    dp-uniform with a pmax (the answers are the same: a row's extra trips
    carry no live lane)."""

    def __init__(self, sidx, mesh):
        self.s = sidx
        self.group = mesh.shard_group
        self.lead = mesh.lead

    def reduce(self, t):
        return all_reduce(t, self.group)

    def lookup(self, what: str, x, y=None):
        return self.reduce(sops.lookup_partial(self.s, what, x, y))


def _search_ranks(run, kmers, lengths, lut, p: int, kstep: int,
                  early_exit: bool):
    """The JAX ``_query_body``'s search: from the LUT or C, each step one
    launch of K9's step partial, written over the interval in place, and
    one all-reduce, whose output is the next (l, u) → int64 (l, u) [B],
    empties (0, 0).  ``early_exit`` (the k-step schedule only, as in the
    JAX program) stops once every interval of the row is empty."""
    s = run.s
    B, K = kmers.shape
    if lut is not None:
        rows0 = lut.index_select(0, prefix_ids(kmers, p).to(torch.int64))
        l, u = rows0[:, 0], rows0[:, 1]
        last_col = K - p
    else:
        c_last = kmers[:, K - 1].to(torch.int64)
        l, u = s.C.index_select(0, c_last), s.C.index_select(0, c_last + 1)
        last_col = K - 1
    lu = torch.cat([l, u]).contiguous()
    if kstep >= 2:
        sched, lens = kstep_schedule(last_col, kstep), None
    else:
        sched, lens = [(j, 1) for j in range(last_col - 1, -1, -1)], lengths
    for j, k in sched:
        if kstep >= 2 and early_exit and not bool((lu[:B] < lu[B:]).any()):
            break
        run.reduce(sops.step_partial(s, k, kmers, lens, j, lu, run.lead,
                                     out=lu))
    return canonical_empty(lu[:B], lu[B:])


def _resolve_ranks(run, rows, valid, walk_early_exit: bool):
    """The JAX ``do_walk`` over global rows int64 [R] and the sample lookup
    after it → (read_id, offset, sample) int32 [R], read_id and offset -1
    where invalid or unterminated, sample that of read id clip(read_id, 0,
    m - 1).  The dsa gather is one K13 launch and all-reduce, then K13's
    sample lookup and one more.  The LF and slow walks are one walk-step
    launch and one all-reduce a step, the walk's state on the card between
    them (:class:`ops.sharded.WalkState`): the LF walk a step, then the
    fused terminal pairs; the slow walk the symbol and the rank a step,
    then the $-rank's read; the last launch also writes the sample lookup's
    partial.  ``walk_early_exit`` stops once every lane is done, as the
    walk's last launch reports (one wait, no reduction over the lanes):
    every lane's terminal partial is written as it ends, so the next
    all-reduce is the terminal's."""
    s = run.s
    kind = sops.walk_kind(s)
    if kind == "dsa":
        neg = torch.full(rows.shape, -1, dtype=torch.int32, device=rows.device)
        p = run.lookup("dsa", rows).to(torch.int64) & 0xFFFFFFFF
        bits = s.dsa_bits
        rid = torch.where(valid, (p >> bits).to(torch.int32), neg)
        off = torch.where(valid, (p & ((1 << bits) - 1)).to(torch.int32), neg)
        return rid, off, run.lookup("sample", rid.to(torch.int64))
    st = sops.walk_state(s, rows, valid, run.lead)
    live = (lambda: sops.walk_live(s, st)) if walk_early_exit else (
        lambda: True)
    if kind == "lf":
        step = functools.partial(sops.lf_walk_step, s, st)
        n = max(s.sample_rate, 1)
        step("first")
        for i in range(n):
            if not live():
                break
            run.reduce(st.step32)  # the raw LF of cur
            step("step" if i < n - 1 else "last")
        run.reduce(st.term64)  # the (LF, mark rank) pairs
        step("terminal")
        run.reduce(st.term32)  # the (read id, pair) triples
    else:
        step = functools.partial(sops.slow_walk_step, s, st)
        n = s.max_read_len
        step("first")
        for t in range(n):
            if not live():
                break
            run.reduce(st.step32)  # the symbol at cur
            step("rank", t)
            run.reduce(st.step64)  # its rank before cur
            step("step" if t < n - 1 else "last", t)
        run.reduce(st.term32)  # the read ids of the $-ranks
    step("finish")
    run.reduce(st.step32)  # the samples of the read ids
    return st.read_id, st.offset, st.step32


def _sweep_ranks(run, l, u, window: int, max_rows: int | None,
                 walk_early_exit: bool):
    """The JAX exact sweep (947-988): windows of ``window`` slots of the
    concatenated intervals, each walked and its samples looked up through
    the all-reduces, then one ``index_add_`` of the window's reduced sample
    ids (outside every step loop).  The row's total decides the trip count
    on every rank of the row alike."""
    s = run.s
    B = l.shape[0]
    S = s.num_samples
    dev = l.device
    cum = torch.cumsum(u - l, 0)
    total = int(cum[B - 1])
    span = torch.arange(window, dtype=torch.int64, device=dev)
    hist = torch.zeros(B * S, dtype=torch.int32, device=dev)
    t = 0
    while t * window < total and (max_rows is None or t * window < max_rows):
        g = t * window + span
        gvalid = g < total
        qc = torch.searchsorted(cum, g, right=True).clamp(max=B - 1)
        prev = torch.where(qc > 0, cum.index_select(0, (qc - 1).clamp(min=0)),
                           torch.zeros_like(qc))
        wrows = l.index_select(0, qc) + (g - prev)
        _, _, smp = _resolve_ranks(run, torch.where(gvalid, wrows, 0), gvalid,
                                   walk_early_exit)
        hist.index_add_(0, qc * S + smp.to(torch.int64),
                        gvalid.to(torch.int32))
        t += 1
    return hist.reshape(B, S), cum <= t * window


def _query_ranks(
    sidx, lut, kmers, lengths, *, mesh,
    max_hits: int, lut_p: int, kstep: int = 1, early_exit: bool = False,
    exact_hist: bool = False, exact_max_rows: int | None = None,
    resolve_budget: int | None = None, walk_early_exit: bool = False,
):
    """Search + resolve + attribution of one dp row across the ranks of its
    shard subgroup, the JAX ``_query_body`` step for step (see
    :class:`_Run`).  The collectives a batch, each one all-reduce: a search
    step each, then dsa 2, lf ``sample_rate`` + 3 or slow ``2 *
    max_read_len`` + 2 (``parallel/stats.query_psum_estimate``), and the
    sweep's walks and sample lookups a window."""
    run = _Run(sidx, mesh)
    B, K = kmers.shape
    if kstep >= 2 and sidx.rank2_rows is not None:
        kstep = 3 if kstep >= 3 and sidx.rank3_rows is not None else 2
    else:
        kstep = 1
    p = lut_p if lut is not None else 0
    raise_if_refused(
        int(_refused(kmers, lengths if kstep == 1 else None, p).sum()), K)
    l, u = _search_ranks(run, kmers, lengths, lut if p else None, p, kstep,
                         early_exit)

    H = max_hits
    # every rank of the row compacts alike: the intervals are reduced values
    read_id, offset, valid, sample, fit = _hit_lanes(
        l, u, H, resolve_budget,
        lambda r, v: _resolve_ranks(run, r, v, walk_early_exit))
    if exact_hist:
        hist, hist_complete = _sweep_ranks(run, l, u, B * H, exact_max_rows,
                                           walk_early_exit)
    else:
        hist = lane_histogram(sample, valid, sidx.num_samples)
        hist_complete = fit
    return dict(
        l=l,
        u=u,
        count=u - l,
        read_id=read_id,
        offset=offset,
        valid=valid,
        sample_hist=hist,
        hist_complete=hist_complete,
    )


def make_sharded_query_fn(
    sidx: ShardedIndex,
    mesh,
    max_hits: int = 64,
    lut_p: int = 0,
    kstep: int | None = None,
    early_exit: bool = False,
    exact_hist: bool = False,
    exact_max_rows: int | None = None,
    resolve_budget: int | None = None,
    walk_early_exit: bool = False,
    owner_route: bool = False,
    route_capacity: int | None = None,
):
    """The sharded query step: ``fn(sidx, lut_or_None, kmers [B,K] int32,
    lengths [B] int32, bad=None) → dict`` of ``l, u, count`` (int64 [B]),
    ``read_id, offset`` (int32 [B, H]), ``valid`` (bool [B, H]),
    ``sample_hist`` (int32 [B, num_samples]) and ``hist_complete`` (bool
    [B]), the JAX ``make_sharded_query_fn``'s answers bit for bit.

    ``kmers`` are this rank's dp rows (the whole batch on a mesh of one
    rank), each row of ``B / mesh.rows_per_rank`` queries run in turn:
    every shard on this rank runs the one-device kernels, shards spread
    over the ranks of a row (or ``mesh.per_step``) the cross-rank program
    (:func:`_query_ranks`), which every rank of the row calls together.

    ``kstep=None`` picks the deepest k-gram tier the index carries; a fn
    with ``kstep >= 2`` needs every query length == K.  With ``lut_p > 0``
    it needs an int64 [4^p, 2] LUT (:func:`build_prefix_lut_sharded`) and
    every length >= lut_p.  ``early_exit``, ``walk_early_exit``,
    ``owner_route`` and ``route_capacity`` change no answer; the one-device
    kernels stop each search and walk per lane and read the owner shard
    only, and the owner-routed rank has no cross-rank form here.  ``bad``
    (int32 [1] on the card) counts refused queries without waiting in the
    one-device form, as the single-device engine's search does; without
    it, and always across ranks, a refused query raises ``ValueError``."""
    if kstep is None:
        kstep = (
            3 if sidx.rank3_rows is not None
            else 2 if sidx.rank2_rows is not None
            else 1
        )
    if route_capacity is not None and int(route_capacity) < 1:
        raise ValueError(f"route_capacity must be >= 1, got {route_capacity}")
    del owner_route
    kw = dict(max_hits=max_hits, lut_p=lut_p, kstep=kstep,
              early_exit=early_exit, exact_hist=exact_hist,
              exact_max_rows=exact_max_rows, resolve_budget=resolve_budget,
              walk_early_exit=walk_early_exit)
    rows = mesh.rows_per_rank

    def one(sidx, lut, kmers, lengths, bad):
        if mesh.cross_rank:
            return _query_ranks(sidx, lut, kmers, lengths, mesh=mesh, **kw)
        return _query(sidx, lut, kmers, lengths, bad=bad, **kw)

    def fn(sidx, lut, kmers, lengths, bad=None):
        B = kmers.shape[0]
        if rows == 1:
            return one(sidx, lut, kmers, lengths, bad)
        if B % rows:
            raise ValueError(f"a batch of {B} does not split into {rows} "
                             f"dp rows")
        b = B // rows
        outs = [one(sidx, lut, kmers[r * b : (r + 1) * b],
                    lengths[r * b : (r + 1) * b], bad) for r in range(rows)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    return fn


def build_prefix_lut_sharded(
    sidx: ShardedIndex, mesh, p: int, max_chunk: int = 1 << 22
) -> torch.Tensor:
    """Prefix LUT (int64 [4^p, 2]) built with the sharded global rank: the
    level BFS of ``ops/lut.py`` (four children per interval, c-major,
    empties frozen, absent p-mers as (0, 0)), bit-exact with the sharded
    search it starts.  Every shard on this rank: K11 a level, each launch
    taking at most ``max_chunk`` intervals.  Shards spread over the ranks
    of a row (or ``mesh.per_step``): the JAX ``level_body``, K11's partial
    and one all-reduce a level, which every rank of the row calls together.
    The plain forms for a CPU index."""
    if not (1 <= p <= 15):
        raise ValueError("prefix LUT order must be in [1, 15]")
    if max_chunk < 1:
        raise ValueError("max_chunk must be >= 1")
    cross = mesh is not None and mesh.cross_rank
    l = sidx.C[1:5].contiguous()
    u = sidx.C[2:6].contiguous()
    for _ in range(p - 1):
        if cross:
            X = l.shape[0]
            out = all_reduce(sops.lut_level_partial(
                sidx, l, u, mesh.lead, max_chunk=max_chunk), mesh.shard_group)
            l, u = out[: 4 * X], out[4 * X :]
        else:
            l, u = sops.lut_level(sidx, l, u, max_chunk=max_chunk)
    empty = l >= u
    zero = torch.zeros_like(l)
    return torch.stack(
        [torch.where(empty, zero, l), torch.where(empty, zero, u)], dim=1
    ).contiguous()
