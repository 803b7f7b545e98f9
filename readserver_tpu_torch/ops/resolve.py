"""Resolve: SA rows → read ids / offsets / sample attribution.

A port of the JAX package's ``ops/resolve.py``.  Every walk has a plain
torch form (``*_plain``) that advances the whole batch one step at a time
with frozen ``done`` lanes, as the JAX lockstep loops do; the public names
launch a kernel (``csrc/resolve.cu``) for CUDA tensors and take the plain
form for CPU tensors, with no fallback between them:

* K5, the direct tier: one uint32 ``dsa`` word per hit lane, split into
  read id and offset, with the lane's sample id gathered beside it
  (:func:`resolve_rows_dsa`, :func:`resolve_dsa_hits`);
* K6, the fused-row walk: ≤ ``sample_rate`` steps of one 64-byte fused
  row each, on a persistent grid whose lanes refill from the 32-slot
  tiles their warp takes (:func:`resolve_rows_fused`);
* the rank walks, on K6's persistent grid with a hot loop of the step
  alone: the marks and slow walks (a step is one round of the four base
  planes' rank rows, and the mark row, while a warp holds at most the
  measured crossover's walks; two rounds, the sym4 word and then the
  symbol's rank row, past it) and the lf walk (one LF word a step)
  (:func:`resolve_rows_marked`, :func:`resolve_rows`,
  :func:`resolve_rows_fast`);
* K7, the exact per-sample histogram: tiles of the worklist mapped to
  their queries through the int64 prefix sums staged in shared memory,
  then the dsa decode or any of the four walks, and an atomic add
  (:func:`exact_sample_histogram`);
* K14, the row-budget compaction before a walk (``csrc/compact.cu``): the
  prefix of each query's hit lanes, the budget's slots filled from their
  queries, and the walk's answers gathered back to the lanes
  (:func:`compact_lanes`, :func:`gather_lanes`);
* K15, the capped per-sample histogram of the resolved hit lanes, by
  their read ids or by the samples a walk gave them
  (:func:`sample_histogram`, :func:`lane_histogram`).

In the JAX package the walks are XLA loops, not Pallas.  The slow walk's
``rank_fn``/``sym_fn`` hooks run only in the plain form; on CUDA tensors
they raise.  No caller passes them: the interval-sharded walks have their
own kernel (``ops/sharded.py``).
"""

from __future__ import annotations

import torch

from readserver_tpu_torch.kernels import (
    CAPPED_HISTOGRAM,
    EXACT_HISTOGRAM,
    RESOLVE_DSA,
    RESOLVE_FUSED,
    RESOLVE_WALK,
    ROW_COMPACT,
    ROW_GATHER,
)
from readserver_tpu_torch.kernels.build import check_int32, on_cuda, ptr
from readserver_tpu_torch.ops import rank as rank_ops
from readserver_tpu_torch.ops.rank import _WORD, popcount32
from readserver_tpu_torch.ops.types import DeviceIndex

# words per block the fused-walk kernels are compiled for (block sizes
# 32, 64, 128, 256; csrc/resolve.cu)
FUSED_WORDS_PER_BLOCK = (1, 2, 4, 8)
# the walk kinds, numbered as csrc/resolve.cu's entry points take them
WALK_KINDS = {"dsa": 0, "fused": 1, "marks": 2, "lf": 3, "slow": 4}


def _take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, i.to(torch.int64).reshape(-1)).reshape(
        *i.shape, *t.shape[1:]
    )


def _clip_take(t: torch.Tensor, i: torch.Tensor, size: int) -> torch.Tensor:
    """``t[clip(i, 0, max(size - 1, 0))]``, the JAX package's clipped gather."""
    return _take(t, i.clamp(0, max(size - 1, 0)))


def _neg(t: torch.Tensor) -> torch.Tensor:
    return torch.full_like(t, -1)


def resolve_rows_plain(
    index: DeviceIndex,
    rows: torch.Tensor,   # int32 [R] starting SA rows
    valid: torch.Tensor,  # bool  [R]
    max_steps: int | None = None,
    rank_fn=None,
    sym_fn=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain form of :func:`resolve_rows`, with the ``rank_fn``/``sym_fn``
    hooks (default K1's rank and the sym4 read)."""
    if max_steps is None:
        max_steps = index.max_read_len
    if rank_fn is None:
        def rank_fn(c, i):
            return rank_ops.occ(index, c, i)
    if sym_fn is None:
        def sym_fn(i):
            return rank_ops.read_symbol(index, i)
    cur = torch.where(valid, rows, torch.zeros_like(rows))
    done = ~valid
    read_id = _neg(rows)
    offset = _neg(rows)
    for t in range(max_steps):
        c = sym_fn(cur)
        o = rank_fn(c, cur)
        hit = (c == 0) & ~done
        rid = _clip_take(index.dollar_map, o, index.num_reads)
        read_id = torch.where(hit, rid, read_id)
        offset = torch.where(hit, torch.full_like(offset, t), offset)
        done = done | (c == 0)
        cur = torch.where(done, cur, _take(index.C, c) + o)
    return read_id, offset


def expand_intervals(
    l: torch.Tensor, u: torch.Tensor, max_hits: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intervals [B] → flattened candidate rows [B*max_hits]:
    ``(rows, valid, query_seg)``.  Hit enumeration is capped per query;
    counts stay exact through ``u - l``."""
    B = l.shape[0]
    span = torch.arange(max_hits, dtype=torch.int32, device=l.device)
    rows = (l[:, None] + span[None, :]).reshape(-1)
    valid = (span[None, :] < (u - l)[:, None]).reshape(-1)
    seg = torch.arange(B, dtype=torch.int32, device=l.device).repeat_interleave(
        max_hits
    )
    return torch.where(valid, rows, torch.zeros_like(rows)), valid, seg


def resolve_rows_fast_plain(
    index: DeviceIndex,
    rows: torch.Tensor,
    valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain form of :func:`resolve_rows_fast`."""
    assert index.lf is not None and index.sample_rate > 0
    m = index.C[1]
    n_marked = index.sample_pairs.shape[0]
    cur = torch.where(valid, rows, torch.zeros_like(rows))
    done = ~valid
    steps = torch.zeros_like(rows)
    for _ in range(index.sample_rate):
        raw = _take(index.lf, cur)
        val = raw & 0x7FFFFFFF
        is_term = (raw < 0) | (val < m)
        step_now = ~done & ~is_term
        cur = torch.where(step_now, val, cur)
        steps = steps + step_now.to(torch.int32)
        done = done | is_term
    raw = _take(index.lf, cur)
    is_marked = raw < 0
    rid_d = _clip_take(
        index.dollar_map, raw & 0x7FFFFFFF, index.dollar_map.shape[0]
    )
    slot = rank_ops.occ_rows(
        index.mark_rank, torch.zeros_like(cur), cur,
        rows_per_symbol=index.mark_rank.shape[0],
        log2_block=index.log2_block, words_per_block=index.words_per_block,
    )
    pair = _clip_take(index.sample_pairs, slot, n_marked)
    rid = torch.where(is_marked, pair[:, 0], rid_d)
    off = torch.where(is_marked, pair[:, 1] + steps, steps)
    ok = valid & done
    return torch.where(ok, rid, _neg(rid)), torch.where(ok, off, _neg(off))


def resolve_rows_marked_plain(
    index: DeviceIndex,
    rows: torch.Tensor,
    valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain form of :func:`resolve_rows_marked`: per step one sym4 gather,
    one rank (K1 on the card) and one mark row (terminal test and slot rank
    in one gather)."""
    assert index.mark_rank is not None and index.sample_rate > 0
    kw = dict(log2_block=index.log2_block,
              words_per_block=index.words_per_block)
    cur = torch.where(valid, rows, torch.zeros_like(rows))
    done = ~valid
    steps = torch.zeros_like(rows)
    for _ in range(index.sample_rate):
        c = rank_ops.read_symbol(index, cur)
        _, marked = rank_ops.bit_rank_and_test(index.mark_rank, cur, **kw)
        is_term = marked | (c == 0)
        o = rank_ops.occ(index, c, cur)
        step_now = ~done & ~is_term
        cur = torch.where(step_now, _take(index.C, c) + o, cur)
        steps = steps + step_now.to(torch.int32)
        done = done | is_term
    slot, marked = rank_ops.bit_rank_and_test(index.mark_rank, cur, **kw)
    o0 = rank_ops.occ(index, torch.zeros_like(cur), cur)
    rid_d = _clip_take(index.dollar_map, o0, index.dollar_map.shape[0])
    pair = _clip_take(index.sample_pairs, slot, index.sample_pairs.shape[0])
    rid = torch.where(marked, pair[:, 0], rid_d)
    off = torch.where(marked, pair[:, 1] + steps, steps)
    ok = valid & done
    return torch.where(ok, rid, _neg(rid)), torch.where(ok, off, _neg(off))


# ------------------------------------------------------------ K5: dsa tier


def resolve_rows_dsa_plain(
    index: DeviceIndex,
    rows: torch.Tensor,
    valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain form of :func:`resolve_rows_dsa`.  ``dsa`` holds uint32 words
    as int32 bits; bit 31 is set once ``read_id << dsa_bits`` passes 2^31
    (chr20 scale), so the word is widened to int64 and masked before the
    shift."""
    p = _take(index.dsa, torch.where(valid, rows, torch.zeros_like(rows)))
    p = p.to(torch.int64) & _WORD
    bits = index.dsa_bits
    rid = (p >> bits).to(torch.int32)
    off = (p & ((1 << bits) - 1)).to(torch.int32)
    return torch.where(valid, rid, _neg(rid)), torch.where(valid, off, _neg(off))


def _launch_dsa(index, l, u, H, with_sample: bool):
    """K5 over ``[B, H]`` lanes: lane (q, h) resolves row ``l[q] + h`` when
    ``h < u[q] - l[q]``, else writes -1."""
    if index.dsa is None or index.dsa_bits <= 0:
        raise ValueError("index carries no dsa tier")
    dev = index.dsa.device
    B = l.shape[0]
    check_int32("l", l, dev, (B,))
    check_int32("u", u, dev, (B,))
    check_int32("dsa", index.dsa, dev)
    check_int32("read_to_sample", index.read_to_sample, dev)
    rid = torch.empty((B, H), dtype=torch.int32, device=dev)
    off = torch.empty_like(rid)
    smp = torch.empty_like(rid) if with_sample else None
    if B * H:
        RESOLVE_DSA(
            ptr(l), ptr(u), B, H, ptr(index.dsa), index.dsa_bits,
            ptr(index.read_to_sample), index.read_to_sample.shape[0],
            ptr(rid), ptr(off), ptr(smp), device=dev,
        )
    return rid, off, smp


def resolve_rows_dsa(
    index: DeviceIndex,
    rows: torch.Tensor,   # int32 [R] SA rows
    valid: torch.Tensor,  # bool  [R]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Direct resolution, ``(read_id, offset)`` in ONE gather, no walk:
    ``dsa[row] = read_id << dsa_bits | offset``.  K5 for CUDA tensors (one
    lane per row), the plain form for CPU tensors."""
    assert index.dsa is not None and index.dsa_bits > 0
    if not on_cuda(index.dsa):
        return resolve_rows_dsa_plain(index, rows, valid)
    start = torch.where(valid, rows, torch.zeros_like(rows)).contiguous()
    rid, off, _ = _launch_dsa(
        index, start, start + valid.to(torch.int32), 1, with_sample=False
    )
    return rid.reshape(-1), off.reshape(-1)


def resolve_dsa_hits_plain(
    index: DeviceIndex, l: torch.Tensor, u: torch.Tensor, max_hits: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain form of :func:`resolve_dsa_hits`: expand the intervals,
    resolve through dsa, gather each hit's sample id, -1 on invalid lanes
    (the JAX engine's ``_pieces`` hit step, ``serve/engine.py:548-561``)."""
    B = l.shape[0]
    rows, valid, _ = expand_intervals(l, u, max_hits)
    rid, off = resolve_rows_dsa_plain(index, rows, valid)
    smp = _clip_take(index.read_to_sample, rid, index.num_reads)
    smp = torch.where(valid, smp, _neg(smp))
    return (rid.reshape(B, max_hits), off.reshape(B, max_hits),
            smp.reshape(B, max_hits))


def resolve_dsa_hits(
    index: DeviceIndex, l: torch.Tensor, u: torch.Tensor, max_hits: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ ``(read_id, offset, sample)`` int32 [B, max_hits] through the dsa
    tier, -1 where a lane holds no hit.  K5 for CUDA tensors: expansion,
    dsa decode and the sample gather in one pass."""
    if not on_cuda(l):
        return resolve_dsa_hits_plain(index, l, u, max_hits)
    return _launch_dsa(
        index, l.contiguous(), u.contiguous(), max_hits, with_sample=True
    )


# ------------------------------------------------------- K6: fused-row walk


def _fused_plane_pop(words: torch.Tensor, within: torch.Tensor) -> torch.Tensor:
    """words int64 [R, W] (uint32 values), within int64 [R] → masked
    popcount int32 [R] over the first ``within`` bits."""
    W = words.shape[1]
    word_base = torch.arange(W, dtype=torch.int64, device=words.device) * 32
    bits = (within[:, None] - word_base[None, :]).clamp(0, 32)
    partial = (torch.ones_like(bits) << bits.clamp(max=31)) - 1
    mask = torch.where(bits >= 32, torch.full_like(bits, _WORD), partial)
    return popcount32(words & mask).sum(dim=1).to(torch.int32)


def _fused_bit_at(words: torch.Tensor, within: torch.Tensor) -> torch.Tensor:
    w = words.gather(1, (within >> 5)[:, None])[:, 0]
    return ((w >> (within & 31)) & 1) != 0


def _fused_step_fields(index: DeviceIndex, cur: torch.Tensor):
    """One fused-row gather → (symbol, occ(symbol, cur), marked, mark_slot).

    Row layout (index/packing.pack_fused_rows): columns 0..4 = occ
    checkpoints, 5 = mark-rank checkpoint, then 4 bitplanes of W words
    each: dollar, base-low, base-high, mark."""
    W = index.words_per_block
    row = _take(index.fused_rows, cur >> index.log2_block).to(torch.int64)
    row = row & _WORD
    within = (cur & (index.block_size - 1)).to(torch.int64)
    dollar = row[:, 6 : 6 + W]
    b0 = row[:, 6 + W : 6 + 2 * W]
    b1 = row[:, 6 + 2 * W : 6 + 3 * W]
    mk = row[:, 6 + 3 * W : 6 + 4 * W]
    is_dollar = _fused_bit_at(dollar, within)
    lo = _fused_bit_at(b0, within)
    hi = _fused_bit_at(b1, within)
    c = torch.where(
        is_dollar,
        torch.zeros_like(cur),
        1 + lo.to(torch.int32) + 2 * hi.to(torch.int32),
    )
    # occ(c, cur): XNOR-match the target bits against the planes ($ rows
    # have zeroed base planes, so mask them out; for c == $ the dollar
    # plane IS the match plane)
    full = torch.full_like(within, _WORD)
    t0x = torch.where(lo, full, torch.zeros_like(full))[:, None]
    t1x = torch.where(hi, full, torch.zeros_like(full))[:, None]
    match = (~(b0 ^ t0x)) & (~(b1 ^ t1x)) & (~dollar) & _WORD
    match = torch.where(is_dollar[:, None], dollar, match)
    ck = row.gather(1, c.to(torch.int64)[:, None])[:, 0].to(torch.int32)
    o = ck + _fused_plane_pop(match, within)
    marked = _fused_bit_at(mk, within)
    slot = row[:, 5].to(torch.int32) + _fused_plane_pop(mk, within)
    return c, o, marked, slot


def resolve_rows_fused_plain(
    index: DeviceIndex,
    rows: torch.Tensor,
    valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain form of :func:`resolve_rows_fused`: ``sample_rate`` lockstep
    steps with frozen ``done`` lanes, then the terminal lookup."""
    assert index.fused_rows is not None and index.sample_rate > 0
    cur = torch.where(valid, rows, torch.zeros_like(rows))
    done = ~valid
    steps = torch.zeros_like(rows)
    for _ in range(index.sample_rate):
        c, o, marked, _ = _fused_step_fields(index, cur)
        is_term = marked | (c == 0)
        step_now = ~done & ~is_term
        cur = torch.where(step_now, _take(index.C, c) + o, cur)
        steps = steps + step_now.to(torch.int32)
        done = done | is_term
    # terminal lookup: marked row → sampled pair; $-row → occ(0, cur) IS
    # the $-rank (c == 0 forces the dollar plane as match plane above)
    c, o, marked, slot = _fused_step_fields(index, cur)
    rid_d = _clip_take(index.dollar_map, o, index.dollar_map.shape[0])
    pair = _clip_take(index.sample_pairs, slot, index.sample_pairs.shape[0])
    rid = torch.where(marked, pair[:, 0], rid_d)
    off = torch.where(marked, pair[:, 1] + steps, steps)
    ok = valid & done
    return torch.where(ok, rid, _neg(rid)), torch.where(ok, off, _neg(off))


# ------------------------------------------- the walk kernels' arguments


def _check_rows(name: str, t: torch.Tensor, device, row_words: int) -> None:
    """A table of rank.cuh's layout the walks read: contiguous int32 on
    ``device``, ``row_words`` wide, rows 16-byte aligned for the vector
    load when ``row_words == 4``."""
    check_int32(name, t, device)
    if t.dim() != 2 or t.shape[1] != row_words or (
            row_words == 4 and t.data_ptr() % 16):
        raise ValueError(
            f"{name} must be a 16-byte aligned [rows, {row_words}] table, "
            f"got {tuple(t.shape)}"
        )


def _walk_args(
    index: DeviceIndex, kind: str, max_steps: int | None = None
) -> tuple:
    """The tables walk ``kind`` reads, in the order of csrc/resolve.cu's
    ``RS_WALK_PARAMS``, after checking them; a kind's unused tables go as
    null.  The slow walk stops within ``max_steps`` steps (default the
    longest read), the others within ``sample_rate``."""
    dev = index.device
    rw = index.rank_rows.shape[1]
    t = {}  # the tables `kind` reads, by RS_WALK_PARAMS name
    if kind == "dsa":
        if index.dsa is None or index.dsa_bits <= 0:
            raise ValueError("index carries no dsa tier")
        check_int32("dsa", index.dsa, dev)
        t["dsa"] = index.dsa
    elif kind == "fused":
        if index.fused_rows is None or index.sample_rate <= 0:
            raise ValueError("index carries no fused walk tier")
        if index.words_per_block not in FUSED_WORDS_PER_BLOCK:
            raise ValueError(
                f"the fused-walk kernels take {FUSED_WORDS_PER_BLOCK} words "
                f"per block, got {index.words_per_block}"
            )
        fr = index.fused_rows
        check_int32("fused_rows", fr, dev)
        words = -(-(6 + 4 * index.words_per_block) // 4) * 4
        if fr.dim() != 2 or fr.shape[1] != words or fr.data_ptr() % 16:
            raise ValueError(
                f"fused rows must be 16-byte aligned [NB, {words}] words, "
                f"got {tuple(fr.shape)}"
            )
        t["fused"] = fr
    else:
        if kind in ("marks", "slow"):
            _check_rows("rank_rows", index.rank_rows, dev, rw)
            check_int32("sym4", index.sym4, dev)
            t["rank"], t["sym4"] = index.rank_rows, index.sym4
        if kind in ("marks", "lf"):
            if index.mark_rank is None or index.sample_rate <= 0:
                raise ValueError(f"index carries no {kind} walk tier")
            _check_rows("mark_rank", index.mark_rank, dev, rw)
            t["marks"] = index.mark_rank
        if kind == "lf":
            if index.lf is None:
                raise ValueError("index carries no lf tier")
            check_int32("lf", index.lf, dev, (index.n,))
            t["lf"] = index.lf
    pairs = None
    steps = 0
    if kind in ("fused", "marks", "lf"):
        pairs = index.sample_pairs
        check_int32("sample_pairs", pairs, dev)
        if pairs.dim() != 2 or pairs.shape[1] != 2 or pairs.data_ptr() % 8:
            raise ValueError(
                f"sample_pairs must be 8-byte aligned [n, 2] pairs, got "
                f"{tuple(pairs.shape)}"
            )
        steps = index.sample_rate
    elif kind == "slow":
        steps = index.max_read_len if max_steps is None else int(max_steps)
        if steps < 1:
            raise ValueError(f"the slow walk's kernel takes max_steps >= 1, "
                             f"got {steps}")
    if kind != "dsa":
        check_int32("C", index.C, dev, (6,))
        check_int32("dollar_map", index.dollar_map, dev)
    # the slow walk clips its $-rank to num_reads, the others to dollar_map
    n_dollar = (index.num_reads if kind == "slow" or index.dollar_map is None
                else index.dollar_map.shape[0])
    fr = t.get("fused")
    return (
        ptr(t.get("dsa")), index.dsa_bits if "dsa" in t else 0,
        ptr(fr), 0 if fr is None else fr.shape[1],
        ptr(t.get("rank")), ptr(t.get("sym4")), ptr(t.get("marks")),
        ptr(t.get("lf")),
        index.rows_per_symbol, index.log2_block, index.words_per_block, rw,
        ptr(index.C), ptr(index.dollar_map), n_dollar,
        ptr(pairs), 0 if pairs is None else pairs.shape[0], steps,
    )


def _launch_walk(
    index: DeviceIndex,
    kind: str,
    rows: torch.Tensor,
    valid: torch.Tensor,
    max_steps: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 (``kind`` fused) or the rank walks' kernel over ``rows`` where
    ``valid`` → ``(read_id, offset)``, -1 where invalid or unterminated."""
    args = _walk_args(index, kind, max_steps)
    R = rows.shape[0]
    check_int32("rows", rows, index.device, (R,))
    if valid.dtype != torch.bool or valid.shape != rows.shape:
        raise ValueError("valid must be a bool tensor shaped like rows")
    valid = valid.contiguous()
    rid = torch.empty_like(rows)
    off = torch.empty_like(rows)
    if R:
        if kind == "fused":
            RESOLVE_FUSED(ptr(rows), ptr(valid), R, *args, ptr(rid),
                          ptr(off), device=index.device)
        else:
            RESOLVE_WALK(WALK_KINDS[kind], ptr(rows), ptr(valid), R, *args,
                         ptr(rid), ptr(off), device=index.device)
    return rid, off


def resolve_rows_fused(
    index: DeviceIndex,
    rows: torch.Tensor,   # int32 [R] starting SA rows
    valid: torch.Tensor,  # bool  [R]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-row walk: the bounded (≤ ``sample_rate`` steps) resolve at ONE
    row gather per step; a walk ends at a marked row (its sampled pair,
    offset plus steps) or a ``$`` (marked wins), and -1 where it did not
    end within ``sample_rate`` steps.  K6 for CUDA tensors: a persistent
    grid whose warps take 32 slots at a time, a lane taking its warp's
    next slot when its walk ends, with the terminal read issued beside the
    other lanes' row reads; the plain form for CPU tensors."""
    if not on_cuda(rows):
        return resolve_rows_fused_plain(index, rows, valid)
    return _launch_walk(index, "fused", rows, valid)


# ------------------------------------------------------ the rank walks


def resolve_rows_marked(
    index: DeviceIndex,
    rows: torch.Tensor,   # int32 [R] starting SA rows
    valid: torch.Tensor,  # bool  [R]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mark walk without the ``lf`` array: ≤ ``sample_rate`` steps, each
    the row's symbol, its rank and its mark bit; a walk ends at a marked
    row (its sampled pair through the mark rank, offset plus steps) or a
    ``$`` (``occ($, i)`` is the dollar_map key; marked wins), -1 where it
    did not end.  The walk kernel for CUDA tensors (on K6's sweep, a step
    in one or two rounds of row reads, see the module docstring), the
    plain form for CPU tensors."""
    if not on_cuda(rows):
        return resolve_rows_marked_plain(index, rows, valid)
    return _launch_walk(index, "marks", rows, valid)


def resolve_rows_fast(
    index: DeviceIndex,
    rows: torch.Tensor,   # int32 [R] starting SA rows
    valid: torch.Tensor,  # bool  [R]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sampled-LF walk over the ``lf`` array (sign bit = sampled row): a
    walk ends at a ``$`` (``lf value < num_reads``, the dollar_map key) or
    at a sampled row, whose mark rank indexes ``sample_pairs``.  The walk
    kernel for CUDA tensors (one LF word a step, the mark row read at a
    sampled row), the plain form for CPU tensors."""
    if not on_cuda(rows):
        return resolve_rows_fast_plain(index, rows, valid)
    return _launch_walk(index, "lf", rows, valid)


def _kernel_steps(max_steps=None, rank_fn=None, sym_fn=None) -> int | None:
    """The slow walk's options the kernel takes: ``max_steps``.  Its
    ``rank_fn``/``sym_fn`` hooks are plain-only: the sharded walks run in
    their own kernel (``ops/sharded.resolve``)."""
    if rank_fn is not None or sym_fn is not None:
        raise NotImplementedError(
            "the slow walk's rank_fn/sym_fn hooks run only in the plain "
            "form, on CPU tensors; the interval-sharded walks have their "
            "own kernel (ops/sharded.resolve)"
        )
    return max_steps


def resolve_rows(
    index: DeviceIndex,
    rows: torch.Tensor,   # int32 [R] starting SA rows
    valid: torch.Tensor,  # bool  [R]
    max_steps: int | None = None,
    rank_fn=None,
    sym_fn=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The slow walk, one symbol per step up to ``max_steps`` (default the
    longest read): → ``(read_id, offset)`` int32 [R]; -1 where invalid or
    unterminated.  At a ``$`` the LF rank ``occ(0, i)`` is the ``$``-rank.
    The walk kernel for CUDA tensors (the marks walk's step without the
    mark row), which takes no hooks; the plain form for CPU tensors."""
    if not on_cuda(rows):
        return resolve_rows_plain(index, rows, valid, max_steps, rank_fn,
                                  sym_fn)
    steps = _kernel_steps(max_steps, rank_fn, sym_fn)
    return _launch_walk(index, "slow", rows, valid, steps)


# --------------------------------------------------------------- selection

# walk kind → the walk, and its plain form
_WALKS = {
    "dsa": (resolve_rows_dsa, resolve_rows_dsa_plain),
    "lf": (resolve_rows_fast, resolve_rows_fast_plain),
    "fused": (resolve_rows_fused, resolve_rows_fused_plain),
    "marks": (resolve_rows_marked, resolve_rows_marked_plain),
    "slow": (resolve_rows, resolve_rows_plain),
}


def walk_kind(index: DeviceIndex) -> str:
    """The best resolve strategy the shipped tiers support, best-first:
    dsa (1 gather, no walk) > lf (1×4B gather/step) > fused (1×64B
    gather/step) > marks (3 gathers/step) > slow (2 gathers × read_len)."""
    if index.dsa is not None and index.dsa_bits > 0:
        return "dsa"
    if index.lf is not None and index.sample_rate > 0:
        return "lf"
    if index.fused_rows is not None and index.sample_rate > 0:
        return "fused"
    if index.mark_rank is not None and index.sample_rate > 0:
        return "marks"
    return "slow"


def select_walk(index: DeviceIndex, plain: bool = False, **slow_kw):
    """``(rows, valid) → (read_id, offset)`` through the walk
    :func:`walk_kind` names (its plain form when ``plain``); ``slow_kw``
    goes to the slow walk."""
    kind = walk_kind(index)
    fn = _WALKS[kind][1 if plain else 0]
    if kind == "slow":
        return lambda r, v: fn(index, r, v, **slow_kw)
    return lambda r, v: fn(index, r, v)


def compact_rows(rows: torch.Tensor, valid: torch.Tensor, R_c: int):
    """The row-budget compaction as a prefix-sum scatter: the first ``R_c``
    valid lanes in flat order → ``(rows [R_c], valid [R_c], orig [R_c],
    keep [F])``, where ``orig`` is each compact slot's flat lane (F where
    the slot is empty) and ``keep`` marks the lanes kept.  The JAX
    package's compaction op for op: the plain form K14 is held against,
    which no served path runs."""
    F = rows.shape[0]
    dev = rows.device
    v32 = valid.to(torch.int32)
    pos = torch.cumsum(v32, 0) - v32
    keep = valid & (pos < R_c)
    # R_c is the overflow slot: written, then cut off
    slot = torch.where(keep, pos, torch.full_like(pos, R_c))
    comp_rows = torch.zeros(R_c + 1, dtype=rows.dtype, device=dev)
    comp_rows = comp_rows.scatter(0, slot, rows)[:R_c]
    comp_valid = torch.zeros(R_c + 1, dtype=torch.bool, device=dev)
    comp_valid = comp_valid.scatter(0, slot, keep)[:R_c]
    orig = torch.full((R_c + 1,), F, dtype=torch.int64, device=dev)
    orig = orig.scatter(
        0, slot, torch.arange(F, dtype=torch.int64, device=dev)
    )[:R_c]
    return comp_rows.contiguous(), comp_valid.contiguous(), orig, keep


# ------------------------------------------ K14: the row-budget compaction


def _lane_prefix(l: torch.Tensor, u: torch.Tensor, max_hits: int):
    """int32 [B + 1]: the exclusive prefix of each query's hit lanes,
    ``min(max(u - l, 0), max_hits)``; the last entry is their total."""
    c = (u - l).clamp(0, max_hits).to(torch.int32)
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=l.device),
                      torch.cumsum(c, 0, dtype=torch.int32)])


def compact_lanes_plain(l, u, max_hits: int, row_budget: int):
    """Plain form of :func:`compact_lanes`: :func:`expand_intervals`, then
    :func:`compact_rows`."""
    rows, valid, _ = expand_intervals(l, u, max_hits)
    comp_rows, comp_valid, _, _ = compact_rows(rows, valid, row_budget)
    return comp_rows, comp_valid, _lane_prefix(l, u, max_hits)


def _check_budget(B: int, max_hits: int, row_budget: int) -> None:
    if (max_hits < 1 or not 0 <= row_budget < 1 << 31
            or B * max_hits >= 1 << 31):
        raise ValueError(
            f"K14 takes max_hits >= 1, 0 <= row_budget < 2^31 and fewer "
            f"than 2^31 lanes, got B={B}, max_hits={max_hits}, "
            f"row_budget={row_budget}"
        )


def _check_lanes(l, u, max_hits: int, row_budget: int) -> int:
    """Raise ``ValueError`` unless K14's compaction takes these intervals
    → 1 for int64 rows, 0 for int32."""
    B = l.shape[0]
    for name, t in (("l", l), ("u", u)):
        if (t.device != l.device or t.dtype != l.dtype
                or t.dtype not in (torch.int32, torch.int64)
                or not t.is_contiguous() or tuple(t.shape) != (B,)):
            raise ValueError(
                f"{name} must be a contiguous int32 or int64 tensor of shape "
                f"({B},) on {l.device}, as l is; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    _check_budget(B, max_hits, row_budget)
    return int(l.dtype == torch.int64)


def compact_lanes(
    l: torch.Tensor, u: torch.Tensor, max_hits: int, row_budget: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The row-budget compaction before a walk.  Lane (b, h) of the
    ``[B, max_hits]`` expansion holds SA row ``l[b] + h`` where ``h <
    u[b] - l[b]``; the first ``row_budget`` valid lanes in flat order →
    ``(rows [row_budget], valid bool [row_budget], prefix int32
    [B + 1])``, a slot past them row 0 and invalid, ``prefix`` the
    exclusive prefix of each query's lanes (:func:`gather_lanes` reads it).
    ``l`` and ``u`` are int32 (one device's rows) or int64 (the interval
    shards' global rows), and the rows take their type.  K14 for CUDA
    tensors: one launch, every block scanning the queries' lanes in shared
    memory and filling its own stretch of slots.  The plain form for CPU
    tensors."""
    if not on_cuda(l):
        return compact_lanes_plain(l, u, max_hits, row_budget)
    # the kernel reads l and u as 16-byte vectors
    l, u = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone()
            for t in (l, u))
    row64 = _check_lanes(l, u, max_hits, row_budget)
    B = l.shape[0]
    dev = l.device
    prefix = torch.empty(B + 1, dtype=torch.int32, device=dev)
    rows = torch.empty(row_budget, dtype=l.dtype, device=dev)
    valid = torch.empty(row_budget, dtype=torch.bool, device=dev)
    ROW_COMPACT(ptr(l), ptr(u), row64, B, max_hits, row_budget, ptr(prefix),
                ptr(rows), ptr(valid), device=dev)
    return rows, valid, prefix


def gather_lanes_plain(l, u, max_hits: int, row_budget: int, prefix,
                       rid_c, off_c, smp_c=None, read_to_sample=None,
                       num_reads: int = 0):
    """Plain form of :func:`gather_lanes`."""
    span = torch.arange(max_hits, dtype=torch.int64, device=l.device)
    pos = prefix[:-1, None].to(torch.int64) + span[None, :]
    keep = (span[None, :] < (u - l)[:, None]) & (pos < row_budget)
    slot = torch.where(keep, pos, torch.full_like(pos, row_budget))
    none = torch.full((1,), -1, dtype=torch.int32, device=l.device)
    rid = _take(torch.cat([rid_c, none]), slot)
    off = _take(torch.cat([off_c, none]), slot)
    if smp_c is not None:  # a dropped lane's sample is 0
        return rid, off, _take(torch.cat([smp_c, torch.zeros_like(none)]),
                               slot), keep
    if read_to_sample is not None:
        smp = _clip_take(read_to_sample, rid, num_reads)
        return rid, off, torch.where(keep, smp, _neg(smp)), keep
    return rid, off, keep


def gather_lanes(
    l: torch.Tensor,
    u: torch.Tensor,
    max_hits: int,
    row_budget: int,
    prefix: torch.Tensor,
    rid_c: torch.Tensor,
    off_c: torch.Tensor,
    smp_c: torch.Tensor | None = None,
    read_to_sample: torch.Tensor | None = None,
    num_reads: int = 0,
) -> tuple[torch.Tensor, ...]:
    """After the walk of :func:`compact_lanes`' slots: each lane's answer
    back from its slot → ``(read_id, offset, valid)`` [B, max_hits], -1
    and invalid where the lane held no hit or fell past the budget.  With
    ``smp_c`` (the walk's samples [row_budget], the interval programs) or
    ``read_to_sample`` (and ``num_reads``: the single-device hit step) a
    third column ``sample`` comes before ``valid``: the slot's sample, 0
    where the lane drops (the JAX program clips a dropped lane's -1 to
    read 0 and counts it with weight 0), or ``read_to_sample[clip(rid, 0,
    num_reads - 1)]``, -1 where the lane drops.  K14's gather for CUDA
    tensors (each query's lanes read off ``prefix``, four lanes a thread),
    the plain form for CPU tensors."""
    if smp_c is not None and read_to_sample is not None:
        raise ValueError("gather_lanes takes smp_c or read_to_sample, "
                         "not both")
    if not on_cuda(l):
        return gather_lanes_plain(l, u, max_hits, row_budget, prefix, rid_c,
                                  off_c, smp_c, read_to_sample, num_reads)
    B = l.shape[0]
    dev = l.device
    _check_budget(B, max_hits, row_budget)
    check_int32("prefix", prefix, dev, (B + 1,))
    check_int32("rid_c", rid_c, dev, (row_budget,))
    check_int32("off_c", off_c, dev, (row_budget,))
    column, col = 0, None
    if smp_c is not None:
        check_int32("smp_c", smp_c, dev, (row_budget,))
        column, col = 1, smp_c
    elif read_to_sample is not None:
        check_int32("read_to_sample", read_to_sample, dev)
        if not 1 <= num_reads <= read_to_sample.shape[0]:
            raise ValueError(f"K14 takes 1 <= num_reads <= "
                             f"len(read_to_sample), got {num_reads}")
        column, col = 2, read_to_sample
    rid = torch.empty((B, max_hits), dtype=torch.int32, device=dev)
    off = torch.empty_like(rid)
    smp = torch.empty_like(rid) if column else None
    valid = torch.empty((B, max_hits), dtype=torch.bool, device=dev)
    if B:
        ROW_GATHER(ptr(prefix), B, max_hits, row_budget, ptr(rid_c),
                   ptr(off_c), column, ptr(col), num_reads, ptr(rid),
                   ptr(off), ptr(smp), ptr(valid), device=dev)
    return (rid, off, smp, valid) if column else (rid, off, valid)


def _budget_walk(walk, l, u, max_hits: int, row_budget: int | None, **col):
    """K14 around ``walk`` where ``row_budget`` cuts the B * max_hits
    lanes: :func:`compact_lanes`, the walk of the budget's rows and
    :func:`gather_lanes` (with ``col``'s third column, if any) → the
    gather's tuple; None where no budget cuts."""
    if row_budget is None or row_budget >= l.shape[0] * max_hits:
        return None
    rows_c, valid_c, prefix = compact_lanes(l, u, max_hits, row_budget)
    rid_c, off_c = walk(rows_c, valid_c)
    return gather_lanes(l, u, max_hits, row_budget, prefix, rid_c, off_c,
                        **col)


def resolve_intervals(
    index: DeviceIndex,
    l: torch.Tensor,
    u: torch.Tensor,
    max_hits: int,
    use_fast: bool | None = None,
    row_budget: int | None = None,
    **kw,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ ``(read_id, offset, valid)``, each [B, max_hits].

    With ``row_budget`` set (and a walk tier serving), the first
    ``row_budget`` valid lanes in flat order walk (:func:`compact_lanes`,
    then :func:`gather_lanes`: K14 on the card), the rest drop and their
    queries report ``hits_truncated``.  The dsa tier ignores the budget
    (one gather per lane is cheaper than the compaction round trip)."""
    if use_fast is False:
        # explicit request for the slow walk (parity tests)
        walk = lambda r, v: resolve_rows(index, r, v, **kw)  # noqa: E731
    elif use_fast is True:
        # explicit request for the lf sampled walk (parity tests)
        walk = lambda r, v: resolve_rows_fast(index, r, v)  # noqa: E731
    else:
        walk = select_walk(index, **kw)

    B = l.shape[0]
    dsa = index.dsa is not None and index.dsa_bits > 0 and use_fast is None
    got = None if dsa else _budget_walk(walk, l, u, max_hits, row_budget)
    if got is not None:
        return got
    rows, valid, _ = expand_intervals(l, u, max_hits)
    read_id, offset = walk(rows, valid)
    return (
        read_id.reshape(B, max_hits),
        offset.reshape(B, max_hits),
        valid.reshape(B, max_hits),
    )


def resolve_hits(
    index: DeviceIndex,
    l: torch.Tensor,
    u: torch.Tensor,
    max_hits: int,
    row_budget: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The engine's hit step: → ``(read_id, offset, sample, valid)`` [B, H]
    with -1 on every lane that holds no hit.  Through K5 in one pass when
    dsa ships (for CUDA tensors); else, under a row budget that cuts,
    :func:`compact_lanes`, the walk and :func:`gather_lanes` with the
    ``read_to_sample`` column (K14 on the card); else
    :func:`resolve_intervals` and a clipped ``read_to_sample`` gather."""
    if index.dsa is not None and index.dsa_bits > 0:
        rid, off, smp = resolve_dsa_hits(index, l, u, max_hits)
        return rid, off, smp, rid >= 0
    # the sample column gathered back with the answers
    got = _budget_walk(select_walk(index), l, u, max_hits, row_budget,
                       read_to_sample=index.read_to_sample,
                       num_reads=index.num_reads)
    if got is not None:
        return got
    rid, off, valid = resolve_intervals(index, l, u, max_hits)
    smp = _clip_take(index.read_to_sample, rid, index.num_reads)
    return (
        torch.where(valid, rid, _neg(rid)),
        torch.where(valid, off, _neg(off)),
        torch.where(valid, smp, _neg(smp)),
        valid,
    )


# ------------------------------------------------- K7: exact attribution


def _rounds_cap(max_rows: int | None, window: int) -> int | None:
    """Rows the ``max_rows`` cap lets the sweep reach: it binds in whole
    windows, ceil(max_rows / window) of them."""
    if max_rows is None:
        return None
    return max(-(-int(max_rows) // window), 0) * window


def exact_sample_histogram_plain(
    index: DeviceIndex,
    l: torch.Tensor,
    u: torch.Tensor,
    window: int,
    max_rows: int | None = None,
    **walk_kw,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain form of :func:`exact_sample_histogram`: window after window
    of the worklist, as the JAX ``while_loop`` sweeps it, each through the
    plain form of the walk."""
    B = l.shape[0]
    S = max(index.num_samples, 1)
    dev = l.device
    counts = (u - l).to(torch.int64)
    cum = torch.cumsum(counts, 0)
    total = int(cum[B - 1])
    span = torch.arange(window, dtype=torch.int64, device=dev)
    walk = select_walk(index, plain=True, **walk_kw)
    hist = torch.zeros(B * S, dtype=torch.int32, device=dev)
    t = 0
    while t * window < total and (max_rows is None or t * window < max_rows):
        g = t * window + span
        valid = g < total
        q = torch.searchsorted(cum, g, right=True)
        qc = q.clamp(max=B - 1)
        prev = torch.where(
            qc > 0, _take(cum, (qc - 1).clamp(min=0)), torch.zeros_like(qc)
        )
        rows = _take(l, qc) + (g - prev).to(l.dtype)
        rid, _ = walk(torch.where(valid, rows, torch.zeros_like(rows)), valid)
        sample = _clip_take(index.read_to_sample, rid, index.num_reads)
        seg = qc * S + sample.to(torch.int64)
        hist.index_add_(0, seg, valid.to(torch.int32))
        t += 1
    # rows are swept in concatenated order, so query b completed iff its
    # interval's end fell inside the processed prefix
    complete = cum <= t * window
    return hist.reshape(B, S), complete


def exact_sample_histogram(
    index: DeviceIndex,
    l: torch.Tensor,       # int32 [B]
    u: torch.Tensor,       # int32 [B]
    window: int,
    max_rows: int | None = None,
    **walk_kw,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-sample attribution over FULL intervals, no hit cap.

    The concatenation of all query intervals is one worklist of
    ``Σ(u - l)`` rows (int64 prefix sums: the total can pass 2^31); slot g
    maps to its query by a right-sided search over the prefix sums and to
    the SA row ``l[q] + (g - cum[q-1])``, which is walked to its read and
    counted under that read's sample.  Returns ``(hist int32 [B, S],
    complete bool [B])``.

    ``max_rows`` caps the sweep in whole ``window`` rounds, as the JAX
    package's loop does: the rows processed are ``min(total,
    ceil(max_rows / window) * window)`` and ``complete[b]`` is
    ``cum[b] <= t_end * window``.  A valid slot whose walk returns -1 is
    counted under ``read_to_sample[0]`` (the JAX package clips the id).

    K7 for CUDA tensors, through the walk :func:`walk_kind` names
    (``walk_kw`` goes to the slow walk, whose hooks the kernel does not
    take): a persistent grid sweeps tiles of slots up to ``min(total,
    cap)``, read on the card, so nothing waits for the card whatever
    ``max_rows`` is.  The plain form for CPU tensors."""
    if not on_cuda(l):
        return exact_sample_histogram_plain(
            index, l, u, window, max_rows, **walk_kw
        )
    kind = walk_kind(index)
    walk = _walk_args(index, kind, _kernel_steps(**walk_kw))
    dev = index.device
    B = l.shape[0]
    S = max(index.num_samples, 1)
    check_int32("l", l, dev, (B,))
    check_int32("u", u, dev, (B,))
    check_int32("read_to_sample", index.read_to_sample, dev)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    cum = torch.cumsum((u - l).to(torch.int64), 0)
    total = cum[B - 1]
    cap = _rounds_cap(max_rows, window)
    tw = (total + window - 1) // window
    if cap is not None:
        tw = torch.clamp(tw, max=cap // window)
    hist = torch.zeros(B * S, dtype=torch.int32, device=dev)
    if cap != 0:
        EXACT_HISTOGRAM(
            ptr(l), ptr(cum), B, -1 if cap is None else cap,
            WALK_KINDS[kind], *walk, ptr(index.read_to_sample),
            index.read_to_sample.shape[0], S, ptr(hist), device=dev,
        )
    return hist.reshape(B, S), cum <= tw * window


def lane_histogram_plain(sample, valid, num_samples: int) -> torch.Tensor:
    """Plain form of :func:`lane_histogram`: an ``index_add_``, the JAX
    ``segment_sum``."""
    B, H = sample.shape
    seg = (
        torch.arange(B, dtype=torch.int64, device=sample.device)[:, None]
        * num_samples + sample.to(torch.int64)
    )
    flat = torch.zeros(B * num_samples, dtype=torch.int32,
                       device=sample.device)
    flat.index_add_(0, seg.reshape(-1), valid.to(torch.int32).reshape(-1))
    return flat.reshape(B, num_samples)


def _histogram(ids, valid, read_to_sample, num_reads: int, S: int):
    """K15 over ``ids`` [B, H] int32 (read ids where ``read_to_sample`` is
    given, else samples) and ``valid`` bool [B, H] → int32 [B, S]."""
    B, H = ids.shape
    dev = ids.device
    ids, valid = ids.contiguous(), valid.contiguous()
    check_int32("ids", ids, dev)
    if valid.dtype != torch.bool or valid.shape != ids.shape:
        raise ValueError("valid must be a bool tensor shaped like the lanes")
    if S < 1:
        raise ValueError(f"K15 takes num_samples >= 1, got {S}")
    if read_to_sample is not None:
        check_int32("read_to_sample", read_to_sample, dev)
        if not 1 <= num_reads <= read_to_sample.shape[0]:
            raise ValueError(f"K15 takes 1 <= num_reads <= "
                             f"len(read_to_sample), got {num_reads}")
    if not B * H:
        return torch.zeros((B, S), dtype=torch.int32, device=dev)
    hist = torch.empty((B, S), dtype=torch.int32, device=dev)
    CAPPED_HISTOGRAM(ptr(ids), ptr(valid), B, H, ptr(read_to_sample),
                     num_reads, S, ptr(hist), device=dev)
    return hist


def lane_histogram(
    sample: torch.Tensor,  # int32 [B, H]
    valid: torch.Tensor,   # bool  [B, H]
    num_samples: int,
) -> torch.Tensor:
    """Per-query per-sample counts [B, num_samples] of the lanes
    ``valid`` marks, each under its own ``sample`` (the interval programs'
    capped histogram, whose walk gave each lane's sample).  K15's sample
    mode for CUDA tensors, the plain form for CPU tensors."""
    if not on_cuda(sample):
        return lane_histogram_plain(sample, valid, num_samples)
    return _histogram(sample, valid, None, 0, num_samples)


def sample_histogram_plain(
    index: DeviceIndex,
    read_id: torch.Tensor,  # int32 [B, H]
    valid: torch.Tensor,    # bool  [B, H]
) -> torch.Tensor:
    """Plain form of :func:`sample_histogram`: a gather of each lane's
    sample and an ``index_add_``."""
    sample = _clip_take(index.read_to_sample, read_id, index.num_reads)
    return lane_histogram_plain(sample, valid, max(index.num_samples, 1))


def sample_histogram(
    index: DeviceIndex,
    read_id: torch.Tensor,  # int32 [B, H]
    valid: torch.Tensor,    # bool  [B, H]
) -> torch.Tensor:
    """Per-query per-sample hit counts [B, num_samples] over the resolved
    (capped) hit lanes; a valid lane's sample is ``read_to_sample[clip(rid,
    0, num_reads - 1)]`` (a walk's -1 counts under sample 0's read, as the
    JAX package clips it).  K15 for CUDA tensors: a warp a query, its bins
    in the warp's shared memory.  The plain form for CPU tensors."""
    if not on_cuda(read_id):
        return sample_histogram_plain(index, read_id, valid)
    return _histogram(read_id, valid, index.read_to_sample, index.num_reads,
                      max(index.num_samples, 1))
